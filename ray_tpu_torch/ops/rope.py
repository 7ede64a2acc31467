"""Rotary position embeddings (RoPE), Llama-3 style."""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, *, theta: float = 500_000.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for each (even) head-dim channel pair."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 500_000.0) -> torch.Tensor:
    """Rotate q or k. x: [B, H, S, D]; positions: [B, S] or [S] int.

    Split-halves convention (rotate_half), matching Llama. Computed in f32,
    cast back to the input dtype.
    """
    d = x.shape[-1]
    inv_freq = rope_frequencies(d, theta=theta, device=x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[:, None, :, None].float() * inv_freq   # [B, 1, S, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
