"""Rotary position embeddings (RoPE), Llama-3 style."""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, *, theta: float = 500_000.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for each (even) head-dim channel pair."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


_cpu_cos_warm = False


def _warm_cpu_cos() -> None:
    """Run one throwaway float32 cos over the CPU thread pool, once a
    process. The first such call can give one worker thread's share of
    its elements values up to ~1.5e-4 off (float64 too, by ~3e-9), in
    roughly one fresh process of ten; every later call in the process
    agrees with the others, so the table is the same on every call."""
    global _cpu_cos_warm
    if not _cpu_cos_warm:
        torch.cos(torch.linspace(0.0, 3000.0, 1 << 20))
        _cpu_cos_warm = True


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
    if angles.device.type == "cpu":
        _warm_cpu_cos()
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
