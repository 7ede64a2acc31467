"""Normalization ops. Plain torch: an elementwise pass the framework fuses
poorly is a candidate for a kernel later, not a TPU kernel to port."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, *,
             eps: float = 1e-6) -> torch.Tensor:
    """Llama-style RMSNorm, f32 statistics regardless of input dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)
