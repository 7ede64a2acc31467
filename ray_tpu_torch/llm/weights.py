"""Carry parameter and page-pool trees across as numpy arrays.

The JAX package's trees (nested dicts of arrays) arrive here as numpy
arrays. bfloat16 numpy arrays (the ``ml_dtypes`` type) have no torch
counterpart, so every floating array goes through float32, which holds
bfloat16 exactly, and is cast to the target dtype on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device


def _is_float(a: np.ndarray) -> bool:
    return a.dtype.kind == "f" or a.dtype.name == "bfloat16"


def _to_tensor(a, device, dtype: torch.dtype | None) -> torch.Tensor:
    a = np.asarray(a)
    if not _is_float(a):
        return torch.from_numpy(np.array(a)).to(device)
    if dtype is None:
        dtype = torch.bfloat16 if a.dtype.name == "bfloat16" else \
            getattr(torch, a.dtype.name)
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.to(device=device, dtype=dtype)


def _tree_to(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    return _to_tensor(tree, device, dtype)


def params_from_numpy(tree, device=None, dtype: torch.dtype | None = None):
    """Nested dict of numpy arrays -> the same dict of tensors on
    ``device`` (``None``: the card, raising where there is none). Floating
    arrays take ``dtype`` (default: their own, with numpy bfloat16 mapped
    to ``torch.bfloat16``); integer arrays keep theirs. Layouts are
    unchanged."""
    return _tree_to(tree, resolve_device(device), dtype)


def pages_from_numpy(pages: dict, device=None,
                     dtype: torch.dtype | None = None) -> dict:
    """A ``{"k", "v"}`` page pool [L, P, KH, page, D] of numpy arrays ->
    tensors on ``device`` (``None``: the card, raising where there is
    none)."""
    if set(pages) != {"k", "v"}:
        raise ValueError(f"a page pool has keys k and v, not {sorted(pages)}")
    device = resolve_device(device)
    out = {k: _to_tensor(v, device, dtype) for k, v in pages.items()}
    if out["k"].dim() != 5 or out["k"].shape != out["v"].shape:
        raise ValueError("page pool arrays must both be [L, P, KH, page, D]")
    return out

