"""Ulysses attention: all-to-all sequence parallelism.

The DeepSpeed-Ulysses strategy: sequence-sharded Q/K/V are reshuffled
over the ``sp`` axis with ONE all-to-all so each rank holds the FULL
sequence for a subset of heads, runs the ordinary flash attention locally
(the sm90 kernels on the card), and a second all-to-all restores
sequence sharding. Two collectives per attention vs ring's (n-1) permute
hops — cheaper when head count divides well and the sequence fits one
card; ring wins when the full sequence per card does not fit.

Call on every rank of the axis, with the sequence axis split over
``sp`` in rank order.
"""

from __future__ import annotations

from ..parallel.collectives import _axis, all_to_all
from .attention import flash_attention


def ulysses_attention(q, k, v, *, axis: str = "sp", causal: bool = True,
                      sm_scale: float | None = None, mesh=None):
    """q [B,Hq,Sl,D], k/v [B,Hkv,Sl,D] — Sl is the per-rank sequence
    chunk (chunks in ring order across the axis). Hq must be divisible
    by the axis size; Hkv must divide it or be divisible by it (smaller
    Hkv is replicated up). Returns the local output chunk [B,Hq,Sl,D].
    ``axis`` is resolved against ``mesh`` or the current ``axis_env``."""
    _, n, _ = _axis(axis, mesh)
    hq, hkv = q.shape[1], k.shape[1]
    if hq % n:
        raise ValueError(
            f"ulysses needs query heads divisible by the sp axis: "
            f"Hq={hq}, sp={n}")
    if hkv % n:
        # GQA with fewer KV heads than sp ranks: replicate KV heads up to
        # the axis size (the standard Ulysses workaround — ships
        # replicated KV through the all-to-all; ring attention avoids
        # this and is preferable at extreme GQA ratios).
        if n % hkv:
            raise ValueError(
                f"ulysses needs Hkv to divide (or be divisible by) sp: "
                f"Hkv={hkv}, sp={n}")
        k = k.repeat_interleave(n // hkv, dim=1)
        v = v.repeat_interleave(n // hkv, dim=1)
    # heads -> ranks, sequence gathered: [B, H/n, Sl*n, D]
    q, k, v = (all_to_all(t, axis, split_dim=1, concat_dim=2, mesh=mesh)
               for t in (q, k, v))
    o = flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    # back: sequence -> ranks, heads gathered
    return all_to_all(o, axis, split_dim=2, concat_dim=1, mesh=mesh)
