"""Ring attention: exact attention over a sequence sharded across ranks.

Each rank holds a contiguous sequence chunk of Q/K/V; KV chunks rotate
around the ``sp`` ring (``parallel.collectives.ppermute``) while each
rank folds every chunk into an online-softmax accumulator. Plain torch
math, as the JAX package's is plain jnp.

Call on every rank of the axis, with the sequence axis split over
``sp`` in rank order.
"""

from __future__ import annotations

import math

import torch

from ..parallel.collectives import _axis, ppermute

NEG_INF = -1e30


def ring_attention(q, k, v, *, axis: str = "sp", causal: bool = True,
                   sm_scale: float | None = None, mesh=None):
    """q [B,Hq,Sl,D], k/v [B,Hkv,Sl,D] — Sl is the per-rank chunk; ranks
    hold chunks in ring order. Returns the local output chunk [B,Hq,Sl,D].
    ``axis`` is resolved against ``mesh`` or the current ``axis_env``."""
    _, n, my = _axis(axis, mesh)
    b, hq, sl, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    # GQA via a grouped head axis: K/V stay at hkv heads, so each ring hop
    # ships 1/g of the bytes a repeat-to-hq layout would
    qf = (q.float() * scale).reshape(b, hkv, g, sl, d)
    q_pos = my * sl + torch.arange(sl, device=q.device)

    def attend(t, kc, vc, acc, m, l):
        src = (my - t) % n  # which global chunk this kv block is
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kc.float())
        if causal:
            k_pos = src * sl + torch.arange(sl, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        # Explicitly zero masked entries: for a fully-masked row m_new is
        # still NEG_INF and exp(s - m_new) would be exp(0) = 1, so the
        # mask (not underflow) must kill those probabilities. Correct for
        # any rotation schedule, not just diagonal-first.
        p = torch.where(s <= NEG_INF / 2, 0.0,
                        torch.exp(s - m_new[..., None]))
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(-1)
        acc_new = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p, vc.float())
        return acc_new, m_new, l_new

    acc = torch.zeros(b, hkv, g, sl, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, hkv, g, sl), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros(b, hkv, g, sl, dtype=torch.float32, device=q.device)
    kc, vc = k, v
    # rotate n-1 times; the final chunk attends without a dead last hop
    for t in range(n - 1):
        acc, m, l = attend(t, kc, vc, acc, m, l)
        kc = ppermute(kc, axis, mesh=mesh)
        vc = ppermute(vc, axis, mesh=mesh)
    acc, m, l = attend(n - 1, kc, vc, acc, m, l)
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.reshape(b, hq, sl, d).to(q.dtype)
