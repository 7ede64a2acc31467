"""Parity of the PyTorch port's ops (``ray_tpu_torch.ops``) with the JAX
package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its port. The JAX paged decode kernel runs in Pallas interpret mode; the
port runs its kernel's plain version (the path a CPU tensor takes).
Tolerances: 1e-6 for f32 elementwise ops, 2e-5 for f32 attention (sums in
another order), one bf16 ulp-scale 2e-2 for bf16 attention (p is rounded
to bf16 before the PV product on both sides).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from ray_tpu.ops import apply_rope as jax_apply_rope
from ray_tpu.ops import rms_norm as jax_rms_norm
from ray_tpu.ops.paged_attention import paged_decode_attention as jax_paged
from ray_tpu.ops.paged_attention import stage_rows as jax_stage_rows
from ray_tpu.ops.rope import rope_frequencies as jax_rope_frequencies
from ray_tpu_torch.ops import (apply_rope, paged_decode_attention, rms_norm,
                               rope_frequencies, stage_rows)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.array(a)).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 128)])
def test_rms_norm_parity(shape, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jw, tw = _pair(w, dtype)
    want = jax_rms_norm(jx, jw, eps=1e-5)
    got = rms_norm(tx, tw, eps=1e-5)
    assert got.dtype == DTYPES[dtype][1]
    atol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=atol)


@pytest.mark.parametrize("head_dim", [16, 64])
def test_rope_frequencies_parity(head_dim):
    np.testing.assert_allclose(rope_frequencies(head_dim).numpy(),
                               np.asarray(jax_rope_frequencies(head_dim)),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batched_positions", [False, True])
def test_apply_rope_parity(batched_positions, dtype):
    rng = np.random.default_rng(1)
    b, h, s, d = 2, 3, 5, 32
    x = rng.standard_normal((b, h, s, d)).astype(np.float32)
    pos = (rng.integers(0, 2500, (b, s)) if batched_positions
           else np.arange(100, 100 + s)).astype(np.int32)
    jx, tx = _pair(x, dtype)
    want = jax_apply_rope(jx, jnp.asarray(pos))
    got = apply_rope(tx, torch.from_numpy(pos))
    assert got.dtype == DTYPES[dtype][1]
    # angles up to 2.5e3 rad: f32 sin/cos of large arguments differ in the
    # last bits between the two libraries
    atol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=atol)


@pytest.mark.parametrize("n_steps", [1, 8, 16, 17, 32, 33])
def test_stage_rows_parity(n_steps):
    assert stage_rows(n_steps) == jax_stage_rows(n_steps)


# ----------------------------------------------------- paged decode kernel

def _paged_inputs(g, page, mode, dtype, pos, seed=0):
    """A 2-layer pool, per-slot page tables, queries and staging rows."""
    rng = np.random.default_rng(seed)
    n, kh, d, max_pages, layers = len(pos), 2, 16, 4, 2
    pool = n + n * max_pages
    arrays = {
        "q": rng.standard_normal((n, kh, g, d)),
        "kp": rng.standard_normal((layers, pool, kh, page, d)),
        "vp": rng.standard_normal((layers, pool, kh, page, d)),
        "ks": rng.standard_normal((layers, n, kh, 16, d)),
        "vs": rng.standard_normal((layers, n, kh, 16, d)),
        "kc": rng.standard_normal((n, kh, d)),
        "vc": rng.standard_normal((n, kh, d)),
    }
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    bt = rng.permutation(np.arange(n, pool)).reshape(n, max_pages)
    j = {k: _pair(v, dtype)[0] for k, v in arrays.items()}
    t = {k: _pair(v, dtype)[1] for k, v in arrays.items()}
    j["bt"], t["bt"] = jnp.asarray(bt, jnp.int32), torch.from_numpy(
        bt.astype(np.int32))
    pos = np.asarray(pos, np.int32)
    j["pos"], t["pos"] = jnp.asarray(pos), torch.from_numpy(pos)
    return j, t


# (G, page, mode, dtype, positions, stage_idx): every mode, G 1/2/4,
# pages 8/16, pos == 0, and both dtypes.
PAGED_CASES = [
    (1, 8, "stage", "float32", [5, 17, 30], 2),
    (2, 16, "stage", "float32", [5, 17, 40], 3),
    (4, 8, "stage", "float32", [9, 31, 3], 0),
    (4, 16, "stage", "bfloat16", [12, 60, 33], 7),
    (2, 8, "stage", "float32", [0, 0, 0], 0),
    (4, 16, "stage", "bfloat16", [0, 0, 0], 0),
    (2, 8, "k_cur", "float32", [5, 17, 31], None),
    (1, 16, "k_cur", "bfloat16", [0, 22, 63], None),
    (4, 8, "pull_back", "float32", [5, 16, 31], None),
    (2, 16, "pull_back", "bfloat16", [0, 15, 50], None),
]


@pytest.mark.parametrize("g,page,mode,dtype,pos,stage_idx", PAGED_CASES)
def test_paged_decode_plain_matches_jax_kernel(g, page, mode, dtype, pos,
                                               stage_idx):
    j, t = _paged_inputs(g, page, mode, dtype, pos)
    kw = dict(page_size=page, layer=1, live_pages=3)
    if mode == "pull_back":
        kw["live_pages"] = None
    if mode == "stage":
        jkw = dict(k_stage=j["ks"], v_stage=j["vs"],
                   stage_idx=jnp.int32(stage_idx))
        tkw = dict(k_stage=t["ks"], v_stage=t["vs"], stage_idx=stage_idx)
        want = jax_paged(j["q"], j["kp"], j["vp"], j["bt"], j["pos"],
                         interpret=True, **kw, **jkw)
        got = paged_decode_attention(t["q"], t["kp"], t["vp"], t["bt"],
                                     t["pos"], **kw, **tkw)
    else:
        cur = (j["kc"], j["vc"]) if mode == "k_cur" else ()
        tcur = (t["kc"], t["vc"]) if mode == "k_cur" else ()
        want = jax_paged(j["q"], j["kp"], j["vp"], j["bt"], j["pos"], *cur,
                         interpret=True, **kw)
        got = paged_decode_attention(t["q"], t["kp"], t["vp"], t["bt"],
                                     t["pos"], *tcur, **kw)
    assert got.shape == tuple(want.shape) and got.dtype == DTYPES[dtype][1]
    atol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=1e-4)
    if mode == "stage" and stage_idx == 0 and not any(pos):
        # pos == 0: no pool page is read, the output is the staged row
        want0 = np.broadcast_to(_np(t["vs"])[1, :, :, None, 0], got.shape)
        np.testing.assert_array_equal(_np(got), want0)


def test_paged_decode_per_layer_staging_and_single_layer_pool():
    """Ls == 1 staging serves any layer, and a [P, KH, page, D] pool is the
    one-layer case of the stacked pool."""
    j, t = _paged_inputs(2, 8, "stage", "float32", [6, 19, 27])
    want = jax_paged(j["q"], j["kp"][1], j["vp"][1], j["bt"], j["pos"],
                     page_size=8, k_stage=j["ks"][:1], v_stage=j["vs"][:1],
                     stage_idx=jnp.int32(4), interpret=True)
    stacked = paged_decode_attention(
        t["q"], t["kp"], t["vp"], t["bt"], t["pos"], page_size=8, layer=1,
        k_stage=t["ks"][:1], v_stage=t["vs"][:1], stage_idx=4)
    single = paged_decode_attention(
        t["q"], t["kp"][1], t["vp"][1], t["bt"], t["pos"], page_size=8,
        k_stage=t["ks"][:1], v_stage=t["vs"][:1], stage_idx=4)
    np.testing.assert_allclose(_np(stacked), _np(want), atol=2e-5, rtol=1e-4)
    np.testing.assert_array_equal(_np(single), _np(stacked))


def test_paged_decode_argument_errors():
    _, t = _paged_inputs(2, 8, "stage", "float32", [3, 4, 5])
    with pytest.raises(ValueError, match="staging mode"):
        paged_decode_attention(t["q"], t["kp"], t["vp"], t["bt"], t["pos"],
                               t["kc"], t["vc"], page_size=8,
                               k_stage=t["ks"], v_stage=t["vs"], stage_idx=0)
    with pytest.raises(NotImplementedError, match="mesh"):
        paged_decode_attention(t["q"], t["kp"], t["vp"], t["bt"], t["pos"],
                               page_size=8, mesh=object())
