"""Parity of the port's flash attention (``ray_tpu_torch.ops.attention``)
with the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through
``ray_tpu.ops.attention.flash_attention`` (its Pallas kernels in interpret
mode; for a length its TPU tiling cannot take, its ``mha_reference``
forward and blocked backward) and through the port's ``flash_attention``,
which runs its kernels' plain versions on a CPU tensor. Gradients come
from ``jax.vjp`` and ``torch.autograd`` with the same output cotangent.

Tolerances, relative to the largest magnitude of the reference: float32
1e-5 for outputs and lse, 1e-4 for gradients (sums in another order);
bfloat16 2e-2 (one bf16 rounding of p, dS or the output, at the same
places on both sides; the JAX kernel rounds dK/dV per q head before the
GQA sum, the port after it).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from ray_tpu.ops.attention import _flash_forward as jax_flash_forward
from ray_tpu.ops.attention import flash_attention as jax_flash
from ray_tpu.ops.attention import mha_reference as jax_mha_reference
from ray_tpu_torch.ops import attention as port
from ray_tpu_torch.ops.attention import (flash_attention, flash_dkdv_cuda,
                                         flash_forward_cuda,
                                         flash_forward_plain, mha_reference)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL_OUT = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_GRAD = {"float32": 1e-4, "bfloat16": 2e-2}


def _inputs(b, hq, hkv, s, d, seed=0, sq=None):
    rng = np.random.default_rng(seed)
    sq = s if sq is None else sq

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return (randn(b, hq, sq, d), randn(b, hkv, s, d), randn(b, hkv, s, d),
            randn(b, hq, sq, d))


def _pair(a, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.array(a)).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_close(got, want, tol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: relative error {err} > {tol}"


CASES = [
    # causal, hq, hkv, head_dim, seq, dtype
    (True, 4, 4, 16, 64, "float32"),
    (True, 4, 2, 32, 64, "float32"),
    (False, 4, 4, 32, 64, "float32"),
    (False, 4, 2, 16, 48, "float32"),
    (True, 4, 2, 16, 33, "float32"),     # odd S: JAX's fallback path
    (False, 2, 1, 32, 33, "float32"),
    (True, 4, 2, 32, 64, "bfloat16"),
    (False, 4, 4, 16, 48, "bfloat16"),
]


@pytest.mark.parametrize("causal,hq,hkv,d,s,dtype", CASES)
def test_flash_attention_and_grads_match_jax(causal, hq, hkv, d, s, dtype):
    q, k, v, do = _inputs(2, hq, hkv, s, d)
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(k, dtype)
    jv, tv = _pair(v, dtype)
    jdo, tdo = _pair(do, dtype)

    want, vjp = jax.vjp(lambda a, b_, c: jax_flash(a, b_, c, causal=causal),
                        jq, jk, jv)
    want_grads = vjp(jdo)

    for t in (tq, tk, tv):
        t.requires_grad_()
    got = flash_attention(tq, tk, tv, causal=causal)
    got.backward(tdo)
    assert got.dtype == DTYPES[dtype][1]
    _assert_close(got, want, TOL_OUT[dtype], "output")
    for name, t, w in zip("qkv", (tq, tk, tv), want_grads):
        assert t.grad.dtype == t.dtype
        _assert_close(t.grad, w, TOL_GRAD[dtype], f"d{name}")


@pytest.mark.parametrize("causal,hq,hkv,d,s", [(True, 4, 2, 16, 64),
                                               (False, 4, 4, 32, 48),
                                               (True, 2, 1, 32, 32)])
def test_lse_matches_jax_kernel_residual(causal, hq, hkv, d, s):
    q, k, v, _ = _inputs(2, hq, hkv, s, d, seed=1)
    o, lse = jax_flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, sm_scale=None, block_q=1024,
                               block_k=1024, interpret=True,
                               save_residuals=True)
    got_o, got_lse = flash_forward_plain(torch.from_numpy(q),
                                         torch.from_numpy(k),
                                         torch.from_numpy(v), causal)
    assert got_lse.shape == (2, hq, s) and got_lse.dtype == torch.float32
    _assert_close(got_lse, np.asarray(lse)[..., 0], TOL_OUT["float32"], "lse")
    _assert_close(got_o, o, TOL_OUT["float32"], "output")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(40, 40), (24, 40)])
def test_mha_reference_matches_jax(causal, sq, sk):
    q, k, v, _ = _inputs(2, 4, 2, sk, 16, seed=2, sq=sq)
    want = jax_mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal)
    got = mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=causal)
    _assert_close(got, want, TOL_OUT["float32"], "mha_reference")


@pytest.mark.parametrize("causal,hkv,s", [(True, 2, 64), (True, 4, 37),
                                          (False, 1, 50)])
def test_plain_backward_matches_autograd_of_reference(causal, hkv, s):
    """The plain dQ and dK/dV (the kernels' arithmetic) against autograd
    through ``mha_reference`` at float32, sq == sk."""
    q, k, v, do = _inputs(2, 4, hkv, s, 32, seed=3)
    grads = []
    for fn in (flash_attention, mha_reference):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        fn(*ts, causal=causal).backward(torch.from_numpy(do))
        grads.append([t.grad for t in ts])
    for name, got, want in zip("qkv", *grads):
        _assert_close(got, want, TOL_GRAD["float32"], f"d{name}")


def test_cpu_tensors_take_the_plain_versions():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 2, 1, 20, 16))
    kernels = (port.flash_fwd_kernel, port.flash_dq_kernel,
               port.flash_dkdv_kernel)
    before = [kern.launches for kern in kernels]
    q.requires_grad_()
    flash_attention(q, k, v).backward(do)
    assert [kern.launches for kern in kernels] == before
    with pytest.raises(ValueError, match="no flash attention path"):
        flash_attention(q.detach().to("meta"), k.to("meta"), v.to("meta"))


@pytest.mark.parametrize("bad,error", [
    ("float16", TypeError),
    ("head_dim_24", ValueError),
    ("heads_3_of_2", ValueError),
    ("k_dtype", TypeError),
])
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(bad, error):
    """Checked before anything is built or launched (so on the CPU too)."""
    b, hq, hkv, s, d = 1, 4, 2, 16, 16
    dtype = torch.float32
    if bad == "float16":
        dtype = torch.float16
    elif bad == "head_dim_24":
        d = 24
    elif bad == "heads_3_of_2":
        hq = 3
    q = torch.zeros(b, hq, s, d, dtype=dtype)
    k = torch.zeros(b, hkv, s, d, dtype=dtype)
    v = k.clone()
    if bad == "k_dtype":
        k = k.to(torch.bfloat16)
    with pytest.raises(error):
        flash_forward_cuda(q, k, v)
    lse = torch.zeros(b, hq, s)
    with pytest.raises(error):
        flash_dkdv_cuda(q, k, v, q, lse, lse)
