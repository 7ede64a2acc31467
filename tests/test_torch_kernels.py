"""The port's CUDA kernels (paged decode on both routes: the bf16 split-K
kernel and the one-block-per-(kv head, slot) kernel; flash-attention
forward, dQ and dK/dV on both routes: the bf16 wgmma kernels and the
float32 FMA kernels) against their plain PyTorch versions, on the card,
the entry points' default device, and the bf16 lm_head backward's
products at llama3-1b widths.

CUDA kernels have no interpreter, so these tests need a CUDA device and
skip without one; on a machine with a card run them with

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tolerances: f32 1e-4 (sums in another order), bf16 2e-2 (p rounded to
bf16 before the PV product, outputs rounded to bf16); for the flash
kernels' dQ/dK/dV, relative to the plain result's largest magnitude
(with a single key dQ and dK are exactly 0, so there they are held to 0
relative to the case's largest plain gradient).
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.llm import pages_from_numpy, params_from_numpy
from ray_tpu_torch.llm.model import init_pages
from ray_tpu_torch.models.llama import PRESETS, lm_head_grads_f32
from ray_tpu_torch.ops.attention import (flash_attention, flash_dkdv_cuda,
                                         flash_dkdv_kernel, flash_dkdv_plain,
                                         flash_dkdv_sm90_cuda,
                                         flash_dkdv_sm90_kernel,
                                         flash_dq_cuda, flash_dq_kernel,
                                         flash_dq_plain, flash_dq_sm90_cuda,
                                         flash_dq_sm90_kernel,
                                         flash_forward_cuda,
                                         flash_forward_plain,
                                         flash_forward_sm90_cuda,
                                         flash_fwd_kernel,
                                         flash_fwd_sm90_kernel)
from ray_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                               paged_decode_cuda,
                                               paged_decode_kernel,
                                               paged_decode_layer_args,
                                               paged_decode_plain,
                                               paged_decode_split_cuda,
                                               paged_decode_split_kernel)

requires_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                   reason="needs a CUDA device")

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _inputs(g, d, page, ctx, dtype, stage_idx, seed=0, max_pages=8):
    rng = np.random.default_rng(seed)
    n, kh = len(ctx), 2
    pool = n + n * max_pages

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            "cuda", dtype)

    kp, vp = randn(2, pool, kh, page, d), randn(2, pool, kh, page, d)
    bt = torch.from_numpy(rng.permutation(np.arange(n, pool)).reshape(
        n, max_pages).astype(np.int32)).cuda()
    pos = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    ks, vs = randn(2, n, kh, 32, d), randn(2, n, kh, 32, d)
    return paged_decode_layer_args(
        randn(n, kh, g, d), kp, vp, bt, pos, page_size=page, layer=1,
        k_stage=ks, v_stage=vs, stage_idx=stage_idx,
        live_pages=max_pages)


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,d,page", [(1, 16, 8), (2, 32, 16), (4, 64, 64),
                                      (8, 128, 32)])
@pytest.mark.parametrize("stage_idx", [0, 31])
def test_paged_decode_kernel_matches_plain(g, d, page, dtype, stage_idx):
    ctx = [stage_idx, stage_idx + 1, 5 * page + 3 + stage_idx,
           8 * page + stage_idx]
    args = _inputs(g, d, page, ctx, dtype, stage_idx)
    got = paged_decode_cuda(*args)
    torch.cuda.synchronize()
    want = paged_decode_plain(*args)
    assert got.dtype == dtype and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


# Context lengths per batch kind, for a page of ``page`` rows: every slot
# long; one slot long and the rest short; every slot at position 0 (the
# staging rows only).
def _ctx(batch, page, stage_idx):
    return {"uniform": [20 * page + 5 + stage_idx] * 4,
            "skewed": [30 * page + 7 + stage_idx] + [page + stage_idx] * 3,
            "pos0": [stage_idx] * 4}[batch]


@requires_cuda
@pytest.mark.parametrize("stage_idx", [0, 31])
@pytest.mark.parametrize("batch", ["uniform", "skewed", "pos0"])
@pytest.mark.parametrize("page", [8, 16, 64])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_paged_split_kernel_matches_plain(g, d, page, batch, stage_idx):
    args = _inputs(g, d, page, _ctx(batch, page, stage_idx), torch.bfloat16,
                   stage_idx, max_pages=32)
    before = paged_decode_split_kernel.launches
    got = paged_decode_split_cuda(*args)
    torch.cuda.synchronize()
    assert paged_decode_split_kernel.launches == before + 1
    want = paged_decode_plain(*args)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@requires_cuda
def test_paged_decode_wrapper_counts_and_raises():
    args = _inputs(2, 32, 16, [3, 40], torch.float32, 0)
    before = paged_decode_kernel.launches
    q, kp, vp, bt, pos = args[0], args[1], args[2], args[3], args[4]
    paged_decode_attention(q, kp, vp, bt, pos, page_size=16)
    assert paged_decode_kernel.launches == before + 1
    with pytest.raises(TypeError, match="int32"):
        paged_decode_attention(q, kp, vp, bt.long(), pos, page_size=16)
    with pytest.raises(TypeError):
        paged_decode_attention(q.half(), kp.half(), vp.half(), bt, pos,
                               page_size=16)
    assert paged_decode_kernel.launches == before + 1
    # bf16 takes the split kernel, once, and not the single one
    before_split = paged_decode_split_kernel.launches
    paged_decode_attention(q.bfloat16(), kp.bfloat16(), vp.bfloat16(), bt,
                           pos, page_size=16)
    assert paged_decode_split_kernel.launches == before_split + 1
    assert paged_decode_kernel.launches == before + 1


# ------------------------------------------------------ flash attention
# dQ/dK/dV in bf16: one bf16 rounding of dS or P that may fall the other
# way on either side, then the output rounding; relative to the largest
# magnitude of the plain version's result.
FLASH_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _flash_inputs(b, hq, hkv, s, d, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            "cuda", dtype)

    return (randn(b, hq, s, d), randn(b, hkv, s, d), randn(b, hkv, s, d),
            randn(b, hq, s, d))


def _rel_err(got, want) -> float:
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv,d,s", [(4, 1, 16, 96), (2, 2, 32, 130),
                                        (8, 2, 64, 256), (4, 4, 128, 77)])
def test_flash_kernels_match_plain(hq, hkv, d, s, causal, dtype):
    q, k, v, do = _flash_inputs(2, hq, hkv, s, d, dtype)
    o, lse = flash_forward_cuda(q, k, v, causal)
    torch.cuda.synchronize()
    want_o, want_lse = flash_forward_plain(q, k, v, causal)
    assert (o.float() - want_o.float()).abs().max().item() <= TOL[dtype]
    assert (lse - want_lse).abs().max().item() <= 1e-4
    delta = (do.float() * want_o.float()).sum(-1)
    args = (q, k, v, do, want_lse, delta, causal)
    dq = flash_dq_cuda(*args)
    dk, dv = flash_dkdv_cuda(*args)
    torch.cuda.synchronize()
    want_dk, want_dv = flash_dkdv_plain(*args)
    tol = FLASH_GRAD_TOL[dtype]
    assert _rel_err(dq, flash_dq_plain(*args)) <= tol
    assert _rel_err(dk, want_dk) <= tol
    assert _rel_err(dv, want_dv) <= tol


def _grad_rel_err(got, want, name, sk) -> float:
    """``_rel_err``, except dQ and dK with one key: exactly 0 there (the
    plain values are rounding noise), relative to the largest plain
    gradient."""
    if sk == 1 and name in ("dq", "dk"):
        scale = max(w.float().abs().max().item() for w in want.values())
        return got.float().abs().max().item() / max(scale, 1e-30)
    return _rel_err(got, want[name])


@requires_cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 100, 257, 1000])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_sm90_kernels_match_plain(d, hq, hkv, s, causal):
    q, k, v, do = _flash_inputs(2, hq, hkv, s, d, torch.bfloat16)
    o, lse = flash_forward_sm90_cuda(q, k, v, causal)
    torch.cuda.synchronize()
    want_o, want_lse = flash_forward_plain(q, k, v, causal)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert (o.float() - want_o.float()).abs().max().item() <= 2e-2
    assert (lse - want_lse).abs().max().item() <= 1e-4
    delta = (do.float() * want_o.float()).sum(-1)
    args = (q, k, v, do, want_lse, delta, causal)
    dq = flash_dq_sm90_cuda(*args)
    dk, dv = flash_dkdv_sm90_cuda(*args)
    torch.cuda.synchronize()
    want = dict(zip(("dk", "dv"), flash_dkdv_plain(*args)))
    want["dq"] = flash_dq_plain(*args)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    for name, got in (("dq", dq), ("dk", dk), ("dv", dv)):
        assert _grad_rel_err(got, want, name, s) <= 2e-2, name


def _counts(kernels):
    return [kern.launches for kern in kernels]


@requires_cuda
def test_flash_attention_counts_launches_and_raises():
    """bf16 takes the sm90 forward, dQ and dK/dV, once each per forward
    and backward, and no other flash kernel."""
    q, k, v, do = _flash_inputs(1, 4, 2, 64, 32, torch.bfloat16)
    on = (flash_fwd_sm90_kernel, flash_dq_sm90_kernel, flash_dkdv_sm90_kernel)
    off = (flash_fwd_kernel, flash_dq_kernel, flash_dkdv_kernel)
    before, before_off = _counts(on), _counts(off)
    q.requires_grad_()
    flash_attention(q, k, v).backward(do)
    assert _counts(on) == [n + 1 for n in before]
    assert _counts(off) == before_off
    with pytest.raises(TypeError):
        flash_attention(q.detach().half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q.detach()[..., :24], k[..., :24], v[..., :24])
    assert _counts(on) == [n + 1 for n in before]


@requires_cuda
def test_flash_attention_f32_launches_only_simt_kernels():
    q, k, v, do = _flash_inputs(1, 4, 2, 64, 32, torch.float32)
    on = (flash_fwd_kernel, flash_dq_kernel, flash_dkdv_kernel)
    off = (flash_fwd_sm90_kernel, flash_dq_sm90_kernel,
           flash_dkdv_sm90_kernel)
    before, before_off = _counts(on), _counts(off)
    q.requires_grad_()
    flash_attention(q, k, v).backward(do)
    assert _counts(on) == [n + 1 for n in before]
    assert _counts(off) == before_off


@requires_cuda
def test_entry_points_default_to_the_card():
    cfg = PRESETS["debug"]
    np_pages = {k: np.zeros((1, 2, 1, 4, 8), np.float32) for k in "kv"}
    assert init_pages(cfg, 4, 8)["k"].device.type == "cuda"
    assert params_from_numpy({"w": np.ones(3, np.float32)})["w"].is_cuda
    assert pages_from_numpy(np_pages)["v"].is_cuda


@requires_cuda
def test_bf16_lm_head_grads_keep_the_f32_gradient_at_llama3_1b():
    """One loss chunk at llama3-1b widths (2048 tokens, hidden 2048, vocab
    128,256): the bf16 lm_head backward's float32 products against float64
    products of the float32 g with the exact bf16 h and w, within 1e-4
    (relative Frobenius)."""
    cfg = PRESETS["llama3-1b"]
    c, e, v = 2048, cfg.hidden, cfg.vocab_size
    gen = torch.Generator("cuda").manual_seed(0)
    g = torch.randn(c, v, generator=gen, device="cuda") * 1e-4
    h = torch.randn(c, e, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(e, v, generator=gen, device="cuda")
         * e ** -0.5).bfloat16()
    dh, dw = lm_head_grads_f32(g, h, w)
    assert dh.dtype == dw.dtype == torch.float32
    g64 = g.double()
    for got, want in ((dh, g64 @ w.double().t()), (dw, h.double().t() @ g64)):
        err = torch.linalg.norm(got.double() - want) / torch.linalg.norm(want)
        assert err.item() <= 1e-4
