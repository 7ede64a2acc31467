"""Routing of the port's paged decode between its CUDA kernels, the split
kernel's plan, and the checks its wrapper makes before anything is built
or launched. CPU only: no kernel is compiled or launched here.

``paged_route`` picks the kernel by dtype alone: bf16 (the serving path)
takes the split-K kernel (``csrc/paged_decode_split.cu``), float32 the
one-block-per-(kv head, slot) kernel (``csrc/paged_decode.cu``). The split
kernel's plan (``paged_split_plan``) is computed from host integers only;
split ``s`` walks the pool pages ``[s * per, min((s + 1) * per, n_live))``
and the last split also folds the staging rows.
"""

import inspect

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import paged_attention as port
from ray_tpu_torch.ops.paged_attention import (SPLIT_MAX,
                                               paged_decode_attention,
                                               paged_decode_cuda,
                                               paged_decode_layer_args,
                                               paged_decode_plain,
                                               paged_decode_split_cuda,
                                               paged_route, paged_split_plan)

KERNELS = (port.paged_decode_kernel, port.paged_decode_split_kernel)


def test_bf16_takes_the_split_kernel_and_f32_the_single_one():
    assert paged_route(torch.bfloat16) == "split"
    assert paged_route(torch.float32) == "single"
    assert port._CUDA["split"] is paged_decode_split_cuda
    assert port._CUDA["single"] is paged_decode_cuda
    assert port.paged_decode_split_kernel.source.name == \
        "paged_decode_split.cu"
    assert port.paged_decode_split_kernel.function == \
        "paged_decode_split_launch"


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_route_rejects_other_dtypes(dtype):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        paged_route(dtype)


def _pages_of(split: int, per: int, n_live: int) -> range:
    """The kernel's rule: split ``split`` walks these pool pages."""
    return range(split * per, min((split + 1) * per, n_live))


@pytest.mark.parametrize("slots,kh,covered,sms", [
    (8, 8, 32, 132),      # llama3-1b, uniform 8 x 2048 (time, kernel)
    (8, 8, 38, 132),      # llama3-1b, skewed 2432 + 7 x 256
    (8, 8, 9, 132),       # the profile's 8 x 512 dispatch
    (8, 8, 40, 132),      # max_len 2560
    (8, 8, 128, 132),     # a 128-page table
    (1, 8, 40, 132),      # one slot: many splits
    (4, 2, 8, 132),
    (2, 2, 1, 132),
    (1, 1, 0, 132),       # no pool page: the staging rows only
    (64, 8, 40, 132),     # more (head, slot) pairs than the plan aims at
    (8, 8, 32, 16),       # a smaller card
])
def test_split_plan_covers_every_live_page_once(slots, kh, covered, sms):
    n_split, per = paged_split_plan(slots, kh, covered, sms)
    assert type(n_split) is int and type(per) is int
    assert 1 <= n_split <= SPLIT_MAX
    assert n_split * per >= covered
    # no split starts past the covered pages
    assert covered == 0 or (n_split - 1) * per < covered
    empty = 0
    for n_live in range(covered + 1):
        owners = [[s for s in range(n_split)
                   if p in _pages_of(s, per, n_live)] for p in range(n_live)]
        assert all(len(o) == 1 for o in owners), (n_live, owners)
        empty += sum(not _pages_of(s, per, n_live) for s in range(n_split))
    if n_split > 1:
        assert empty > 0          # short slots leave splits with no page


def test_split_plan_fills_the_card_at_llama3_1b():
    """8 slots x 8 kv heads (64 pairs) on 132 SMs: the single kernel's 64
    blocks become at least 4 per SM's worth, pages permitting."""
    n_split, per = paged_split_plan(8, 8, 32, 132)
    assert 8 * 8 * n_split >= 4 * 132 - 8 * 8
    assert per * n_split >= 32
    # more pages per split rather than more splits once the card is full
    assert paged_split_plan(64, 8, 40, 132) == (2, 20)


def test_split_plan_takes_host_integers_only():
    assert list(inspect.signature(paged_split_plan).parameters) == [
        "slots", "kh", "covered", "num_sms"]
    # the same integers give the same plan, however the call is made
    assert paged_split_plan(8, 8, 32, 132) == paged_split_plan(
        slots=8, kh=8, covered=32, num_sms=132)


def _raw(dtype=torch.bfloat16, *, g=2, d=16, page=8, ctx=(9, 0, 30),
         stage_idx=3, seed=0):
    """q, a 2-layer pool, tables, pos and the staging keywords of a
    ``paged_decode_attention`` call on the CPU."""
    rng = np.random.default_rng(seed)
    n, kh, max_pages = len(ctx), 2, 6
    pool = n + n * max_pages

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            dtype)

    kp, vp = randn(2, pool, kh, page, d), randn(2, pool, kh, page, d)
    bt = torch.from_numpy(rng.permutation(np.arange(n, pool)).reshape(
        n, max_pages).astype(np.int32))
    pos = torch.tensor([c + stage_idx for c in ctx], dtype=torch.int32)
    ks, vs = randn(2, n, kh, 16, d), randn(2, n, kh, 16, d)
    return randn(n, kh, g, d), kp, vp, bt, pos, dict(
        page_size=page, layer=1, k_stage=ks, v_stage=vs,
        stage_idx=stage_idx, live_pages=max_pages)


def _args(dtype=torch.bfloat16, **kw):
    *tensors, kwargs = _raw(dtype, **kw)
    return paged_decode_layer_args(*tensors, **kwargs)


def _bad(bad: str) -> list:
    args = list(_args(torch.float32 if bad == "float32" else
                      torch.float16 if bad == "float16" else torch.bfloat16,
                      d=24 if bad == "head_dim_24" else 16,
                      page=12 if bad == "page_12" else 8,
                      g=17 if bad == "g_17" else 2))
    if bad == "tables_int64":
        args[3] = args[3].long()
    elif bad == "non_contiguous":
        q = args[0]
        args[0] = q.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif bad == "misaligned":
        q = args[0]
        args[0] = torch.zeros(q.numel() + 1, dtype=q.dtype)[1:].view(q.shape)
    elif bad == "stage_idx_16":
        args[7] = 16
    return args


@pytest.mark.parametrize("bad,error", [
    ("float32", TypeError),
    ("float16", TypeError),
    ("head_dim_24", ValueError),
    ("page_12", ValueError),
    ("g_17", ValueError),
    ("tables_int64", TypeError),
    ("non_contiguous", ValueError),
    ("misaligned", ValueError),
    ("stage_idx_16", ValueError),
    ("cpu_tensor", ValueError),
])
def test_split_wrapper_raises_before_any_launch(bad, error):
    args = _bad(bad)
    before = [kern.launches for kern in KERNELS]
    with pytest.raises(error):
        paged_decode_split_cuda(*args)
    assert [kern.launches for kern in KERNELS] == before
    assert port.paged_decode_split_kernel._fn is None   # nothing was built


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_take_the_plain_version(dtype):
    *tensors, kwargs = _raw(dtype)
    before = [kern.launches for kern in KERNELS]
    got = paged_decode_attention(*tensors, **kwargs)
    want = paged_decode_plain(*_args(dtype))
    assert got.dtype == dtype and got.shape == tensors[0].shape
    assert torch.equal(got, want)
    assert torch.isfinite(got.float()).all()
    assert [kern.launches for kern in KERNELS] == before
