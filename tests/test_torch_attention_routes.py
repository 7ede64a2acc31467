"""Routing of the port's flash attention between its CUDA kernels, and the
checks the sm90 kernels' wrappers make before anything is built or
launched. CPU only: no kernel is compiled or launched here.

``flash_route`` picks the kernels by dtype alone: bf16 takes the wgmma
kernels for all three steps (``csrc/flash_fwd_sm90.cu``,
``csrc/flash_dq_sm90.cu``, ``csrc/flash_dkdv_sm90.cu``); float32 takes the
float32-FMA ("simt") kernels for all three.
"""

import pytest
import torch

from ray_tpu_torch.ops import attention as port
from ray_tpu_torch.ops.attention import (flash_attention, flash_dkdv_sm90_cuda,
                                         flash_dq_sm90_cuda,
                                         flash_forward_sm90_cuda, flash_route)

ALL_KERNELS = (port.flash_fwd_kernel, port.flash_dq_kernel,
               port.flash_dkdv_kernel, port.flash_fwd_sm90_kernel,
               port.flash_dq_sm90_kernel, port.flash_dkdv_sm90_kernel)
SM90_KERNELS = (port.flash_fwd_sm90_kernel, port.flash_dq_sm90_kernel,
                port.flash_dkdv_sm90_kernel)


def test_bf16_route_takes_sm90_kernels_for_all_three_steps():
    assert flash_route(torch.bfloat16) == {"fwd": "sm90", "dq": "sm90",
                                           "dkdv": "sm90"}


def test_f32_route_takes_simt_kernels_only():
    assert flash_route(torch.float32) == {"fwd": "simt", "dq": "simt",
                                          "dkdv": "simt"}


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_route_rejects_other_dtypes(dtype):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_route(dtype)


def test_each_route_names_a_wrapper():
    for dtype in (torch.bfloat16, torch.float32):
        for step, variant in flash_route(dtype).items():
            assert callable(port._CUDA[step, variant])
    assert port._CUDA["fwd", "sm90"] is flash_forward_sm90_cuda
    assert port._CUDA["dq", "sm90"] is flash_dq_sm90_cuda
    assert port._CUDA["dkdv", "sm90"] is flash_dkdv_sm90_cuda
    # each sm90 wrapper launches its own library's entry point
    assert {kern.source.name for kern in SM90_KERNELS} == {
        "flash_fwd_sm90.cu", "flash_dq_sm90.cu", "flash_dkdv_sm90.cu"}
    assert port.flash_dq_sm90_kernel.function == "flash_dq_sm90_launch"


def _inputs(bad: str):
    b, hq, hkv, s, d = 1, 4, 2, 16, 16
    dtype = torch.bfloat16
    if bad == "float32":
        dtype = torch.float32
    elif bad == "float16":
        dtype = torch.float16
    elif bad.startswith("head_dim"):
        d = int(bad.split("_")[-1])
    elif bad == "heads_3_of_2":
        hq = 3
    q = torch.zeros(b, hq, s, d, dtype=dtype)
    k = torch.zeros(b, hkv, s, d, dtype=dtype)
    v = torch.zeros(b, hkv, s, d, dtype=dtype)
    if bad == "non_contiguous":
        q = torch.zeros(b, hq, d, s, dtype=dtype).transpose(-1, -2)
    elif bad == "misaligned":
        # one bf16 element past a 16-byte boundary
        q = torch.zeros(q.numel() + 1, dtype=dtype)[1:].view(q.shape)
    lse = torch.zeros(b, hq, s)
    return q, k, v, lse


@pytest.mark.parametrize("bad,error", [
    ("float32", TypeError),
    ("float16", TypeError),
    ("head_dim_24", ValueError),
    ("head_dim_256", ValueError),
    ("non_contiguous", ValueError),
    ("misaligned", ValueError),
    ("heads_3_of_2", ValueError),
    ("cpu_tensor", ValueError),
])
def test_sm90_wrappers_raise_before_any_launch(bad, error):
    q, k, v, lse = _inputs(bad)
    before = [kern.launches for kern in ALL_KERNELS]
    with pytest.raises(error):
        flash_forward_sm90_cuda(q, k, v)
    with pytest.raises(error):
        flash_dq_sm90_cuda(q, k, v, q, lse, lse)
    with pytest.raises(error):
        flash_dkdv_sm90_cuda(q, k, v, q, lse, lse)
    assert [kern.launches for kern in ALL_KERNELS] == before
    # nothing was built or loaded
    assert all(kern._fn is None for kern in SM90_KERNELS)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_take_plain_versions_on_every_route(dtype):
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=gen).to(dtype)
                   for shape in ((1, 4, 24, 32), (1, 2, 24, 32),
                                 (1, 2, 24, 32), (1, 4, 24, 32)))
    before = [kern.launches for kern in ALL_KERNELS]
    q.requires_grad_()
    out = flash_attention(q, k, v)
    out.backward(do)
    assert out.dtype == dtype and q.grad.dtype == dtype
    assert [kern.launches for kern in ALL_KERNELS] == before
