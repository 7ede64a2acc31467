"""Flash attention: the forward, dQ and dK/dV kernels behind one autograd
function.

The port of ``ray_tpu/ops/attention.py``. Its three Pallas TPU kernels
(``_flash_kernel``, ``_bwd_dq_kernel``, ``_bwd_dkdv_kernel``) become CUDA
C++ kernels written for Hopper, on two routes chosen by dtype alone
(``flash_route``):

  * bfloat16: ``csrc/flash_fwd_sm90.cu`` (forward),
    ``csrc/flash_dq_sm90.cu`` (dQ) and ``csrc/flash_dkdv_sm90.cu``
    (dK/dV), bf16 ``wgmma`` products fed by TMA ("sm90");
  * float32: ``csrc/flash_fwd.cu`` (forward) and ``csrc/flash_bwd.cu``
    (dQ, dK/dV), exact float32 FMAs ("simt").

``flash_attention`` keeps the JAX function's layouts: q [B, Hq, S, D],
k/v [B, Hkv, S, D], GQA when Hq > Hkv, output in q's dtype.

Each kernel has a plain PyTorch version here that computes what its body
computes, rounding at the same places:

  * forward: scores and softmax statistics in float32; P is rounded to V's
    dtype before the PV product while the row sum uses the unrounded P;
    lse = m + log(max(l, 1e-30)), kept as [B, Hq, S] float32;
  * backward: P = exp(scale * Q Kᵀ - lse); δ = rowsum(dO ∘ O) in float32
    from the output in its own dtype (computed by the autograd function,
    outside the kernels, as the TPU path does); dS = P ∘ (dO Vᵀ − δ) · scale
    rounded to q's dtype before both the dQ and dK products; P rounded to
    dO's dtype before the dV product; the GQA group's dK/dV summed in
    float32.

Causal masking is the TPU kernel's rule, q_id >= k_id on absolute ids.
``mha_reference`` masks with ``tril(k=sk - sq)``, as JAX's does; the two
agree only when sq == sk, which is all the training path uses. Any
sequence length works: the JAX package falls back to ``mha_reference``
and a blocked backward for lengths its TPU tiling cannot take, which
compute the same function (they round differently in bf16).

A CPU tensor takes the plain versions; a CUDA tensor launches the kernels
or raises. The sequence-parallel callers (ring, Ulysses) are not in this
package yet.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .._cuda import CudaKernel

NEG_INF = -1e30

KERNEL_DIMS = (16, 32, 64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# b, hq, hkv, sq, sk, d, scale, causal, dtype, stream
_SHAPE_ARGS = [_I, _I, _I, _I, _I, _I, _F, _I, _I, _P]
flash_fwd_kernel = CudaKernel(
    "flash_fwd.cu", "flash_fwd_launch",
    [_P, _P, _P, _P, _P] + _SHAPE_ARGS)            # q, k, v, o, lse
flash_dq_kernel = CudaKernel(
    "flash_bwd.cu", "flash_dq_launch",
    [_P, _P, _P, _P, _P, _P, _P] + _SHAPE_ARGS)    # q, k, v, dO, lse, δ, dq
flash_dkdv_kernel = CudaKernel(
    "flash_bwd.cu", "flash_dkdv_launch",
    [_P] * 8 + _SHAPE_ARGS)                        # q, k, v, dO, lse, δ, dk, dv
flash_fwd_sm90_kernel = CudaKernel(
    "flash_fwd_sm90.cu", "flash_fwd_sm90_launch",
    [_P, _P, _P, _P, _P] + _SHAPE_ARGS)            # q, k, v, o, lse
flash_dq_sm90_kernel = CudaKernel(
    "flash_dq_sm90.cu", "flash_dq_sm90_launch",
    [_P] * 7 + _SHAPE_ARGS)                        # q, k, v, dO, lse, δ, dq
flash_dkdv_sm90_kernel = CudaKernel(
    "flash_dkdv_sm90.cu", "flash_dkdv_sm90_launch",
    [_P] * 8 + _SHAPE_ARGS)                        # q, k, v, dO, lse, δ, dk, dv


def flash_route(dtype: torch.dtype) -> dict:
    """Which kernel each step of ``flash_attention`` launches on a CUDA
    tensor of ``dtype``: ``"sm90"`` (bf16 wgmma, TMA) or ``"simt"`` (exact
    float32 FMAs). Decided by dtype alone; raises TypeError for a dtype
    no kernel takes."""
    if dtype == torch.bfloat16:
        return {"fwd": "sm90", "dq": "sm90", "dkdv": "sm90"}
    if dtype == torch.float32:
        return {"fwd": "simt", "dq": "simt", "dkdv": "simt"}
    raise TypeError(f"flash kernels take float32 or bfloat16, not {dtype}")


def _scale(d: int, sm_scale: float | None) -> float:
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)


def _repeat_kv(k: torch.Tensor, hq: int) -> torch.Tensor:
    """[B, Hkv, S, D] -> [B, Hq, S, D]: kv head h // rep serves q head h."""
    rep = hq // k.shape[1]
    return k if rep == 1 else k.repeat_interleave(rep, dim=1)


def mha_reference(q, k, v, *, causal: bool = True,
                  sm_scale: float | None = None):
    """Plain attention; ground truth for the kernel tests and the
    ``attn_impl="reference"`` model path. q [B, Hq, Sq, D], k/v
    [B, Hkv, Sk, D]; GQA by repeat. Scores in float32; the causal mask is
    ``tril(k=sk - sq)``."""
    hq, sq, d = q.shape[1], q.shape[2], q.shape[3]
    k, v = _repeat_kv(k, hq), _repeat_kv(v, hq)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits * _scale(d, sm_scale)
    if causal:
        sk = k.shape[2]
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs, v.float()).to(q.dtype)


def _scores(q, k, causal: bool, scale: float) -> torch.Tensor:
    """scale * Q Kᵀ in float32 at q-head count, masked with the kernel's
    rule (q_id >= k_id) to NEG_INF."""
    s = torch.matmul(q.float(), _repeat_kv(k, q.shape[1]).float()
                     .transpose(-1, -2)) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(qi >= ki, s, torch.full_like(s, NEG_INF))
    return s


def flash_forward_plain(q, k, v, causal: bool = True,
                        sm_scale: float | None = None):
    """The forward kernel's arithmetic: ``(o, lse)``, o in q's dtype, lse
    [B, Hq, Sq] float32."""
    s = _scores(q, k, causal, _scale(q.shape[-1], sm_scale))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    # p rounded to V's dtype before the PV product; l sums the unrounded p
    acc = torch.matmul(p.to(v.dtype).float(), _repeat_kv(v, q.shape[1]).float())
    o = (acc / l).to(q.dtype)
    lse = (m + torch.log(torch.clamp(l, min=1e-30)))[..., 0]
    return o, lse


def _probs_and_ds(q, k, v, do, lse, delta, causal, scale):
    s = _scores(q, k, causal, scale)
    p = torch.exp(s - lse[..., None])          # masked entries underflow to 0
    dp = torch.matmul(do.float(), _repeat_kv(v, q.shape[1]).float()
                      .transpose(-1, -2))
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype)
    return p, ds


def flash_dq_plain(q, k, v, do, lse, delta, causal: bool = True,
                   sm_scale: float | None = None):
    """The dQ kernel's arithmetic: dQ = dS K with dS rounded to q's dtype
    (scale already inside dS). Returns [B, Hq, Sq, D] in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal,
                          _scale(q.shape[-1], sm_scale))
    dq = torch.matmul(ds.float(), _repeat_kv(k, q.shape[1]).float())
    return dq.to(q.dtype)


def flash_dkdv_plain(q, k, v, do, lse, delta, causal: bool = True,
                     sm_scale: float | None = None):
    """The dK/dV kernel's arithmetic: dV = P̂ᵀ dO (P̂ = P rounded to dO's
    dtype) and dK = dSᵀ Q at q-head count, summed over each GQA group in
    float32. Returns ``(dk, dv)`` [B, Hkv, Sk, D] in k's and v's dtype."""
    b, hq = q.shape[0], q.shape[1]
    hkv, sk, d = k.shape[1], k.shape[2], k.shape[3]
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal,
                          _scale(d, sm_scale))
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.float().transpose(-1, -2), q.float())
    dk = dk.reshape(b, hkv, hq // hkv, sk, d).sum(dim=2)
    dv = dv.reshape(b, hkv, hq // hkv, sk, d).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------ kernels
def _check_kernel_inputs(named: dict, q, k) -> None:
    b, hq, sq, d = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match "
                         f"[{b}, Hkv, S, {d}]")
    if k.shape[1] < 1 or hq % k.shape[1]:
        raise ValueError(f"{hq} q heads is not a multiple of {k.shape[1]} "
                         "kv heads")
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash kernels take float32 or bfloat16, not "
                        f"{q.dtype}")
    if d not in KERNEL_DIMS:
        raise ValueError(f"head_dim {d} not in {KERNEL_DIMS}")
    for name, (t, dtype, shape) in named.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_sm90(q) -> None:
    """What the sm90 kernels take beyond ``_check_kernel_inputs``:
    bfloat16 on a CUDA device. Checked before anything is built."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the sm90 flash kernels take bfloat16, not {q.dtype}")
    if q.device.type != "cuda":
        raise ValueError(f"the sm90 flash kernels take CUDA tensors, not "
                         f"{q.device}")


def _launch(kernel: CudaKernel, q, k, ptrs: list, causal: bool,
            scale: float) -> None:
    b, hq, sq, d = q.shape
    fn = kernel.fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*ptrs, b, hq, k.shape[1], sq, k.shape[2], d, scale,
                int(causal), _KERNEL_DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{kernel.function} failed (code {rc})")
    kernel.launches += 1


def _forward(kernel: CudaKernel, q, k, v, causal, sm_scale):
    b, hq, sq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    _launch(kernel, q, k,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr()], causal, _scale(d, sm_scale))
    return o, lse


def _check_fwd(q, k, v) -> None:
    _check_kernel_inputs({"q": (q, q.dtype, q.shape),
                          "k": (k, q.dtype, k.shape),
                          "v": (v, q.dtype, k.shape)}, q, k)


def flash_forward_cuda(q, k, v, causal: bool = True,
                       sm_scale: float | None = None):
    """Launch the float32-FMA ("simt") forward kernel on the current
    stream: ``(o, lse)`` as ``flash_forward_plain`` returns them, for
    float32 or bfloat16. Raises on any input the kernel does not take, and
    if the launch is refused."""
    _check_fwd(q, k, v)
    return _forward(flash_fwd_kernel, q, k, v, causal, sm_scale)


def flash_forward_sm90_cuda(q, k, v, causal: bool = True,
                            sm_scale: float | None = None):
    """Launch the bf16 wgmma forward kernel (arguments and results as for
    ``flash_forward_cuda``; bfloat16 CUDA tensors only)."""
    _check_fwd(q, k, v)
    _check_sm90(q)
    return _forward(flash_fwd_sm90_kernel, q, k, v, causal, sm_scale)


def _check_bwd(q, k, v, do, lse, delta) -> None:
    stats = tuple(q.shape[:3])
    _check_kernel_inputs({"q": (q, q.dtype, q.shape),
                          "k": (k, q.dtype, k.shape),
                          "v": (v, q.dtype, k.shape),
                          "dO": (do, q.dtype, q.shape),
                          "lse": (lse, torch.float32, stats),
                          "delta": (delta, torch.float32, stats)}, q, k)


def _dq(kernel: CudaKernel, q, k, v, do, lse, delta, causal, sm_scale):
    dq = torch.empty_like(q)
    _launch(kernel, q, k,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr()], causal,
            _scale(q.shape[-1], sm_scale))
    return dq


def flash_dq_cuda(q, k, v, do, lse, delta, causal: bool = True,
                  sm_scale: float | None = None):
    """Launch the float32-FMA ("simt") dQ kernel (arguments as for
    ``flash_dq_plain``; float32 or bfloat16)."""
    _check_bwd(q, k, v, do, lse, delta)
    return _dq(flash_dq_kernel, q, k, v, do, lse, delta, causal, sm_scale)


def flash_dq_sm90_cuda(q, k, v, do, lse, delta, causal: bool = True,
                       sm_scale: float | None = None):
    """Launch the bf16 wgmma dQ kernel (arguments as for
    ``flash_dq_plain``; bfloat16 CUDA tensors only)."""
    _check_bwd(q, k, v, do, lse, delta)
    _check_sm90(q)
    return _dq(flash_dq_sm90_kernel, q, k, v, do, lse, delta, causal,
               sm_scale)


def _dkdv(kernel: CudaKernel, q, k, v, do, lse, delta, causal, sm_scale):
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(kernel, q, k,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr()],
            causal, _scale(q.shape[-1], sm_scale))
    return dk, dv


def flash_dkdv_cuda(q, k, v, do, lse, delta, causal: bool = True,
                    sm_scale: float | None = None):
    """Launch the float32-FMA ("simt") dK/dV kernel (arguments as for
    ``flash_dkdv_plain``; float32 or bfloat16)."""
    _check_bwd(q, k, v, do, lse, delta)
    return _dkdv(flash_dkdv_kernel, q, k, v, do, lse, delta, causal, sm_scale)


def flash_dkdv_sm90_cuda(q, k, v, do, lse, delta, causal: bool = True,
                         sm_scale: float | None = None):
    """Launch the bf16 wgmma dK/dV kernel (arguments as for
    ``flash_dkdv_plain``; bfloat16 CUDA tensors only)."""
    _check_bwd(q, k, v, do, lse, delta)
    _check_sm90(q)
    return _dkdv(flash_dkdv_sm90_kernel, q, k, v, do, lse, delta, causal,
                 sm_scale)


_CUDA = {("fwd", "simt"): flash_forward_cuda,
         ("fwd", "sm90"): flash_forward_sm90_cuda,
         ("dq", "simt"): flash_dq_cuda,
         ("dq", "sm90"): flash_dq_sm90_cuda,
         ("dkdv", "simt"): flash_dkdv_cuda,
         ("dkdv", "sm90"): flash_dkdv_sm90_cuda}


def _on(q: torch.Tensor, step: str):
    """The plain version of ``step`` for a CPU tensor, the kernel of
    ``flash_route`` for a CUDA one."""
    if q.device.type == "cpu":
        # looked up at call time, so a test may wrap a plain version
        return {"fwd": flash_forward_plain, "dq": flash_dq_plain,
                "dkdv": flash_dkdv_plain}[step]
    if q.device.type == "cuda":
        return _CUDA[step, flash_route(q.dtype)[step]]
    raise ValueError(f"no flash attention path for device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """Forward kernel; backward = δ in float32, then the dQ and dK/dV
    kernels (the ``_make_flash`` custom VJP of the JAX package)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = _on(q, "fwd")(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        # δ = rowsum(dO ∘ O) in float32 from O in its own dtype, outside
        # the kernels (ray_tpu/ops/attention.py:290)
        delta = (do.float() * o.float()).sum(dim=-1)
        args = (q, k, v, do, lse, delta, ctx.causal, ctx.sm_scale)
        dq = _on(q, "dq")(*args)
        dk, dv = _on(q, "dkdv")(*args)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: float | None = None):
    """Tiled attention. q [B, Hq, S, D], k/v [B, Hkv, S, D] with Hq a
    multiple of Hkv; differentiable in q, k and v. CPU tensors run the
    kernels' plain versions, CUDA tensors the kernels ``flash_route``
    names for their dtype."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention takes q [B, Hq, S, D] and k, v "
                         f"[B, Hkv, S, D], not {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal, sm_scale)
