"""Paged-attention decode step over a read-only KV page pool.

The port of ``ray_tpu/ops/paged_attention.py``. The TPU kernel
(``_decode_kernel``) becomes CUDA C++ kernels written for Hopper, on two
routes chosen by dtype alone (``paged_route``):

  * bfloat16 (the serving path): ``csrc/paged_decode_split.cu``, the page
    walk of each (kv head, slot) split over several blocks
    (``paged_split_plan``) and combined in the same launch ("split");
  * float32: ``csrc/paged_decode.cu``, one block per (kv head, slot)
    ("single").

The wrapper ``paged_decode_attention`` keeps the JAX function's signature
and its three modes:

  * staging (the fused decode loop): the pool holds positions
    ``[0, pos - stage_idx)`` and the staging rows ``[0, stage_idx]`` of
    ``k_stage``/``v_stage`` [Ls, slots, KH, SC, D] hold the newer tokens,
    the last being the current one;
  * compat with ``k_cur``/``v_cur`` [slots, KH, D]: the pool holds
    ``[0, pos)`` and the current token rides a one-row staging buffer;
  * compat without them: the pool already holds ``pos``, and the current
    token is pulled back out of it.

Layouts are the JAX ones: q [slots, KH, G, D], pool [L, P, KH, page, D]
(a single-layer [P, KH, page, D] pool is promoted), block_tables
[slots, max_pages] int32, pos [slots] int32.

A tensor on the CPU takes the plain PyTorch version below, which walks the
same pages and rounds at the same places; a CUDA tensor launches the kernel
of its dtype's route or raises. The tensor-parallel split over KV heads
(``mesh``) is not in this package yet.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .._cuda import CudaKernel

NEG_INF = -1e30

# Staging rows are padded to a multiple of this, as in the JAX package, so
# the two sides allocate identical staging shapes.
_STAGE_TILE = 16

KERNEL_DIMS = (16, 32, 64, 128)
KERNEL_PAGES = (8, 16, 32, 64)
KERNEL_MAX_G = 16
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The split kernel's most splits per (kv head, slot), and the blocks per
# SM its plan aims at: enough copies in flight to keep the card's memory
# busy.
SPLIT_MAX = 32
SPLIT_BLOCKS_PER_SM = 4

_P = ctypes.c_void_p
_I = ctypes.c_int
paged_decode_kernel = CudaKernel(
    "paged_decode.cu", "paged_decode_attention_launch",
    [_P, _P, _P, _P, _P, _P, _P, _P,          # q, k/v pool, tables, base, k/v stage, out
     _I, _I, _I, _I, _I, _I, _I, _I, _I,      # slots kh g d page max_pages covered sc sl
     ctypes.c_float, _I, _P])                 # scale, dtype, stream
paged_decode_split_kernel = CudaKernel(
    "paged_decode_split.cu", "paged_decode_split_launch",
    # q, k/v pool, tables, base, k/v stage, out, workspace, tickets;
    # slots kh g d page max_pages covered sc sl n_split per; scale, dtype,
    # stream
    [_P] * 10 + [_I] * 11 + [ctypes.c_float, _I, _P])


def paged_route(dtype: torch.dtype) -> str:
    """Which kernel ``paged_decode_attention`` launches on a CUDA tensor of
    ``dtype``: ``"split"`` (bf16, ``csrc/paged_decode_split.cu``) or
    ``"single"`` (float32, ``csrc/paged_decode.cu``). Decided by dtype
    alone; raises TypeError for a dtype no kernel takes."""
    if dtype == torch.bfloat16:
        return "split"
    if dtype == torch.float32:
        return "single"
    raise TypeError(f"paged decode kernels take float32 or bfloat16, not "
                    f"{dtype}")


def paged_split_plan(slots: int, kh: int, covered: int,
                     num_sms: int) -> tuple[int, int]:
    """``(n_split, pages_per_split)`` for the split kernel, from host
    integers only (the context lengths live on the device and are never
    read here). Split ``s`` of a (kv head, slot) walks the pool pages
    ``[s * per, min((s + 1) * per, n_live))``, where ``n_live =
    min(ceil(base / page), covered)`` is the slot's own, so a split may
    find no live page; the last split also folds the staging rows. Aims
    at ``SPLIT_BLOCKS_PER_SM`` blocks on each SM, at most ``SPLIT_MAX``
    splits and at least one page a split."""
    want = -(-SPLIT_BLOCKS_PER_SM * num_sms // max(slots * kh, 1))
    n_split = max(1, min(want, covered, SPLIT_MAX))
    per = -(-covered // n_split)
    if per:
        n_split = -(-covered // per)     # no split past the covered pages
    return n_split, per


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# Per device, the split kernel's tickets: one int32 per (kv head, slot),
# zeroed once here and reset to 0 by the kernel's last split. Launches
# that share them run in order on one stream.
_TICKETS: dict = {}


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    t = _TICKETS.get(device.index)
    if t is None or t.numel() < n:
        t = _TICKETS[device.index] = torch.zeros(n, dtype=torch.int32,
                                                 device=device)
    return t


def stage_rows(n_steps: int) -> int:
    """Padded staging-row count for an ``n_steps``-deep fused dispatch."""
    return max(_STAGE_TILE, -(-n_steps // _STAGE_TILE) * _STAGE_TILE)


def paged_decode_plain(q, k_pool, v_pool, block_tables, base, k_stage,
                       v_stage, sl: int, page_size: int, covered: int):
    """The kernel's arithmetic in plain PyTorch, for one layer.

    k/v_pool: [P, KH, page, D]; k/v_stage: [slots, KH, SC, D]; base:
    [slots] (the pool holds [0, base)). Reads the pages
    ``[0, min(ceil(base / page), covered))`` of each slot (by gathering the
    first ``covered`` table entries and masking positions ``>= base``),
    then the staging rows ``[0, sl]``. Scores, the softmax statistics and
    the accumulation are f32; probabilities are rounded to the V dtype
    before the PV product, as in the kernel.
    """
    n, kh, g, d = q.shape
    bt = block_tables[:, :covered].long()
    ck = k_pool[bt].transpose(1, 2).reshape(n, kh, covered * page_size, d)
    cv = v_pool[bt].transpose(1, 2).reshape(n, kh, covered * page_size, d)
    keys = torch.cat([ck, k_stage[:, :, :sl + 1]], dim=2)
    vals = torch.cat([cv, v_stage[:, :, :sl + 1]], dim=2)
    t_pos = torch.arange(covered * page_size, device=q.device)
    live = torch.cat([t_pos[None, :] < base[:, None].long(),
                      torch.ones(n, sl + 1, dtype=torch.bool,
                                 device=q.device)], dim=1)      # [n, T]
    s = torch.einsum("nkgd,nktd->nkgt", q.float(), keys.float()) * d ** -0.5
    s = torch.where(live[:, None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    lsum = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("nkgt,nktd->nkgd", p.to(vals.dtype).float(),
                       vals.float())
    return (acc / lsum).to(q.dtype)


def _check_kernel_inputs(q, k_pool, v_pool, block_tables, base, k_stage,
                         v_stage, sl: int, page_size: int) -> None:
    n, kh, g, d = q.shape
    dev = q.device
    for name, t in (("k_pages", k_pool), ("v_pages", v_pool),
                    ("block_tables", block_tables), ("pos", base),
                    ("k_stage", k_stage), ("v_stage", v_stage)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"paged decode kernel takes float32 or bfloat16, "
                        f"not {q.dtype}")
    for name, t in (("k_pages", k_pool), ("v_pages", v_pool),
                    ("k_stage", k_stage), ("v_stage", v_stage)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if block_tables.dtype != torch.int32 or base.dtype != torch.int32:
        raise TypeError("block_tables and pos must be int32")
    if d not in KERNEL_DIMS:
        raise ValueError(f"head_dim {d} not in {KERNEL_DIMS}")
    if page_size not in KERNEL_PAGES:
        raise ValueError(f"page_size {page_size} not in {KERNEL_PAGES}")
    if g > KERNEL_MAX_G:
        raise ValueError(f"{g} q heads per kv head > {KERNEL_MAX_G}")
    if k_pool.shape[1:] != (kh, page_size, d) or v_pool.shape != k_pool.shape:
        raise ValueError(f"pool shape {tuple(k_pool.shape)} does not match "
                         f"[P, {kh}, {page_size}, {d}]")
    if (k_stage.shape[:2] != (n, kh) or k_stage.shape[3] != d
            or v_stage.shape != k_stage.shape):
        raise ValueError(f"staging shape {tuple(k_stage.shape)} does not "
                         f"match [{n}, {kh}, SC, {d}]")
    if not 0 <= sl < k_stage.shape[2]:
        raise ValueError(f"stage_idx {sl} outside [0, {k_stage.shape[2]})")
    if block_tables.dim() != 2 or block_tables.shape[0] != n \
            or base.shape != (n,):
        raise ValueError("block_tables must be [slots, max_pages] and pos "
                         "[slots]")
    for name, t in (("q", q), ("k_pages", k_pool), ("v_pages", v_pool),
                    ("block_tables", block_tables), ("pos", base),
                    ("k_stage", k_stage), ("v_stage", v_stage)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_decode_cuda(q, k_pool, v_pool, block_tables, base, k_stage,
                      v_stage, sl: int, page_size: int, covered: int):
    """Launch the one-block-per-(kv head, slot) kernel ("single", float32
    or bfloat16) for one layer (arguments as for ``paged_decode_plain``)
    on the current stream. Raises on any input the kernel does not take,
    and if the launch is refused."""
    _check_kernel_inputs(q, k_pool, v_pool, block_tables, base, k_stage,
                         v_stage, sl, page_size)
    n, kh, g, d = q.shape
    out = torch.empty_like(q)
    fn = paged_decode_kernel.fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                block_tables.data_ptr(), base.data_ptr(), k_stage.data_ptr(),
                v_stage.data_ptr(), out.data_ptr(), n, kh, g, d, page_size,
                block_tables.shape[1], covered, k_stage.shape[2], sl,
                d ** -0.5, _KERNEL_DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged decode kernel launch failed (code {rc})")
    paged_decode_kernel.launches += 1
    return out


def paged_decode_split_cuda(q, k_pool, v_pool, block_tables, base, k_stage,
                            v_stage, sl: int, page_size: int, covered: int):
    """Launch the split-K kernel ("split", bfloat16 CUDA tensors only) for
    one layer (arguments as for ``paged_decode_plain``) on the current
    stream. Raises on any input the kernel does not take, before anything
    is built, and if the launch is refused."""
    _check_kernel_inputs(q, k_pool, v_pool, block_tables, base, k_stage,
                         v_stage, sl, page_size)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the split paged decode kernel takes bfloat16, not "
                        f"{q.dtype}")
    if q.device.type != "cuda":
        raise ValueError(f"the split paged decode kernel takes CUDA tensors, "
                         f"not {q.device}")
    n, kh, g, d = q.shape
    if not 0 <= covered <= block_tables.shape[1]:
        raise ValueError(f"covered {covered} outside [0, "
                         f"{block_tables.shape[1]}]")
    n_split, per = paged_split_plan(n, kh, covered,
                                    _num_sms(q.device.index))
    out = torch.empty_like(q)
    ws = torch.empty(n * kh * n_split * g * (d + 2), dtype=torch.float32,
                     device=q.device)
    tickets = _tickets(q.device, n * kh)
    fn = paged_decode_split_kernel.fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                block_tables.data_ptr(), base.data_ptr(), k_stage.data_ptr(),
                v_stage.data_ptr(), out.data_ptr(), ws.data_ptr(),
                tickets.data_ptr(), n, kh, g, d, page_size,
                block_tables.shape[1], covered, k_stage.shape[2], sl,
                n_split, per, d ** -0.5, _KERNEL_DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"split paged decode kernel launch failed "
                           f"(code {rc})")
    paged_decode_split_kernel.launches += 1
    return out


_CUDA = {"single": paged_decode_cuda, "split": paged_decode_split_cuda}


def paged_decode_layer_args(
    q,
    k_pages,
    v_pages,
    block_tables,
    pos,
    k_cur=None,
    v_cur=None,
    *,
    page_size: int,
    live_pages: int | None = None,
    layer: int | None = None,
    k_stage=None,
    v_stage=None,
    stage_idx: int | None = None,
) -> tuple:
    """Reduce a ``paged_decode_attention`` call to the per-layer arguments
    that the kernel and its plain version take:
    ``(q, k_pool, v_pool, block_tables, base, k_stage, v_stage, sl,
    page_size, covered)``."""
    if k_pages.dim() == 4:
        k_pages, v_pages = k_pages[None], v_pages[None]
    layer = 0 if layer is None else int(layer)
    n, kh, g, d = q.shape
    max_pages = block_tables.shape[1]
    if k_stage is not None:
        if k_cur is not None or stage_idx is None:
            raise ValueError("staging mode takes k_stage/v_stage/stage_idx "
                             "and no k_cur/v_cur")
        sl = int(stage_idx)
        base = pos - sl
    else:
        # Compat: a one-row staging buffer holding the current token at
        # position ``pos``; the pool side masks strictly below it.
        base = pos
        sl = 0
        if k_cur is None:
            # The pool already holds ``pos``: pull the token back out.
            wp = block_tables.long().gather(
                1, torch.clamp(pos.long() // page_size,
                               max=max_pages - 1)[:, None])[:, 0]
            off = pos.long() % page_size
            k_cur = k_pages[layer, wp, :, off]             # [slots, KH, D]
            v_cur = v_pages[layer, wp, :, off]
        k_stage = torch.zeros((1, n, kh, _STAGE_TILE, d), dtype=k_pages.dtype,
                              device=q.device)
        v_stage = torch.zeros_like(k_stage)
        k_stage[0, :, :, 0] = k_cur.to(k_pages.dtype)
        v_stage[0, :, :, 0] = v_cur.to(v_pages.dtype)
    # Per-layer staging (Ls == 1) serves every layer.
    stage_layer = min(layer, k_stage.shape[0] - 1)
    covered = max_pages if live_pages is None else min(live_pages, max_pages)
    return (q, k_pages[layer], v_pages[layer], block_tables, base,
            k_stage[stage_layer], v_stage[stage_layer], sl, page_size,
            covered)


def paged_decode_attention(q, k_pages, v_pages, block_tables, pos,
                           k_cur=None, v_cur=None, *, page_size: int,
                           live_pages: int | None = None,
                           layer: int | None = None, k_stage=None,
                           v_stage=None, stage_idx: int | None = None,
                           mesh=None):
    """One decode step of attention over a read-only paged KV pool.

    q [slots, KH, G, D]; k/v_pages [L, P, KH, page, D] with ``layer`` the
    layer index (or one layer [P, KH, page, D]); block_tables
    [slots, max_pages] int32; pos [slots] int32 — attend over [0, pos].
    ``live_pages`` caps the pool pages read per slot. Staging and compat
    modes as in the module docstring; ``Ls == 1`` staging serves every
    layer. The pool is never written. Returns [slots, KH, G, D] in q.dtype.
    """
    if mesh is not None:
        raise NotImplementedError(
            "paged_decode_attention over a mesh (tp split over KV heads) is "
            "not ported yet")
    args = paged_decode_layer_args(
        q, k_pages, v_pages, block_tables, pos, k_cur, v_cur,
        page_size=page_size, live_pages=live_pages, layer=layer,
        k_stage=k_stage, v_stage=v_stage, stage_idx=stage_idx)
    if q.device.type == "cpu":
        return paged_decode_plain(*args)
    if q.device.type == "cuda":
        return _CUDA[paged_route(q.dtype)](*args)
    raise ValueError(f"no paged decode path for device {q.device}")
