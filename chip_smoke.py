"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing JSON lines:

  card          the card's name and power limit (nvidia-smi) and torch's name;
  build         builds every CUDA source in ``ray_tpu_torch/csrc`` (one nvcc
                per source, all started together, seven sources): seconds,
                registers and spills for each;
  kernel        the paged decode kernels against their plain PyTorch version
                on the card, at llama3-1b shapes (uniform and skewed batches,
                staging rows 0/5/31, both compat modes, pos 0), at head_dim
                128, 16 and 32 with pages of 64, 8 and 16, with more splits
                than live pages, with a 128-page table, and at the
                speculative verify's calls (page 16, 16 staging rows, row j
                = 0..6 at pos + j, uniform and skewed): the split kernel
                (the bf16 route, ``paged_route``) in bf16, the single kernel
                (one block per (kv head, slot), the f32 route) in bf16 and
                f32;
  time          the split kernel, the single kernel it replaces on bf16
                (``previous_ms``; the split kernel must take at most half of
                it on the uniform batch and no more on the skewed one), the
                plain version and one PyTorch call computing the same
                function (scaled_dot_product_attention over pre-gathered
                K/V, a yardstick only) at the two llama3-1b batches, beside
                the least time the card could take;
  flash_kernel  the flash-attention kernels of each dtype's route
                (``flash_route``: bf16 takes the sm90 forward, dQ and dK/dV,
                f32 the simt kernels) against their plain versions:
                llama3-1b shapes (causal at bench.py's 8 x 2048, non-causal,
                f32), and in bf16 every head_dim 16/32/64/128 with GQA
                groups 1 and 4, S 1/100/257/1000, causal and not; at the
                main shape the simt kernels on bf16 too;
  flash_time    each flash kernel at [8, 32, 2048, 64] / [8, 8, 2048, 64]
                bf16, causal, beside its plain version, its bound and SDPA
                (forward, and its backward for dQ and dK/dV; a yardstick
                only, over K/V repeated to the q heads beforehand); each
                sm90 kernel also beside the simt kernel it replaces on bf16
                (``previous_ms``), which it must beat 4x;
  lm_head_grad  one loss chunk's bf16 lm_head backward at llama3-1b widths:
                its two float32 products (g kept at f32 as two bf16 terms)
                within 1e-4 of float64 products, the parent's g rounded to
                bf16 seen to miss, and both timed;
  train         the training main path: llama3-1b with random weights,
                batch 8 x 2048, remat "attn", chunked loss, autograd and an
                SGD update, 2 warm-up and 5 timed steps on one repeated
                batch, with each flash kernel's launch count read around
                the run (16 a step each for the sm90 forward, dQ and dK/dV,
                0 for the simt kernels), then the step time with the
                lm_head fix against the parent's arithmetic, in turns;
  train_profile one more step under torch.profiler: the card's idle share
                and where its time goes, per flash kernel;
  train_parity  f32 loss and every gradient of the kernel path
                (attn_impl="flash", the simt kernels) equal the plain
                path's ("reference") at llama3-1b widths and 2 layers, with
                the launch counts read around it;
  serve         the serving main path: a llama3-1b ``InferenceEngine`` with
                random weights serves 8 greedy requests (chunked prefill,
                mixed dispatch, a prefix hit), with the paged kernels' launch
                counts read around the run (16 a decode step of the split
                kernel, 0 of the single one);
  profile       one more decode dispatch on that engine under torch.profiler:
                the card's idle share, kernels launched per step and the
                paged kernels' device time;
  parity        f32 greedy tokens of the paged engine (the single kernel)
                equal the dense engine's at llama3-1b widths and 2 layers;
  spec_parity   f32 greedy tokens of the speculative paged engine (K = 3,
                page 16) equal the plain paged engine's at llama3-1b widths
                and 2 layers, with an oracle, an always-wrong and the n-gram
                drafter and a COW-forked shared prefix, with the single
                kernel's launches read around each run (2 x 4 a verify);
  speculate     ray_tpu/_speculative_bench.py's traffic on llama3-1b at full
                width, bf16: 8 period-6 prompts of 512 tokens, 96 new tokens,
                page 16, plain and with K = 6 (n-gram and oracle drafters):
                tokens per second, acceptance, split-kernel launches (16 x 7
                a verify call, read around each run), how many requests
                match plain, and one verify call under torch.profiler.

Then a JSON line of the kernels, the card's ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``. Any failed check raises
and the script exits non-zero without that last line. It needs CUDA and
the repository checkout beside it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ray_tpu_torch.llm import (Drafter, InferenceEngine, LocalEngineExecutor,
                               Request, resolve_device)
from ray_tpu_torch.models import llama as llama_model
from ray_tpu_torch.models.llama import (PRESETS, init_params,
                                        lm_head_grads_f32, loss_fn,
                                        train_flops_per_token)
from ray_tpu_torch.ops.attention import (flash_dkdv_cuda, flash_dkdv_kernel,
                                         flash_dkdv_plain,
                                         flash_dkdv_sm90_cuda,
                                         flash_dkdv_sm90_kernel, flash_dq_cuda,
                                         flash_dq_kernel, flash_dq_plain,
                                         flash_dq_sm90_cuda,
                                         flash_dq_sm90_kernel,
                                         flash_forward_cuda,
                                         flash_forward_plain,
                                         flash_forward_sm90_cuda,
                                         flash_fwd_kernel,
                                         flash_fwd_sm90_kernel, flash_route)
from ray_tpu_torch.ops.paged_attention import (paged_decode_cuda,
                                               paged_decode_kernel,
                                               paged_decode_layer_args,
                                               paged_decode_plain,
                                               paged_decode_split_cuda,
                                               paged_decode_split_kernel,
                                               paged_route, stage_rows)

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
L2_BYTES = 50 * 2 ** 20
# About 0.5 ms at the H100's 1.98 GHz: longer than any timed call's host
# enqueue.
GPU_SPIN_CYCLES = 1_000_000
DEVICE = "cuda"

# llama3-1b engine geometry as the serving benchmark runs it.
SLOTS, MAX_LEN, PAGE, CHUNK, STEPS = 8, 2560, 64, 256, 32
# The speculative bench's geometry (ray_tpu/_speculative_bench.py): K = 6
# drafts, page 16, 96 new tokens, with 512-token prompts (its CPU default
# is 48), so max_len = ceil((512 + 96 + 16) / 16) * 16.
SPEC_K, SPEC_PAGE, SPEC_NEW, SPEC_PROMPT = 6, 16, 96, 512
SPEC_MAX_LEN = -(-(SPEC_PROMPT + SPEC_NEW + SPEC_PAGE) // SPEC_PAGE) * SPEC_PAGE


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ kernel
@dataclasses.dataclass
class Case:
    name: str
    ctx: list            # context length (pos) per slot
    kh: int = 8
    g: int = 4
    d: int = 64
    page: int = PAGE
    max_pages: int = MAX_LEN // PAGE
    mode: str = "stage"  # "stage" | "k_cur" | "pull_back"
    stage_idx: int = 0
    stage_layers: int = 2
    live_pages: int | None = None   # default: the longest context's pages
    stage_rows: int = stage_rows(STEPS)


def make_inputs(case: Case, dtype, seed: int = 0) -> tuple:
    """Random pool/queries for ``case`` on the card, layer 1 of a 2-layer
    pool, distinct pages per slot; returns the kernel's per-layer args."""
    rng = np.random.default_rng(seed)
    n = len(case.ctx)
    num_pages = n + n * case.max_pages
    dev = DEVICE

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            device=dev, dtype=dtype)

    pool_shape = (2, num_pages, case.kh, case.page, case.d)
    k_pages, v_pages = randn(*pool_shape), randn(*pool_shape)
    perm = rng.permutation(np.arange(n, num_pages)).astype(np.int32)
    tables = torch.from_numpy(perm.reshape(n, case.max_pages)).to(dev)
    pos = torch.tensor(case.ctx, dtype=torch.int32, device=dev)
    q = randn(n, case.kh, case.g, case.d)
    kw = {"page_size": case.page, "layer": 1,
          "live_pages": case.live_pages or max(
              1, -(-(max(case.ctx) - case.stage_idx) // case.page))}
    if case.mode == "stage":
        shape = (case.stage_layers, n, case.kh, case.stage_rows, case.d)
        kw.update(k_stage=randn(*shape), v_stage=randn(*shape),
                  stage_idx=case.stage_idx)
        return paged_decode_layer_args(q, k_pages, v_pages, tables, pos, **kw)
    if case.mode == "k_cur":
        return paged_decode_layer_args(
            q, k_pages, v_pages, tables, pos, randn(n, case.kh, case.d),
            randn(n, case.kh, case.d), **kw)
    kw["live_pages"] = case.max_pages
    return paged_decode_layer_args(q, k_pages, v_pages, tables, pos, **kw)


def kernel_cases() -> list:
    uniform = [2048] * SLOTS
    skewed = [2432] + [256] * 7
    cases = []
    for batch, ctx in (("uniform", uniform), ("skewed", skewed)):
        for si in (0, 5, 31):
            cases.append(Case(f"{batch}_stage{si}", ctx, stage_idx=si))
    cases += [
        Case("uniform_stage5_per_layer_staging", uniform, stage_idx=5,
             stage_layers=1),
        Case("skewed_compat_k_cur", skewed, mode="k_cur"),
        Case("skewed_compat_pull_back", skewed, mode="pull_back"),
        Case("pos0", [0] * SLOTS, stage_idx=0),
        Case("d128_page64", [1000, 64, 1, 700], d=128),
        Case("d16_page8_g2", [100, 8, 0, 57], kh=2, g=2, d=16, page=8,
             max_pages=32),
        Case("d32_page16_g2", [300, 16, 33, 1], kh=2, g=2, d=32, page=16,
             max_pages=32),
        # 64 covered pages in splits of 4 (16 splits on 132 SMs), the
        # longest slot holding 13: every slot leaves splits with no live
        # page, and one slot has none at all
        Case("covered_past_live_pages", [100, 30, 3, 64], page=8,
             max_pages=64, live_pages=64, stage_idx=3),
        Case("max_pages128_page16", [2000, 1000, 47, 31], page=16,
             max_pages=128, stage_idx=31),
    ]
    # The speculative verify's calls at the `speculate` phase's geometry:
    # position j of a K = 6 draft runs with pos + j and staging row j of
    # 16, so the pool side reads [0, pos) (partly filled last pages) and
    # live_pages is the executor's bucket of ceil(max(pos) / page).
    for batch, pos in (("uniform", [519, 530, 601, 512, 555, 560, 577, 590]),
                       ("skewed", [600, 17, 3, 0, 40, 5, 300, 2])):
        for j in range(SPEC_K + 1):
            cases.append(Case(
                f"verify_{batch}_j{j}", [p + j for p in pos], page=SPEC_PAGE,
                max_pages=SPEC_MAX_LEN // SPEC_PAGE, stage_idx=j,
                stage_rows=stage_rows(SPEC_K + 1),
                live_pages=LocalEngineExecutor._bucket_pages(
                    -(-max(pos) // SPEC_PAGE), SPEC_MAX_LEN // SPEC_PAGE)))
    return cases


@dataclasses.dataclass(frozen=True)
class PagedKernel:
    variant: str     # "split" (bf16 route) | "single" (f32 route)
    kernel: object   # its CudaKernel (library, entry point, launch count)
    cuda: object     # its wrapper
    source: str


PAGED_KERNELS = {
    "paged_decode_attention_split": PagedKernel(
        "split", paged_decode_split_kernel, paged_decode_split_cuda,
        "paged_decode_split.cu"),
    "paged_decode_attention_single": PagedKernel(
        "single", paged_decode_kernel, paged_decode_cuda, "paged_decode.cu"),
}


def paged_kernel_of(dtype) -> str:
    """The name of the kernel ``paged_decode_attention`` launches on a
    CUDA tensor of ``dtype``."""
    return next(n for n, pk in PAGED_KERNELS.items()
                if pk.variant == paged_route(dtype))


def paged_launches() -> dict:
    return {name: pk.kernel.launches for name, pk in PAGED_KERNELS.items()}


def reset_paged_launches() -> None:
    for pk in PAGED_KERNELS.values():
        pk.kernel.launches = 0


def phase_kernel() -> tuple[dict, dict]:
    """Every case through the kernel of each dtype's route, and the single
    kernel on bf16 too; returns each kernel's largest bf16 error at the
    llama3-1b shapes (the main path's), and over the verify's cases."""
    worst_main = {name: 0.0 for name in PAGED_KERNELS}
    worst_verify = dict(worst_main)
    for case in kernel_cases():
        for dtype in (torch.bfloat16, torch.float32):
            args = make_inputs(case, dtype)
            want = paged_decode_plain(*args)
            names = (list(PAGED_KERNELS) if dtype is torch.bfloat16
                     else [paged_kernel_of(dtype)])
            for name in names:
                got = PAGED_KERNELS[name].cuda(*args)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                tol = TOLERANCE[dtype]
                emit("kernel", case=case.name, kernel=name,
                     dtype=str(dtype).split(".")[-1], max_abs_err=err,
                     tolerance=tol)
                if not err <= tol:
                    raise AssertionError(f"kernel case {case.name} {name} "
                                         f"{dtype}: max abs error {err} > "
                                         f"{tol}")
                if dtype is torch.bfloat16 and case.d == 64:
                    worst_main[name] = max(worst_main[name], err)
                if dtype is torch.bfloat16 and case.name.startswith("verify"):
                    worst_verify[name] = max(worst_verify[name], err)
    return worst_main, worst_verify


def _time_ms(fn, iters: int = 30) -> float:
    """Median CUDA-event time of ``fn`` with the L2 cache flushed before
    each call (each decode layer reads a different layer's pages). The
    card spins (``GPU_SPIN_CYCLES``) between the flush and the start
    event, so the host has enqueued ``fn``'s kernels before the window
    opens: the time is the device's, without the wrapper's host time
    (40-60 us for a paged decode call, as much as its kernel)."""
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=DEVICE)
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(GPU_SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _host_ms(fn, calls: int = 200) -> float:
    """Host time of one call of ``fn`` (checks, allocation, enqueue), over
    ``calls`` calls that the card runs behind the host."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e3


def _bound(args) -> tuple[float, str]:
    """Least time on the card: each input byte read once, the output
    written once, against HBM bandwidth; the flops against the dtype's
    peak. Counts what this data needs: live pool rows and staged rows."""
    q, k_pool, _, tables, base, k_stage, _, sl, page, covered = args
    n, kh, g, d = q.shape
    el = q.element_size()
    pool_rows = int(torch.clamp(base.long(), max=covered * page).sum())
    rows = pool_rows + n * (sl + 1)
    pages = int(torch.clamp(-(-base.long() // page), max=covered).sum())
    nbytes = (2 * rows * kh * d * el + 2 * q.numel() * el + pages * 4
              + base.numel() * 4)
    flops = 4 * rows * kh * g * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _library_call(args):
    """scaled_dot_product_attention over K/V gathered beforehand (pool
    rows padded to the longest context, then the staged rows)."""
    q, k_pool, v_pool, tables, base, k_stage, v_stage, sl, page, covered = args
    n, kh, g, d = q.shape
    bt = tables[:, :covered].long()
    k = torch.cat([k_pool[bt].transpose(1, 2).reshape(n, kh, -1, d),
                   k_stage[:, :, :sl + 1]], dim=2).contiguous()
    v = torch.cat([v_pool[bt].transpose(1, 2).reshape(n, kh, -1, d),
                   v_stage[:, :, :sl + 1]], dim=2).contiguous()
    t = torch.arange(covered * page, device=q.device)
    mask = torch.cat([t[None] < base[:, None].long(),
                      torch.ones(n, sl + 1, dtype=torch.bool,
                                 device=q.device)], dim=1)[:, None, None]
    qh = q.reshape(n, kh * g, 1, d)
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)

    def call():
        return torch.nn.functional.scaled_dot_product_attention(
            qh, k, v, attn_mask=mask)
    return call


def phase_time() -> dict:
    """Both paged kernels in bf16 at the two llama3-1b batches, per batch
    and kernel name; the split kernel carries the single kernel as
    ``previous_ms`` and must take at most half of it on the uniform batch
    and no more than it on the skewed one."""
    out = {}
    split = paged_kernel_of(torch.bfloat16)
    single = paged_kernel_of(torch.float32)
    for batch, ctx in (("uniform", [2048] * SLOTS),
                       ("skewed", [2432] + [256] * 7)):
        args = make_inputs(Case(batch, ctx, stage_idx=16), torch.bfloat16)
        plain_ms = _time_ms(lambda: paged_decode_plain(*args))
        # in turns: split, single, single, split
        ms = {name: [] for name in PAGED_KERNELS}
        for name in (split, single, single, split):
            ms[name].append(_time_ms(lambda: PAGED_KERNELS[name].cuda(*args)))
        library_ms = _time_ms(_library_call(args))
        bound_ms, bound_by = _bound(args)
        out[batch] = {}
        for name, pk in PAGED_KERNELS.items():
            out[batch][name] = {"ms": float(np.median(ms[name])),
                                "plain_ms": plain_ms, "bound_ms": bound_ms,
                                "bound_by": bound_by, "library_ms": library_ms,
                                "host_ms": _host_ms(lambda: pk.cuda(*args))}
        out[batch][split]["previous_ms"] = out[batch][single]["ms"]
        for name, t in out[batch].items():
            emit("time", batch=batch, kernel=name, stage_idx=16,
                 dtype="bfloat16", runs_ms=ms[name], **t)
    slow = {batch: out[batch][split] for batch, limit in
            (("uniform", 0.5), ("skewed", 1.0))
            if not out[batch][split]["ms"]
            <= limit * out[batch][split]["previous_ms"]}
    if slow:
        raise AssertionError(f"split paged kernel not fast enough against "
                             f"the single kernel: {slow}")
    return out


# ------------------------------------------------------------------- flash
# llama3-1b's attention at bench.py's batch: q [8, 32, 2048, 64], k/v
# [8, 8, 2048, 64].
FLASH_MAIN = (8, 32, 8, 2048, 64)
# dQ/dK/dV: relative to the largest magnitude of the plain version's result
# (one bf16 rounding of dS or P that may fall the other way on either side,
# then the output's rounding).
FLASH_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOL = 1e-4


@dataclasses.dataclass(frozen=True)
class FlashKernel:
    step: str        # "fwd" | "dq" | "dkdv"
    variant: str     # "sm90" (bf16 wgmma, TMA) | "simt" (float32 FMAs)
    kernel: object   # its CudaKernel (library, entry point, launch count)
    cuda: object     # its wrapper
    source: str
    tpu_line: int    # the TPU kernel's body in ray_tpu/ops/attention.py


FLASH_KERNELS = {
    "flash_attention_fwd_sm90": FlashKernel(
        "fwd", "sm90", flash_fwd_sm90_kernel, flash_forward_sm90_cuda,
        "flash_fwd_sm90.cu", 48),
    "flash_attention_fwd_simt": FlashKernel(
        "fwd", "simt", flash_fwd_kernel, flash_forward_cuda, "flash_fwd.cu", 48),
    "flash_attention_dq_sm90": FlashKernel(
        "dq", "sm90", flash_dq_sm90_kernel, flash_dq_sm90_cuda,
        "flash_dq_sm90.cu", 184),
    "flash_attention_dq_simt": FlashKernel(
        "dq", "simt", flash_dq_kernel, flash_dq_cuda, "flash_bwd.cu", 184),
    "flash_attention_dkdv_sm90": FlashKernel(
        "dkdv", "sm90", flash_dkdv_sm90_kernel, flash_dkdv_sm90_cuda,
        "flash_dkdv_sm90.cu", 226),
    "flash_attention_dkdv_simt": FlashKernel(
        "dkdv", "simt", flash_dkdv_kernel, flash_dkdv_cuda, "flash_bwd.cu", 226),
}


def flash_kernel_of(step: str, dtype) -> str:
    """The name of the kernel ``flash_attention`` launches for ``step`` on
    a CUDA tensor of ``dtype``."""
    variant = flash_route(dtype)[step]
    return next(n for n, fk in FLASH_KERNELS.items()
                if fk.step == step and fk.variant == variant)


def flash_launches() -> dict:
    return {name: fk.kernel.launches for name, fk in FLASH_KERNELS.items()}


def reset_flash_launches() -> None:
    for fk in FLASH_KERNELS.values():
        fk.kernel.launches = 0


def flash_inputs(b, hq, hkv, s, d, dtype, seed: int = 0) -> tuple:
    """q, k, v and an output cotangent dO, random normal, on the card."""
    g = torch.Generator(DEVICE).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=DEVICE).to(dtype)

    return (randn(b, hq, s, d), randn(b, hkv, s, d), randn(b, hkv, s, d),
            randn(b, hq, s, d))


def flash_cases() -> list:
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, (b, hq, hkv, s, d), causal, dtype
        ("llama3-1b_causal", FLASH_MAIN, True, bf16),
        ("llama3-1b_noncausal_b2", (2, 32, 8, 2048, 64), False, bf16),
        ("llama3-1b_causal_b1_s1024", (1, 32, 8, 1024, 64), True, f32),
        ("d16_rep1_odd_s257", (2, 4, 4, 257, 16), True, bf16),
        ("d16_rep1_odd_s257", (2, 4, 4, 257, 16), True, f32),
        ("d32_rep4_noncausal", (2, 8, 2, 512, 32), False, bf16),
        ("d32_rep4_noncausal", (2, 8, 2, 512, 32), False, f32),
        ("d128_rep4_s1000", (1, 32, 8, 1000, 128), True, bf16),
        ("d128_rep4_s1000", (1, 32, 8, 1000, 128), True, f32),
    ]
    # bf16 grid for the sm90 kernels: one key, a sub-tile S, an odd S and
    # a ragged multi-tile S at every head_dim and both GQA groups
    for d in (16, 32, 64, 128):
        for hq, hkv in ((4, 4), (8, 2)):
            for s in (1, 100, 257, 1000):
                for causal in (True, False):
                    cases.append((f"grid_d{d}_rep{hq // hkv}_s{s}"
                                  f"{'' if causal else '_noncausal'}",
                                  (2, hq, hkv, s, d), causal, bf16))
    return cases


def _errs(got, want) -> tuple[float, float]:
    """(max abs error, max abs error over the reference's max magnitude)."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def _grad_errs(got: dict, want: dict, sk: int) -> dict:
    """Each gradient in ``got``'s (max abs error, relative error) against
    ``want`` (the plain dq, dk and dv of the case). With one key
    (sk == 1) softmax has no gradient, so dQ and dK are exactly 0 and both
    the kernel's and the plain version's values are rounding noise (~1e-7
    beside a dV of ~3): there they are held to 0, relative to the largest
    plain gradient of the case."""
    errs = {g: _errs(got[g], want[g]) for g in got}
    if sk == 1:
        scale = max(t.float().abs().max().item() for t in want.values())
        for g in {"dq", "dk"} & got.keys():
            err = got[g].float().abs().max().item()
            errs[g] = (err, err / max(scale, 1e-30))
    return errs


def phase_flash_kernel() -> dict:
    """Every case, through the kernels of its dtype's route; returns the
    largest abs errors at the main case, per kernel (the simt forward and
    dK/dV are also held against the plain versions there, on bf16)."""
    main = {}
    for name, shape, causal, dtype in flash_cases():
        q, k, v, do = flash_inputs(*shape, dtype)
        kern = {step: flash_kernel_of(step, dtype)
                for step in ("fwd", "dq", "dkdv")}
        extra = ([n for n in FLASH_KERNELS if n not in kern.values()]
                 if shape == FLASH_MAIN else [])
        want_o, want_lse = flash_forward_plain(q, k, v, causal)
        # the backward kernels take the plain forward's lse and δ, so each
        # is held against its plain version on identical inputs
        delta = (do.float() * want_o.float()).sum(-1)
        args = (q, k, v, do, want_lse, delta, causal)
        want = {"dq": flash_dq_plain(*args)}
        want["dk"], want["dv"] = flash_dkdv_plain(*args)
        errs = {}
        for kname in [*kern.values(), *extra]:
            fk = FLASH_KERNELS[kname]
            if fk.step == "fwd":
                o, lse = fk.cuda(q, k, v, causal)
                torch.cuda.synchronize()
                errs[kname] = {"o": _errs(o, want_o),
                               "lse": _errs(lse, want_lse)}
            elif fk.step == "dq":
                got = {"dq": fk.cuda(*args)}
                torch.cuda.synchronize()
                errs[kname] = _grad_errs(got, want, shape[3])
            else:
                got = dict(zip(("dk", "dv"), fk.cuda(*args)))
                torch.cuda.synchronize()
                errs[kname] = _grad_errs(got, want, shape[3])
        # the plain results' largest magnitudes: an error of 0 (the same
        # sums in the same order) is not an all-zero result
        ref_max = {g: t.float().abs().max().item() for g, t in want.items()}
        del q, k, v, do, want_o, want_lse, delta, args, want
        torch.cuda.empty_cache()
        tol_o, tol_g = TOLERANCE[dtype], FLASH_GRAD_TOL[dtype]
        flat = {f"{w}": e for kname in errs for w, e in errs[kname].items()
                if kname in kern.values()}
        emit("flash_kernel", case=name, shape=list(shape), causal=causal,
             dtype=str(dtype).split(".")[-1],
             kernels={s: FLASH_KERNELS[n].variant for s, n in kern.items()},
             o_max_abs_err=flat["o"][0], lse_max_abs_err=flat["lse"][0],
             **{f"{g}_max_abs_err": flat[g][0] for g in ("dq", "dk", "dv")},
             **{f"{g}_rel_err": flat[g][1] for g in ("dq", "dk", "dv")},
             **{f"{g}_plain_max_abs": m for g, m in ref_max.items()},
             also_checked={n: {w: e[0] for w, e in errs[n].items()}
                           for n in extra},
             o_tolerance=tol_o, lse_tolerance=LSE_TOL, grad_rel_tolerance=tol_g)
        bad = []
        for kname, e in errs.items():
            bad += [f"{kname}:{g}" for g in ("dq", "dk", "dv")
                    if g in e and not e[g][1] <= tol_g]
            if "o" in e and not e["o"][0] <= tol_o:
                bad.append(f"{kname}:o")
            if "lse" in e and not e["lse"][0] <= LSE_TOL:
                bad.append(f"{kname}:lse")
        if bad:
            raise AssertionError(f"flash case {name} {dtype}: {bad} out of "
                                 f"tolerance: {errs}")
        if shape == FLASH_MAIN:
            main = {n: max(err[0] for w, err in e.items() if w != "lse")
                    for n, e in errs.items()}
    return main


def _flash_bound(kind: str, b, hq, hkv, s, d, el: int) -> tuple[float, str]:
    """Least time on the card: causal flops (half of each S x S product)
    over the bf16 peak, or each input read once and each output written
    once over HBM bandwidth, whichever is larger."""
    products = {"fwd": 2, "dq": 3, "dkdv": 4}[kind]
    flops = products * 2 * b * hq * s * s * d / 2
    q_bytes, kv_bytes, stat_bytes = b * hq * s * d * el, b * hkv * s * d * el, \
        b * hq * s * 4
    nbytes = {"fwd": 2 * q_bytes + 2 * kv_bytes + stat_bytes,
              "dq": 3 * q_bytes + 2 * kv_bytes + 2 * stat_bytes,
              "dkdv": 2 * q_bytes + 4 * kv_bytes + 2 * stat_bytes}[kind]
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_flash_time() -> dict:
    """Every flash kernel at the main shape in bf16, per kernel name; the
    kernels of the bf16 route (``flash_route``) carry the simt kernel they
    replace as ``previous_ms``, and must be at least 4x faster than it."""
    b, hq, hkv, s, d = FLASH_MAIN
    q, k, v, do = flash_inputs(*FLASH_MAIN, torch.bfloat16, seed=1)
    o, lse = flash_forward_sm90_cuda(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True)
    # the yardstick: SDPA over K/V repeated to the q heads beforehand
    kr = k.repeat_interleave(hq // hkv, dim=1)
    vr = v.repeat_interleave(hq // hkv, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, kr, vr))
    out = sdpa(qg, kg, vg, is_causal=True)
    library_fwd = _time_ms(lambda: sdpa(q, kr, vr, is_causal=True))
    library_bwd = _time_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True))
    step_args = {"fwd": (q, k, v, True), "dq": args, "dkdv": args}
    plain = {"fwd": flash_forward_plain, "dq": flash_dq_plain,
             "dkdv": flash_dkdv_plain}
    library = {"fwd": library_fwd, "dq": library_bwd, "dkdv": library_bwd}
    plain_ms = {step: _time_ms(lambda: fn(*step_args[step]), iters=5)
                for step, fn in plain.items()}
    ms = {name: _time_ms(lambda: fk.cuda(*step_args[fk.step]))
          for name, fk in FLASH_KERNELS.items()}
    out_times = {}
    for name, fk in FLASH_KERNELS.items():
        bound_ms, bound_by = _flash_bound(fk.step, b, hq, hkv, s, d, 2)
        out_times[name] = {"ms": ms[name], "plain_ms": plain_ms[fk.step],
                           "bound_ms": bound_ms, "bound_by": bound_by,
                           "library_ms": library[fk.step]}
        if fk.variant == "sm90":
            out_times[name]["previous_ms"] = ms[flash_kernel_of(
                fk.step, torch.float32)]
        emit("flash_time", kernel=name, variant=fk.variant,
             shape=[b, hq, hkv, s, d], causal=True, dtype="bfloat16",
             library_call="scaled_dot_product_attention"
             + (" forward" if fk.step == "fwd" else
                " backward (dQ, dK and dV together)"),
             **out_times[name])
    del q, k, v, do, o, lse, delta, args, step_args, kr, vr, qg, kg, vg, out
    torch.cuda.empty_cache()
    slow = {n: t for n, t in out_times.items()
            if "previous_ms" in t and not t["ms"] <= t["previous_ms"] / 4}
    if slow:
        raise AssertionError(f"sm90 kernels not 4x faster than the simt "
                             f"kernels they replace: {slow}")
    return out_times


# ------------------------------------------------------------------- train
TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARMUP, TRAIN_STEPS = 8, 2048, 2, 5
# Large enough that p - lr * g still moves bf16 weights (the lm_head and
# embedding gradients are ~1/(8 * 2048) per token) on the repeated batch.
TRAIN_LR = 2.0
TRAIN_CHUNK = 2048  # bench.py's chunk_tokens


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _sgd_step(params: dict, batch: dict, cfg, lr: float) -> torch.Tensor:
    """bench.py's step with SGD for Adafactor: loss, autograd over the
    param tree, p - lr * g."""
    loss = loss_fn(params, batch, cfg, chunk_tokens=TRAIN_CHUNK)
    loss.backward()
    with torch.no_grad():
        for p in _leaves(params):
            p.sub_(lr * p.grad)
            p.grad = None
    return loss.detach()


def phase_train(seed: int = 0) -> dict:
    """Returns each flash kernel's launch count over the trained steps:
    ``n_layers`` a step for the kernels ``flash_route`` names for bf16, 0
    for the others."""
    device = resolve_device(None)
    cfg = dataclasses.replace(PRESETS["llama3-1b"], remat_policy="attn")
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device).manual_seed(seed))
    for p in _leaves(params):
        p.requires_grad_()
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).to(device)
    batch = {"tokens": tokens}
    n_params = sum(p.numel() for p in _leaves(params))

    reset_flash_launches()
    losses, step_s = [], []
    for _ in range(TRAIN_WARMUP):
        losses.append(_sgd_step(params, batch, cfg, TRAIN_LR).item())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        t_step = time.perf_counter()
        losses.append(_sgd_step(params, batch, cfg, TRAIN_LR).item())
        step_s.append(time.perf_counter() - t_step)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = flash_launches()

    steps = TRAIN_WARMUP + TRAIN_STEPS
    on_route = {flash_kernel_of(step, cfg.dtype)
                for step in ("fwd", "dq", "dkdv")}
    expected = {name: cfg.n_layers * steps if name in on_route else 0
                for name in FLASH_KERNELS}
    tokens_per_sec = TRAIN_BATCH * TRAIN_SEQ * TRAIN_STEPS / dt
    flops_per_token = train_flops_per_token(cfg, TRAIN_SEQ)
    emit("train", preset="llama3-1b", optimizer="sgd", lr=TRAIN_LR,
         remat_policy=cfg.remat_policy, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         chunk_tokens=TRAIN_CHUNK, params=n_params, warmup_steps=TRAIN_WARMUP,
         timed_steps=TRAIN_STEPS, losses=losses, step_s=step_s,
         tokens_per_sec=tokens_per_sec, train_flops_per_token=flops_per_token,
         mfu=tokens_per_sec * flops_per_token / PEAK_FLOPS[torch.bfloat16],
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         kernel_launches=launches, expected_launches=expected,
         launches_per_step={n: c / steps for n, c in launches.items()})
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall on a repeated batch: {losses}")
    if launches != expected:
        raise AssertionError(f"flash launches {launches} != {expected} "
                             f"({cfg.n_layers} layers x {steps} steps on the "
                             f"{cfg.dtype} route)")
    profile_train_step(params, batch, cfg)
    time_lm_head_fix(params, batch, cfg)
    del params, batch
    torch.cuda.empty_cache()
    return launches


def _parent_lm_head_grads(g, h, w):
    """The bf16 lm_head backward's products before the fix: g rounded to
    bf16 for both, float32 results (the backward rounds dh to bf16 as the
    parent's bf16-output product did)."""
    g = g.to(h.dtype)
    return (torch.mm(g, w.t(), out_dtype=torch.float32),
            torch.mm(h.t(), g, out_dtype=torch.float32))


def time_lm_head_fix(params: dict, batch: dict, cfg, steps: int = 3) -> None:
    """Train step time with the lm_head backward's two-term products
    against the parent's rounded g, in turns (fix, parent, parent, fix),
    after the launch counts were read."""
    times = {"fix": [], "parent": []}
    for which in ("fix", "parent", "parent", "fix"):
        if which == "parent":
            llama_model.lm_head_grads_f32 = _parent_lm_head_grads
        try:
            for _ in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _sgd_step(params, batch, cfg, TRAIN_LR).item()
                times[which].append(time.perf_counter() - t0)
        finally:
            llama_model.lm_head_grads_f32 = lm_head_grads_f32
    fix, parent = (float(np.median(times[k])) for k in ("fix", "parent"))
    emit("train_lm_head_fix", what="llama3-1b train step, 8 x 2048, the "
         "lm_head backward with g kept at f32 (two bf16 terms) against the "
         "parent's g rounded to bf16", step_s_fix=times["fix"],
         step_s_parent=times["parent"], median_step_s_fix=fix,
         median_step_s_parent=parent, cost_ms=(fix - parent) * 1e3)


def phase_lm_head_grad(seed: int = 0) -> dict:
    """One loss chunk's lm_head backward at llama3-1b widths in bf16 (2048
    tokens, hidden 2048, vocab 128,256): the two float32 products of
    ``lm_head_grads_f32`` against float64 products of the float32 g with
    the exact bf16 h and w, within 1e-4 (relative Frobenius); the parent's
    g rounded to bf16 must miss by more than 1e-3, which shows the check
    sees the fault; the fix's dh with its reduction over V in one piece
    is shown beside. Times the fix and the parent's arithmetic."""
    cfg = PRESETS["llama3-1b"]
    c, e, v = TRAIN_CHUNK, cfg.hidden, cfg.vocab_size
    gen = torch.Generator(DEVICE).manual_seed(seed)
    g = torch.randn(c, v, generator=gen, device=DEVICE) * 1e-4
    h = torch.randn(c, e, generator=gen, device=DEVICE).bfloat16()
    w = (torch.randn(e, v, generator=gen, device=DEVICE) * e ** -0.5
         ).bfloat16()

    def unsplit(g, h, w):
        """The two-term products with dh's reduction over V in one piece."""
        g_hi = g.to(h.dtype)
        g_lo = (g - g_hi).to(h.dtype)
        dh = torch.mm(g_hi, w.t(), out_dtype=torch.float32)
        dh += torch.mm(g_lo, w.t(), out_dtype=torch.float32)
        return (dh,)

    g64 = g.double()
    want = {"dh": g64 @ w.double().t(), "dw": h.double().t() @ g64}
    errs = {}
    for name, fn in (("fix", lm_head_grads_f32),
                     ("parent", _parent_lm_head_grads),
                     ("unsplit", unsplit)):
        got = dict(zip(("dh", "dw"), fn(g, h, w)))
        errs[name] = {k: (torch.linalg.norm(got[k].double() - want[k])
                          / torch.linalg.norm(want[k])).item() for k in got}
        del got
    del g64, want
    torch.cuda.empty_cache()
    ms = {"fix": _time_ms(lambda: lm_head_grads_f32(g, h, w), iters=10),
          "parent": _time_ms(lambda: _parent_lm_head_grads(g, h, w),
                             iters=10)}
    emit("lm_head_grad", preset="llama3-1b", chunk_tokens=c, hidden=e,
         vocab=v, rel_frobenius_err_fix=errs["fix"],
         rel_frobenius_err_parent=errs["parent"],
         rel_frobenius_err_unsplit=errs["unsplit"],
         dh_reduction_piece=llama_model.LM_HEAD_MAX_K, tolerance=1e-4,
         ms_fix=ms["fix"], ms_parent=ms["parent"],
         chunks_per_train_step=TRAIN_BATCH * TRAIN_SEQ // c)
    if not max(errs["fix"].values()) <= 1e-4:
        raise AssertionError(f"lm_head backward: {errs['fix']} > 1e-4")
    if not min(errs["parent"].values()) > 1e-3:
        raise AssertionError(f"the parent's rounding is not seen: "
                             f"{errs['parent']}")
    del g, h, w
    torch.cuda.empty_cache()
    return {"errs": errs, "ms": ms}


# cuBLAS's matrix-product kernels, by name (the projections, MLP, lm_head)
GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma")


def _device_name(kernel) -> str:
    """What a kernel's device name holds: its C entry point's name with
    "_launch" replaced by "_kernel" (flash_fwd_sm90_kernel, ...). The
    single paged kernel's entry keeps its older name."""
    if kernel is paged_decode_kernel:
        return "paged_decode_kernel"
    return kernel.function.replace("_launch", "_kernel")


def profile_train_step(params: dict, batch: dict, cfg) -> None:
    """One more train step under torch.profiler, after the launch counts
    were read: wall time against the summed device time of its kernels
    gives the card's idle share; device time split into the flash
    kernels, matrix products and the rest, and the top kernels, show where
    the step goes."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _sgd_step(params, batch, cfg, TRAIN_LR).item()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
            n_kernels += 1
    busy_ms = sum(by_name.values()) / 1e3
    # Each kernel's device name holds its C entry point's name with
    # "_launch" replaced by "_kernel" (flash_fwd_sm90_kernel, ...).
    flash_ms = {name: sum(t for n, t in by_name.items()
                          if _device_name(fk.kernel) in n) / 1e3
                for name, fk in FLASH_KERNELS.items()}
    gemm_ms = sum(t for n, t in by_name.items()
                  if any(w in n for w in GEMM_NAMES)) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit("train_profile", what="one llama3-1b train step, 8 x 2048, "
         "remat attn, sgd", wall_ms=wall_ms,
         device_busy_ms=busy_ms if by_name else "not measured",
         device_idle_frac=1 - busy_ms / wall_ms if by_name else "not measured",
         kernels_launched=n_kernels, flash_kernel_ms=flash_ms,
         gemm_ms=gemm_ms,
         other_ms=busy_ms - gemm_ms - sum(flash_ms.values()),
         top_kernels_ms=[[n[:80], t / 1e3] for n, t in top])


def phase_train_parity(seed: int = 1) -> dict:
    """f32 loss and gradients, kernel path against the plain path, at
    llama3-1b widths, 2 layers, batch 2 x 256. Returns the flash kernels'
    launch counts over the kernel path's step (the f32 route's)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(PRESETS["llama3-1b"], n_layers=2,
                              dtype=torch.float32, remat_policy="attn")
    base = init_params(cfg, torch.Generator(DEVICE).manual_seed(seed))
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256))).to(
        DEVICE)
    out = {}
    for impl in ("flash", "reference"):
        params = {k: ({n: w.clone().requires_grad_() for n, w in v.items()}
                      if isinstance(v, dict) else v.clone().requires_grad_())
                  for k, v in base.items()}
        reset_flash_launches()
        loss = loss_fn(params, {"tokens": tokens},
                       dataclasses.replace(cfg, attn_impl=impl),
                       chunk_tokens=TRAIN_CHUNK)
        loss.backward()
        torch.cuda.synchronize()
        if impl == "flash":
            launches = flash_launches()
        grads = {k: v.grad for k, v in params.items() if k != "layers"}
        grads.update({f"layers/{n}": w.grad
                      for n, w in params["layers"].items()})
        out[impl] = (loss.item(), grads)
    (loss_k, g_k), (loss_r, g_r) = out["flash"], out["reference"]
    loss_err = abs(loss_k - loss_r) / abs(loss_r)
    grad_errs = {n: _errs(g_k[n], g_r[n])[1] for n in g_r}
    emit("train_parity", dtype="float32", layers=2, batch=[2, 256],
         loss_flash=loss_k, loss_reference=loss_r, loss_rel_err=loss_err,
         loss_tolerance=1e-5, grad_rel_err=grad_errs, grad_tolerance=1e-4,
         kernel_launches=launches)
    on_route = {flash_kernel_of(step, cfg.dtype)
                for step in ("fwd", "dq", "dkdv")}
    if any((n > 0) != (name in on_route) for name, n in launches.items()):
        raise AssertionError(f"f32 flash launches {launches}: expected only "
                             f"{sorted(on_route)}")
    if not loss_err <= 1e-5:
        raise AssertionError(f"train parity: loss {loss_k} vs {loss_r}")
    bad = {n: e for n, e in grad_errs.items() if not e <= 1e-4}
    if bad:
        raise AssertionError(f"train parity: gradients out of tolerance {bad}")
    del base, out
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------------- serve
def _submit(eng: InferenceEngine, prompts: dict,
            max_new_tokens: int) -> list:
    """Requests made (so stamped with their arrival) and added now."""
    reqs = [Request(name, p, max_new_tokens=max_new_tokens)
            for name, p in prompts.items()]
    for r in reqs:
        eng.add_request(r)
    return reqs


def _drain(eng: InferenceEngine, reqs: list) -> None:
    while any(not r.done for r in reqs):
        eng.step()


def phase_serve(seed: int = 0) -> dict:
    """Returns the paged kernels' launch counts over the served run:
    ``n_layers`` a decode step for the kernel ``paged_route`` names for
    bf16, 0 for the other."""
    cfg = PRESETS["llama3-1b"]
    rng = np.random.default_rng(seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = InferenceEngine(
        "llama3-1b", max_slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
        prefill_chunk_size=CHUNK, decode_steps_per_dispatch=STEPS,
        attention_impl="auto", seed=seed)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if eng.attention_impl != "paged":
        raise AssertionError(f"auto resolved to {eng.attention_impl}")

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    shared = prompt(2000)
    shorts = {f"short{i}": prompt(n)
              for i, n in enumerate((16, 40, 77, 120, 160, 200))}
    names = list(shorts)

    reset_paged_launches()
    t0 = time.monotonic()
    # Three requests arrive first; the rest arrive once those decode, so
    # their prompt chunks ride along with the decode bursts (mixed
    # dispatch). The second shared-prefix request arrives after the first
    # has retired, so the first one's prompt pages are in the cache.
    wave1 = _submit(eng, {k: shorts[k] for k in names[:3]}, 64)
    while any(r.first_token_at is None for r in wave1):
        eng.step()
    wave2 = _submit(eng, {**{k: shorts[k] for k in names[3:]},
                          "shared0": shared + prompt(24)}, 64)
    _drain(eng, wave1 + wave2)
    second = _submit(eng, {"shared1": shared + prompt(40)}, 64)
    _drain(eng, second)
    torch.cuda.synchronize()
    t_end = time.monotonic()
    launches = paged_launches()

    reqs = wave1 + wave2 + second
    m = eng.metrics
    for r in reqs:
        toks = np.asarray(r.generated)
        if len(toks) != 64 or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"{r.request_id}: bad output {r.generated}")
    if m["engine_step_mix"]["mixed"] <= 0:
        raise AssertionError(f"no mixed dispatch ran: {m['engine_step_mix']}")
    if m["prefix_hit_pages"] <= 0 or second[0].cached_prefix_tokens <= 0:
        raise AssertionError("no prefix hit")
    on_route = paged_kernel_of(cfg.dtype)
    expected = {name: cfg.n_layers * m["decode_steps"] if name == on_route
                else 0 for name in PAGED_KERNELS}
    if launches != expected or m["decode_steps"] == 0:
        raise AssertionError(f"paged kernel launches {launches} != "
                             f"{expected} ({cfg.n_layers} layers x "
                             f"{m['decode_steps']} decode steps)")
    ttft = [(r.first_token_at - r.arrived_at) * 1e3 for r in reqs]
    first_tok = min(r.first_token_at for r in reqs)
    n_tokens = sum(len(r.generated) for r in reqs)
    emit("serve", preset="llama3-1b", requests=len(reqs),
         output_tokens=n_tokens, wall_s=t_end - t0, setup_s=setup_s,
         ttft_p50_ms=float(np.median(ttft)), ttft_max_ms=float(max(ttft)),
         # tokens after each request's first, over the time from the first
         # first-token to the end of the run
         decode_tok_per_s=(n_tokens - len(reqs)) / (t_end - first_tok),
         output_tok_per_s=n_tokens / (t_end - t0),
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         kernel_launches=launches, expected_launches=expected,
         decode_steps=m["decode_steps"],
         decode_dispatches=m["decode_dispatches"],
         engine_step_mix=m["engine_step_mix"],
         prefix_hit_pages=m["prefix_hit_pages"],
         prefix_cached_tokens=m["prefix_cached_tokens"])
    profile_decode_dispatch(eng, rng, cfg)
    del eng
    torch.cuda.empty_cache()
    return launches


def profile_decode_dispatch(eng: InferenceEngine, rng, cfg) -> None:
    """One pure decode dispatch (8 slots at 512-token contexts, 32 steps)
    under torch.profiler: wall time against the summed device time of its
    kernels gives the card's idle share; the decode kernel's share of the
    device time and the kernels launched per step come with it. Runs after
    the main path's launch count was read."""
    from torch.profiler import ProfilerActivity, profile

    reqs = _submit(eng, {f"prof{i}": rng.integers(0, cfg.vocab_size,
                                                   512).tolist()
                         for i in range(SLOTS)}, STEPS + 1)
    while any(r.first_token_at is None for r in reqs):
        eng.step()            # prefill and the first-token flush
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()            # one 32-step decode dispatch
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    # Each kernel's device name holds its C entry point's name with
    # "_launch" replaced by "_kernel" (paged_decode_split_kernel, ...).
    paged_ms = {name: sum(e.device_time_total for e in kernels
                          if _device_name(pk.kernel) in e.name) / 1e3
                for name, pk in PAGED_KERNELS.items()}
    _drain(eng, reqs)
    emit("profile", what="one decode dispatch, 8 slots x 512 context, "
         f"{STEPS} steps", wall_ms=wall_ms,
         device_busy_ms=busy_ms if kernels else "not measured",
         device_idle_frac=1 - busy_ms / wall_ms if kernels else "not measured",
         decode_kernel_ms=sum(paged_ms.values()), paged_kernel_ms=paged_ms,
         kernels_per_step=len(kernels) / STEPS)


def phase_parity(seed: int = 1) -> dict:
    """f32 greedy tokens, paged engine against dense; returns the paged
    kernels' launch counts over the paged engine's run (the f32 route's
    single kernel only)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(PRESETS["llama3-1b"], n_layers=2,
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(seed))
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 70, 131)]
    out = {}
    for impl in ("paged", "dense"):
        eng = InferenceEngine(cfg, params, max_slots=4, max_len=256,
                              page_size=PAGE, prefill_chunk_size=128,
                              decode_steps_per_dispatch=8,
                              attention_impl=impl)
        reset_paged_launches()
        reqs = _submit(eng, {f"p{i}": p for i, p in enumerate(prompts)}, 24)
        _drain(eng, reqs)
        out[impl] = [r.generated for r in reqs]
        if impl == "paged":
            launches = paged_launches()
    same = out["paged"] == out["dense"]
    emit("parity", dtype="float32", layers=2, prompts=len(prompts),
         tokens_per_prompt=24, paged_equals_dense=same,
         kernel_launches=launches)
    if not same:
        raise AssertionError(f"paged {out['paged']} != dense {out['dense']}")
    on_route = paged_kernel_of(cfg.dtype)
    if any((n > 0) != (name == on_route) for name, n in launches.items()):
        raise AssertionError(f"f32 paged launches {launches}: expected only "
                             f"{on_route}")
    return launches


# ------------------------------------------------------------- speculate
class OracleDrafter(Drafter):
    """Drafts the continuation a plain run produced for the sequence whose
    prompt and output start with the history; ``wrong=True`` shifts every
    drafted id by one, so the first is never the argmax. Where no sequence
    matches, drafts the last token ``k`` times, so every slot drafts."""

    def __init__(self, sequences, vocab: int, wrong: bool = False):
        self.sequences = [list(q) for q in sequences]
        self.vocab, self.wrong = vocab, wrong

    def draft(self, tokens: list, k: int) -> list:
        for seq in self.sequences:
            if len(seq) > len(tokens) and seq[:len(tokens)] == tokens:
                d = seq[len(tokens):len(tokens) + k]
                return [(t + 1) % self.vocab for t in d] if self.wrong else d
        return [tokens[-1]] * k


def _expected_paged(eng: InferenceEngine, cfg) -> dict:
    """Paged launches an engine's run must show: ``n_layers`` a decode
    step of the plain bursts and ``n_layers * (K + 1)`` a verify call, all
    on the kernel of the config's dtype."""
    m = eng.metrics
    k = eng.speculation.num_draft_tokens if eng.speculation else 0
    n = cfg.n_layers * (m["decode_steps"] + (k + 1) * m["spec_dispatches"])
    on_route = paged_kernel_of(cfg.dtype)
    return {name: n if name == on_route else 0 for name in PAGED_KERNELS}


def phase_spec_parity(seed: int = 2) -> dict:
    """f32 greedy tokens of the speculative paged engine equal the plain
    paged engine's at llama3-1b widths and 2 layers (page 16, 4 slots,
    K = 3): with an oracle drafter (accepted runs cross page edges), a
    wrong one (accept-0 rounds still advance a token) and an n-gram one; a
    last request shares a retired prompt's prefix into a partial page, so
    it COW-forks that page and its drafts are rejected mid-page. Returns
    the paged kernels' launch counts over the speculative runs (the f32
    route's single kernel only)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(PRESETS["llama3-1b"], n_layers=2,
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator(DEVICE).manual_seed(seed))
    rng = np.random.default_rng(seed)
    prompts = {f"p{i}": rng.integers(0, cfg.vocab_size, n).tolist()
               for i, n in enumerate((5, 37, 70, 131))}
    # The last request shares p1's 37 prompt tokens and first 15 outputs:
    # p1 retires with 60 tokens of K/V, 3 full pages and 12 rows of a
    # fourth, and the last request matches the 3 pages and 4 of the rows.
    late_tail = rng.integers(0, cfg.vocab_size, 9).tolist()

    def serve(spec):
        eng = InferenceEngine(cfg, params, max_slots=4, max_len=256,
                              page_size=SPEC_PAGE, prefill_chunk_size=64,
                              decode_steps_per_dispatch=8,
                              attention_impl="paged",
                              speculation_config=spec)
        reqs = _submit(eng, prompts, 24)
        _drain(eng, reqs)
        late = _submit(eng, {"late": prompts["p1"] + reqs[1].generated[:15]
                             + late_tail}, 24)
        _drain(eng, late)
        return [r.generated for r in reqs + late], eng

    plain, _ = serve(None)
    seqs = [p + out for p, out in zip(
        [*prompts.values(), prompts["p1"] + plain[1][:15] + late_tail],
        plain)]
    launches = {name: 0 for name in PAGED_KERNELS}
    runs = {}
    for name, drafter in (
            ("oracle", OracleDrafter(seqs, cfg.vocab_size)),
            ("wrong", OracleDrafter(seqs, cfg.vocab_size, wrong=True)),
            ("ngram", "ngram")):
        reset_paged_launches()
        got, eng = serve({"num_draft_tokens": 3, "drafter": drafter})
        torch.cuda.synchronize()
        run_launches = paged_launches()
        m = eng.metrics
        runs[name] = {
            "equal_to_plain": got == plain, "kernel_launches": run_launches,
            "expected_launches": _expected_paged(eng, cfg),
            **{k: m[k] for k in ("spec_dispatches", "spec_drafted_tokens",
                                 "spec_accepted_tokens", "spec_rollbacks",
                                 "decode_steps", "cow_forks",
                                 "prefix_hit_pages")},
            "spec_accept_rate": eng.spec_accept_rate,
            "spec_tokens_per_dispatch": eng.spec_tokens_per_dispatch}
        for k, n in run_launches.items():
            launches[k] += n
        del eng
    emit("spec_parity", dtype="float32", layers=2, page=SPEC_PAGE, slots=4,
         draft_k=3, requests=len(plain), tokens_per_request=24, runs=runs)
    for name, r in runs.items():
        if not r["equal_to_plain"]:
            raise AssertionError(f"spec_parity {name}: speculative tokens "
                                 f"differ from plain")
        if r["kernel_launches"] != r["expected_launches"]:
            raise AssertionError(f"spec_parity {name}: launches "
                                 f"{r['kernel_launches']} != "
                                 f"{r['expected_launches']}")
        if r["cow_forks"] < 1:
            raise AssertionError(f"spec_parity {name}: no COW fork: {r}")
    if not (runs["oracle"]["spec_accepted_tokens"] > 0
            and runs["wrong"]["spec_dispatches"] > 0
            and runs["wrong"]["spec_accepted_tokens"] == 0
            and runs["wrong"]["spec_rollbacks"] > 0
            and runs["wrong"]["spec_tokens_per_dispatch"] == 1.0):
        raise AssertionError(f"spec_parity metrics: {runs}")
    del params
    torch.cuda.empty_cache()
    return launches


def spec_prompts(n: int, length: int) -> list:
    """ray_tpu/_speculative_bench.py's traffic: repetitive prompts of
    period 6, distinct per slot."""
    out = []
    for i in range(n):
        period = [11 + i, 23, 37, 41 + i, 5, 17]
        out.append([period[j % len(period)] % 200 + 1 for j in range(length)])
    return out


def phase_speculate(seed: int = 0) -> dict:
    """The speculative bench's traffic on llama3-1b at full width, bf16,
    random weights: 8 slots, 512-token period-6 prompts (one prefill chunk
    each), 96 new tokens, page 16; plain, then K = 6 with the n-gram
    drafter and with an oracle drafter taken from the plain run. Returns
    the paged kernels' launch counts over the two speculative runs (the
    split kernel only: 16 x 7 a verify call)."""
    cfg = PRESETS["llama3-1b"]
    params = init_params(cfg, torch.Generator(DEVICE).manual_seed(seed))
    prompts = spec_prompts(SLOTS, SPEC_PROMPT)

    def engine(spec):
        return InferenceEngine(
            cfg, params, max_slots=SLOTS, max_len=SPEC_MAX_LEN,
            page_size=SPEC_PAGE, prefill_chunk_size=SPEC_PROMPT,
            attention_impl="paged", speculation_config=spec, seed=seed)

    def run(eng):
        torch.cuda.reset_peak_memory_stats()
        reqs = _submit(eng, {f"s{i}": p for i, p in enumerate(prompts)},
                       SPEC_NEW)
        t0 = time.monotonic()
        _drain(eng, reqs)
        torch.cuda.synchronize()
        t_end = time.monotonic()
        first = min(r.first_token_at for r in reqs)
        n_tok = sum(len(r.generated) for r in reqs)
        for r in reqs:
            toks = np.asarray(r.generated)
            if (len(toks) != SPEC_NEW or toks.min() < 0
                    or toks.max() >= cfg.vocab_size):
                raise AssertionError(f"{r.request_id}: bad output "
                                     f"{r.generated}")
        return [r.generated for r in reqs], {
            "decode_tok_per_s": (n_tok - len(reqs)) / (t_end - first),
            "wall_s": t_end - t0,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}

    reset_paged_launches()
    plain_eng = engine(None)
    plain, out = run(plain_eng)
    results = {"plain": {**out, "kernel_launches": paged_launches(),
                         "decode_steps": plain_eng.metrics["decode_steps"]}}
    del plain_eng
    seqs = [p + o for p, o in zip(prompts, plain)]
    launches = {name: 0 for name in PAGED_KERNELS}
    L = cfg.n_layers
    for name, drafter in (("ngram", "ngram"),
                          ("oracle", OracleDrafter(seqs, cfg.vocab_size))):
        eng = engine({"num_draft_tokens": SPEC_K, "drafter": drafter})
        reset_paged_launches()
        got, out = run(eng)
        run_launches = paged_launches()
        m = eng.metrics
        split = run_launches[paged_kernel_of(cfg.dtype)]
        firsts = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b),
                       None) for x, y in zip(got, plain)]
        results[name] = {
            **out, "spec_accept_rate": eng.spec_accept_rate,
            "spec_tokens_per_dispatch": eng.spec_tokens_per_dispatch,
            "spec_dispatches": m["spec_dispatches"],
            "decode_steps": m["decode_steps"],
            "split_launches_per_verify": (
                (split - L * m["decode_steps"]) / m["spec_dispatches"]
                if m["spec_dispatches"] else None),
            "kernel_launches": run_launches,
            "expected_launches": _expected_paged(eng, cfg),
            "requests_equal_to_plain": sum(f is None for f in firsts),
            "first_differing_token": firsts}
        for k, n in run_launches.items():
            launches[k] += n
        if name == "oracle":
            results[name]["profile"] = profile_verify_dispatch(eng, prompts)
        del eng
        torch.cuda.empty_cache()
    emit("speculate", preset="llama3-1b", dtype="bfloat16", slots=SLOTS,
         prompt_tokens=SPEC_PROMPT, new_tokens=SPEC_NEW, draft_k=SPEC_K,
         page=SPEC_PAGE, max_len=SPEC_MAX_LEN, runs=results)
    for name in ("ngram", "oracle"):
        r = results[name]
        if r["kernel_launches"] != r["expected_launches"]:
            raise AssertionError(f"speculate {name}: launches "
                                 f"{r['kernel_launches']} != "
                                 f"{r['expected_launches']}")
    if not (results["oracle"]["spec_dispatches"] > 0
            and results["oracle"]["spec_accept_rate"] > 0):
        raise AssertionError(f"speculate: the oracle drafter accepted "
                             f"nothing: {results['oracle']}")
    del params
    torch.cuda.empty_cache()
    return launches


def profile_verify_dispatch(eng: InferenceEngine, prompts: list) -> dict:
    """One verify call under torch.profiler, on the same prompts again (8
    new tokens each), after the run's launch counts were read: the card's
    idle share over it and the split kernel's device time."""
    from torch.profiler import ProfilerActivity, profile

    reqs = _submit(eng, {f"prof{i}": p for i, p in enumerate(prompts)}, 8)
    while any(r.first_token_at is None for r in reqs):
        eng.step()            # prefill and the first-token flush
    torch.cuda.synchronize()
    before = eng.metrics["spec_dispatches"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()            # one verify call (the oracle always drafts)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if eng.metrics["spec_dispatches"] != before + 1:
        raise AssertionError("the profiled step was not a verify call")
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    split = paged_decode_split_kernel
    _drain(eng, reqs)
    return {"what": "one verify call, 8 slots x ~513 context, K = 6",
            "wall_ms": wall_ms,
            "device_busy_ms": busy_ms if kernels else "not measured",
            "device_idle_frac": (1 - busy_ms / wall_ms if kernels
                                 else "not measured"),
            "kernels_launched": len(kernels),
            "split_kernel_ms": sum(e.device_time_total for e in kernels
                                   if _device_name(split) in e.name) / 1e3}


def _build_all() -> None:
    """One nvcc per CUDA source, all started together."""
    # one library per source: flash_bwd.cu holds the simt dQ and dK/dV
    kernels = [paged_decode_kernel, paged_decode_split_kernel,
               flash_fwd_kernel, flash_dq_kernel, flash_fwd_sm90_kernel,
               flash_dq_sm90_kernel, flash_dkdv_sm90_kernel]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda kern: kern.build(), kernels))
    wall = time.perf_counter() - t0
    for kern in kernels:
        log = kern.build_log
        regs = [int(w) for line in log.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt.startswith("registers")]
        spills = sum(int(w) for line in log.splitlines()
                     for w, nxt in zip(line.split(), line.split()[1:])
                     if nxt == "bytes" and "spill" in line and w.isdigit())
        emit("build", source=f"ray_tpu_torch/csrc/{kern.source.name}",
             seconds=kern.build_seconds, max_registers=max(regs, default=None),
             spill_bytes=spills, all_sources_wall_s=wall)
        # a spilled wgmma kernel serialises its products (ptxas C7512)
        if kern.source.name.endswith("_sm90.cu") and spills:
            raise AssertionError(f"{kern.source.name} spills {spills} bytes")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    emit("card", nvidia_smi=card, torch_name=kind,
         torch=torch.__version__, cuda=torch.version.cuda)
    _build_all()

    paged_err, paged_err_verify = phase_kernel()
    times = phase_time()
    flash_err = phase_flash_kernel()
    flash_times = phase_flash_time()
    phase_lm_head_grad()
    train_launches = phase_train()
    parity_launches = phase_train_parity()
    launches = phase_serve()
    paged_parity_launches = phase_parity()
    spec_parity_launches = phase_spec_parity()
    verify_launches = phase_speculate()
    kernels = []
    for name, pk in PAGED_KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "variant": pk.variant,
            "source": f"ray_tpu_torch/csrc/{pk.source}",
            "replaces": "ray_tpu/ops/paged_attention.py:103",
            # on the bf16 serve path; the single kernel runs on the f32
            # path (parity) instead
            "launches": launches[name],
            "launches_f32_parity": paged_parity_launches[name],
            # the speculative runs (`speculate`, bf16) and the f32
            # speculative parity runs (`spec_parity`)
            "launches_verify": verify_launches[name],
            "launches_f32_spec_parity": spec_parity_launches[name],
            "max_abs_err": paged_err[name],
            "max_abs_err_verify_cases": paged_err_verify[name],
            **times["uniform"][name],
            "skewed": times["skewed"][name]})
    for name, fk in FLASH_KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "variant": fk.variant,
            "source": f"ray_tpu_torch/csrc/{fk.source}",
            "replaces": f"ray_tpu/ops/attention.py:{fk.tpu_line}",
            # on the bf16 train path; the simt forward and dK/dV run on
            # the f32 path (train_parity) instead
            "launches": train_launches[name],
            "launches_f32_train_parity": parity_launches[name],
            "max_abs_err": flash_err[name], **flash_times[name]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
