"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  card     the card's name and power limit (nvidia-smi) and torch's name;
  build    builds the CUDA kernel from ``ray_tpu_torch/csrc`` (nvcc);
  kernel   the paged decode kernel against its plain PyTorch version on
           the card, at llama3-1b shapes (uniform and skewed batches,
           staging rows 0/5/31, both compat modes, pos 0) and at head_dim
           128, 16 and 32 with pages of 64, 8 and 16, in bf16 and f32;
  time     the kernel, its plain version and one PyTorch call computing
           the same function (scaled_dot_product_attention over
           pre-gathered K/V, a yardstick only) at the two llama3-1b
           batches, beside the least time the card could take;
  serve    the main path: a llama3-1b ``InferenceEngine`` with random
           weights serves 8 greedy requests (chunked prefill, mixed
           dispatch, a prefix hit), with the kernel's launch count read
           around the run;
  profile  one more decode dispatch on that engine under torch.profiler:
           the card's idle share and kernels launched per step;
  parity   f32 greedy tokens of the paged engine (the kernel) equal the
           dense engine's at llama3-1b widths and 2 layers.

Then a JSON line of the kernels, the card's ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``. Any failed check raises
and the script exits non-zero without that last line. It needs CUDA and
the repository checkout beside it.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ray_tpu_torch.llm import InferenceEngine, Request
from ray_tpu_torch.models.llama import PRESETS, init_params
from ray_tpu_torch.ops.paged_attention import (paged_decode_cuda,
                                               paged_decode_kernel,
                                               paged_decode_layer_args,
                                               paged_decode_plain, stage_rows)

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
L2_BYTES = 50 * 2 ** 20
DEVICE = "cuda"

# llama3-1b engine geometry as the serving benchmark runs it.
SLOTS, MAX_LEN, PAGE, CHUNK, STEPS = 8, 2560, 64, 256, 32


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
          "live_pages": max(1, -(-(max(case.ctx) - case.stage_idx)
                                 // case.page))}
    if case.mode == "stage":
        shape = (case.stage_layers, n, case.kh, stage_rows(STEPS), case.d)
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
    ]
    return cases


def phase_kernel() -> float:
    """Every case in bf16 and f32; returns the largest bf16 error at the
    llama3-1b shapes (the main path's)."""
    worst_main = 0.0
    for case in kernel_cases():
        for dtype in (torch.bfloat16, torch.float32):
            args = make_inputs(case, dtype)
            got = paged_decode_cuda(*args)
            torch.cuda.synchronize()
            want = paged_decode_plain(*args)
            err = (got.float() - want.float()).abs().max().item()
            tol = TOLERANCE[dtype]
            emit("kernel", case=case.name, dtype=str(dtype).split(".")[-1],
                 max_abs_err=err, tolerance=tol)
            if not err <= tol:
                raise AssertionError(f"kernel case {case.name} {dtype}: "
                                     f"max abs error {err} > {tol}")
            if dtype is torch.bfloat16 and case.d == 64:
                worst_main = max(worst_main, err)
    return worst_main


def _time_ms(fn, iters: int = 30) -> float:
    """Median CUDA-event time of ``fn`` with the L2 cache flushed before
    each call (each decode layer reads a different layer's pages)."""
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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
    out = {}
    for batch, ctx in (("uniform", [2048] * SLOTS),
                       ("skewed", [2432] + [256] * 7)):
        args = make_inputs(Case(batch, ctx, stage_idx=16), torch.bfloat16)
        plain_ms = _time_ms(lambda: paged_decode_plain(*args))
        ms = _time_ms(lambda: paged_decode_cuda(*args))
        library_ms = _time_ms(_library_call(args))
        bound_ms, bound_by = _bound(args)
        out[batch] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": library_ms}
        emit("time", batch=batch, stage_idx=16, dtype="bfloat16", **out[batch])
    return out


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


def phase_serve(seed: int = 0) -> int:
    """Returns the kernel's launch count over the served run."""
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

    paged_decode_kernel.launches = 0
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
    launches = paged_decode_kernel.launches

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
    if launches != cfg.n_layers * m["decode_steps"] or launches == 0:
        raise AssertionError(f"kernel launches {launches} != "
                             f"{cfg.n_layers} x {m['decode_steps']} steps")
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
         kernel_launches=launches, decode_steps=m["decode_steps"],
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
    decode_ms = sum(e.device_time_total for e in kernels
                    if "paged_decode_kernel" in e.name) / 1e3
    _drain(eng, reqs)
    emit("profile", what="one decode dispatch, 8 slots x 512 context, "
         f"{STEPS} steps", wall_ms=wall_ms,
         device_busy_ms=busy_ms if kernels else "not measured",
         device_idle_frac=1 - busy_ms / wall_ms if kernels else "not measured",
         decode_kernel_ms=decode_ms,
         kernels_per_step=len(kernels) / STEPS)


def phase_parity(seed: int = 1) -> None:
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
        reqs = _submit(eng, {f"p{i}": p for i, p in enumerate(prompts)}, 24)
        _drain(eng, reqs)
        out[impl] = [r.generated for r in reqs]
    same = out["paged"] == out["dense"]
    emit("parity", dtype="float32", layers=2, prompts=len(prompts),
         tokens_per_prompt=24, paged_equals_dense=same)
    if not same:
        raise AssertionError(f"paged {out['paged']} != dense {out['dense']}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    emit("card", nvidia_smi=card, torch_name=kind,
         torch=torch.__version__, cuda=torch.version.cuda)

    paged_decode_kernel.build()
    log = paged_decode_kernel.build_log
    regs = [int(w) for line in log.splitlines() if "registers" in line
            for w, nxt in zip(line.split(), line.split()[1:])
            if nxt.startswith("registers")]
    spills = sum(int(w) for line in log.splitlines()
                 for w, nxt in zip(line.split(), line.split()[1:])
                 if nxt == "bytes" and "spill" in line and w.isdigit())
    emit("build", seconds=paged_decode_kernel.build_seconds,
         max_registers=max(regs, default=None), spill_bytes=spills)

    max_err = phase_kernel()
    times = phase_time()
    launches = phase_serve()
    phase_parity()
    t = times["uniform"]
    print(json.dumps({"kernels": [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "ray_tpu_torch/csrc/paged_decode.cu",
        "replaces": "ray_tpu/ops/paged_attention.py:103",
        "launches": launches, "max_abs_err": max_err, "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
