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
  train_remat   the remat policies on the same params (learning rate 0):
                one step of "full" for its peak allocation, then 3 steps
                each of "dots" and "attn" in turns (dots, attn, attn,
                dots): step time, peak allocation and the flash launches a
                step (16 forward under "attn", 32 under "full" and "dots",
                whose backward runs the forward again; 16 dQ and dK/dV);
  train_fit     the train leg through the Train and Data libraries (the
                port's bench.py::run_framework): ``init()`` on the card,
                ``data.from_numpy`` of (2 + 5 + 2) x 8 rows of 2,048
                tokens from the seed, and ``TorchTrainer.fit`` with one
                worker leased the card (``ScalingConfig(use_gpu=True)``):
                in that process the train_fn builds llama3-1b (remat
                "attn"), takes 2 warm-up, 5 timed and 2 more SGD steps on
                ``to_device_batches`` of its shard, and reports the last
                two steps' params as ``state=`` (async checkpoints). The
                worker must be another process on the card, with 16
                launches a step of each sm90 flash kernel and 0 of the
                simt ones, finite losses, and its last commit registered
                on the GCS; tokens per second, step time, each save's
                blocking milliseconds and its commit's seconds are printed
                beside the ``train`` phase's. A second fit resumes from
                that checkpoint and its worker must load params of the
                fingerprint the first worker took before it saved; no
                worker process may be left after ``shutdown()``;
  train_loop    the structured step spec through ``DataParallelTrainer``:
                ``TrainLoopConfig`` with ``train``'s step (llama3-1b's
                widths and 4 of its 16 layers, remat "attn", SGD) and no
                drive argument, whose default is
                the compiled loop: data, step and checkpoint stage actors
                parked once over shm rings (``compile_loop``), the step
                stage leased the card; 2 warm-up and 6 timed steps of 8 x
                2,048 seeded tokens, a snapshot every 4 steps through the
                step -> checkpoint ring (its slots sized from a packed
                snapshot message made here first), 2 credits; then the
                same spec with ``use_compiled_loop=False`` (the eager
                drive). The step stage must be another process on the
                card with 16 launches a step of each sm90 flash kernel and
                0 simt (counted there), the two drives' per-step losses
                bit-equal, each drive must commit two checkpoints and
                register the last, and no worker may be left; prints the
                step wall time, tokens per second, the checkpoint overlap
                and blocking, the pack's bytes and seconds, the rings'
                bytes, the loop's stall attribution and teardown time;
  train_parity  f32 loss and every gradient of the kernel path
                (attn_impl="flash", the simt kernels) equal the plain
                path's ("reference") at llama3-1b widths and 2 layers, with
                the launch counts read around it;
  serve         the serving main path: a llama3-1b ``InferenceEngine`` with
                random weights serves 8 greedy requests (chunked prefill,
                mixed dispatch, a prefix hit), with the paged kernels' launch
                counts read around the run (16 a decode step of the split
                kernel, 0 of the single one);
  deadline      request deadlines in the ``serve`` geometry at llama3-1b
                bf16: 16 requests of 64 tokens, each under its own trace;
                4 arrive past their deadline and expire queued, a
                2,000-token prompt expires after its first prefill chunk,
                3 expire after their first token (deadlines set between
                steps, a few ms ahead, so they pass inside a dispatch), 8
                run to their length. Checks the finish reasons and both
                counters, that each tick's pinned pages are exactly those
                of the requests still running (an expiry's pages leave in
                its tick), the pool back at its baseline, 16 split
                launches a decode step and 0 single, one timeline dump per
                expiry opening at admission, and the prefix-match, prefill
                and decode spans of each served request; prints the
                overshoot from deadline to the sweep and to the returned
                event beside the dispatch wall time;
  recorder      the flight recorder's cost: 8 requests of 97 tokens on an
                engine sharing those weights, without a prefix cache, with
                the recorder on and stubbed off, 3 turns of on/off/off/on;
                tokens must be equal in all 12 runs; prints
                ``recorder_overhead_frac`` (median over the turns of
                (on - off) / off of the runs' median dispatch wall time),
                the host time of a dispatch's token emission on and off,
                and one ``RequestTimeline.add`` timed alone;
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
                match plain, and one verify call under torch.profiler;
  lora_parity   f32 multi-LoRA serving at llama3-1b widths and 2 layers
                (page 16, rank-16 adapters, the single kernel): a batch of
                the base model and three adapters gives exactly the tokens
                of the same requests served one by one, with the single
                kernel's launches read around the batch, and one decode
                step with the adapter stack is within 1e-4 (relative,
                Frobenius) of the same step on weights with each slot's
                adapter merged in (W + A·B), in its logits and in the K/V
                it writes, while the step without the deltas is not;
  lora_serve    the LoRA serving path: the ``serve`` geometry at llama3-1b
                bf16 with ``LoRAServingConfig(max_loras=4, max_rank=16)``;
                8 greedy requests of 64 tokens over the base model and four
                adapters (.npz files under a temporary directory), then a
                fifth adapter's request while all four are pinned. Every
                request must finish, the fifth must be deferred, the split
                kernel must run 16 launches a decode step, and the 8
                requests must take as many decode dispatches as the same
                traffic on one adapter; every adapter request's tokens
                must differ from the no-LoRA run's, and one bf16 decode
                step with the engine's stack must sit within 0.1 of f32
                merged weights (logits and written K/V) while the step
                without the deltas does not. Tokens per second, TTFT, the mean
                adapter load time, the peak allocation and one decode
                dispatch under torch.profiler, beside the same traffic with
                no ``lora_config``;
  migrate_parity
                f32 KV migration at llama3-1b widths and 2 layers (page 16,
                the single kernel, 8 greedy tokens a request; a 71-token
                prompt, 4 full pages and a 7-row tail): the export/import
                round trip (pages ``torch.equal`` to the source's, a prompt
                that leaves the tail mid-page COW-forks it, a duplicate
                import leaks no page), the live stream (one page a chunk
                while the source prefills), source death after 2 chunks,
                live (mid-prefill) and static, where the importer keeps a
                strict prefix and every source page returns to refcount 0,
                the host-RAM tier (restored pages equal the spilled ones)
                and an import under pool pressure (one failure, a cold
                prefill). Every request's tokens equal a cold dense
                engine's, with the single kernel's launches read around;
  migrate       KV migration at llama3-1b bf16 in the migration bench's
                geometry (ray_tpu/_migration_bench.py: a 2,048-token
                prompt, page 64, chunks of 256, 2 slots, max_len + 128):
                engine A prefills the prompt (prefill_only) and streams it
                to engine B over the loop wire, two rounds, best kept
                (``kv_migration_mb_s``); B's pages are ``torch.equal`` to
                A's, and B's 32 greedy tokens equal A's from the same
                layout (the streamed payload imported into A itself); TTFT
                on B against a cold engine; then the host tier at the same
                geometry (spill ms per page, restore time, tokens equal to
                the hit before the eviction), with the split kernel's
                launches read around (16 a decode step);
  weights       weight residency at llama3-1b bf16 on an engine built from
                a seed: demotion frees at least 0.99 of the weights' bytes,
                promotion (ms, GB/s), the fingerprint and greedy tokens
                unchanged, demotion refused while busy, the first request
                promoting, a broadcast to 2 loopback readers (MB/s, both
                fingerprints equal) and ``install_weights`` into a demoted
                engine;
  serve_app     the LLM app through the port's runtime and Serve:
                ``init()`` on the card (the node reports its cards as
                ``GPU``), ``serve.run(build_llm_app("llama3-1b", ...))`` in
                the ``serve`` geometry with ``num_gpus=1``, so the replica
                is a worker process leased the card; ``/v1/models`` (and
                its round trip alone, the HTTP hop), 8 concurrent streamed
                ``/v1/completions`` of the ``serve`` traffic as text (two
                sharing a 2,000-byte prefix, 64 greedy tokens each): the
                client-side TTFT and output tokens per second beside the
                ``serve`` phase's, and the replica's own paged launches
                (``engine_metrics()["port"]``, 16 split a decode step, 0
                single) in a process that is not this one and runs on the
                card; then a plain and a streamed completion of one prompt
                (equal text and count) and a chat completion. The f32
                ``debug-128`` app over HTTP must answer what an in-process
                ``LLMDeployment`` on the card answers, and after
                ``serve.shutdown()`` and ``shutdown()`` no worker process
                may be left;
  disagg_app    the rest of the serve leg on one new cluster, first
                ``build_llm_app("llama3-1b", ...,
                serve_disaggregation="prefill_decode")`` in the ``serve``
                geometry, a prefill and a decode replica each leased half
                of the card (``num_gpus=0.5``), both on ``cuda`` in
                processes of their own; ``serve.status()`` shows the
                pools; ``serve_app``'s 8 prompts streamed at once over
                HTTP, meeting both replicas cold: each finishes, each
                leaves one complete
                ``llm.kv_migrate`` span of kind ``disagg_handoff`` with
                cached tokens (read through ``util.state.list_spans``),
                the decode replica imports 8 handoffs and launches the
                split kernel 16 times a decode step, the prefill replica
                launches none and decodes nothing, and both pools return
                to their baseline (no page pinned); TTFT, tokens per
                second and the start time beside ``serve_app``'s;
  disagg_parity f32 ``debug-128``: a disaggregated app's text over HTTP,
                plain and streamed, equals an in-process unified
                ``LLMDeployment``'s; then two unified replicas (half the
                card each) and an affinity spill between them: equal
                text, one spill migration, pages imported on the target;
  fleet_app     llama3-1b under ``autoscaling_config`` (1 to 2 replicas,
                scale to zero after 5 s idle), half the card a replica:
                one request, the park (0 running, a standby with its
                weights in host RAM, still healthy, read through
                ``util.state.serve_fleet``), and a request that wakes it
                from the standby (``host``, ``stream`` or ``resident``;
                ``scale_to_zero`` and ``wake`` events); the wake's TTFT,
                and the launches summed over every replica the state API
                lists;
  batch         ``build_llm_processor`` of llama3-1b's widths and 4 of its
                16 layers (``BATCH_LAYERS``; 8 slots, max_len 1,024,
                batches of 16) over ``data.from_items`` of 32 rows
                with a per-row ``max_tokens`` column, on one engine actor
                leased the whole card: every row generates no more than
                its column, and the actor counts its own launches; then
                an f32 ``debug-128`` processor whose texts equal the same
                engine worker's run in this process on the same batch;
                no worker process may be left after ``shutdown()``;
  fleet_ladder  the promotion ladder on an in-process llama3-1b
                ``LLMDeployment`` on the card: ``open_weight_stream``,
                ``fleet_demote`` and ``fleet_promote(address)`` (path
                ``stream``, the donor's fingerprint); a donor dying after
                one chunk (path ``host``); a dead address with the host
                copy lost (path ``cold_init``: the seed's weights, the
                donor's fingerprint again); a request served after each,
                each rung's seconds;
  libraries     Tune, workflows and jobs on one new cluster. ``tune``: a
                ``Tuner`` over ``lr`` in {2.0, 0.5} (``max_concurrent_trials
                =2``, JSON and CSV logger callbacks) whose trainable runs
                ``TorchTrainer.fit`` with one worker leased half of the card
                (``resources_per_worker={"CPU": 1, "GPU": 0.5}``): each fit
                worker builds llama3-1b's widths and 4 of its 16 layers
                (``TUNE_LAYERS``) from the seed (remat "attn") and takes 1
                warm-up and 3 SGD steps at its trial's rate on 8 x 2,048
                seeded tokens. Both trials must end TERMINATED, the best
                result be the lower loss, each fit worker be a process of
                its own on ``cuda`` with 4 launches a step of each sm90
                flash kernel and 0 simt (counted there), the two step
                windows overlap, each trial directory hold its
                ``result.json`` line and ``progress.csv`` row, and
                ``Tuner.restore`` of the finished experiment start no trial
                and no worker and give the same results; prints each
                trial's wall time, the time to its fit's first step and
                its tokens per second beside ``train``'s. ``job`` +
                ``workflow``: a driver script written to a temporary
                directory is submitted with ``JobSubmissionClient``; it
                connects through ``RAY_TPU_TORCH_ADDRESS`` and runs a
                workflow whose step A (``remote(num_gpus=1)``) serves 4
                greedy requests of 64 tokens on a llama3-1b bf16 engine
                in the ``serve`` geometry and whose step B (a CPU step)
                fails once. The job must end FAILED with step B's error in
                its logs and the workflow read FAILED; ``workflow.resume``
                here must finish it without running step A again (its run
                counter stays 1), step A's tokens must equal an in-process
                engine's of the same seed, prompts and shapes, and its
                worker must have run the split kernel 16 times a decode
                step and the single one 0 times. A ``sleep`` job is
                stopped: STOPPED, and its process gone. No worker may be
                left after ``shutdown()``;
  operator      the operator plane on a new cluster whose head and driver
                nodes offer no card: an ``Autoscaler`` over a
                ``LocalNodeProvider`` with one node type ``gpu`` = {CPU 2,
                GPU 1} (at most 1, idle timeout 5 s), a ``ClientServer``
                and the dashboard on loopback. A ``ray://`` driver in a
                fresh interpreter starts a ``num_gpus=1`` actor that builds
                llama3-1b bf16 on the card from the seed (the ``serve``
                geometry) and streams 4 prompts x 64 greedy tokens back
                over ``num_returns="streaming"``. The actor must pend until
                the autoscaler launches the node: ``python -m
                ray_tpu_torch.cli status`` shows the pending GPU demand
                first (the reconciler starts only then), then GPU 1 total.
                The tokens must equal an in-process engine's, the worker
                must count 16 split launches a decode step over 64 steps
                and 0 single, ``cli list nodes``, ``metrics`` (the GPU
                usage series) and ``memory`` (the node's store line) exit
                0, ``cli profile`` of the worker while its actor decodes
                (1 s, across the whole capture) writes a trace naming the split
                kernel's device function, and the dashboard's
                ``/api/nodes``, ``/api/metrics`` and
                ``/api/grafana_dashboard`` answer, every metric a GPU or
                HBM panel names present. After the driver leaves, its
                session is gone, the worker's process ends (the device
                fence) and then the autoscaler terminates the idle node
                within 5 + 10 s; ``cli status`` shows no GPU; no process is
                left. Prints the launch to the worker's start, the ray://
                first token, tokens per second beside the in-process
                engine's, and the phase's seconds.

Then a JSON line of the kernels, the card's ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``. Any failed check raises
and the script exits non-zero without that last line. It needs CUDA and
the repository checkout beside it.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ray_tpu_torch.dag.channel import TcpLoopReader, TcpLoopServer
from ray_tpu_torch.llm import (Drafter, InferenceEngine, KVMigrationSource,
                               LocalEngineExecutor, LoRAServingConfig,
                               Request, WeightBroadcastSource,
                               params_fingerprint, receive_kv_stream,
                               receive_weight_stream, resolve_device,
                               tree_bytes)
from ray_tpu_torch.llm.lora import proj_dims, save_adapter
from ray_tpu_torch.llm.migration import KV_MIGRATION_CHUNK_PAGES
from ray_tpu_torch.llm.model import decode_step, init_pages
from ray_tpu_torch.llm.weights import DEFAULT_CHUNK_BYTES
from ray_tpu_torch.models import llama as llama_model
from ray_tpu_torch.models.llama import (PRESETS, init_params,
                                        lm_head_grads_f32, loss_fn,
                                        train_flops_per_token)
from ray_tpu_torch.observability import loop_recorder, tracing
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


def phase_train(seed: int = 0) -> tuple[dict, dict]:
    """Returns each flash kernel's launch count over the trained steps
    (``n_layers`` a step for the kernels ``flash_route`` names for bf16, 0
    for the others) and the run's step time, tokens per second and peak
    allocation."""
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
    stats = {"tokens_per_sec": tokens_per_sec,
             "median_step_s": float(np.median(step_s)),
             "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    profile_train_step(params, batch, cfg)
    time_lm_head_fix(params, batch, cfg)
    time_remat_policies(params, batch, cfg)
    del params, batch
    torch.cuda.empty_cache()
    return launches, stats


# Each policy's flash launches a step per layer: "attn" keeps the attention
# output, "full" and "dots" run the forward again in the backward.
REMAT_FWD_PER_LAYER = {"attn": 1, "dots": 2, "full": 2}
# "dots" against "attn" on one step's gradients in bf16 (relative Frobenius
# error of each param leaf): a dropped or doubled term of the block's
# backward moves a leaf by tens of percent.
REMAT_GRAD_RTOL = 2e-2


def _named_leaves(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {k: t for key, v in tree.items()
                for k, t in _named_leaves(v, f"{prefix}{key}/").items()}
    return {prefix.rstrip("/"): tree}


def _step_grads(params: dict, batch: dict, cfg) -> tuple[float, dict]:
    """One step's loss and the gradient of every param leaf, by name; the
    params' ``.grad`` are cleared again."""
    loss = loss_fn(params, batch, cfg, chunk_tokens=TRAIN_CHUNK)
    loss.backward()
    grads = {}
    for name, p in _named_leaves(params).items():
        grads[name], p.grad = p.grad, None
    return loss.item(), grads


def check_dots_grads(params: dict, batch: dict, cfg) -> None:
    """One step's loss and gradients under "dots" against "attn" on the
    same params and batch, through the sm90 flash kernels in bf16: the
    losses must be equal (the policies change only what the backward
    keeps) and each leaf's gradient within ``REMAT_GRAD_RTOL``. "full"
    against "attn" is shown beside it, two policies whose backward is
    PyTorch's own."""
    losses, grads = {}, {}
    for policy in ("attn", "dots", "full"):
        losses[policy], grads[policy] = _step_grads(
            params, batch, dataclasses.replace(cfg, remat_policy=policy))
    errs = {policy: {
        name: (torch.linalg.norm((g - grads["attn"][name]).float())
               / torch.linalg.norm(grads["attn"][name].float())).item()
        for name, g in grads[policy].items()} for policy in ("dots", "full")}
    del grads
    torch.cuda.empty_cache()
    emit("train_remat_grads", what="one llama3-1b step, 8 x 2048, bf16: "
         "loss and per-leaf gradient relative error against attn's",
         losses=losses, grad_rel_err_dots_vs_attn=errs["dots"],
         grad_rel_err_full_vs_attn=errs["full"], grad_rtol=REMAT_GRAD_RTOL)
    if losses["dots"] != losses["attn"]:
        raise AssertionError(f"loss under dots {losses['dots']} != under "
                             f"attn {losses['attn']}")
    bad = {k: e for k, e in errs["dots"].items() if not e <= REMAT_GRAD_RTOL}
    if bad:
        raise AssertionError(f"dots gradients off attn's beyond "
                             f"{REMAT_GRAD_RTOL}: {bad}")


def time_remat_policies(params: dict, batch: dict, cfg, steps: int = 3) -> None:
    """Step time and peak allocation of the remat policies on the same
    params (learning rate 0, so every step sees the same weights): one
    step of "full" for its peak, then 3 steps each of "dots" and "attn" in
    turns (dots, attn, attn, dots), with the flash launches read around
    each turn; then one step's gradients of "dots" held against "attn"'s
    (``check_dots_grads``)."""
    times = {"dots": [], "attn": []}
    peaks, launches = {}, {}
    for policy in ("full", "dots", "attn", "attn", "dots"):
        c = dataclasses.replace(cfg, remat_policy=policy)
        n = 1 if policy == "full" else steps
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_flash_launches()
        for _ in range(n):
            t0 = time.perf_counter()
            loss = _sgd_step(params, batch, c, 0.0).item()
            if policy != "full":
                times[policy].append(time.perf_counter() - t0)
        if not math.isfinite(loss):
            raise AssertionError(f"{policy}: non-finite loss {loss}")
        peaks[policy] = max(peaks.get(policy, 0),
                            torch.cuda.max_memory_allocated())
        got = {k: v / n for k, v in flash_launches().items()}
        want = {flash_kernel_of(step, cfg.dtype): cfg.n_layers * (
            REMAT_FWD_PER_LAYER[policy] if step == "fwd" else 1)
            for step in ("fwd", "dq", "dkdv")}
        want = {k: want.get(k, 0) for k in FLASH_KERNELS}
        if got != want:
            raise AssertionError(f"{policy}: flash launches a step {got} "
                                 f"!= {want}")
        launches[policy] = got
    dots, attn = (float(np.median(times[k])) for k in ("dots", "attn"))
    check_dots_grads(params, batch, cfg)
    emit("train_remat", what="llama3-1b train step, 8 x 2048, sgd at lr 0 "
         "(the same params every step), remat policies in turns",
         step_s_dots=times["dots"], step_s_attn=times["attn"],
         median_step_s_dots=dots, median_step_s_attn=attn,
         dots_over_attn=dots / attn,
         max_memory_allocated_bytes=peaks,
         flash_launches_per_step=launches)


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


# ------------------------------------------------------------- train_fit
# The Train library's run (bench.py::run_framework): 2 warm-up and 5 timed
# steps, then 2 steps that report the state for an async checkpoint each.
FIT_CKPT_STEPS = 2
FIT_RUN = "train_fit"
FIT_TIMEOUT_S = 600.0


def _kernel_attrs() -> dict:
    """Each of ``FLASH_KERNELS``' kernels by its attribute name in
    ``ray_tpu_torch.ops.attention``, through which the train worker reads
    its own process's launch counts."""
    from ray_tpu_torch.ops import attention

    return {name: next(a for a, v in vars(attention).items()
                       if v is fk.kernel)
            for name, fk in FLASH_KERNELS.items()}


def fit_train_fn(config: dict) -> None:
    """The train_fn of ``TorchTrainer``: everything is built here, in the
    worker. A first run builds llama3-1b from the seed on the card and
    trains it with SGD on its Data shard, one batch a step; the last
    ``ckpt_steps`` steps report the params as ``state=`` (an async
    checkpoint each). The last report carries the throughput, the peak
    allocation, this process's flash launches over the run, the params'
    fingerprint taken before the last save, and each save's blocking and
    commit times. A resumed run loads the checkpoint and reports its
    fingerprint."""
    import time

    started_at, t_fn = time.time(), time.perf_counter()
    import dataclasses
    import os

    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.llm.weights import params_fingerprint
    from ray_tpu_torch.models.llama import (PRESETS, init_params, loss_fn,
                                            train_flops_per_token)
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.resilience import list_committed, load_checkpoint
    from ray_tpu_torch.train.checkpoint import map_tree

    t0 = time.perf_counter()
    device = torch.device("cuda")
    where = {"pid": os.getpid(), "device": str(device),
             "started_at": started_at, "import_s": t0 - t_fn,
             "device_name": torch.cuda.get_device_name(device)}
    resumed = train.get_checkpoint()
    if resumed is not None:
        state, meta = load_checkpoint(resumed.path)
        params = map_tree(lambda t: t.to(device), state["params"])
        train.report({**where, "resumed_step": int(meta["step"]),
                      "resumed_fingerprint": params_fingerprint(params),
                      "load_s": time.perf_counter() - t0})
        return

    cfg = dataclasses.replace(PRESETS[config["preset"]],
                              remat_policy=config["remat_policy"])
    params = init_params(cfg, torch.Generator(device).manual_seed(
        config["seed"]))
    leaves = []
    map_tree(leaves.append, params)
    for p in leaves:
        p.requires_grad_()
    init_s = time.perf_counter() - t0
    kernels = {name: getattr(attention, attr)
               for name, attr in config["kernels"].items()}
    before = {name: k.launches for name, k in kernels.items()}
    torch.cuda.reset_peak_memory_stats(device)
    warmup, timed = config["warmup"], config["timed"]
    n_steps = warmup + timed + config["ckpt_steps"]
    losses, step_s, saves = [], [], []
    shard = train.get_dataset_shard("train")
    for i, batch in enumerate(shard.to_device_batches(
            batch_size=config["batch"], device=device)):
        if i == warmup:
            torch.cuda.synchronize(device)
            t_timed = time.perf_counter()
        t_step = time.perf_counter()
        loss = loss_fn(params, {"tokens": batch["tokens"]}, cfg,
                       chunk_tokens=config["chunk"])
        loss.backward()
        with torch.no_grad():
            for p in leaves:
                p.sub_(config["lr"] * p.grad)
                p.grad = None
        losses.append(loss.item())
        step_s.append(time.perf_counter() - t_step)
        if i == warmup + timed - 1:
            torch.cuda.synchronize(device)
            timed_s = time.perf_counter() - t_timed
        if i < warmup + timed:
            train.report({"step": i, "loss": losses[-1]})
            continue
        metrics = {"step": i, "loss": losses[-1]}
        if i == n_steps - 1:
            launches = {n: k.launches - before[n] for n, k in kernels.items()}
            tokens_per_sec = config["batch"] * batch["tokens"].shape[1] \
                * timed / timed_s
            metrics.update(
                where, steps=i + 1, losses=losses, step_s=step_s,
                init_s=init_s, timed_s=timed_s,
                tokens_per_sec=tokens_per_sec,
                mfu=tokens_per_sec * train_flops_per_token(
                    cfg, batch["tokens"].shape[1]) / config["peak_flops"],
                max_memory_allocated_bytes=torch.cuda.max_memory_allocated(
                    device),
                kernel_launches=launches, saved_step=i,
                saved_fingerprint=params_fingerprint(params))
        t_save = time.perf_counter()
        train.report(metrics, state={"params": params, "step": i})
        saves.append({"step": i, "block_ms": (time.perf_counter() - t_save)
                      * 1e3, "returned_at": time.time()})
    # Wait for the commits (the writer thread), then time each one: save
    # returned -> its commit marker written.
    root = os.path.join(train.get_context().storage_path, "async_ckpts")
    deadline = time.monotonic() + config["commit_timeout_s"]
    while time.monotonic() < deadline and not any(
            s == n_steps - 1 for s, _ in list_committed(root)):
        time.sleep(0.05)
    committed = dict(list_committed(root))
    for save in saves:
        path = committed.get(save["step"])
        save["commit_s"] = (os.stat(os.path.join(path, "COMMITTED")).st_mtime
                            - save["returned_at"]) if path else None
    train.report({"step": n_steps, "saves": saves, "root": root})


def _fit(name: str, storage: str, ds, resume=None, **config):
    from ray_tpu_torch import train

    return train.TorchTrainer(
        fit_train_fn,
        train_loop_config=dict(
            preset="llama3-1b", remat_policy="attn",
            seed=0, batch=TRAIN_BATCH, chunk=TRAIN_CHUNK, lr=TRAIN_LR,
            warmup=TRAIN_WARMUP, timed=TRAIN_STEPS,
            ckpt_steps=FIT_CKPT_STEPS, kernels=_kernel_attrs(),
            peak_flops=PEAK_FLOPS[torch.bfloat16],
            commit_timeout_s=FIT_TIMEOUT_S, **config),
        scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
        run_config=train.RunConfig(
            name=name, storage_path=storage,
            checkpoint_config=train.CheckpointConfig(
                async_save=True, num_to_keep=FIT_CKPT_STEPS)),
        datasets={"train": ds} if ds is not None else None,
        resume_from_checkpoint=resume).fit()


def phase_train_fit(train_stats: dict, seed: int = 0) -> dict:
    """The train leg through its normal entry points (the port's
    bench.py::run_framework): ``init()`` on the card, a Data set of
    (2 + 5 + 2) x 8 rows of 2,048 tokens made from the seed, and
    ``TorchTrainer.fit`` with one worker leased the card, which trains
    llama3-1b on its shard and commits two async checkpoints. Then a
    second fit resumes from the registered checkpoint and must load the
    params the first one saved. Returns the flash kernels' launches
    counted in the first fit's worker."""
    import shutil

    import ray_tpu_torch as rt
    from ray_tpu_torch import data, train
    from ray_tpu_torch.resilience import latest_registered

    cfg = PRESETS["llama3-1b"]
    n_steps = TRAIN_WARMUP + TRAIN_STEPS + FIT_CKPT_STEPS
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n_steps * TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)
    storage = tempfile.mkdtemp(prefix="train_fit_")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rt.init()
    try:
        gpus = rt.cluster_resources().get("GPU", 0.0)
        if gpus != float(torch.cuda.device_count()) or gpus < 1:
            raise AssertionError(f"node reports GPU {gpus}, the host has "
                                 f"{torch.cuda.device_count()} cards")
        init_s = time.perf_counter() - t0
        ds = data.from_numpy(tokens, column="tokens")
        t1, fit_started_at = time.perf_counter(), time.time()
        result = _fit(FIT_RUN, storage, ds)
        fit_s = time.perf_counter() - t1
        if result.error is not None:
            raise AssertionError(f"fit failed: {result.error}")
        history = result.metrics_history
        final = next(m for m in history if "kernel_launches" in m)
        saves = history[-1]["saves"]
        if final["pid"] == os.getpid():
            raise AssertionError("the train worker runs in the driver")
        if not final["device"].startswith("cuda"):
            raise AssertionError(f"train worker on {final['device']}")
        if not all(math.isfinite(x) for x in final["losses"]):
            raise AssertionError(f"non-finite loss: {final['losses']}")
        launches = {name: final["kernel_launches"][name]
                    for name in FLASH_KERNELS}
        on_route = {flash_kernel_of(step, cfg.dtype)
                    for step in ("fwd", "dq", "dkdv")}
        expected = {name: cfg.n_layers * n_steps if name in on_route else 0
                    for name in FLASH_KERNELS}
        if launches != expected:
            raise AssertionError(f"worker flash launches {launches} != "
                                 f"{expected} ({cfg.n_layers} layers x "
                                 f"{n_steps} steps)")
        entry = latest_registered(FIT_RUN)
        if entry is None or entry["step"] != final["saved_step"]:
            raise AssertionError(f"registered checkpoint {entry}, the last "
                                 f"save was step {final['saved_step']}")
        if any(s["commit_s"] is None for s in saves):
            raise AssertionError(f"a save was not committed: {saves}")
        emit("train_fit", preset="llama3-1b", optimizer="sgd",
             remat_policy="attn", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
             rows=len(tokens), warmup_steps=TRAIN_WARMUP,
             timed_steps=TRAIN_STEPS, ckpt_steps=FIT_CKPT_STEPS,
             init_s=init_s, fit_s=fit_s,
             # fit() to the train_fn's first line: placement, the worker's
             # cold spawn, its shard; then its torch import, and the model's
             # init with CUDA's
             worker_start_s=final["started_at"] - fit_started_at,
             worker_import_s=final["import_s"],
             worker_init_s=final["init_s"],
             worker_pid=final["pid"], driver_pid=os.getpid(),
             worker_device=final["device"],
             worker_device_name=final["device_name"],
             losses=final["losses"], step_s=final["step_s"],
             tokens_per_sec=final["tokens_per_sec"], mfu=final["mfu"],
             median_step_s=float(np.median(
                 final["step_s"][TRAIN_WARMUP:TRAIN_WARMUP + TRAIN_STEPS])),
             ckpt_step_s=final["step_s"][-FIT_CKPT_STEPS:],
             max_memory_allocated_bytes=final["max_memory_allocated_bytes"],
             ckpt_save_block_ms=[s["block_ms"] for s in saves],
             ckpt_commit_s=[s["commit_s"] for s in saves],
             registered=entry, kernel_launches=launches,
             expected_launches=expected,
             train_phase={k: train_stats[k] for k in (
                 "tokens_per_sec", "median_step_s",
                 "max_memory_allocated_bytes")})

        t2 = time.perf_counter()
        again = _fit(FIT_RUN + "_resume", storage, None,
                     resume=train.Checkpoint(entry["path"]))
        if again.error is not None:
            raise AssertionError(f"resumed fit failed: {again.error}")
        got = again.metrics_history[-1]
        if (got["resumed_fingerprint"], got["resumed_step"]) != (
                final["saved_fingerprint"], final["saved_step"]):
            raise AssertionError(f"resumed {got}, saved step "
                                 f"{final['saved_step']} fingerprint "
                                 f"{final['saved_fingerprint']}")
        emit("train_fit_resume", fit_s=time.perf_counter() - t2,
             worker_load_s=got["load_s"], worker_pid=got["pid"],
             resumed_step=got["resumed_step"],
             fingerprint=got["resumed_fingerprint"], equal=True)
    finally:
        try:
            rt.shutdown()
        finally:
            shutil.rmtree(storage, ignore_errors=True)
    deadline = time.monotonic() + 20.0
    while _worker_pids() and time.monotonic() < deadline:
        time.sleep(0.2)
    left = _worker_pids()
    if left:
        raise AssertionError(f"worker processes left after shutdown: {left}")
    emit("train_fit_shutdown", workers_left=0,
         total_s=time.perf_counter() - t0)
    return launches


# ------------------------------------------------------------- train_loop
# The structured step spec (TrainLoopConfig) at train's step: the default
# drive parks data -> step -> ckpt stage actors on a compiled loop over shm
# rings; the same spec with use_compiled_loop=False is the eager drive.
LOOP_WARMUP, LOOP_TIMED = 2, 6
LOOP_LAYERS = 4          # of llama3-1b's 16: the depth cut to fit the limit
LOOP_SNAPSHOT_EVERY = 4
LOOP_CREDITS = 2
LOOP_RUN = "train_loop"
LOOP_RINGS = 4           # driver -> data -> step -> ckpt -> driver
LOOP_MARGIN = 1 << 20    # a slot's room past the packed snapshot message
LOOP_STORE_SLOTS = 2     # packed snapshots the object store holds (eager)


def _loop_fns(cfg, seed: int, kernels: dict) -> tuple:
    """init/data/step functions of the spec, closures pickled by value for
    the stage actors. ``init_fn`` builds ``cfg`` from the seed on the
    card (the step stage's process); ``data_fn`` yields 8 x 2,048 seeded
    tokens a step as numpy (the data stage never touches CUDA);
    ``step_fn`` runs ``train``'s ``_sgd_step`` and reports its loss, its
    process and device, its end time and this process's flash launches
    in the step (``kernels``: ``_kernel_attrs()``)."""

    def init_fn(config):
        import torch

        from ray_tpu_torch.models.llama import init_params

        params = init_params(cfg, torch.Generator("cuda").manual_seed(seed))
        for p in _leaves(params):
            p.requires_grad_()
        return params

    def data_fn(config):
        import numpy as np

        rng = np.random.default_rng(seed)
        return iter([rng.integers(0, cfg.vocab_size, (
            config["batch"], config["seq"])).astype(np.int64)
            for _ in range(config["steps"])])

    def step_fn(params, tokens):
        import os
        import time

        import torch

        from ray_tpu_torch.ops import attention

        counted = {name: getattr(attention, attr)
                   for name, attr in kernels.items()}
        before = {name: k.launches for name, k in counted.items()}
        # the ring's bytes are read-only: copy them into the tensor
        batch = torch.tensor(tokens, device="cuda")
        loss = _sgd_step(params, {"tokens": batch}, cfg, TRAIN_LR)
        return params, {
            "loss": loss.item(), "pid": os.getpid(),
            "device": str(batch.device), "ended_at": time.time(),
            "launches": {name: k.launches - before[name]
                         for name, k in counted.items()}}

    return init_fn, data_fn, step_fn


def _packed_snapshot(cfg, seed: int) -> dict:
    """What the step stage sends down its ring at a snapshot step, made
    here the same way: ``cfg``'s model from the seed on the card, its host
    snapshot (``resilience.checkpoint._snapshot``) in a step message, and
    ``dag.compiled._pack`` of that message. Returns the packed bytes and
    the snapshot's and the pack's seconds; the ring's slots are sized
    from the bytes."""
    from ray_tpu_torch.dag.compiled import _pack
    from ray_tpu_torch.resilience.checkpoint import _snapshot

    params = init_params(cfg, torch.Generator("cuda").manual_seed(seed))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = _snapshot(params)
    t1 = time.perf_counter()
    del params
    torch.cuda.empty_cache()
    message = {"step": LOOP_SNAPSHOT_EVERY - 1,
               "metrics": {"loss": 0.0, "pid": 0, "device": "cuda:0",
                           "ended_at": time.time(),
                           "launches": dict.fromkeys(FLASH_KERNELS, 0)},
               "step_window": (time.time(), time.time()),
               "snapshot": snap, "snapshot_ms": 0.0}
    t2 = time.perf_counter()
    packed = len(_pack(message))
    t3 = time.perf_counter()
    return {"tree_bytes": tree_bytes(snap), "packed_bytes": packed,
            "snapshot_s": t1 - t0, "pack_s": t3 - t2}


def _loop_fit(name: str, storage: str, spec, drive):
    from ray_tpu_torch import train

    return train.DataParallelTrainer(
        spec,
        train_loop_config={"batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                           "steps": LOOP_WARMUP + LOOP_TIMED},
        scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
        run_config=train.RunConfig(name=name, storage_path=storage),
        **({} if drive is None else {"use_compiled_loop": drive})).fit()


def phase_train_loop(seed: int = 0) -> dict:
    """The structured step spec through ``DataParallelTrainer`` at
    llama3-1b's widths and ``LOOP_LAYERS`` of its layers:
    ``TrainLoopConfig`` with no drive argument, whose
    default is the compiled loop (three stage actors parked over shm
    rings, the step stage leased the card), then the same spec with
    ``use_compiled_loop=False``, in turns. Each run takes 2 warm-up and 6
    timed SGD steps and commits snapshots at steps 4 and 8. Checks the
    drive's mode, the step stage in another process on the card with 16
    launches a step of each sm90 flash kernel and 0 simt (counted there),
    bit-equal per-step losses across the drives, two commits each with the
    last registered on the GCS, and no worker left after ``shutdown()``.
    Returns the flash launches of the compiled loop's run."""
    import shutil

    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.resilience import latest_registered

    cfg = dataclasses.replace(PRESETS["llama3-1b"], remat_policy="attn",
                              n_layers=LOOP_LAYERS)
    n_steps = LOOP_WARMUP + LOOP_TIMED
    torch.cuda.empty_cache()
    packed = _packed_snapshot(cfg, seed)
    capacity = packed["packed_bytes"] + LOOP_MARGIN
    storage = tempfile.mkdtemp(prefix="train_loop_")
    on_route = {flash_kernel_of(step, cfg.dtype)
                for step in ("fwd", "dq", "dkdv")}
    expected = {name: cfg.n_layers * n_steps if name in on_route else 0
                for name in FLASH_KERNELS}
    t0 = time.perf_counter()
    # The eager drive hands each step's output to the checkpoint stage
    # through the object store: room for two packed snapshots.
    rt.init(object_store_memory=LOOP_STORE_SLOTS * capacity)
    runs = {}
    try:
        for mode, drive in (("loop", None), ("eager", False)):
            init_fn, data_fn, step_fn = _loop_fns(cfg, seed, _kernel_attrs())
            spec = train.TrainLoopConfig(
                step_fn=step_fn, init_fn=init_fn, data_fn=data_fn,
                num_steps=n_steps, snapshot_every=LOOP_SNAPSHOT_EVERY,
                credits=LOOP_CREDITS, channel_capacity=capacity)
            name = LOOP_RUN if mode == "loop" else f"{LOOP_RUN}_eager"
            t1 = time.perf_counter()
            result = _loop_fit(name, storage, spec, drive)
            fit_s = time.perf_counter() - t1
            if result.error is not None:
                raise AssertionError(f"{mode} fit failed: {result.error}")
            stats = result.loop_stats
            history = result.metrics_history
            if stats["mode"] != mode:
                raise AssertionError(f"drive {stats['mode']}, expected {mode}")
            if len(history) != n_steps:
                raise AssertionError(f"{len(history)} steps reported")
            pids = {m["pid"] for m in history}
            devices = {m["device"] for m in history}
            if len(pids) != 1 or os.getpid() in pids:
                raise AssertionError(f"step stage pids {pids}")
            if not all(d.startswith("cuda") for d in devices):
                raise AssertionError(f"step stage on {devices}")
            launches = {name_: sum(m["launches"][name_] for m in history)
                        for name_ in FLASH_KERNELS}
            if launches != expected:
                raise AssertionError(f"{mode} step-stage flash launches "
                                     f"{launches} != {expected}")
            losses = [m["loss"] for m in history]
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"non-finite loss: {losses}")
            if stats["ckpt_commits"] != n_steps // LOOP_SNAPSHOT_EVERY:
                raise AssertionError(f"{stats['ckpt_commits']} commits")
            entry = latest_registered(name)
            if entry is None or entry["step"] != n_steps - 1:
                raise AssertionError(f"registered checkpoint {entry}")
            ended = [m["ended_at"] for m in history]
            timed_s = ended[-1] - ended[LOOP_WARMUP - 1]
            runs[mode] = {
                "losses": losses, "launches": launches, "fit_s": fit_s,
                "step_pid": pids.pop(),
                "steady_step_wall_us": stats["steady_step_wall_us"],
                "timed_s": timed_s,
                "tokens_per_sec": TRAIN_BATCH * TRAIN_SEQ * LOOP_TIMED
                / timed_s,
                "train_ckpt_overlap_frac": stats["train_ckpt_overlap_frac"],
                "ckpt_save_block_ms": stats["ckpt_save_block_ms"],
                "ckpt_total_s": stats["ckpt_total_s"],
                "ckpt_commits": stats["ckpt_commits"],
                "loop_stall": stats.get("loop_stall"),
                "loop_torn_down_in_s": stats.get("loop_torn_down_in_s"),
                "registered_step": entry["step"]}
            emit("train_loop_drive", mode=mode, **runs[mode])
        if runs["loop"]["losses"] != runs["eager"]["losses"]:
            raise AssertionError(f"loop losses {runs['loop']['losses']} != "
                                 f"eager {runs['eager']['losses']}")
        if not runs["loop"]["loop_stall"] or \
                runs["loop"]["loop_torn_down_in_s"] is None:
            raise AssertionError("the loop drive kept no stall stats")
    finally:
        try:
            rt.shutdown()
        finally:
            shutil.rmtree(storage, ignore_errors=True)
    deadline = time.monotonic() + 20.0
    while _worker_pids() and time.monotonic() < deadline:
        time.sleep(0.2)
    left = _worker_pids()
    if left:
        raise AssertionError(f"worker processes left after shutdown: {left}")
    emit("train_loop", preset="llama3-1b", n_layers=cfg.n_layers,
         optimizer="sgd", lr=TRAIN_LR,
         remat_policy="attn", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         chunk_tokens=TRAIN_CHUNK, warmup_steps=LOOP_WARMUP,
         timed_steps=LOOP_TIMED, snapshot_every=LOOP_SNAPSHOT_EVERY,
         credits=LOOP_CREDITS, channel_capacity=capacity,
         ring_bytes=LOOP_RINGS * LOOP_CREDITS * capacity,
         snapshot_tree_bytes=packed["tree_bytes"],
         snapshot_packed_bytes=packed["packed_bytes"],
         snapshot_s=packed["snapshot_s"], pack_s=packed["pack_s"],
         losses_bit_equal=True, expected_launches=expected,
         object_store_memory=LOOP_STORE_SLOTS * capacity,
         driver_pid=os.getpid(), workers_left=0,
         total_s=time.perf_counter() - t0)
    return runs["loop"]["launches"]


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
def _submit(eng: InferenceEngine, prompts: dict, max_new_tokens: int,
            models: dict | None = None) -> list:
    """Requests made (so stamped with their arrival) and added now;
    ``models`` names each one's LoRA adapter (absent: the base model)."""
    models = models or {}
    reqs = [Request(name, p, max_new_tokens=max_new_tokens,
                    model=models.get(name))
            for name, p in prompts.items()]
    for r in reqs:
        eng.add_request(r)
    return reqs


def _drain(eng: InferenceEngine, reqs: list) -> None:
    while any(not r.done for r in reqs):
        eng.step()


def phase_serve(seed: int = 0) -> tuple[dict, dict]:
    """Returns the paged kernels' launch counts over the served run
    (``n_layers`` a decode step for the kernel ``paged_route`` names for
    bf16, 0 for the other) and the run's TTFT and throughput."""
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
    stats = {"ttft_p50_ms": float(np.median(ttft)),
             "ttft_max_ms": float(max(ttft)), "wall_s": t_end - t0,
             # tokens after each request's first, over the time from the
             # first first-token to the end of the run
             "decode_tok_per_s": (n_tokens - len(reqs)) / (t_end - first_tok),
             "output_tok_per_s": n_tokens / (t_end - t0)}
    emit("serve", preset="llama3-1b", requests=len(reqs),
         output_tokens=n_tokens, setup_s=setup_s, **stats,
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
    return launches, stats


def profile_decode_dispatch(eng: InferenceEngine, rng, cfg) -> None:
    """One pure decode dispatch (8 slots at 512-token contexts, 32 steps)
    under torch.profiler: wall time against the summed device time of its
    kernels gives the card's idle share; the decode kernel's share of the
    device time and the kernels launched per step come with it. Runs after
    the main path's launch count was read."""
    emit("profile", **_profile_dispatch(eng, rng, cfg))


def _ready_dispatch(eng: InferenceEngine, rng, cfg,
                    models: list | None = None) -> list:
    """8 requests of 512-token prompts (``models``: each one's adapter,
    None for the base model), prefilled and given their first tokens, so
    that the engine's next step is one pure 32-step decode dispatch."""
    models = models or [None] * SLOTS
    reqs = _submit(eng, {f"prof{i}": rng.integers(0, cfg.vocab_size,
                                                   512).tolist()
                         for i in range(SLOTS)}, STEPS + 1,
                   {f"prof{i}": m for i, m in enumerate(models)})
    while any(r.first_token_at is None for r in reqs):
        eng.step()            # prefill and the first-token flush
    torch.cuda.synchronize()
    return reqs


def _dispatch_ms(eng: InferenceEngine, rng, cfg,
                 models: list | None = None) -> float:
    """Wall time of one such decode dispatch, without the profiler."""
    reqs = _ready_dispatch(eng, rng, cfg, models)
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    _drain(eng, reqs)
    return ms


def _profile_dispatch(eng: InferenceEngine, rng, cfg,
                      models: list | None = None) -> dict:
    """``profile_decode_dispatch``'s measurement over ``_ready_dispatch``'s
    requests."""
    from torch.profiler import ProfilerActivity, profile

    reqs = _ready_dispatch(eng, rng, cfg, models)
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
    return {"what": "one decode dispatch, 8 slots x 512 context, "
            f"{STEPS} steps", "wall_ms": wall_ms,
            "device_busy_ms": busy_ms if kernels else "not measured",
            "device_idle_frac": (1 - busy_ms / wall_ms if kernels
                                 else "not measured"),
            "decode_kernel_ms": sum(paged_ms.values()),
            "paged_kernel_ms": paged_ms,
            "kernels_per_step": len(kernels) / STEPS}


# ---------------------------------------------------------------- deadline
DEADLINE_NEW = 64
# How far past the moment it is set each running request's deadline lies:
# longer than the gap to the next step's sweep, shorter than one dispatch,
# so it passes inside that step's dispatch and the step after sweeps it.
DEADLINE_AFTER_S = {"pf": 0.002, "mid0": 0.002, "mid1": 0.005,
                    "mid2": 0.010}
RECORDER_TURNS = 3
RECORDER_NEW = 1 + 3 * STEPS     # the first sample, then 3 dispatches


def _deadline_traffic(rng, vocab: int) -> list:
    """(name, prompt, deadline) of the phase's 16 requests: 4 already past
    their deadline, a 2,000-token prompt and 3 short ones whose deadlines
    are set as they run, and 8 with none."""
    past = time.time() - 1.0

    def prompt(n):
        return rng.integers(0, vocab, n).tolist()

    return ([(f"dead{i}", prompt(40 + 10 * i), past) for i in range(4)]
            + [("pf", prompt(2000), None)]
            + [(f"mid{i}", prompt(60 + 20 * i), None) for i in range(3)]
            + [(f"ok{i}", prompt(16 + 24 * i), None) for i in range(8)])


def _held_by_live(reqs) -> int:
    """Pages the requests still running hold (no prefix is shared: the
    prompts are random)."""
    return sum(len(r.block_table) + (r.cow_page is not None)
               for r in reqs if not r.done)


def _recorder_run(eng: InferenceEngine, prompts: list) -> tuple:
    """The recorder turns' traffic on ``eng``: every request's tokens, the
    median wall time of its decode dispatches, and the median host time
    of a dispatch's token emission (``_emit_decode_events``: one
    ``_emit``, and one recorder event, a token)."""
    reqs = _submit(eng, {f"rec{i}": p for i, p in enumerate(prompts)},
                   RECORDER_NEW)
    mix = eng.metrics["engine_step_mix"]
    dispatch_ms, emit_ms = [], []
    emit = eng._emit_decode_events

    def timed_emit(*args):
        t0 = time.perf_counter()
        out = emit(*args)
        emit_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    eng._emit_decode_events = timed_emit
    try:
        while any(not r.done for r in reqs):
            before = mix["decode"] + mix["mixed"]
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            if mix["decode"] + mix["mixed"] > before:
                dispatch_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        del eng._emit_decode_events
    return ([r.generated for r in reqs], float(np.median(dispatch_ms)),
            float(np.median(emit_ms)))


def _add_ns(n: int = 200_000) -> float:
    """One ``RequestTimeline.add`` as the engine calls it for a token."""
    tl = loop_recorder.RequestTimeline()
    t0 = time.perf_counter()
    for i in range(n):
        tl.add(loop_recorder.EV_TOKEN, i)
    return (time.perf_counter() - t0) / n * 1e9


def phase_deadline(seed: int = 0) -> dict:
    """Request deadlines at llama3-1b bf16 in the ``serve`` geometry: 16
    requests of 64 tokens, each under its own trace; 4 expire queued, the
    2,000-token prompt after its first prefill chunk, 3 after their first
    token (their deadlines set between steps), 8 run to their length.
    Every expired request's pages leave the pool's pinned count in the
    tick it expires; the pool ends at its baseline; each expiry dumps a
    timeline that opens at admission and holds the expiry; each served
    request has its prefix-match, prefill and decode spans. Then the
    recorder's cost: the same traffic with the recorder on and stubbed
    off, in turns, with equal tokens. Returns the paged kernels' launch
    counts over the deadline run."""
    cfg = PRESETS["llama3-1b"]
    rng = np.random.default_rng(seed)
    eng = InferenceEngine(
        "llama3-1b", max_slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
        prefill_chunk_size=CHUNK, decode_steps_per_dispatch=STEPS,
        attention_impl="auto", seed=seed)
    baseline = eng.pool_stats()
    reqs = {}
    for name, prompt, deadline in _deadline_traffic(rng, cfg.vocab_size):
        with tracing.span("chip_smoke.request", root=True):
            reqs[name] = Request(name, prompt, max_new_tokens=DEADLINE_NEW,
                                 deadline=deadline)
            eng.add_request(reqs[name])
    live = list(reqs.values())
    mix = eng.metrics["engine_step_mix"]
    ended, dispatch_ms, ticks = {}, [], 0
    reset_paged_launches()
    while any(not r.done for r in live):
        before = mix["decode"] + mix["mixed"]
        t0 = time.perf_counter()
        events = eng.step()
        torch.cuda.synchronize()
        now = time.time()
        if mix["decode"] + mix["mixed"] > before:
            dispatch_ms.append((time.perf_counter() - t0) * 1e3)
        ticks += 1
        for e in events:
            if not e["done"]:
                continue
            ended[e["request_id"]] = now
            r = reqs[e["request_id"]]
            if e["finish_reason"] == "deadline" and (
                    r.slot != -1 or r.block_table or r.cow_page is not None):
                raise AssertionError(f"{r.request_id} expired holding slot "
                                     f"{r.slot}, pages {r.block_table}")
        pinned = eng.pool_stats()["pinned"]
        if pinned != _held_by_live(live):
            raise AssertionError(f"tick {ticks}: {pinned} pages pinned, "
                                 f"{_held_by_live(live)} held by live "
                                 "requests")
        # deadlines set between steps, once each request has got that far
        for name, after_s in DEADLINE_AFTER_S.items():
            r = reqs[name]
            started = (r.prefill_pos > 0 if name == "pf"
                       else r.first_token_at is not None)
            if r.deadline is None and started and not r.done:
                r.deadline = time.time() + after_s
        if ticks > 10_000:
            raise AssertionError("deadline traffic did not drain")
    launches = paged_launches()

    m, stats = eng.metrics, eng.pool_stats()
    finish = {n: (r.finish_reason, len(r.generated)) for n, r in reqs.items()}
    bad = {n: f for n, f in finish.items() if not (
        (n.startswith(("dead", "pf")) and f == ("deadline", 0))
        or (n.startswith("mid") and f[0] == "deadline"
            and 1 <= f[1] < DEADLINE_NEW)
        or (n.startswith("ok") and f == ("length", DEADLINE_NEW)))}
    if bad or not 0 < reqs["pf"].prefill_pos < len(reqs["pf"].prompt):
        raise AssertionError(f"finish reasons {bad}, pf prefilled "
                             f"{reqs['pf'].prefill_pos}")
    for r in reqs.values():
        toks = np.asarray(r.generated, dtype=np.int64)
        if toks.size and (toks.min() < 0 or toks.max() >= cfg.vocab_size):
            raise AssertionError(f"{r.request_id}: bad output {r.generated}")
    counters = (m["deadline_expired_queued"], m["deadline_expired_running"],
                m["timeline_dumps"])
    if counters != (4, 4, 8):
        raise AssertionError(f"deadline counters {counters} != (4, 4, 8)")
    if not (stats["pinned"] == 0 and stats["active_slots"] == 0
            and stats["free"] + stats["cached"]
            == baseline["free"] + baseline["cached"]):
        raise AssertionError(f"pool {stats} against baseline {baseline}")
    on_route = paged_kernel_of(cfg.dtype)
    expected = {name: cfg.n_layers * m["decode_steps"] if name == on_route
                else 0 for name in PAGED_KERNELS}
    if launches != expected or m["decode_steps"] == 0:
        raise AssertionError(f"deadline launches {launches} != {expected}")
    # the dumps: one per expiry, each opening at admission
    dumps = {s["attrs"]["request_id"]: s["attrs"] for s in
             tracing.local_spans() if s["name"] == "llm.request_timeline"
             and s["attrs"]["request_id"] in reqs}
    expired = sorted(n for n, f in finish.items() if f[0] == "deadline")
    for name in expired:
        attrs = dumps.get(name)
        names = [e["ev"] for e in attrs["events"]] if attrs else []
        if not (names and names[0] == "admit"
                and "deadline_expired" in names
                and attrs["reason"] == "deadline"):
            raise AssertionError(f"{name}: timeline dump {names}")
    if sorted(dumps) != expired:
        raise AssertionError(f"dumps {sorted(dumps)} != {expired}")
    # the spans of every request that ran
    for name, r in reqs.items():
        got = {s["name"] for s in tracing.local_spans(r.trace["trace_id"])}
        want = {"chip_smoke.request"}
        if not name.startswith("dead"):
            want |= {"llm.prefix_match", "llm.decode"}
        if name.startswith(("mid", "ok")):
            want.add("llm.prefill")
        if not want <= got:
            raise AssertionError(f"{name}: spans {sorted(got)}, missing "
                                 f"{sorted(want - got)}")
    # overshoot of each running expiry: to its sweep (the pages freed, the
    # timeline's expiry time) and to the step that returned its event
    running = [reqs[n] for n in DEADLINE_AFTER_S]
    to_sweep = [(next(e["t"] for e in r.timeline.events()
                      if e["ev"] == "deadline_expired") - r.deadline) * 1e3
                for r in running]
    to_event = [(ended[r.request_id] - r.deadline) * 1e3 for r in running]
    emit("deadline", preset="llama3-1b", requests=len(reqs), ticks=ticks,
         finish=finish, deadline_expired_queued=counters[0],
         deadline_expired_running=counters[1], timeline_dumps=counters[2],
         pool=stats, pool_baseline=baseline,
         kernel_launches=launches, expected_launches=expected,
         decode_steps=m["decode_steps"], engine_step_mix=mix,
         overshoot_to_event_ms={"p50": float(np.median(to_event)),
                                "max": float(max(to_event)),
                                "each": to_event},
         overshoot_to_sweep_ms={"p50": float(np.median(to_sweep)),
                                "max": float(max(to_sweep)),
                                "each": to_sweep},
         dispatch_wall_ms={"p50": float(np.median(dispatch_ms)),
                           "max": float(max(dispatch_ms)),
                           "n": len(dispatch_ms)},
         breach_samples=[{k: row[k] for k in ("request_id", "reason",
                                               "n_events")}
                         for row in eng.breach_samples()])
    _recorder_turns(eng, rng, cfg)
    del eng
    torch.cuda.empty_cache()
    return launches


def _recorder_turns(eng: InferenceEngine, rng, cfg) -> None:
    """The flight recorder's cost: one traffic (8 requests of 256-token
    prompts, 97 tokens each) served with the recorder on and with
    ``RequestTimeline.add`` stubbed out, each turn on/off/off/on (a drift
    of the host's speed within a turn cancels), on an engine without a
    prefix cache sharing the weights, so every run has the same shapes
    and gives the same tokens."""
    twin = InferenceEngine(
        "llama3-1b", eng.executor.params, max_slots=SLOTS, max_len=MAX_LEN,
        page_size=PAGE, prefill_chunk_size=CHUNK,
        decode_steps_per_dispatch=STEPS, attention_impl="auto",
        enable_prefix_cache=False)
    prompts = [rng.integers(0, cfg.vocab_size, 256).tolist()
               for _ in range(SLOTS)]
    add = loop_recorder.RequestTimeline.add
    runs = {"on": [], "off": []}
    emits = {"on": [], "off": []}
    tokens = []
    try:
        for _ in range(RECORDER_TURNS):
            for mode in ("on", "off", "off", "on"):
                loop_recorder.RequestTimeline.add = (
                    add if mode == "on" else lambda *a, **k: None)
                toks, ms, emit_ms = _recorder_run(twin, prompts)
                runs[mode].append(ms)
                emits[mode].append(emit_ms)
                tokens.append(toks)
    finally:
        loop_recorder.RequestTimeline.add = add
    same = all(t == tokens[0] for t in tokens)
    on, off = (np.reshape(runs[m], (RECORDER_TURNS, 2)).sum(axis=1)
               for m in ("on", "off"))
    fracs = ((on - off) / off).tolist()
    emit("recorder", preset="llama3-1b", turns=RECORDER_TURNS,
         requests=SLOTS, new_tokens=RECORDER_NEW,
         dispatch_ms_on=runs["on"], dispatch_ms_off=runs["off"],
         recorder_overhead_frac=float(np.median(fracs)),
         overhead_frac_each=fracs,
         # the host time of a dispatch's token emission, where the
         # recorder's per-token event is stored
         emit_ms_on=emits["on"], emit_ms_off=emits["off"],
         recorder_emit_ms=float(np.median(emits["on"])
                                - np.median(emits["off"])),
         add_ns=_add_ns(), events_per_dispatch=SLOTS * STEPS,
         tokens_equal=same)
    if not same:
        raise AssertionError("tokens differ between recorder on and off")
    del twin


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


# -------------------------------------------------------------------- lora
LORA_RANK = 16
# A bf16 stack decode step at llama3-1b against f32 merged weights (W +
# A·B), relative Frobenius over the 8 rows of its logits and of the K and
# V rows it writes: the bf16 route's own rounding over 16 layers stays
# inside it, while one row's delta lost or taken from another slot (of
# the order of 1 relative on that row at these adapters' scale, so about
# 0.35 over 8 rows) does not.
LORA_BF16_STEP_TOL = 1e-1


def write_adapters(cfg, names, directory: str, seed: int) -> None:
    """ray_tpu/_tenancy_bench.py's random adapters (scale 0.5, A over
    sqrt(E_in)) at rank 16, one .npz each, from a numpy seed."""
    rng = np.random.default_rng(seed)
    for name in names:
        arrays = {}
        for p, (ein, eout) in proj_dims(cfg).items():
            arrays[f"{p}.A"] = rng.standard_normal(
                (cfg.n_layers, ein, LORA_RANK), np.float32) * (0.5 / ein ** 0.5)
            arrays[f"{p}.B"] = rng.standard_normal(
                (cfg.n_layers, LORA_RANK, eout), np.float32) * 0.5
        save_adapter(os.path.join(directory, f"{name}.npz"), arrays)


def _merged(params: dict, stack: dict, slot: int, cfg, dtype) -> dict:
    """The params in ``dtype`` with stack slot ``slot``'s adapter merged
    in: W + A·B for wq, wk, wv and wo, the product taken in ``dtype``."""
    L, E, D = cfg.n_layers, cfg.hidden, cfg.head_dim
    shapes = {"wq": (L, E, cfg.n_heads, D), "wk": (L, E, cfg.n_kv_heads, D),
              "wv": (L, E, cfg.n_kv_heads, D), "wo": (L, cfg.n_heads, D, E)}
    layers = dict(params["layers"])
    for p, shape in shapes.items():
        ab = torch.bmm(stack[f"{p}.A"][:, slot].to(dtype),
                       stack[f"{p}.B"][:, slot].to(dtype))
        layers[p] = layers[p] + ab.reshape(shape)
    return {**params, "layers": layers}


def stack_step_check(params, stack, slots: list, cfg, page: int, pos: list,
                     seed: int, ref_dtype) -> dict:
    """One paged decode step of a batch whose row i runs on stack slot
    ``slots[i]`` (0 = base), on random pages, against each row's step on
    merged weights (W + A·B, built and run in ``ref_dtype`` on the dense
    route, so the reference launches no kernel). Compares the logits and
    the K and V rows the step writes at ``pos`` in every layer (one step
    over a long random context hides a k or v delta in the logits; the
    written rows show it). Returns, for each of the three, the relative
    Frobenius error of the stack step over every row and that of the
    step without the stack over the adapter rows (what a lost delta would
    read); and whether the base rows equal the step without the stack."""
    torch.backends.cuda.matmul.allow_tf32 = False
    n, max_pages = len(slots), -(-(max(pos) + 1) // page)
    pool = init_pages(cfg, n + n * max_pages, page, DEVICE)
    gen = torch.Generator(DEVICE).manual_seed(seed)
    for t in pool.values():
        t.normal_(generator=gen)
    tables = torch.arange(n, n + n * max_pages, dtype=torch.int32,
                          device=DEVICE).reshape(n, max_pages)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=DEVICE)
    tokens = torch.tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, n), dtype=torch.int32, device=DEVICE)
    rows = torch.arange(n, device=DEVICE)
    written = (tables[rows, pos_t // page].long(), (pos_t % page).long())
    bucket = LocalEngineExecutor._bucket_pages

    def step(p, c, paged: bool, **lora) -> dict:
        live = bucket(-(-max(pos) // page) if paged
                      else max(pos) // page + 1, max_pages)
        pages = {k: v.to(c.dtype, copy=True) for k, v in pool.items()}
        logits = decode_step(p, pages, tables, tokens, pos_t, c, page,
                             paged=paged, live_pages=live, **lora)[0]
        # [n, L, KH, D] (the indexed dims lead): each row's fresh K/V in
        # every layer
        return {"logits": logits.double(),
                **{kv: pages[kv][:, written[0], :, written[1]].double()
                   for kv in ("k", "v")}}

    got = step(params, cfg, True, lora=stack, lora_idx=torch.tensor(
        slots, dtype=torch.int32, device=DEVICE))
    plain = step(params, cfg, True)
    ref_cfg = dataclasses.replace(cfg, dtype=ref_dtype)
    ref_params = {k: (v.to(ref_dtype) if torch.is_tensor(v)
                      else {n_: w.to(ref_dtype) for n_, w in v.items()})
                  for k, v in params.items()}
    want = {}
    for i, s in enumerate(slots):
        ref = step(_merged(ref_params, stack, s, cfg, ref_dtype), ref_cfg,
                   False)
        for key, t in ref.items():
            want.setdefault(key, []).append(t[i])
    want = {key: torch.stack(t) for key, t in want.items()}
    del ref_params
    ad = [i for i, s in enumerate(slots) if s]
    base = [i for i, s in enumerate(slots) if not s]

    def rel(a, b):
        return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()
    return {"rel_frobenius_err": {k: rel(got[k], want[k]) for k in want},
            "rel_frobenius_err_without_deltas": {
                k: rel(plain[k][ad], want[k][ad]) for k in want},
            "base_rows_equal_no_stack": all(
                bool((got[k][base] == plain[k][base]).all()) for k in want)}


def phase_lora_parity(seed: int = 3) -> dict:
    """f32 multi-LoRA serving at llama3-1b widths, 2 layers, page 16,
    rank-16 adapters: the base model and three adapters decoding in one
    batch give exactly the tokens of the same requests served one by one;
    one decode step with the stack (slots on the base model and the three
    adapters) is within 1e-4 relative (Frobenius) of the same step on
    each slot's merged weights, in its logits and its written K/V
    (``stack_step_check``). Returns the paged kernels' launch counts
    over the batch (the f32 route's single kernel only)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(PRESETS["llama3-1b"], n_layers=2,
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator(DEVICE).manual_seed(seed))
    rng = np.random.default_rng(seed)
    prompts = {f"p{i}": rng.integers(0, cfg.vocab_size, n).tolist()
               for i, n in enumerate((5, 37, 70, 131))}
    models = {"p1": "a1", "p2": "a2", "p3": "a3"}
    with tempfile.TemporaryDirectory() as lora_dir:
        write_adapters(cfg, ("a1", "a2", "a3"), lora_dir, seed)

        def engine():
            return InferenceEngine(
                cfg, params, max_slots=4, max_len=256, page_size=SPEC_PAGE,
                prefill_chunk_size=64, decode_steps_per_dispatch=8,
                attention_impl="paged", enable_prefix_cache=False,
                lora_config=LoRAServingConfig(
                    max_loras=4, max_rank=LORA_RANK,
                    dynamic_lora_loading_path=lora_dir))

        eng = engine()
        reset_paged_launches()
        reqs = _submit(eng, prompts, 24, models)
        _drain(eng, reqs)
        torch.cuda.synchronize()
        launches = paged_launches()
        expected = _expected_paged(eng, cfg)
        batch = [r.generated for r in reqs]
        alone, base = [], []
        one = engine()
        for name, p in prompts.items():
            for out, m in ((alone, models), (base, {})):
                r = _submit(one, {name: p}, 24, m)[0]
                _drain(one, [r])
                out.append(r.generated)
        # One decode step with the stack against merged weights.
        step = stack_step_check(
            params, eng.executor.lora_stack,
            [0] + [eng.lora_manager.resident()[a] for a in ("a1", "a2", "a3")],
            cfg, SPEC_PAGE, [200, 37, 131, 5], seed, torch.float32)
    same = batch == alone
    changed = sum(a != b for a, b in zip(alone[1:], base[1:]))
    emit("lora_parity", dtype="float32", layers=2, page=SPEC_PAGE,
         rank=LORA_RANK, requests=len(batch), tokens_per_request=24,
         models=[models.get(k) for k in prompts], batch_equals_one_by_one=same,
         adapter_requests_differing_from_base=changed,
         decode_step=step, tolerance=1e-4, kernel_launches=launches,
         expected_launches=expected, decode_steps=eng.metrics["decode_steps"],
         adapter_stats=eng.lora_manager.stats())
    if not same:
        raise AssertionError(f"lora_parity: batch {batch} != one by one "
                             f"{alone}")
    if changed < 3:
        raise AssertionError("lora_parity: the adapters change no tokens")
    _check_stack_step("lora_parity", step, 1e-4)
    if launches != expected or eng.metrics["decode_steps"] == 0:
        raise AssertionError(f"lora_parity: launches {launches} != "
                             f"{expected}")
    del params, eng, one
    torch.cuda.empty_cache()
    return launches


def _check_stack_step(phase: str, step: dict, tol: float) -> None:
    """The stack step's logits and written K/V sit within ``tol`` of
    merged weights, those of the step without the deltas do not (so a
    lost delta would fail), and the base rows are those of the step
    without the stack."""
    if not max(step["rel_frobenius_err"].values()) <= tol:
        raise AssertionError(f"{phase}: stack step {step} > {tol} from "
                             "merged weights")
    if not min(step["rel_frobenius_err_without_deltas"].values()) > tol:
        raise AssertionError(f"{phase}: the deltas move the step by no more "
                             f"than {tol}: {step}")
    if not step["base_rows_equal_no_stack"]:
        raise AssertionError(f"{phase}: the base slot moved under a stack")


# The lora_serve traffic: 8 requests of the serve geometry over the base
# model and four adapters, in two waves so that prompts arrive while
# others decode (base prompts ride mixed dispatches, adapter prompts
# prefill on their own); the fifth adapter's request comes once the first
# wave is done, while the second wave pins all four adapters.
LORA_WAVES = ({"w0": (16, None), "w1": (40, "a1"), "w2": (77, None)},
              {"w3": (120, "a2"), "w4": (160, "a3"), "w5": (200, "a4"),
               "w6": (64, "a1"), "w7": (96, None)})
LORA_LATE = {"late": (50, "a5")}


def _lora_serve_run(params, cfg, lora_dir: str | None, rename, seed: int):
    """One run of the lora_serve traffic; ``rename`` maps each adapter
    name to the one this run uses (None: the base model), and
    ``lora_dir`` None runs without a lora_config. Returns (engine,
    requests, result)."""
    rng = np.random.default_rng(seed)
    lora = (LoRAServingConfig(max_loras=4, max_rank=LORA_RANK,
                              dynamic_lora_loading_path=lora_dir)
            if lora_dir else None)
    eng = InferenceEngine(
        cfg, params, max_slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
        prefill_chunk_size=CHUNK, decode_steps_per_dispatch=STEPS,
        attention_impl="auto", seed=seed, lora_config=lora)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resting = torch.cuda.memory_allocated()

    def submit(wave):
        prompts = {k: rng.integers(0, cfg.vocab_size, n).tolist()
                   for k, (n, _) in wave.items()}
        return _submit(eng, prompts, 64,
                       {k: rename(m) for k, (_, m) in wave.items()})

    reset_paged_launches()
    t0 = time.monotonic()
    wave1 = submit(LORA_WAVES[0])
    while any(r.first_token_at is None for r in wave1):
        eng.step()
    wave2 = submit(LORA_WAVES[1])
    _drain(eng, wave1)
    eight = wave1 + wave2
    late = submit(LORA_LATE)
    dispatches_eight = None
    while any(not r.done for r in eight + late):
        eng.step()
        if dispatches_eight is None and all(r.done for r in eight):
            dispatches_eight = eng.metrics["decode_dispatches"]
    torch.cuda.synchronize()
    t_end = time.monotonic()
    launches = paged_launches()
    reqs = eight + late
    n_tok = sum(len(r.generated) for r in reqs)
    first = min(r.first_token_at for r in reqs)
    ttft = [(r.first_token_at - r.arrived_at) * 1e3 for r in reqs]
    m = eng.metrics
    out = {"requests": len(reqs), "output_tokens": n_tok,
           "wall_s": t_end - t0,
           "decode_tok_per_s": (n_tok - len(reqs)) / (t_end - first),
           "output_tok_per_s": n_tok / (t_end - t0),
           "ttft_p50_ms": float(np.median(ttft)),
           "ttft_max_ms": float(max(ttft)),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           # weights, pool and (with LoRA) the stack, before the traffic
           "memory_allocated_at_start_bytes": resting,
           "kernel_launches": launches,
           "expected_launches": _expected_paged(eng, cfg),
           "decode_steps": m["decode_steps"],
           "decode_dispatches": m["decode_dispatches"],
           "decode_dispatches_first_eight": dispatches_eight,
           "engine_step_mix": dict(m["engine_step_mix"]),
           "decode_stall_steps": m["decode_stall_steps"],
           "adapter_defers": m["adapter_defers"],
           "finish_reasons": sorted({r.finish_reason for r in reqs})}
    for r in reqs:
        toks = np.asarray(r.generated)
        if (len(toks) != 64 or r.finish_reason != "length"
                or toks.min() < 0 or toks.max() >= cfg.vocab_size):
            raise AssertionError(f"lora_serve {r.request_id} ({r.model}): "
                                 f"{r.finish_reason}, {r.generated}")
    if eng.lora_manager is not None:
        out["adapter_stats"] = eng.lora_manager.stats()
        out["adapter_hot_load_ms"] = out["adapter_stats"]["avg_load_ms"]
    return eng, reqs, out


def phase_lora_serve(seed: int = 0) -> dict:
    """The LoRA serve path at llama3-1b bf16 (see LORA_WAVES), beside the
    same traffic on one adapter and with no lora_config; then one decode
    dispatch of the LoRA and the no-LoRA engine under torch.profiler, and
    one of each without it, in turns. Returns the paged kernels' launch
    counts over the LoRA run."""
    cfg = PRESETS["llama3-1b"]
    params = init_params(cfg, torch.Generator(DEVICE).manual_seed(seed))
    runs, tokens, engines, prof_models = {}, {}, {}, {}
    rename = {"lora": lambda m: m, "one_adapter": lambda m: m and "a1",
              "no_lora": lambda m: None}
    with tempfile.TemporaryDirectory() as lora_dir:
        t0 = time.perf_counter()
        write_adapters(cfg, ("a1", "a2", "a3", "a4", "a5"), lora_dir, seed)
        write_s = time.perf_counter() - t0
        for name in ("lora", "one_adapter", "no_lora"):
            eng, reqs, runs[name] = _lora_serve_run(
                params, cfg, None if name == "no_lora" else lora_dir,
                rename[name], seed)
            tokens[name] = {r.request_id: r.generated for r in reqs}
            del eng
            torch.cuda.empty_cache()
        # Fresh engines of the run's geometry for the dispatch measurements:
        # half the slots on the base model, half on adapters a1..a4.
        for name in ("lora", "no_lora"):
            engines[name] = InferenceEngine(
                cfg, params, max_slots=SLOTS, max_len=MAX_LEN,
                page_size=PAGE, prefill_chunk_size=CHUNK,
                decode_steps_per_dispatch=STEPS, seed=seed,
                lora_config=LoRAServingConfig(
                    max_loras=4, max_rank=LORA_RANK,
                    dynamic_lora_loading_path=lora_dir)
                if name == "lora" else None)
            prof_models[name] = [rename[name](f"a{i // 2 + 1}") if i % 2
                                 else None for i in range(SLOTS)]
            runs[name]["profile"] = _profile_dispatch(
                engines[name], np.random.default_rng(seed), cfg,
                prof_models[name])
            runs[name]["profile"]["models"] = prof_models[name]
        # The LoRA engine on all-base slots skips the LoRA terms: the
        # no-LoRA engine's kernels a step.
        runs["lora"]["profile_all_base"] = _profile_dispatch(
            engines["lora"], np.random.default_rng(seed), cfg)
        dispatch_ms = {"lora": [], "no_lora": []}
        for name in ("no_lora", "lora", "lora", "no_lora"):
            dispatch_ms[name].append(_dispatch_ms(
                engines[name], np.random.default_rng(seed), cfg,
                prof_models[name]))
        # One bf16 decode step with the engine's stack (a1..a4 resident)
        # against merged weights in f32.
        resident = engines["lora"].lora_manager.resident()
        step = stack_step_check(
            params, engines["lora"].executor.lora_stack,
            [resident[m] if m else 0 for m in prof_models["lora"]], cfg,
            PAGE, [511, 37, 200, 1000, 5, 300, 64, 700], seed, torch.float32)
        del engines
        torch.cuda.empty_cache()
    lora = runs["lora"]
    # requests whose tokens differ from the no-lora run's, by what the
    # lora run served them with
    kinds = {k: m for w in (*LORA_WAVES, LORA_LATE) for k, (_, m) in w.items()}
    adapter_reqs = [k for k, m in kinds.items() if m]
    differing = {kind: sum(tokens["lora"][k] != tokens["no_lora"][k]
                           for k, m in kinds.items() if bool(m) != base)
                 for kind, base in (("adapter", False), ("base", True))}
    emit("lora_serve", preset="llama3-1b", dtype="bfloat16", slots=SLOTS,
         max_len=MAX_LEN, page=PAGE, chunk=CHUNK, steps=STEPS,
         max_loras=4, rank=LORA_RANK, new_tokens=64,
         adapter_write_s=write_s,
         traffic=kinds,
         runs=runs,
         # one 32-step decode dispatch at 8 x 512 context without the
         # profiler, the two engines in turns
         dispatch_ms=dispatch_ms,
         dispatch_ms_ratio=float(np.median(dispatch_ms["lora"])
                                 / np.median(dispatch_ms["no_lora"])),
         differing_from_no_lora=differing,
         adapter_requests=len(adapter_reqs), decode_step=step,
         tolerance=LORA_BF16_STEP_TOL)
    if differing["adapter"] != len(adapter_reqs):
        raise AssertionError(
            f"lora_serve: {len(adapter_reqs) - differing['adapter']} "
            "adapter requests gave the no-LoRA run's tokens")
    _check_stack_step("lora_serve", step, LORA_BF16_STEP_TOL)
    if lora["kernel_launches"] != lora["expected_launches"]:
        raise AssertionError(f"lora_serve: launches {lora['kernel_launches']}"
                             f" != {lora['expected_launches']}")
    if lora["adapter_defers"] < 1:
        raise AssertionError("lora_serve: the fifth adapter was not deferred")
    if (lora["decode_dispatches_first_eight"]
            != runs["one_adapter"]["decode_dispatches_first_eight"]):
        raise AssertionError(
            f"lora_serve: {lora['decode_dispatches_first_eight']} decode "
            f"dispatches for four adapters against "
            f"{runs['one_adapter']['decode_dispatches_first_eight']} for one")
    del params
    torch.cuda.empty_cache()
    return lora["kernel_launches"]


# ----------------------------------------------------------------- migrate
MIG_PARITY_PAGE, MIG_PARITY_NEW = 16, 8
# The migration bench's geometry (ray_tpu/_migration_bench.py:
# _raw_transfer_mb_s): a 2,048-token prompt, pages of 64, prefill chunks
# of 256, 2 slots; max_len = prompt + 128 so the migrated prompt can decode.
MIG_PROMPT, MIG_NEW = 2048, 32
MIG_MAX_LEN = MIG_PROMPT + 128
# demotion must free at least this share of the weights' bytes
WEIGHTS_FREED_FRAC = 0.99


def _prefill_only(eng: InferenceEngine, prompt: list) -> Request:
    r = Request("src", list(prompt), max_new_tokens=1, prefill_only=True,
                pin_for_export=True)
    eng.add_request(r)
    _drain(eng, [r])
    if r.finish_reason != "prefilled" or r.generated or not r.export_pinned:
        raise AssertionError(f"prefill_only: {r.finish_reason} "
                             f"{r.generated} {r.export_pinned}")
    return r


def _serve_one(eng: InferenceEngine, prompt: list, n: int) -> Request:
    [r] = _submit(eng, {f"q{time.perf_counter_ns()}": list(prompt)}, n)
    _drain(eng, [r])
    return r


def _held(eng: InferenceEngine) -> dict:
    """Pages the engine's allocator holds a ref on."""
    return {p: c for p, c in eng.allocator.refcount.items() if c}


def _reusable(eng: InferenceEngine) -> int:
    a = eng.allocator
    return len(a.free) + sum(1 for p in a.page_hash
                             if not a.refcount.get(p, 0))


def _check_stream(what: str, stats: dict, eng: InferenceEngine,
                  covered: int) -> None:
    """An expected migration: complete, every token covered, no cold
    fallback."""
    if not (stats["status"] == "ok" and stats["complete"]
            and stats["cached_tokens"] == covered
            and eng.metrics["kv_import_failures"] == 0):
        raise AssertionError(f"{what}: {stats}, import failures "
                             f"{eng.metrics['kv_import_failures']}, "
                             f"expected {covered} tokens")


def _pages_equal(a: InferenceEngine, ids_a, b: InferenceEngine,
                 ids_b) -> bool:
    ia = torch.tensor(ids_a, device=DEVICE)
    ib = torch.tensor(ids_b, device=DEVICE)
    return all(torch.equal(a.executor.pages[n][:, ia],
                           b.executor.pages[n][:, ib]) for n in ("k", "v"))


def _sum_expected(engines: list, cfg) -> dict:
    total = {name: 0 for name in PAGED_KERNELS}
    for eng in engines:
        for name, n in _expected_paged(eng, cfg).items():
            total[name] += n
    return total


def _death_live(engine, prompt: list, ps: int) -> tuple:
    """A live source that dies after 2 chunks while its request is still
    prefilling (this thread steps the engine, so the order is fixed).
    Returns (source engine, importer stats, importer engine, whether the
    request was still prefilling when the source died)."""
    a = engine(prefill_chunk_size=ps)
    r = Request("src", list(prompt), max_new_tokens=1, prefill_only=True,
                pin_for_export=True)
    a.add_request(r)
    src = KVMigrationSource(a, r, chunk_pages=1, _die_after_chunks=2)
    c = engine()
    got = {}
    reader = threading.Thread(target=lambda: got.update(
        receive_kv_stream(c, src.address, timeout_s=30)))
    reader.start()
    deadline = time.monotonic() + 30
    while not (src.stats["bytes"] and not src._server.occupancy()):
        if time.monotonic() > deadline:
            raise AssertionError("migrate_parity: the reader never connected")
        time.sleep(0.005)
    while r.prefill_pos < 2 * ps:
        a.step()
    src.join(timeout=30)
    reader.join(timeout=30)
    mid_prefill = not r.done
    _drain(a, [r])
    return a, got, c, mid_prefill


def _wire_parts(before: list, after: list, n: int = 5) -> dict:
    """Host ms of each part of one message's way over the loop wire, timed
    alone: the named steps ``before``, the wire (the message written to a
    loopback server and read back by one reader), then ``after``, each
    fed the previous one's result, a synchronize around each; the median
    of ``n`` runs of each part, and their sum."""
    server = TcpLoopServer(n_slots=8)
    reader = TcpLoopReader(server.address)
    wire = ("wire", lambda blob: (server.write(blob), reader.read())[1])
    times: dict = {}
    try:
        for _ in range(n):
            x = None
            for name, fn in before + [wire] + after:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                x = fn(x)
                torch.cuda.synchronize()
                times.setdefault(name, []).append(
                    (time.perf_counter() - t0) * 1e3)
    finally:
        reader.close()
        server.close()
    med = {name: float(np.median(v)) for name, v in times.items()}
    return {**med, "sum": sum(med.values())}


def phase_migrate_parity(seed: int = 4) -> dict:
    """f32 KV migration at llama3-1b widths and 2 layers (page 16, the
    single kernel, 8 greedy tokens a request): the export/import round
    trip, the live stream, source death after 2 chunks (live and static),
    the host-RAM tier and an import under pool pressure; every request's
    tokens must equal a cold dense engine's. Returns the paged kernels'
    launch counts over the paged engines."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(PRESETS["llama3-1b"], n_layers=2,
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator(DEVICE).manual_seed(seed))
    rng = np.random.default_rng(seed)
    ps, n = MIG_PARITY_PAGE, MIG_PARITY_NEW
    geo = dict(max_slots=2, max_len=256, page_size=ps,
               prefill_chunk_size=32, decode_steps_per_dispatch=8)
    paged = []

    def engine(**kw):
        eng = InferenceEngine(cfg, params, attention_impl="paged",
                              **{**geo, **kw})
        paged.append(eng)
        return eng

    cold_eng = InferenceEngine(cfg, params, attention_impl="dense", **geo)
    memo = {}

    def cold(prompt):
        if tuple(prompt) not in memo:
            memo[tuple(prompt)] = cold_eng.generate(list(prompt), n)
        return memo[tuple(prompt)]

    def prompt(k):
        return rng.integers(0, cfg.vocab_size, k).tolist()

    p = prompt(4 * ps + 7)    # 4 full pages and a 7-row tail
    cases = {}
    reset_paged_launches()

    # 1. round trip through one payload
    a = engine()
    r = _prefill_only(a, p)
    payload = a.export_prefix_kv(p)
    b = engine()
    covered = b.import_prefix_kv(payload)
    plan_a, plan_b = a.pin_prefix_for_export(p), b.pin_prefix_for_export(p)
    equal_pages = _pages_equal(a, plan_a["page_ids"], b, plan_b["page_ids"])
    a.release_export_pages(plan_a["page_ids"])
    b.release_export_pages(plan_b["page_ids"])
    rb = _serve_one(b, p, n)
    div = p[:4 * ps + 4] + prompt(3)   # leaves the tail after 4 rows
    rc = _serve_one(b, div, n)
    before = _reusable(b)
    dup = b.import_prefix_kv(a.export_prefix_kv(p))
    a.release_export_pins(r)
    cases["round_trip"] = {
        "covered": covered, "pages": int(payload["k"].shape[1]),
        "pages_equal": equal_pages, "cached": rb.cached_prefix_tokens,
        "tokens_equal_cold": rb.generated == cold(p),
        "divergent_cached": rc.cached_prefix_tokens,
        "divergent_equal_cold": rc.generated == cold(div),
        "cow_forks": b.metrics["cow_forks"],
        "duplicate_covered": dup, "duplicate_leaked_pages":
            before - _reusable(b),
        "import_failures": b.metrics["kv_import_failures"],
        "source_pins_left": len(_held(a))}
    c = cases["round_trip"]
    if not (c["covered"] == c["duplicate_covered"] == len(p) - 1
            and c["pages_equal"] and c["cached"] == len(p) - 1
            and c["tokens_equal_cold"] and c["divergent_equal_cold"]
            and c["divergent_cached"] == 4 * ps + 4 and c["cow_forks"] >= 1
            and c["duplicate_leaked_pages"] == 0
            and c["import_failures"] == 0 and c["source_pins_left"] == 0):
        raise AssertionError(f"migrate_parity round trip: {c}")

    # 2. the live stream, one page a chunk, while the source prefills
    a = engine(prefill_chunk_size=ps)
    r = Request("src", list(p), max_new_tokens=1, prefill_only=True,
                pin_for_export=True)
    a.add_request(r)
    src = KVMigrationSource(a, r, chunk_pages=1)
    stepper = threading.Thread(target=_drain, args=(a, [r]))
    stepper.start()
    b = engine()
    stats = receive_kv_stream(b, src.address, timeout_s=60)
    stepper.join(timeout=60)
    src.close()
    _check_stream("migrate_parity live", stats, b, len(p))
    rb = _serve_one(b, p, n)
    cases["live"] = {**stats, "chunks": src.stats["chunks"],
                     "cached": rb.cached_prefix_tokens,
                     "tokens_equal_cold": rb.generated == cold(p),
                     "source_pins_left": len(_held(a))}
    if not (rb.generated == cold(p) and rb.cached_prefix_tokens == len(p) - 1
            and not _held(a) and src.stats["chunks"] == 4):
        raise AssertionError(f"migrate_parity live: {cases['live']}")

    # 3. source death after 2 chunks, live and static
    a, stats, c_eng, mid = _death_live(engine, p, ps)
    rc = _serve_one(c_eng, p, n)
    cases["death_live"] = {
        **stats, "died_mid_prefill": mid, "cached": rc.cached_prefix_tokens,
        "tokens_equal_cold": rc.generated == cold(p),
        "source_pins_left": len(_held(a))}
    a = engine()
    a.generate(p, 1)
    src = KVMigrationSource.for_cached_prefix(a, p, chunk_pages=1,
                                              _die_after_chunks=2)
    c_eng = engine()
    stats = receive_kv_stream(c_eng, src.address, timeout_s=30)
    src.join(timeout=30)
    rc = _serve_one(c_eng, p, n)
    cases["death_static"] = {
        **stats, "cached": rc.cached_prefix_tokens,
        "tokens_equal_cold": rc.generated == cold(p),
        "source_pins_left": len(_held(a))}
    for name in ("death_live", "death_static"):
        c = cases[name]
        if not (not c["complete"] and 0 < c["cached_tokens"] < len(p) - 1
                and c["cached"] == c["cached_tokens"]
                and c["tokens_equal_cold"] and c["source_pins_left"] == 0
                and c.get("died_mid_prefill", True)):
            raise AssertionError(f"migrate_parity {name}: {c}")

    # 4. the host tier: a pool of 4 pages, 8 host pages
    h = engine(num_pages=4, host_kv_cache_pages=8)
    x = prompt(2 * ps + 1)
    h.generate(x, 1)
    chain = h._chain_hashes(x)[1][:2]
    kept = h.executor.export_pages(h.allocator.match_prefix(chain))
    h.generate(prompt(2 * ps + 1), 1)   # evicts x's pages
    rx = _serve_one(h, x, n)
    back = h.executor.export_pages(h.allocator.match_prefix(chain))
    cases["host_tier"] = {
        "spilled": h.metrics["host_kv_spilled_pages"],
        "restored": h.metrics["host_kv_restored_pages"],
        "cached": rx.cached_prefix_tokens,
        "restored_equal_spilled": all(np.array_equal(kept[k], back[k])
                                      for k in ("k", "v")),
        "tokens_equal_cold": rx.generated == cold(x)}
    c = cases["host_tier"]
    if not (c["spilled"] > 0 and c["restored"] > 0
            and c["cached"] == 2 * ps and c["restored_equal_spilled"]
            and c["tokens_equal_cold"]):
        raise AssertionError(f"migrate_parity host tier: {c}")

    # 5. an import under pool pressure falls back cold, once
    tiny = engine(num_pages=2)
    got = tiny.import_prefix_kv(payload)
    short = p[:ps]
    rs = _serve_one(tiny, short, n)
    cases["pressure"] = {
        "covered": got, "import_failures": tiny.metrics["kv_import_failures"],
        "cached": rs.cached_prefix_tokens,
        "tokens_equal_cold": rs.generated == cold(short)}
    c = cases["pressure"]
    if not (c["covered"] == 0 and c["import_failures"] == 1
            and c["cached"] == 0 and c["tokens_equal_cold"]):
        raise AssertionError(f"migrate_parity pressure: {c}")

    torch.cuda.synchronize()
    launches = paged_launches()
    expected = _sum_expected(paged, cfg)
    emit("migrate_parity", dtype="float32", layers=2, page=ps,
         new_tokens=n, prompt_tokens=len(p), cases=cases,
         kernel_launches=launches, expected_launches=expected)
    if launches != expected:
        raise AssertionError(f"migrate_parity launches {launches} != "
                             f"{expected}")
    del paged, cold_eng, params
    torch.cuda.empty_cache()
    return launches


def phase_migrate(seed: int = 0) -> dict:
    """KV migration at llama3-1b, full width, bf16, in the migration
    bench's geometry: engine A prefills a 2,048-token prompt
    (prefill_only) and streams it to engine B over the loop wire, two
    rounds, best kept; B's pages must equal A's, and B's 32 greedy tokens
    must equal A's from the same pages with the same suffix shape. Then
    the host tier at the same geometry. Returns the paged kernels' launch
    counts over every engine of the phase."""
    cfg = PRESETS["llama3-1b"]
    params = init_params(cfg, torch.Generator(DEVICE).manual_seed(seed))
    ps = PAGE
    geo = dict(max_slots=2, max_len=MIG_MAX_LEN, page_size=ps,
               prefill_chunk_size=CHUNK, decode_steps_per_dispatch=8)
    engines = []

    def engine(**kw):
        eng = InferenceEngine(cfg, params, **{**geo, **kw})
        engines.append(eng)
        return eng

    prompt = [(7 + 13 * i) % 200 + 1 for i in range(MIG_PROMPT)]
    reset_paged_launches()
    a = engine()
    t0 = time.perf_counter()
    r = _prefill_only(a, prompt)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pages = list(r.export_pinned)
    # what a stream carries: the full pages a hit can map, then the last
    # prompt page as a tail (the request's table also holds a page for
    # its one new token)
    full = (MIG_PROMPT - 1) // ps
    streamed = pages[:full + 1]
    rounds = []
    for i in range(2):
        if i:  # re-pin the retired request's pages for the next stream
            with a._lock:
                for pid in pages:
                    a.allocator.share(pid)
                r.export_pinned, r.pin_for_export = list(pages), True
        src = KVMigrationSource(a, r)
        b = engine()
        stats = receive_kv_stream(b, src.address, timeout_s=120.0)
        src.close()
        _check_stream(f"migrate round {i}", stats, b, MIG_PROMPT)
        rounds.append({**stats, "mb_s": stats["bytes"] / 1e6
                       / stats["seconds"], "chunks": src.stats["chunks"]})
    if _held(a):
        raise AssertionError(f"migrate: source pins left {_held(a)}")
    plan_b = b.pin_prefix_for_export(prompt)
    pages_equal = _pages_equal(a, streamed, b, plan_b["page_ids"])
    b.release_export_pages(plan_b["page_ids"])
    # A's reference layout is B's: the payload the stream carried (31 full
    # pages and the last page as a partial tail), imported into A itself,
    # so A serves from its own pages with the suffix B prefills.
    self_payload = {"page_size": ps, "model": "", "tokens": prompt,
                    "full_pages": full, "partial_len": MIG_PROMPT - full * ps,
                    **a.executor.export_pages(streamed)}
    a_covered = a.import_prefix_kv(self_payload)
    ra = _serve_one(a, prompt, MIG_NEW)
    rb = _serve_one(b, prompt, MIG_NEW)
    c = engine()
    rc = _serve_one(c, prompt, MIG_NEW)
    ttft = {name: (q.first_token_at - q.arrived_at) * 1e3
            for name, q in (("a", ra), ("b", rb), ("cold", rc))}
    migrate = {
        "pages_streamed": rounds[-1]["pages"], "rounds": rounds,
        "kv_migration_mb_s": max(x["mb_s"] for x in rounds),
        "source_prefill_s": prefill_s, "pages_equal": pages_equal,
        "a_self_import_covered": a_covered,
        "cached": {"a": ra.cached_prefix_tokens,
                   "b": rb.cached_prefix_tokens},
        "tokens_equal_a": rb.generated == ra.generated,
        # B's admissions: one request, every cacheable page a hit
        "b_prefix_cache_hit_rate": b.prefix_cache_hit_rate,
        "b_prefill_suffix_frac": b.prefill_suffix_frac,
        "ttft_migrated_ms": ttft["b"], "ttft_a_ms": ttft["a"],
        "ttft_cold_ms": ttft["cold"],
        "tokens_equal_cold": int(sum(x == y for x, y in
                                     zip(rb.generated, rc.generated)))}
    if not (pages_equal and a_covered == MIG_PROMPT
            and ra.cached_prefix_tokens == rb.cached_prefix_tokens
            == MIG_PROMPT - 1 and rb.generated == ra.generated
            and len(rb.generated) == MIG_NEW):
        raise AssertionError(f"migrate: {migrate}")

    # Where a chunk's time goes: each part of one 8-page chunk alone (A's
    # gather and synchronous copy to the host, the pickle, the wire, the
    # unpickle, the copy to the card and scatter into free pages of C).
    chunk = streamed[:KV_MIGRATION_CHUNK_PAGES]
    with c._lock:
        dst = c.allocator.alloc(len(chunk))
    if dst is None:
        raise AssertionError("migrate: no free pages for the chunk parts")
    best = max(rounds, key=lambda x: x["mb_s"])
    migrate["chunk_parts_ms"] = {**_wire_parts(
        [("export", lambda _: a.executor.export_pages(chunk)),
         ("pickle", lambda d: pickle.dumps(
             {"kind": "pages", "tokens": prompt[:len(chunk) * ps], **d},
             protocol=pickle.HIGHEST_PROTOCOL))],
        [("unpickle", pickle.loads),
         ("import", lambda msg: c.executor.import_pages(dst, msg))]),
        "stream_ms_per_chunk": best["seconds"] * 1e3 / best["chunks"]}
    with c._lock:
        for pid in dst:
            c.allocator.release(pid)

    # The host tier: a pool of one sequence; a second prompt evicts the
    # first's cached pages to host RAM, and the first's next admission
    # restores them (31 matchable: (len - 1) // page caps a hit).
    h = engine(num_pages=-(-(MIG_PROMPT + MIG_NEW) // ps) + 1,
               host_kv_cache_pages=64)
    other = [(11 + 17 * i) % 200 + 1 for i in range(MIG_PROMPT)]
    _serve_one(h, prompt, MIG_NEW)
    hit = _serve_one(h, prompt, MIG_NEW)
    chain = h._chain_hashes(prompt)[1][:full]
    kept = h.executor.export_pages(h.allocator.match_prefix(chain))
    m = h.metrics

    def admit_ms(req) -> float:
        h.add_request(req)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h._admit()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    q = Request("evict", list(other), max_new_tokens=1)
    spilled0 = m["host_kv_spilled_pages"]
    evict_ms = admit_ms(q)
    spilled = m["host_kv_spilled_pages"] - spilled0
    _drain(h, [q])
    back = Request("back", list(prompt), max_new_tokens=MIG_NEW)
    spilled1 = m["host_kv_spilled_pages"]
    restore_ms = admit_ms(back)
    _drain(h, [back])
    restored = h.executor.export_pages(h.allocator.match_prefix(chain))
    host_tier = {
        "host_kv_spilled_pages": m["host_kv_spilled_pages"],
        "host_kv_restored_pages": m["host_kv_restored_pages"],
        "spilled_by_eviction": spilled, "eviction_admission_ms": evict_ms,
        "spill_ms_per_page": evict_ms / spilled if spilled else None,
        "restore_admission_ms": restore_ms,
        "spilled_during_restore": m["host_kv_spilled_pages"] - spilled1,
        "cached_hit": hit.cached_prefix_tokens,
        "cached_restored": back.cached_prefix_tokens,
        "restored_equal_spilled": all(np.array_equal(kept[k], restored[k])
                                      for k in ("k", "v")),
        "tokens_equal_hit": back.generated == hit.generated,
        "ttft_hit_ms": (hit.first_token_at - hit.arrived_at) * 1e3,
        "ttft_restored_ms": (back.first_token_at - back.arrived_at) * 1e3}
    # every chain page the eviction spilled comes back: the restored
    # request maps the whole chain, as the hit before the eviction did
    if not (spilled > 0 and m["host_kv_restored_pages"] > 0
            and back.cached_prefix_tokens == hit.cached_prefix_tokens
            == len(chain) * ps and host_tier["restored_equal_spilled"]
            and host_tier["tokens_equal_hit"]):
        raise AssertionError(f"migrate host tier: {host_tier}")
    torch.cuda.synchronize()
    launches = paged_launches()
    expected = _sum_expected(engines, cfg)
    emit("migrate", preset="llama3-1b", dtype="bfloat16", page=ps,
         chunk=CHUNK, max_len=MIG_MAX_LEN, prompt_tokens=MIG_PROMPT,
         new_tokens=MIG_NEW, **migrate, host_tier=host_tier,
         kernel_launches=launches, expected_launches=expected)
    if launches != expected:
        raise AssertionError(f"migrate launches {launches} != {expected}")
    del engines, a, b, c, h, params
    torch.cuda.empty_cache()
    return launches


def phase_weights(seed: int = 0) -> dict:
    """Weight residency at llama3-1b bf16 on an engine built from a seed:
    demote (the allocation must fall by the weights' bytes), promote
    (ms, GB/s), the fingerprint and the greedy tokens unchanged, demotion
    refused while busy, the first request promoting, a broadcast to two
    loopback readers, and install_weights into a demoted engine. Returns
    the paged kernels' launch counts."""
    cfg = PRESETS["llama3-1b"]
    rng = np.random.default_rng(seed)
    reset_paged_launches()
    # no prefix cache: every request prefills cold, so the same weights
    # give the same bf16 tokens (a cache hit changes the suffix's shape)
    eng = InferenceEngine("llama3-1b", max_slots=2, max_len=256,
                          page_size=PAGE, prefill_chunk_size=CHUNK,
                          decode_steps_per_dispatch=8, seed=seed,
                          enable_prefix_cache=False)
    prompt = rng.integers(0, cfg.vocab_size, 100).tolist()
    new = 16
    before = eng.generate(prompt, new)
    nbytes = tree_bytes(eng.executor.params)
    t0 = time.perf_counter()
    fingerprint = params_fingerprint(eng.executor.params)
    fingerprint_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    demoted = eng.demote_weights_to_host()
    mem1 = torch.cuda.memory_allocated()
    promoted = eng.promote_weights_from_host()
    out = {"tree_bytes": nbytes, "demote": demoted,
           "freed_bytes": mem0 - mem1,
           "freed_frac": (mem0 - mem1) / nbytes,
           "promote_ms": promoted["seconds"] * 1e3,
           "promote_gb_s": nbytes / promoted["seconds"] / 1e9,
           "weight_promote_ms": eng.metrics["weight_promote_ms"],
           "fingerprint_s": fingerprint_s,
           "fingerprint_equal": params_fingerprint(eng.executor.params)
           == fingerprint,
           "tokens_equal_after_promote": eng.generate(prompt, new) == before}
    busy = Request("busy", list(prompt), max_new_tokens=4)
    eng.add_request(busy)
    out["demote_while_busy"] = eng.demote_weights_to_host()
    _drain(eng, [busy])
    eng.demote_weights_to_host()
    out["tokens_equal_auto_promote"] = eng.generate(prompt, new) == before
    out["auto_promoted"] = eng.weights_resident() and \
        eng.metrics["weights_promoted"] == 2

    src = WeightBroadcastSource(eng.executor.params, model="llama3-1b",
                                n_readers=2)
    got = [None, None]

    def read(i):
        got[i] = receive_weight_stream(src.address, timeout_s=120.0)

    t0 = time.perf_counter()
    readers = [threading.Thread(target=read, args=(i,)) for i in range(2)]
    for t in readers:
        t.start()
    for t in readers:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    src.join(timeout=30)
    src.close()
    out["broadcast"] = {
        "wire_bytes": src.stats["bytes"], "chunks": src.stats["chunks"],
        "wall_s": wall, "readers": [
            {k: g[k] for k in ("status", "complete", "bytes", "seconds")}
            | {"mb_s": g["bytes"] / 1e6 / g["seconds"],
               "fingerprint_equal": g["fingerprint"] == fingerprint}
            for g in got],
        "aggregate_mb_s": sum(g["bytes"] for g in got) / 1e6 / wall}
    # Where a message's time goes: each part of one 4 MiB chunk of the
    # embedding alone (the source's slice copy, the pickle, the wire, the
    # unpickle, the receiver's append), against the broadcast's wall time
    # a message.
    raw = got[0]["params"]["embed"].reshape(-1).view(torch.uint8)
    out["broadcast"]["message_parts_ms"] = {**_wire_parts(
        [("slice", lambda _: raw[:DEFAULT_CHUNK_BYTES].numpy().tobytes()),
         ("pickle", lambda data: pickle.dumps(
             {"kind": "chunk", "leaf": 0, "dtype": "bfloat16",
              "shape": tuple(got[0]["params"]["embed"].shape),
              "offset": 0, "data": data},
             protocol=pickle.HIGHEST_PROTOCOL))],
        [("unpickle", pickle.loads),
         ("append", lambda msg: bytearray().__iadd__(msg["data"]))]),
        "broadcast_ms_per_message": wall * 1e3 / src.stats["chunks"]}
    eng.demote_weights_to_host()
    installed = eng.install_weights(got[0]["params"])
    del got
    out["install"] = installed
    out["tokens_equal_after_install"] = eng.generate(prompt, new) == before
    torch.cuda.synchronize()
    launches = paged_launches()
    expected = _expected_paged(eng, cfg)
    emit("weights", preset="llama3-1b", dtype="bfloat16", new_tokens=new,
         **out, metrics={k: eng.metrics[k] for k in (
             "weights_demoted", "weights_promoted", "weight_promote_ms")},
         kernel_launches=launches, expected_launches=expected)
    if not (demoted["ok"] and out["freed_frac"] >= WEIGHTS_FREED_FRAC
            and promoted["ok"] and out["fingerprint_equal"]
            and out["tokens_equal_after_promote"]
            and out["demote_while_busy"] == {"ok": False, "reason": "busy"}
            and out["tokens_equal_auto_promote"] and out["auto_promoted"]
            and all(g["complete"] and g["fingerprint_equal"]
                    for g in out["broadcast"]["readers"])
            and installed["ok"] and out["tokens_equal_after_install"]):
        raise AssertionError(f"weights: {out}")
    if launches != expected:
        raise AssertionError(f"weights launches {launches} != {expected}")
    del eng, src
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------- serve_app
# The app's replica serves the `serve` geometry at llama3-1b; the f32 parity
# app is the smallest preset whose vocabulary holds the byte tokenizer.
APP_PRESET = "llama3-1b"
APP_DEVICE = None                 # the replica's engine: the card
APP_NEW = 64
APP_PARITY_PRESET = "debug-128"
APP_PARITY_GEOMETRY = dict(max_slots=4, max_len=256, page_size=16,
                           prefill_chunk_size=64, decode_steps_per_dispatch=4)
APP_START_TIMEOUT_S = 300.0
WORKER_MODULES = ("ray_tpu_torch.core.worker_main",
                  "ray_tpu_torch.core.worker_zygote")
# engine_metrics()["port"]["kernel_launches"] names kernels by CUDA source
APP_KERNEL_KEYS = {"paged_decode_attention_split": "paged_decode_split",
                   "paged_decode_attention_single": "paged_decode"}


def _app_prompts(rng) -> dict:
    """The serve phase's traffic as text: six prompts of 16-200 bytes and
    two sharing a 2,000-byte prefix (lowercase letters and spaces, one
    token a byte)."""
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)

    def text(n):
        return bytes(rng.choice(letters, n)).decode()

    prompts = {f"short{i}": text(n)
               for i, n in enumerate((16, 40, 77, 120, 160, 200))}
    shared = text(2000)
    prompts["shared0"] = shared + text(24)
    prompts["shared1"] = shared + text(40)
    return prompts


def _http(addr: str, method: str, path: str, body: dict | None = None):
    """One HTTP exchange with the app; returns the parsed JSON body."""
    host, port = addr.rsplit("/", 1)[-1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=600)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"content-type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    if resp.status != 200:
        raise AssertionError(f"{method} {path}: HTTP {resp.status} {data!r}")
    return json.loads(data)


def _http_stream(addr: str, body: dict,
                 path: str = "/v1/completions") -> dict:
    """One ``"stream": true`` completion over HTTP, read event by event:
    the client-side TTFT (send to the first token's event), the wall
    time, the token events' text and the finish reason."""
    host, port = addr.rsplit("/", 1)[-1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=600)
    t0 = time.perf_counter()
    ttft = None
    chunks = []
    try:
        conn.request("POST", path,
                     body=json.dumps({**body, "stream": True}),
                     headers={"content-type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f"stream: HTTP {resp.status} {resp.read()!r}")
        for raw in resp:  # line by line through the chunked body
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                break
            if ttft is None:
                ttft = time.perf_counter() - t0
            chunks.append(json.loads(line[len("data: "):]))
    finally:
        conn.close()
    if not chunks:
        raise AssertionError(f"stream: no token events for {body}")
    choices = [c["choices"][0] for c in chunks]
    return {"ttft_ms": ttft * 1e3, "wall_s": time.perf_counter() - t0,
            "tokens": len(chunks), "text": "".join(c["text"] for c in choices),
            "finish_reason": choices[-1]["finish_reason"]}


def _port_row(handle) -> dict:
    """The replica's ``engine_metrics()``: its engine counters and the
    port's own row (process, device, this process's paged launches)."""
    return handle.options(method_name="engine_metrics").remote().result(
        timeout=120)


def _launch_delta(before: dict, after: dict) -> dict:
    """Paged launches between two ``engine_metrics()`` rows, by kernel."""
    return {name: (after["port"]["kernel_launches"][key]
                   - before["port"]["kernel_launches"][key])
            for name, key in APP_KERNEL_KEYS.items()}


def _cmdlines():
    """(pid, command line with spaces between its arguments) of every
    process this one can read."""
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").strip()
        except OSError:
            continue
        yield int(entry), cmd.decode(errors="replace")


def _worker_pids() -> list:
    return [pid for pid, cmd in _cmdlines()
            if any(m in cmd for m in WORKER_MODULES)]


def _strip(body: dict) -> dict:
    return {k: v for k, v in body.items() if k not in ("id", "created")}


def phase_serve_app(serve_stats: dict, seed: int = 0) -> tuple[dict, dict]:
    """The LLM app through the port's runtime and Serve: a llama3-1b
    replica in a worker process leased the card, 8 concurrent streamed
    completions over HTTP, then a plain and a streamed completion of one
    prompt, a chat completion, and the f32 parity app. Returns the paged
    kernels' launches counted in the replica over the 8 requests, and the
    HTTP run's TTFT, throughput and start time."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import LLMDeployment, build_llm_app

    cfg = PRESETS[APP_PRESET]
    rng = np.random.default_rng(seed)
    # The earlier phases' cached blocks go back to the card before the
    # replica allocates its weights and page pool in its own process.
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rt.init()
    try:
        gpus = rt.cluster_resources().get("GPU", 0.0)
        if gpus != float(torch.cuda.device_count()) or gpus < 1:
            raise AssertionError(f"node reports GPU {gpus}, the host has "
                                 f"{torch.cuda.device_count()} cards")
        init_s = time.perf_counter() - t0
        serve.run(build_llm_app(
            APP_PRESET, max_slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
            prefill_chunk_size=CHUNK, decode_steps_per_dispatch=STEPS,
            ray_actor_options={"num_gpus": 1}, device=APP_DEVICE),
            name="llm", timeout_s=APP_START_TIMEOUT_S)
        start_s = time.perf_counter() - t0 - init_s
        addr = serve.http_address()
        handle = serve.get_app_handle("llm")
        models = _http(addr, "GET", "/v1/models")
        if models["data"][0]["id"] != APP_PRESET:
            raise AssertionError(f"/v1/models: {models}")
        # the HTTP hop alone: proxy, router, replica and back, no engine
        hop_ms = []
        for _ in range(20):
            t = time.perf_counter()
            _http(addr, "GET", "/v1/models")
            hop_ms.append((time.perf_counter() - t) * 1e3)
        before = _port_row(handle)
        replica = before["port"]
        if replica["pid"] == os.getpid():
            raise AssertionError("the replica runs in the driver's process")
        if APP_DEVICE is None and not replica["device"].startswith("cuda"):
            raise AssertionError(f"replica engine on {replica['device']}")

        prompts = _app_prompts(rng)
        t1 = time.perf_counter()
        with ThreadPoolExecutor(len(prompts)) as pool:
            runs = dict(zip(prompts, pool.map(
                lambda p: _http_stream(addr, {"prompt": p,
                                              "max_tokens": APP_NEW,
                                              "temperature": 0.0}),
                prompts.values())))
        wall = time.perf_counter() - t1
        after = _port_row(handle)
        steps = after["decode_steps"] - before["decode_steps"]
        launches = _launch_delta(before, after)
        on_route = paged_kernel_of(cfg.dtype)
        expected = {name: cfg.n_layers * steps if name == on_route else 0
                    for name in APP_KERNEL_KEYS}
        if launches != expected or steps <= 0:
            raise AssertionError(f"replica paged launches {launches} != "
                                 f"{expected} ({cfg.n_layers} layers x "
                                 f"{steps} decode steps)")
        for name, r in runs.items():
            if not (r["tokens"] == APP_NEW or r["finish_reason"] == "stop"):
                raise AssertionError(f"{name}: {r['tokens']} tokens, "
                                     f"finish {r['finish_reason']}")
        ttft = [r["ttft_ms"] for r in runs.values()]
        n_tokens = sum(r["tokens"] for r in runs.values())

        # one prompt plain and streamed: the same text and token count
        body = {"prompt": prompts["short2"], "max_tokens": APP_NEW}
        plain = _http(addr, "POST", "/v1/completions", body)
        streamed = _http_stream(addr, body)
        if (streamed["text"], streamed["tokens"]) != (
                plain["choices"][0]["text"],
                plain["usage"]["completion_tokens"]):
            raise AssertionError(f"streamed {streamed} != plain {plain}")
        chat = _http(addr, "POST", "/v1/chat/completions", {
            "messages": [{"role": "user", "content": prompts["short1"]}],
            "max_tokens": 16})
        if chat["object"] != "chat.completion" or \
                chat["usage"]["completion_tokens"] <= 0:
            raise AssertionError(f"chat: {chat}")
        app_stats = {"ttft_p50_ms": float(np.median(ttft)),
                     "ttft_max_ms": float(max(ttft)),
                     "output_tok_per_s": n_tokens / wall,
                     "app_start_s": start_s}
        emit("serve_app", preset=APP_PRESET, requests=len(runs),
             output_tokens=n_tokens, wall_s=wall, init_s=init_s,
             app_start_s=start_s,
             ttft_p50_ms=app_stats["ttft_p50_ms"],
             ttft_max_ms=app_stats["ttft_max_ms"],
             ttft_ms={k: r["ttft_ms"] for k, r in runs.items()},
             output_tok_per_s=app_stats["output_tok_per_s"],
             http_hop_p50_ms=float(np.median(hop_ms)),
             in_process_serve={k: serve_stats[k] for k in (
                 "ttft_p50_ms", "ttft_max_ms", "output_tok_per_s",
                 "decode_tok_per_s", "wall_s")},
             replica_pid=replica["pid"], driver_pid=os.getpid(),
             replica_device=replica["device"],
             replica_device_name=replica["device_name"],
             kernel_launches=launches, expected_launches=expected,
             decode_steps=steps,
             decode_dispatches=(after["decode_dispatches"]
                                - before["decode_dispatches"]),
             prefix_hit_pages=(after["prefix_hit_pages"]
                               - before["prefix_hit_pages"]),
             stream_equals_plain=True,
             chat_completion_tokens=chat["usage"]["completion_tokens"])
        serve.delete("llm")

        # f32 parity: the app over HTTP against a deployment in this process
        cfg32 = dataclasses.replace(PRESETS[APP_PARITY_PRESET],
                                    dtype=torch.float32)
        serve.run(build_llm_app(
            cfg32, model_id=APP_PARITY_PRESET,
            ray_actor_options={"num_gpus": 1}, device=APP_DEVICE,
            **APP_PARITY_GEOMETRY),
            name="llm_f32", timeout_s=APP_START_TIMEOUT_S)
        local = LLMDeployment(cfg32, model_id=APP_PARITY_PRESET,
                              device=DEVICE, **APP_PARITY_GEOMETRY)
        try:
            compared = 0
            for prompt in ("The quick brown fox", prompts["short3"]):
                body = {"prompt": prompt, "max_tokens": 24}
                got = _strip(_http(addr, "POST", "/v1/completions", body))
                want = _strip(local.completions(dict(body)))
                if got != want:
                    raise AssertionError(f"f32 app {got} != in-process "
                                         f"{want}")
                compared += 1
            f32_port = _port_row(
                serve.get_app_handle("llm_f32"))["port"]
        finally:
            local.close()
        emit("serve_app_parity", preset=APP_PARITY_PRESET, dtype="float32",
             prompts=compared, equal=True,
             replica_pid=f32_port["pid"],
             replica_kernel_launches=f32_port["kernel_launches"])
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
    deadline = time.monotonic() + 20.0
    while _worker_pids() and time.monotonic() < deadline:
        time.sleep(0.2)
    left = _worker_pids()
    if left:
        raise AssertionError(f"worker processes left after shutdown: {left}")
    emit("serve_app_shutdown", workers_left=0,
         total_s=time.perf_counter() - t0)
    return launches, app_stats


# ------------------------------------------------------------- serve leg
# The rest of the serve leg on the port's runtime: the prefill and decode
# pools on one card (each replica leased half of it), spill migration
# between two unified replicas, the fleet's park and wake, its promotion
# ladder, and Data batch inference on an engine actor leased the card.
HALF_CARD = {"num_gpus": 0.5}
FLEET_IDLE_S = 5.0
FLEET_TIMEOUT_S = 120.0
LADDER_GEOMETRY = dict(max_slots=2, max_len=256, page_size=PAGE,
                       prefill_chunk_size=128, decode_steps_per_dispatch=8)
BATCH_ROWS, BATCH_NEW = 32, 32
BATCH_LAYERS = 4         # of llama3-1b's 16: the depth cut to fit the limit
SPAN_WAIT_S = 20.0


def _serve_geometry() -> dict:
    return dict(max_slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
                prefill_chunk_size=CHUNK, decode_steps_per_dispatch=STEPS)


def _on_route_only(launches: dict, dtype) -> bool:
    """The kernel ``paged_route`` names for ``dtype`` ran and the other did
    not (all zero where ``paged_kernel_of`` names none)."""
    on_route = paged_kernel_of(dtype)
    return all(v > 0 if k == on_route else v == 0
               for k, v in launches.items())


def _check_on_card(row: dict, what: str) -> None:
    port = row["port"]
    if port["pid"] == os.getpid():
        raise AssertionError(f"{what} runs in the driver's process")
    if APP_DEVICE is None and not port["device"].startswith("cuda"):
        raise AssertionError(f"{what}'s engine on {port['device']}")


def _pool_idle(handle, baseline: dict, what: str) -> dict:
    """Wait until ``what``'s pool is back at ``baseline``: no request in
    any stage, no page pinned, every page free or cached."""
    deadline = time.monotonic() + 20.0
    while True:
        pool = handle.options(method_name="pool_stats").remote().result(
            timeout=60)
        back = (pool["pinned"] == 0 and pool["active_slots"] == 0
                and pool["prefilling"] == 0 and pool["waiting"] == 0
                and pool["free"] + pool["cached"] == baseline["free"])
        if back:
            return pool
        if time.monotonic() > deadline:
            raise AssertionError(f"{what} pool {pool} not back at {baseline}")
        time.sleep(0.2)


def _sse_text(items) -> str:
    """The token text of an in-process SSE completion, event by event as
    a client joins it (each token's bytes decoded alone)."""
    text = ""
    for item in items:
        if isinstance(item, str) and item.startswith("data: ") \
                and item.strip() != "data: [DONE]":
            text += json.loads(item[len("data: "):])["choices"][0]["text"]
    return text


def _handoff_spans(n: int) -> list:
    """The ``llm.kv_migrate`` spans of kind ``disagg_handoff`` in the GCS
    span store, read through the port's state API (flushed each second);
    waits for ``n`` of them."""
    from ray_tpu_torch.util.state import list_spans

    deadline = time.monotonic() + SPAN_WAIT_S
    while True:
        spans = [sp for sp in list_spans(limit=100_000)
                 if sp.get("name") == "llm.kv_migrate"
                 and sp["attrs"].get("kind") == "disagg_handoff"]
        if len(spans) >= n or time.monotonic() > deadline:
            return spans
        time.sleep(0.5)


def _disagg_app(app_stats: dict, seed: int) -> dict:
    """llama3-1b's prefill and decode pools, one replica each on half of
    the card, one wave of 8 streamed requests at once over HTTP. Returns
    the decode replica's paged launches."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import build_llm_app

    cfg = PRESETS[APP_PRESET]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serve.run(build_llm_app(
        APP_PRESET, serve_disaggregation="prefill_decode", num_replicas=1,
        prefill_replicas=1, ray_actor_options=HALF_CARD, device=APP_DEVICE,
        **_serve_geometry()),
        name="llm-disagg", timeout_s=APP_START_TIMEOUT_S)
    start_s = time.perf_counter() - t0
    addr = serve.http_address()
    pools = {name: d.get("pool")
             for name, d in serve.status()["llm-disagg"].items()}
    if pools != {"llm-decode": "decode", "llm-prefill": "prefill"}:
        raise AssertionError(f"pools {pools}")
    handles = {role: serve.get_deployment_handle(f"llm-{role}", "llm-disagg")
               for role in ("prefill", "decode")}
    before = {role: _port_row(h) for role, h in handles.items()}
    for role, row in before.items():
        _check_on_card(row, f"the {role} replica")
        if row["role"] != role:
            raise AssertionError(f"llm-{role} reports role {row['role']}")
    if before["prefill"]["port"]["pid"] == before["decode"]["port"]["pid"]:
        raise AssertionError("both pools in one process")
    pools0 = {role: h.options(method_name="pool_stats").remote().result(
        timeout=60) for role, h in handles.items()}

    def wave(rng_seed: int) -> tuple:
        prompts = _app_prompts(np.random.default_rng(rng_seed))
        t = time.perf_counter()
        with ThreadPoolExecutor(len(prompts)) as pool:
            runs = dict(zip(prompts, pool.map(
                lambda p: _http_stream(addr, {"prompt": p,
                                              "max_tokens": APP_NEW,
                                              "temperature": 0.0}),
                prompts.values())))
        return runs, time.perf_counter() - t

    # the wave meets both replicas cold, as serve_app's does (a second
    # wave of new text was cut to keep the script inside its time limit)
    waves = [wave(seed)]
    after = {role: _port_row(h) for role, h in handles.items()}
    launches = {role: _launch_delta(before[role], after[role])
                for role in handles}
    n_requests = sum(len(runs) for runs, _ in waves)
    for name, r in [(k, r) for runs, _ in waves for k, r in runs.items()]:
        if not (r["tokens"] == APP_NEW or r["finish_reason"] == "stop"):
            raise AssertionError(f"disagg {name}: {r['tokens']} tokens, "
                                 f"finish {r['finish_reason']}")
    steps = after["decode"]["decode_steps"] - before["decode"]["decode_steps"]
    on_route = paged_kernel_of(cfg.dtype)
    expected = {name: cfg.n_layers * steps if name == on_route else 0
                for name in APP_KERNEL_KEYS}
    if launches["decode"] != expected or steps <= 0:
        raise AssertionError(f"decode replica launches {launches['decode']}"
                             f" != {expected} ({steps} decode steps)")
    # no request fell back to local serving in the prefill pool
    if any(launches["prefill"].values()) or \
            after["prefill"]["decode_steps"] != before["prefill"]["decode_steps"]:
        raise AssertionError(f"the prefill replica decoded: "
                             f"{launches['prefill']}")
    migrations = (after["decode"]["kv_migrations_in"]
                  - before["decode"]["kv_migrations_in"])
    if migrations != n_requests:
        raise AssertionError(f"decode replica imported {migrations} of "
                             f"{n_requests} handoffs")
    spans = _handoff_spans(n_requests)
    if len(spans) != n_requests or \
            len({sp["trace_id"] for sp in spans}) != n_requests or \
            not all(sp["attrs"].get("complete")
                    and (sp["attrs"].get("cached_tokens") or 0) > 0
                    for sp in spans):
        raise AssertionError(f"handoff spans: {[sp['attrs'] for sp in spans]}")
    idle = {role: _pool_idle(h, pools0[role], f"the {role} replica")
            for role, h in handles.items()}
    stats = []
    for runs, wall in waves:
        ttft = [r["ttft_ms"] for r in runs.values()]
        n_tokens = sum(r["tokens"] for r in runs.values())
        stats.append({"requests": len(runs), "output_tokens": n_tokens,
                      "wall_s": wall, "ttft_p50_ms": float(np.median(ttft)),
                      "ttft_max_ms": float(max(ttft)),
                      "ttft_ms": {k: r["ttft_ms"] for k, r in runs.items()},
                      "output_tok_per_s": n_tokens / wall})
    emit("disagg_app", preset=APP_PRESET, app_start_s=start_s,
         **stats[0],
         serve_app={k: app_stats[k] for k in (
             "ttft_p50_ms", "ttft_max_ms", "output_tok_per_s",
             "app_start_s")},
         pools=pools,
         replica_pids={role: row["port"]["pid"]
                       for role, row in after.items()},
         replica_devices={role: row["port"]["device"]
                          for role, row in after.items()},
         kernel_launches=launches, expected_decode_launches=expected,
         decode_steps=steps, kv_migrations_in=migrations,
         kv_pages_exported=(after["prefill"]["kv_pages_exported"]
                            - before["prefill"]["kv_pages_exported"]),
         kv_pages_imported=(after["decode"]["kv_pages_imported"]
                            - before["decode"]["kv_pages_imported"]),
         handoff_spans=len(spans),
         handoffs=sorted((sp["attrs"]["cached_tokens"],
                          sp["attrs"]["seconds"], sp["start"])
                         for sp in spans),
         pools_after=idle)
    serve.delete("llm-disagg")
    return launches["decode"]


def _disagg_parity() -> dict:
    """f32 ``debug-128``: the disaggregated app's text, plain and
    streamed, equals an in-process unified deployment's; an affinity spill
    between two unified replicas imports the group's pages. Returns the
    disaggregated app's decode replica's paged launches."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.core.config import get_config
    from ray_tpu_torch.llm import LLMDeployment, build_llm_app

    cfg32 = dataclasses.replace(PRESETS[APP_PARITY_PRESET],
                                dtype=torch.float32)
    common = dict(model_id=APP_PARITY_PRESET, device=APP_DEVICE,
                  **APP_PARITY_GEOMETRY)
    serve.run(build_llm_app(
        cfg32, serve_disaggregation="prefill_decode",
        ray_actor_options=HALF_CARD, **common),
        name="llm-disagg-f32", timeout_s=APP_START_TIMEOUT_S)
    addr = serve.http_address()
    local = LLMDeployment(cfg32, **{**common, "device": DEVICE})
    try:
        compared = 0
        for prompt in ("The quick brown fox", "hello disaggregated world"):
            body = {"prompt": prompt, "max_tokens": 24}
            want = _strip(local.completions(dict(body)))
            want_streamed = _sse_text(local.completions({**body,
                                                         "stream": True}))
            got = _strip(_http(addr, "POST", "/v1/completions", body))
            streamed = _http_stream(addr, body)
            if got != want or streamed["text"] != want_streamed:
                raise AssertionError(f"f32 disagg {got} / {streamed} != "
                                     f"unified {want} / {want_streamed}")
            compared += 1
    finally:
        local.close()
    decode = _port_row(serve.get_deployment_handle("llm-decode",
                                                   "llm-disagg-f32"))
    if decode["kv_migrations_in"] != 2 * compared:
        raise AssertionError(f"f32 decode replica imported "
                             f"{decode['kv_migrations_in']} handoffs")
    serve.delete("llm-disagg-f32")

    serve.run(build_llm_app(cfg32, num_replicas=2,
                            ray_actor_options=HALF_CARD, **common),
              name="llm-spill", timeout_s=APP_START_TIMEOUT_S)
    h = serve.get_app_handle("llm-spill").options(
        method_name="completions", prefix_group="grp-mig")
    body = {"prompt": "You are a helpful assistant. " * 4 + " tail",
            "max_tokens": 16}
    out1 = h.remote(dict(body)).result(timeout=120)
    router = h._get_router()
    affine = router._group_affinity["grp-mig"]
    bump = get_config().serve_affinity_spill_margin + 1
    with router._cond:
        router._inflight[affine] += bump
    try:
        out2 = h.remote(dict(body)).result(timeout=120)
    finally:
        with router._cond:
            router._inflight[affine] -= bump
    target = _port_row(h)  # routed by the group: the spill's target
    if out2["choices"][0]["text"] != out1["choices"][0]["text"] or \
            router.spill_migrations != 1 or \
            router._group_affinity["grp-mig"] == affine or \
            target["kv_pages_imported"] < 1:
        raise AssertionError(
            f"spill: equal {out2 == out1}, spill_migrations "
            f"{router.spill_migrations}, pages imported "
            f"{target['kv_pages_imported']}")
    emit("disagg_parity", preset=APP_PARITY_PRESET, dtype="float32",
         prompts=compared, plain_and_streamed_equal=True,
         decode_kv_migrations_in=decode["kv_migrations_in"],
         decode_kernel_launches=decode["port"]["kernel_launches"],
         spill_text_equal=True, spill_migrations=router.spill_migrations,
         spill_target_kv_pages_imported=target["kv_pages_imported"],
         spill_target_kv_migrations_in=target["kv_migrations_in"])
    serve.delete("llm-spill")
    return {name: decode["port"]["kernel_launches"][key]
            for name, key in APP_KERNEL_KEYS.items()}


def _fleet_status(app: str) -> dict:
    from ray_tpu_torch.util.state import serve_fleet

    return serve_fleet().get(f"{app}#LLMDeployment") or {}


def _fleet_wait(app: str, pred) -> dict:
    deadline = time.monotonic() + FLEET_TIMEOUT_S
    while time.monotonic() < deadline:
        row = _fleet_status(app)
        if row and pred(row):
            return row
        time.sleep(0.25)
    raise AssertionError(f"fleet {app}: {_fleet_status(app)}")


def _replica_rows(skip: set) -> dict:
    """``engine_metrics()`` of every live replica actor whose id is not in
    ``skip``, by actor id, found through the state API (a deployment under
    scale-to-zero keeps a standby replica that no routing table lists).
    Replicas are the unnamed actors; Serve's controller and proxy are
    named."""
    from ray_tpu_torch.core import api
    from ray_tpu_torch.util.state import list_actors

    rows = {}
    for actor in list_actors():
        if actor["state"] != "ALIVE" or actor["name"] \
                or actor["actor_id"] in skip:
            continue
        handle = api.ActorHandle(bytes.fromhex(actor["actor_id"]))
        try:
            row = api.get(handle.handle_request.remote(
                "engine_metrics", (), {}), timeout=30)
        except Exception:  # not a replica
            continue
        if isinstance(row, dict) and "port" in row:
            rows[actor["actor_id"]] = row
    return rows


def _launch_sum(rows: dict) -> dict:
    return {name: sum(r["port"]["kernel_launches"][key]
                      for r in rows.values())
            for name, key in APP_KERNEL_KEYS.items()}


def _fleet_app() -> dict:
    """llama3-1b behind scale-to-zero: one request, the park (0 running,
    a standby with its weights in host RAM, still healthy), and the wake
    of the next request from the standby."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import build_llm_app
    from ray_tpu_torch.util.state import list_actors

    torch.cuda.empty_cache()
    others = {a["actor_id"] for a in list_actors()}
    serve.run(build_llm_app(
        APP_PRESET, ray_actor_options=HALF_CARD, device=APP_DEVICE,
        autoscaling_config={"min_replicas": 1, "max_replicas": 2,
                            "scale_to_zero_idle_s": FLEET_IDLE_S},
        **_serve_geometry()),
        name="fleet", timeout_s=APP_START_TIMEOUT_S)
    addr = serve.http_address()
    before = _launch_sum(_replica_rows(others))
    body = {"prompt": "the always warm fleet", "max_tokens": APP_NEW}
    first = _http_stream(addr, body)
    served = _replica_rows(others)
    for row in served.values():
        _check_on_card(row, "a fleet replica")
    t0 = time.perf_counter()
    parked = _fleet_wait("fleet", lambda r: r.get("scaled_to_zero")
                         and r.get("running") == 0
                         and (r.get("standby") or 0) >= 1
                         and r["fleet"].get("host_resident", 0) >= 1)
    park_s = time.perf_counter() - t0
    if not serve.status()["fleet"]["LLMDeployment"]["healthy"]:
        raise AssertionError("the parked deployment is not healthy")
    wake = _http_stream(addr, body)
    woke = _fleet_wait("fleet", lambda r: not r.get("scaled_to_zero")
                       and (r.get("running") or 0) >= 1)
    promote = woke.get("last_promote") or {}
    if promote.get("path") not in ("host", "stream", "resident"):
        raise AssertionError(f"wake promoted by {promote}")
    events = serve.status()["fleet"]["LLMDeployment"]["autoscale_events"]
    triggers = [e["trigger"] for e in events]
    if "scale_to_zero" not in triggers or "wake" not in triggers:
        raise AssertionError(f"autoscale events {triggers}")
    after = _replica_rows(others)
    total = _launch_sum(after)
    launches = {k: v - before[k] for k, v in total.items()}
    # a replica that started after the first request counts from 0
    woke_launches = {k: v - _launch_sum(served)[k] for k, v in total.items()}
    for name, r in (("first", first), ("wake", wake)):
        if not (r["tokens"] == APP_NEW or r["finish_reason"] == "stop"):
            raise AssertionError(f"fleet {name}: {r['tokens']} tokens")
    if not _on_route_only(woke_launches, PRESETS[APP_PRESET].dtype):
        raise AssertionError(f"the wake's launches {woke_launches}")
    emit("fleet_app", preset=APP_PRESET, idle_s=FLEET_IDLE_S,
         first_ttft_ms=first["ttft_ms"], park_s=park_s,
         parked={k: parked.get(k) for k in ("running", "standby",
                                            "scaled_to_zero", "fleet")},
         wake_ttft_ms=wake["ttft_ms"], wake_wall_s=wake["wall_s"],
         last_promote=promote, autoscale_triggers=triggers,
         replicas={row["port"]["pid"]: {
             k: row[k] for k in ("decode_steps", "weights_demoted",
                                 "weights_promoted", "weight_promote_ms")}
             for row in after.values()},
         kernel_launches=launches, wake_kernel_launches=woke_launches)
    serve.delete("fleet")
    return launches


def _counting_engine_worker():
    """The batch stage's engine actor class, reporting its own process's
    paged launches in two extra columns (read by the postprocess)."""
    from ray_tpu_torch.llm import batch as batch_mod

    class CountingEngineWorker(batch_mod._EngineWorker):
        def __call__(self, batch: dict) -> dict:
            from ray_tpu_torch.ops.paged_attention import (
                paged_decode_kernel, paged_decode_split_kernel)

            out = super().__call__(batch)
            n = len(out["generated_text"])
            out["launches_split"] = [paged_decode_split_kernel.launches] * n
            out["launches_single"] = [paged_decode_kernel.launches] * n
            out["device"] = [str(self.engine.executor.device)] * n
            out["pid"] = [os.getpid()] * n
            return out

    return CountingEngineWorker


def _run_processor(config, rows: list) -> list:
    """``build_llm_processor(config)`` over ``rows``, its engine actor the
    counting subclass; rows sorted by id."""
    from ray_tpu_torch import data
    from ray_tpu_torch.llm import batch as batch_mod
    from ray_tpu_torch.llm import build_llm_processor

    def pre(row):
        return {"prompt": row["prompt"], "max_tokens": row["max_tokens"],
                "id": row["id"]}

    def post(row):
        return {"id": row["id"], "max_tokens": row["max_tokens"],
                "text": row["generated_text"],
                "n": row["num_generated_tokens"],
                "launches_split": row["launches_split"],
                "launches_single": row["launches_single"],
                "device": row["device"], "pid": row["pid"]}

    real = batch_mod._EngineWorker
    batch_mod._EngineWorker = _counting_engine_worker()
    try:
        processor = build_llm_processor(config, preprocess=pre,
                                        postprocess=post)
        out = processor(data.from_items(rows, parallelism=1)).take_all()
    finally:
        batch_mod._EngineWorker = real
    return sorted(out, key=lambda r: r["id"])


def _batch(seed: int) -> dict:
    """Data batch inference: llama3-1b (``BATCH_LAYERS`` deep) over 32
    rows with a per-row
    ``max_tokens`` column on an engine actor leased the card; then an f32
    ``debug-128`` processor whose texts equal the same engine worker run
    in this process on the same batch."""
    from ray_tpu_torch.llm import LLMProcessorConfig
    from ray_tpu_torch.llm.batch import _EngineWorker

    cfg = dataclasses.replace(
        PRESETS[APP_PRESET],
        n_layers=min(BATCH_LAYERS, PRESETS[APP_PRESET].n_layers))
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)
    rows = [{"id": i,
             "prompt": bytes(rng.choice(letters, 16 + 24 * (i % 8))).decode(),
             "max_tokens": 8 * (1 + i % 4)} for i in range(BATCH_ROWS)]
    config = LLMProcessorConfig(preset=cfg, concurrency=1,
                                batch_size=16, max_slots=8, max_len=1024,
                                max_tokens=BATCH_NEW, device=APP_DEVICE)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = _run_processor(config, rows)
    wall = time.perf_counter() - t0
    if [r["id"] for r in out] != list(range(BATCH_ROWS)):
        raise AssertionError(f"batch rows {[r['id'] for r in out]}")
    pids = {r["pid"] for r in out}
    if pids == {os.getpid()} or len(pids) != 1 or (
            APP_DEVICE is None
            and not all(r["device"].startswith("cuda") for r in out)):
        raise AssertionError(f"engine actor {pids} on "
                             f"{sorted({r['device'] for r in out})}")
    short = [r["id"] for r in out if r["n"] < r["max_tokens"]]
    if any(r["n"] > r["max_tokens"] or r["n"] < 1 for r in out) or \
            len(short) > 2:
        raise AssertionError(f"num_generated_tokens against the column: "
                             f"{[(r['n'], r['max_tokens']) for r in out]}")
    launches = {
        "paged_decode_attention_split": max(r["launches_split"] for r in out),
        "paged_decode_attention_single": max(r["launches_single"]
                                             for r in out)}
    if not _on_route_only(launches, cfg.dtype):
        raise AssertionError(f"batch actor launches {launches}")
    n_tokens = sum(r["n"] for r in out)

    cfg32 = dataclasses.replace(PRESETS[APP_PARITY_PRESET],
                                dtype=torch.float32)
    config32 = LLMProcessorConfig(preset=cfg32, concurrency=1,
                                  batch_size=BATCH_ROWS, max_slots=4,
                                  max_len=256, max_tokens=16,
                                  device=APP_DEVICE)
    rows32 = [{**r, "max_tokens": 4 + r["id"] % 13} for r in rows[:12]]
    got32 = _run_processor(config32, rows32)
    local = _EngineWorker(dataclasses.replace(config32, device=DEVICE))
    want32 = local({"prompt": np.array([r["prompt"] for r in rows32],
                                       dtype=object),
                    "max_tokens": np.array([r["max_tokens"]
                                            for r in rows32])})
    del local
    if [r["text"] for r in got32] != list(want32["generated_text"]) or \
            [r["n"] for r in got32] != list(want32["num_generated_tokens"]):
        raise AssertionError(f"f32 batch {[r['text'] for r in got32]} != "
                             f"in-process {want32['generated_text']}")
    emit("batch", preset=APP_PRESET, layers=cfg.n_layers, rows=len(out),
         output_tokens=n_tokens,
         wall_s=wall, rows_per_s=len(out) / wall,
         output_tok_per_s=n_tokens / wall, rows_short_of_column=short,
         actor_pid=pids.pop(), actor_device=out[0]["device"],
         kernel_launches=launches,
         f32_parity={"preset": APP_PARITY_PRESET, "rows": len(got32),
                     "texts_equal": True})
    return launches


def phase_serve_leg(app_stats: dict, seed: int = 0) -> dict:
    """The rest of the serve leg through the port's runtime, on one
    cluster: ``disagg_app``, ``disagg_parity``, ``fleet_app`` and
    ``batch``; then no worker may be left. Returns each phase's paged
    launches, counted in the process that decoded."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    t0 = time.perf_counter()
    seconds = {}
    launches = {}
    rt.init()
    try:
        for name, run in (("disagg_app", lambda: _disagg_app(app_stats, seed)),
                          ("disagg_parity", _disagg_parity),
                          ("fleet_app", _fleet_app)):
            t = time.perf_counter()
            launches[name] = run()
            seconds[name] = time.perf_counter() - t
        serve.shutdown()  # the batch actor takes the whole card
        t = time.perf_counter()
        launches["batch"] = _batch(seed)
        seconds["batch"] = time.perf_counter() - t
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
    deadline = time.monotonic() + 20.0
    while _worker_pids() and time.monotonic() < deadline:
        time.sleep(0.2)
    left = _worker_pids()
    if left:
        raise AssertionError(f"worker processes left after shutdown: {left}")
    emit("serve_leg", phase_seconds=seconds, workers_left=0,
         total_s=time.perf_counter() - t0)
    return launches


def phase_fleet_ladder(seed: int = 0) -> dict:
    """The promotion ladder on an in-process llama3-1b deployment on the
    card: a donor's broadcast stream, the host copy when the donor dies
    after one chunk, and the cold re-init from the seed when the donor is
    unreachable and the host copy lost, each rung proved by the weights'
    fingerprint (the re-init's equals the donor's), and a request served
    after each."""
    from ray_tpu_torch.llm import LLMDeployment

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dep = LLMDeployment(APP_PRESET, seed=seed, device=DEVICE,
                        **LADDER_GEOMETRY)
    reset_paged_launches()
    prompts = iter(f"promotion ladder, rung {i}" for i in range(8))

    def serves() -> bool:
        return dep.generate(next(prompts), 16)["num_generated"] == 16

    try:
        rungs = {"before": {"ok": serves(), "path": "before"}}
        donor = dep.open_weight_stream(n_readers=1)
        want = donor["fingerprint"]
        if not dep.fleet_demote()["ok"]:
            raise AssertionError("demotion refused")
        rungs["stream"] = dep.fleet_promote(donor["weight_address"])
        rungs["stream"]["fingerprint_equal"] = \
            params_fingerprint(dep.engine.executor.params) == want
        rungs["stream"]["serves"] = serves()
        dying = dep.open_weight_stream(n_readers=1, _die_after_chunks=1)
        if not dep.fleet_demote()["ok"]:
            raise AssertionError("demotion refused")
        rungs["host"] = dep.fleet_promote(dying["weight_address"])
        rungs["host"]["serves"] = serves()
        if not dep.fleet_demote()["ok"]:
            raise AssertionError("demotion refused")
        dep.engine._host_params = None  # the host tier is lost
        rungs["cold_init"] = dep.fleet_promote("127.0.0.1:1")
        rungs["cold_init"]["fingerprint_equal"] = \
            params_fingerprint(dep.engine.executor.params) == want
        rungs["cold_init"]["serves"] = serves()
        launches = paged_launches()
    finally:
        dep.close()
    for path, out in rungs.items():
        if not (out["ok"] and out["path"] == path
                and out.get("fingerprint_equal", True)
                and out.get("serves", True)):
            raise AssertionError(f"ladder rung {path}: {out}")
    if not _on_route_only(launches, PRESETS[APP_PRESET].dtype):
        raise AssertionError(f"ladder launches {launches}")
    emit("fleet_ladder", preset=APP_PRESET, fingerprint=want,
         rungs=rungs, kernel_launches=launches,
         seconds=time.perf_counter() - t0)
    del dep
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------- libraries
# Tune, workflows and jobs on one port cluster: a Tuner grid of two
# llama3-1b TorchTrainer runs, each fit worker leased half of the card, and
# a submitted job whose driver runs a durable workflow: a step leased the
# card serves on the paged kernel, a CPU step fails once and is resumed.
TUNE_LRS = (2.0, 0.5)
TUNE_WARMUP, TUNE_STEPS = 1, 3
TUNE_LAYERS = 4          # of llama3-1b's 16: the depth cut to fit the limit
TUNE_WORKER = {"CPU": 1, "GPU": 0.5}
LIB_TIMEOUT_S = 600.0
WF_PROMPTS = (16, 40, 77, 120)   # prompt lengths of the workflow's requests
WF_NEW = 64
WF_ID = "libraries"


def _paged_kernel_attrs() -> dict:
    """Each of ``PAGED_KERNELS``' kernels by its attribute name in
    ``ray_tpu_torch.ops.paged_attention``, through which another process
    reads its own launch counts."""
    from ray_tpu_torch.ops import paged_attention

    return {name: next(a for a, v in vars(paged_attention).items()
                       if v is pk.kernel)
            for name, pk in PAGED_KERNELS.items()}


def tune_fit_fn(config: dict) -> None:
    """The train_fn of each Tune trial's ``TorchTrainer``: llama3-1b's
    widths and ``layers`` of its layers from the seed (remat "attn") on
    the card, one warm-up and ``timed`` SGD steps at the trial's learning
    rate on one batch of seeded tokens.
    Reports the losses, the step window on the wall clock, the timed
    steps' tokens per second and this process's flash launches."""
    import time

    started_at = time.time()
    import dataclasses
    import os

    import numpy as np
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models.llama import PRESETS, init_params, loss_fn
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.train.checkpoint import map_tree

    device = torch.device(config["device"] or "cuda")
    cfg = dataclasses.replace(PRESETS[config["preset"]],
                              remat_policy="attn",
                              n_layers=config["layers"])
    params = init_params(cfg, torch.Generator(device).manual_seed(
        config["seed"]))
    leaves = []
    map_tree(leaves.append, params)
    for p in leaves:
        p.requires_grad_()
    tokens = torch.from_numpy(np.random.default_rng(config["seed"]).integers(
        0, cfg.vocab_size, (config["batch"], config["seq"])).astype(
            np.int32)).to(device)
    kernels = {name: getattr(attention, attr)
               for name, attr in config["kernels"].items()}
    before = {name: k.launches for name, k in kernels.items()}
    warmup, timed = config["warmup"], config["timed"]
    losses, step_s = [], []
    first_step_at = time.time()
    for i in range(warmup + timed):
        if i == warmup:
            t_timed = time.perf_counter()
        t_step = time.perf_counter()
        loss = loss_fn(params, {"tokens": tokens}, cfg,
                       chunk_tokens=config["chunk"])
        loss.backward()
        with torch.no_grad():
            for p in leaves:
                p.sub_(config["lr"] * p.grad)
                p.grad = None
        losses.append(loss.item())  # waits for the step
        step_s.append(time.perf_counter() - t_step)
    timed_s = time.perf_counter() - t_timed
    on_card = device.type == "cuda"
    train.report({
        "loss": losses[-1], "losses": losses, "step_s": step_s,
        "tokens_per_sec": tokens.numel() * timed / timed_s,
        "window": [first_step_at, time.time()], "started_at": started_at,
        "pid": os.getpid(), "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if on_card
        else "cpu",
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(device)
        if on_card else 0,
        "kernel_launches": {n: k.launches - before[n]
                            for n, k in kernels.items()}})


def tune_trainable(config: dict) -> None:
    """A Tune trial: ``TorchTrainer.fit`` of ``tune_fit_fn`` at the
    trial's learning rate, its worker leased half of the card, and the
    fit's metrics reported with the trial's own process and wall time."""
    import os
    import time

    started_at = time.time()
    from ray_tpu_torch import tune
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    result = TorchTrainer(
        tune_fit_fn, train_loop_config={**config["fit"], "lr": config["lr"]},
        scaling_config=ScalingConfig(
            num_workers=1, use_gpu=True,
            resources_per_worker=dict(config["worker_resources"])),
        run_config=RunConfig(name=f"fit_lr{config['lr']}",
                             storage_path=config["storage"])).fit()
    if result.error is not None:
        raise result.error
    tune.report({**result.metrics, "lr": config["lr"],
                 "trial_pid": os.getpid(), "trial_started_at": started_at,
                 "trial_wall_s": time.time() - started_at})


def _experiment_states(exp_dir: str) -> list:
    with open(os.path.join(exp_dir, "experiment_state.pkl"), "rb") as f:
        return [entry["state"] for entry in pickle.load(f)]


def _tune_grid(storage: str, train_stats: dict, seed: int) -> dict:
    """The Tuner grid of two llama3-1b fits (``TUNE_LAYERS`` deep) sharing
    the card, then ``Tuner.restore`` of the finished experiment. Returns
    the flash launches summed over the two fit workers."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.train import RunConfig

    cfg = dataclasses.replace(
        PRESETS[APP_PRESET],
        n_layers=min(TUNE_LAYERS, PRESETS[APP_PRESET].n_layers))
    fit = dict(preset=APP_PRESET, device=APP_DEVICE, seed=seed,
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, chunk=TRAIN_CHUNK,
               warmup=TUNE_WARMUP, timed=TUNE_STEPS, kernels=_kernel_attrs(),
               layers=cfg.n_layers)
    space = {"lr": tune.grid_search(list(TUNE_LRS)), "fit": fit,
             "worker_resources": TUNE_WORKER,
             "storage": os.path.join(storage, "fits")}
    tune_config = tune.TuneConfig(metric="loss", mode="min",
                                  max_concurrent_trials=2)
    t0 = time.time()
    grid = tune.Tuner(
        tune_trainable, param_space=space, tune_config=tune_config,
        run_config=RunConfig(name="tune_llama", storage_path=storage,
                             callbacks=[tune.JsonLoggerCallback(),
                                        tune.CSVLoggerCallback()])).fit()
    fit_s = time.time() - t0
    if grid.errors:
        raise AssertionError(f"tune trials failed: {grid.errors}")
    exp_dir = os.path.join(storage, "tune_llama")
    states = _experiment_states(exp_dir)
    if states != ["TERMINATED"] * len(TUNE_LRS):
        raise AssertionError(f"trial states {states}")
    rows = [r.metrics for r in grid]
    best = grid.get_best_result("loss", "min")
    if best.metrics["loss"] != min(m["loss"] for m in rows):
        raise AssertionError(f"best {best.metrics['loss']} of "
                             f"{[m['loss'] for m in rows]}")
    pids = {m["pid"] for m in rows}
    others = {os.getpid()} | {m["trial_pid"] for m in rows}
    if len(pids) != len(rows) or pids & others:
        raise AssertionError(f"fit workers {pids}, trials and driver "
                             f"{others}")
    if APP_DEVICE is None and not all(m["device"].startswith("cuda")
                                      for m in rows):
        raise AssertionError(f"fit workers on {[m['device'] for m in rows]}")
    start = max(m["window"][0] for m in rows)
    end = min(m["window"][1] for m in rows)
    if start >= end:
        raise AssertionError(f"fit step windows do not overlap: "
                             f"{[m['window'] for m in rows]}")
    n_steps = TUNE_WARMUP + TUNE_STEPS
    on_route = {flash_kernel_of(step, cfg.dtype)
                for step in ("fwd", "dq", "dkdv")}
    expected = {name: cfg.n_layers * n_steps if name in on_route else 0
                for name in FLASH_KERNELS}
    for m in rows:
        if m["kernel_launches"] != expected:
            raise AssertionError(f"fit worker {m['pid']} flash launches "
                                 f"{m['kernel_launches']} != {expected}")
        if not all(math.isfinite(x) for x in m["losses"]):
            raise AssertionError(f"non-finite loss: {m['losses']}")
    for r in grid:
        with open(os.path.join(r.path, "result.json")) as f:
            lines = [json.loads(line) for line in f]
        with open(os.path.join(r.path, "progress.csv")) as f:
            csv_lines = f.read().splitlines()
        if len(lines) != 1 or lines[0]["loss"] != r.metrics["loss"] or \
                len(csv_lines) != 2:
            raise AssertionError(f"{r.path}: {len(lines)} result.json lines, "
                                 f"{len(csv_lines)} progress.csv lines")

    starts = []

    class Starts(tune.Callback):
        def on_trial_start(self, trial):
            starts.append(trial.trial_id)

    pids_before = set(_worker_pids())
    t1 = time.time()
    again = tune.Tuner.restore(exp_dir, tune_trainable,
                               tune_config=tune_config,
                               run_config=RunConfig(callbacks=[Starts()]))
    again = again.fit()
    restore_s = time.time() - t1
    new_pids = set(_worker_pids()) - pids_before
    if starts or new_pids or [r.metrics for r in again] != rows or \
            _experiment_states(exp_dir) != states:
        raise AssertionError(f"restore started trials {starts}, new "
                             f"workers {sorted(new_pids)}")
    emit("libraries_tune", preset=APP_PRESET, layers=cfg.n_layers,
         lrs=list(TUNE_LRS),
         warmup_steps=TUNE_WARMUP, timed_steps=TUNE_STEPS,
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, worker_resources=TUNE_WORKER,
         fit_s=fit_s, best_lr=best.metrics["lr"],
         best_loss=best.metrics["loss"],
         trials=[{
             "lr": m["lr"], "loss": m["loss"], "losses": m["losses"],
             "trial_wall_s": m["trial_wall_s"],
             "tokens_per_sec": m["tokens_per_sec"], "step_s": m["step_s"],
             # Tuner.fit() to the trainable's first line, to the fit
             # worker's train_fn, and to its first step (the model's init
             # on the card between the last two)
             "trial_start_s": m["trial_started_at"] - t0,
             "worker_start_s": m["started_at"] - t0,
             "first_step_s": m["window"][0] - t0,
             "window_s": m["window"][1] - m["window"][0],
             "worker_pid": m["pid"], "trial_pid": m["trial_pid"],
             "device": m["device"], "device_name": m["device_name"],
             "max_memory_allocated_bytes": m["max_memory_allocated_bytes"],
             "kernel_launches": m["kernel_launches"]} for m in rows],
         overlap_s=end - start, expected_launches=expected,
         restore_s=restore_s, restore_trial_starts=len(starts),
         driver_pid=os.getpid(),
         train_phase_tokens_per_sec=train_stats["tokens_per_sec"])
    return {name: sum(m["kernel_launches"][name] for m in rows)
            for name in FLASH_KERNELS}


LIB_JOB_SCRIPT = '''"""A job's driver: a durable workflow whose first step serves
requests on the card and whose second step fails on its first attempt."""
import json
import sys

import ray_tpu_torch as rt
from ray_tpu_torch import workflow


@rt.remote(num_gpus=1)
def serve_step(args):
    """Step A: an engine from the seed serves the requests greedily;
    returns the tokens and this process's paged launches."""
    import os

    from ray_tpu_torch.llm import InferenceEngine, Request
    from ray_tpu_torch.ops import paged_attention

    with open(os.path.join(args["mark_dir"], "serve_runs"), "a") as f:
        f.write("x")
    kernels = {name: getattr(paged_attention, attr)
               for name, attr in args["kernels"].items()}
    eng = InferenceEngine(args["preset"], **args["geometry"],
                          attention_impl="auto", seed=args["seed"],
                          device=args["device"])
    before = {name: k.launches for name, k in kernels.items()}
    reqs = [Request(f"wf{i}", p, max_new_tokens=args["new"])
            for i, p in enumerate(args["prompts"])]
    for r in reqs:
        eng.add_request(r)
    while any(not r.done for r in reqs):
        eng.step()
    return {"tokens": [list(r.generated) for r in reqs],
            "launches": {n: k.launches - before[n]
                         for n, k in kernels.items()},
            "decode_steps": eng.metrics["decode_steps"],
            "pid": os.getpid(), "device": str(eng.executor.device),
            "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES")}


def sum_step(served, mark_dir):
    """Step B, on a CPU worker: the sum of the served tokens. Its first
    attempt fails."""
    import os

    mark = os.path.join(mark_dir, "sum_failed_once")
    if not os.path.exists(mark):
        open(mark, "w").close()
        raise RuntimeError("sum_step fails on its first attempt")
    return {"sum": sum(sum(t) for t in served["tokens"]), "served": served,
            "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES")}


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        args = json.load(f)
    rt.init()  # the cluster's address comes in RAY_TPU_TORCH_ADDRESS
    dag = workflow.step(sum_step)(workflow.step(serve_step)(args),
                                  args["mark_dir"])
    out = workflow.run(dag, workflow_id=args["workflow_id"],
                       storage=args["storage"])
    print("workflow output:", out["sum"])
    rt.shutdown()
'''


_IN_PROCESS: dict = {}  # (seed, new, prompts) -> (tokens in order, stats)


def _in_process_tokens(prompts: dict, new: int, seed: int) -> tuple:
    """Greedy tokens of an engine built in this process from ``seed`` in
    the serve geometry, by request name, and its first-token seconds and
    tokens per second (the engine's first run, as the remote ones). The
    workflow's step and the operator's actor serve the same prompts: the
    engine runs once for both."""
    key = (seed, new, tuple(tuple(p) for p in prompts.values()))
    if key not in _IN_PROCESS:
        torch.cuda.empty_cache()
        eng = InferenceEngine(APP_PRESET, **_serve_geometry(),
                              attention_impl="auto", seed=seed,
                              device=APP_DEVICE)
        t0 = time.perf_counter()
        reqs = _submit(eng, {str(i): p for i, p in
                             enumerate(prompts.values())}, new)
        first = None
        while any(not r.done for r in reqs):
            eng.step()
            if first is None and any(r.generated for r in reqs):
                first = time.perf_counter() - t0
        wall = time.perf_counter() - t0
        tokens = [list(r.generated) for r in reqs]
        del eng
        torch.cuda.empty_cache()
        _IN_PROCESS[key] = (tokens, {
            "first_token_s": first, "wall_s": wall,
            "tokens_per_sec": sum(len(t) for t in tokens) / wall})
    tokens, stats = _IN_PROCESS[key]
    return dict(zip(prompts, tokens)), stats


def _proc_pids(cmdline: str) -> list:
    """Processes whose command line is exactly ``cmdline``."""
    return [pid for pid, cmd in _cmdlines() if cmd == cmdline]


def _job_workflow(storage: str, seed: int) -> dict:
    """A submitted job whose driver runs the workflow: it ends FAILED at
    step B; ``workflow.resume`` here finishes it without running step A
    again, whose tokens must equal an in-process engine's; then a
    ``sleep`` job is stopped. Returns step A's paged launches."""
    import shlex

    from ray_tpu_torch import workflow
    from ray_tpu_torch.job import JobStatus, JobSubmissionClient

    cfg = PRESETS[APP_PRESET]
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in WF_PROMPTS]
    job_dir = os.path.join(storage, "job")
    mark_dir = os.path.join(storage, "marks")
    wf_storage = os.path.join(storage, "workflows")
    os.makedirs(job_dir)
    os.makedirs(mark_dir)
    args = {"preset": APP_PRESET, "device": APP_DEVICE, "seed": seed,
            "geometry": _serve_geometry(), "prompts": prompts, "new": WF_NEW,
            "mark_dir": mark_dir, "workflow_id": WF_ID,
            "storage": wf_storage, "kernels": _paged_kernel_attrs()}
    with open(os.path.join(job_dir, "driver.py"), "w") as f:
        f.write(LIB_JOB_SCRIPT)
    with open(os.path.join(job_dir, "args.json"), "w") as f:
        json.dump(args, f)

    client = JobSubmissionClient()
    t0 = time.perf_counter()
    jid = client.submit_job(
        entrypoint=f"{shlex.quote(sys.executable)} driver.py args.json",
        runtime_env={"working_dir": job_dir})
    status = client.wait_until_terminal(jid, timeout=LIB_TIMEOUT_S)
    job_s = time.perf_counter() - t0
    logs = client.get_job_logs(jid)
    if status != JobStatus.FAILED or \
            "sum_step fails on its first attempt" not in logs:
        raise AssertionError(f"job {jid} ended {status}; logs:\n{logs}")
    if workflow.get_status(WF_ID, storage=wf_storage) != "FAILED":
        raise AssertionError("the workflow's status is not FAILED")

    runs = os.path.join(mark_dir, "serve_runs")
    before = paged_launches()
    t1 = time.perf_counter()
    out = workflow.resume(WF_ID, storage=wf_storage,
                          step_timeout_s=LIB_TIMEOUT_S)
    resume_s = time.perf_counter() - t1
    served = out["served"]
    if os.path.getsize(runs) != 1 or paged_launches() != before:
        raise AssertionError(f"step A ran {os.path.getsize(runs)} times; "
                             f"this process's launches {paged_launches()}")
    if workflow.get_status(WF_ID, storage=wf_storage) != "SUCCESSFUL" or \
            out["sum"] != sum(sum(t) for t in served["tokens"]):
        raise AssertionError(f"workflow output {out['sum']}")
    if served["pid"] == os.getpid() or out["cuda_visible"] != "" or (
            APP_DEVICE is None and (not served["device"].startswith("cuda")
                                    or served["cuda_visible"] == "")):
        raise AssertionError(f"step A in {served['pid']} on "
                             f"{served['device']} (CUDA_VISIBLE_DEVICES "
                             f"{served['cuda_visible']!r}), step B's "
                             f"{out['cuda_visible']!r}")
    launches = served["launches"]
    expected = {name: cfg.n_layers * served["decode_steps"]
                if name == paged_kernel_of(cfg.dtype) else 0
                for name in PAGED_KERNELS}
    if launches != expected or served["decode_steps"] == 0:
        raise AssertionError(f"step A's paged launches {launches} != "
                             f"{expected}")

    # The same seed, prompts and shapes in this process.
    want, _ = _in_process_tokens({f"wf{i}": p for i, p in enumerate(prompts)},
                                 WF_NEW, seed)
    if served["tokens"] != list(want.values()):
        raise AssertionError("step A's tokens differ from an in-process "
                             "engine's")

    # The shell forks sleep: stopping the job must end it too.
    sleep = f"sleep {700 + os.getpid() % 1000}.5"
    t2 = time.perf_counter()
    sid = client.submit_job(entrypoint=f"{sleep}; echo after")
    deadline = time.monotonic() + 60
    while not _proc_pids(sleep):
        if time.monotonic() > deadline:
            raise AssertionError(f"sleep job {sid}: "
                                 f"{client.get_job_status(sid)}")
        time.sleep(0.1)
    if not client.stop_job(sid):
        raise AssertionError(f"stop_job({sid}) refused")
    stopped = client.wait_until_terminal(sid, timeout=60)
    deadline = time.monotonic() + 10
    while _proc_pids(sleep) and time.monotonic() < deadline:
        time.sleep(0.1)
    if stopped != JobStatus.STOPPED or _proc_pids(sleep):
        raise AssertionError(f"sleep job {stopped}, processes "
                             f"{_proc_pids(sleep)}")
    emit("libraries_job_workflow", preset=APP_PRESET, job_id=jid,
         job_status=status, job_s=job_s, resume_s=resume_s,
         step_a_runs=1, output_sum=out["sum"], requests=len(prompts),
         new_tokens=WF_NEW, step_a_pid=served["pid"],
         step_a_device=served["device"],
         decode_steps=served["decode_steps"], kernel_launches=launches,
         expected_launches=expected, tokens_equal_in_process=True,
         stop_job={"status": stopped, "processes_left": 0,
                   "seconds": time.perf_counter() - t2})
    return launches


def phase_libraries(train_stats: dict, seed: int = 0) -> dict:
    """Tune, workflows and jobs on one port cluster (``init()`` with the
    card as ``GPU``): the Tuner grid, then the job and its workflow; no
    worker may be left after ``shutdown()``. Returns the flash launches of
    the Tune fits and the paged launches of the workflow's step."""
    import shutil

    import ray_tpu_torch as rt

    storage = tempfile.mkdtemp(prefix="libraries_")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    seconds = {}
    launches = {}
    rt.init()
    try:
        gpus = rt.cluster_resources().get("GPU", 0.0)
        if gpus != float(torch.cuda.device_count()) or gpus < 1:
            raise AssertionError(f"node reports GPU {gpus}, the host has "
                                 f"{torch.cuda.device_count()} cards")
        t = time.perf_counter()
        launches["tune"] = _tune_grid(storage, train_stats, seed)
        seconds["tune"] = time.perf_counter() - t
        t = time.perf_counter()
        launches["workflow"] = _job_workflow(storage, seed)
        seconds["job_workflow"] = time.perf_counter() - t
    finally:
        try:
            rt.shutdown()
        finally:
            shutil.rmtree(storage, ignore_errors=True)
    deadline = time.monotonic() + 20.0
    while _worker_pids() and time.monotonic() < deadline:
        time.sleep(0.2)
    left = _worker_pids()
    if left:
        raise AssertionError(f"worker processes left after shutdown: {left}")
    emit("libraries", phase_seconds=seconds, workers_left=0,
         total_s=time.perf_counter() - t0)
    return launches


OP_NODE_TYPE = "gpu"
OP_NODE = {"CPU": 2, "GPU": 1}   # the node type the autoscaler launches
OP_IDLE_S = 5.0                  # its idle timeout
OP_TERMINATE_SLACK_S = 10.0      # past the idle timeout, from the driver's exit
OP_PROFILE_S = 1.0
OP_TIMEOUT_S = 600.0
OP_CLI_TIMEOUT_S = 180.0

OP_DRIVER_SCRIPT = '''"""A ray:// driver: a GPU actor that builds the engine on the card from a
seed, streams greedy tokens back, then decodes until told to stop."""
import json
import sys
import time

import ray_tpu_torch as rt


def say(event, **fields):
    print(json.dumps({"event": event, "t": time.time(), **fields}),
          flush=True)


@rt.remote(num_gpus=1)
class Decoder:
    def __init__(self, args):
        import os

        self.started_at = time.time()
        import torch

        from ray_tpu_torch.llm import InferenceEngine
        from ray_tpu_torch.ops import paged_attention

        self.kernels = {name: getattr(paged_attention, attr)
                        for name, attr in args["kernels"].items()}
        self.eng = InferenceEngine(args["preset"], **args["geometry"],
                                   attention_impl="auto", seed=args["seed"],
                                   device=args["device"])
        ctx = rt.get_runtime_context()
        device = self.eng.executor.device
        self.info = {
            "pid": os.getpid(), "worker_id": ctx.worker_id,
            "node_id": ctx.node_id, "device": str(device),
            "device_name": torch.cuda.get_device_name(device)
            if device.type == "cuda" else "cpu",
            "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "started_at": self.started_at, "ready_at": time.time()}

    def describe(self):
        return self.info

    def stream(self, prompts, new):
        """Each engine step's new tokens, then this process's paged
        launches and decode steps over the run."""
        from ray_tpu_torch.llm import Request

        before = {n: k.launches for n, k in self.kernels.items()}
        steps0 = self.eng.metrics["decode_steps"]
        reqs = [Request(rid, p, max_new_tokens=new)
                for rid, p in prompts.items()]
        for r in reqs:
            self.eng.add_request(r)
        sent = {r.request_id: 0 for r in reqs}
        while any(not r.done for r in reqs):
            self.eng.step()
            out = {}
            for r in reqs:
                if len(r.generated) > sent[r.request_id]:
                    out[r.request_id] = list(r.generated[sent[r.request_id]:])
                    sent[r.request_id] = len(r.generated)
            if out:
                yield {"tokens": out}
        yield {"launches": {n: k.launches - before[n]
                            for n, k in self.kernels.items()},
               "decode_steps": self.eng.metrics["decode_steps"] - steps0}

    def decode_until(self, prompts, new, start_path, stop_path):
        """Serve the prompts again and again until ``stop_path`` exists;
        ``start_path`` appears once the first step has run."""
        import os

        from ray_tpu_torch.llm import Request

        t0 = time.time()
        steps0 = self.eng.metrics["decode_steps"]
        rounds = 0
        while not os.path.exists(stop_path):
            reqs = [Request(f"{rid}-w{rounds}", p, max_new_tokens=new)
                    for rid, p in prompts.items()]
            for r in reqs:
                self.eng.add_request(r)
            while any(not r.done for r in reqs):
                self.eng.step()
                if not os.path.exists(start_path):
                    open(start_path, "w").close()
            rounds += 1
        return {"window": [t0, time.time()], "rounds": rounds,
                "decode_steps": self.eng.metrics["decode_steps"] - steps0}


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        args = json.load(f)
    rt.init(address="ray://" + args["client_address"])
    say("connected")
    dec = Decoder.remote(args)
    say("actor_submitted")
    say("actor_ready", info=rt.get(dec.describe.remote(),
                                   timeout=args["timeout"]))
    tokens = {rid: [] for rid in args["prompts"]}
    t0 = time.perf_counter()
    first = None
    chunks = 0
    for ref in dec.stream.options(num_returns="streaming").remote(
            args["prompts"], args["new"]):
        item = rt.get(ref, timeout=args["timeout"])
        if "tokens" in item:
            if first is None:
                first = time.perf_counter() - t0
            chunks += 1
            for rid, toks in item["tokens"].items():
                tokens[rid].extend(toks)
        else:
            counts = item
    wall = time.perf_counter() - t0
    say("streamed", tokens=tokens, first_token_s=first, wall_s=wall,
        chunks=chunks,
        tokens_per_sec=sum(len(t) for t in tokens.values()) / wall,
        **counts)
    window = dec.decode_until.remote(args["prompts"], args["new"],
                                     args["start_path"], args["stop_path"])
    say("decoding")
    say("decoded", **rt.get(window, timeout=args["timeout"]))
    rt.shutdown()
    say("done")
'''


class _Events:
    """The driver's JSON lines, read on a thread of their own."""

    def __init__(self, proc):
        import queue

        self.proc = proc
        self.lines = []
        self._q = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.append(line)
            if line.startswith("{"):
                self._q.put(json.loads(line))
        self._q.put(None)

    def next(self, event: str, timeout: float = OP_TIMEOUT_S) -> dict:
        import queue

        try:
            ev = self._q.get(timeout=timeout)
        except queue.Empty:
            ev = None
        if ev is None or ev["event"] != event:
            raise AssertionError(f"driver: expected {event!r}, got {ev}; "
                                 f"output {''.join(self.lines)[-2000:]}")
        return ev


def _cli(address: str, *args) -> tuple:
    """``python -m ray_tpu_torch.cli --address ... args``: its stdout and
    its seconds; fails the phase unless it exits 0."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.cli", "--address", address,
         *args], capture_output=True, text=True, timeout=OP_CLI_TIMEOUT_S,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"cli {' '.join(args)} exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout, time.perf_counter() - t0


def _status_gpu(out: str) -> tuple:
    """`cli status`: the GPU total (0 where no node offers one) and the
    pending GPU demand's count."""
    total, pending = 0.0, 0
    head, _, demand = out.partition("pending demand:")
    for line in head.splitlines():
        if line.strip().startswith("GPU:"):
            total = float(line.split("/")[1].split()[0])
    for line in demand.splitlines():
        if "GPU:" in line:
            pending += int(line.rsplit("x", 1)[1])
    return total, pending


def _dash(url: str, path: str):
    import urllib.request

    with urllib.request.urlopen(url + path, timeout=60) as r:
        return json.loads(r.read())


def _panel_metrics(panel: dict) -> set:
    import re

    return {m for t in panel["targets"]
            for m in re.findall(r"\b(ray_tpu_[a-z_]+)", t["expr"])}


def phase_operator(seed: int = 0) -> dict:
    """The operator plane: a port cluster whose head offers no card, an
    ``Autoscaler`` over a ``LocalNodeProvider`` with one ``gpu`` node
    type, a ``ClientServer`` and the dashboard on loopback; a ``ray://``
    driver in a fresh interpreter whose GPU actor pends until the
    autoscaler launches the node, builds llama3-1b on the card and
    streams greedy tokens; watched through the CLI (`status`, `list
    nodes`, `metrics`, `memory`, `profile`) and the dashboard; the idle
    node terminated after the driver leaves. Returns the actor's paged
    launches over the streamed run."""
    import shutil

    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import (Autoscaler, LocalNodeProvider,
                                          NodeTypeConfig)
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard
    from ray_tpu_torch.util.client import ClientServer

    cfg = PRESETS[APP_PRESET]
    rng = np.random.default_rng(seed)
    prompts = {f"op{i}": rng.integers(0, cfg.vocab_size, n).tolist()
               for i, n in enumerate(WF_PROMPTS)}
    work = tempfile.mkdtemp(prefix="operator_")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    # Each raylet offers the host's cards unless told otherwise: the head
    # and this driver's node offer none, so only a launched node can
    # take the actor.
    cluster = Cluster(head_node_args={"num_cpus": 2, "resources": {"GPU": 0}})
    rt.init(address=cluster.address, num_cpus=0, resources={"GPU": 0})
    address = cluster.address
    launched, terminated = [], []

    class Provider(LocalNodeProvider):
        """The harness's provider, with each launch and termination's
        wall time."""

        def create_node(self, node_type, resources):
            iid = super().create_node(node_type, resources)
            launched.append((iid, time.time()))
            return iid

        def terminate_node(self, instance_id):
            super().terminate_node(instance_id)
            terminated.append((instance_id, time.time()))

    provider = Provider(cluster)

    def gcs_call(method, payload):
        return cluster._loop.run_sync(
            getattr(cluster.gcs, f"handle_{method}")(payload))

    scaler = Autoscaler(gcs_call, provider,
                        [NodeTypeConfig(OP_NODE_TYPE, dict(OP_NODE),
                                        max_workers=1)],
                        idle_timeout_s=OP_IDLE_S, launch_cooldown_s=0.5)
    server = ClientServer(port=0)
    dash = start_dashboard()
    proc = None
    stats = {}
    try:
        if rt.cluster_resources().get("GPU", 0.0):
            raise AssertionError("the cluster offers a card before any "
                                 "launch")
        args = {"client_address": server.address, "preset": APP_PRESET,
                "device": APP_DEVICE, "seed": seed,
                "geometry": _serve_geometry(), "prompts": prompts,
                "new": WF_NEW, "kernels": _paged_kernel_attrs(),
                "timeout": OP_TIMEOUT_S,
                "start_path": os.path.join(work, "decoding"),
                "stop_path": os.path.join(work, "stop")}
        with open(os.path.join(work, "driver.py"), "w") as f:
            f.write(OP_DRIVER_SCRIPT)
        with open(os.path.join(work, "args.json"), "w") as f:
            json.dump(args, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.dirname(os.path.abspath(__file__))]
            + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        # A fresh interpreter: this process has CUDA up and must not fork.
        t_driver = time.perf_counter()
        with open(os.path.join(work, "driver.err"), "w") as err:
            proc = subprocess.Popen(
                [sys.executable, os.path.join(work, "driver.py"),
                 os.path.join(work, "args.json")],
                stdout=subprocess.PIPE, stderr=err, text=True, env=env,
                cwd=work)
        events = _Events(proc)
        events.next("connected")
        events.next("actor_submitted")

        # The actor pends: the CLI sees its demand and no card. The
        # reconciler starts only then, so the CLI reads the demand before
        # the launch takes it.
        deadline = time.monotonic() + OP_TIMEOUT_S
        polls = 0
        while True:
            out, status_s = _cli(address, "status")
            polls += 1
            gpus, pending = _status_gpu(out)
            if pending:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"no pending GPU demand:\n{out}")
            time.sleep(0.5)
        if gpus or launched:
            raise AssertionError(f"GPU {gpus} before the launch:\n{out}")
        stats["status_pending"] = {"gpu_total": gpus, "gpu_pending": pending,
                                   "polls": polls, "cli_s": status_s}
        scaler.start(period_s=0.5)

        info = events.next("actor_ready")["info"]
        (iid, t_launch), = launched
        node_id = provider.node_id_of(iid)
        if info["node_id"] != node_id or info["pid"] == os.getpid():
            raise AssertionError(f"actor on node {info['node_id']} (the "
                                 f"launched node is {node_id}), pid "
                                 f"{info['pid']}")
        if APP_DEVICE is None and (not info["device"].startswith("cuda")
                                   or info["cuda_visible"] == ""):
            raise AssertionError(f"actor on {info['device']} "
                                 f"(CUDA_VISIBLE_DEVICES "
                                 f"{info['cuda_visible']!r})")
        stats["launch_to_worker_s"] = info["started_at"] - t_launch
        stats["launch_to_actor_ready_s"] = info["ready_at"] - t_launch
        out, _ = _cli(address, "status")
        gpus, pending = _status_gpu(out)
        if gpus != float(OP_NODE["GPU"]) or pending:
            raise AssertionError(f"after the launch, GPU {gpus} total and "
                                 f"{pending} pending:\n{out}")
        stats["status_after_launch"] = out.splitlines()

        streamed = events.next("streamed")
        kernel = paged_kernel_of(cfg.dtype)
        expected = {name: cfg.n_layers * streamed["decode_steps"]
                    if name == kernel else 0 for name in PAGED_KERNELS}
        if streamed["launches"] != expected or \
                streamed["decode_steps"] != WF_NEW:
            raise AssertionError(f"actor's paged launches "
                                 f"{streamed['launches']} over "
                                 f"{streamed['decode_steps']} decode steps "
                                 f"!= {expected}")

        with ThreadPoolExecutor(3) as pool:
            (out, _), (metrics_out, _), (memory_out, _) = pool.map(
                lambda cmd: _cli(address, *cmd),
                (("list", "nodes"), ("metrics",), ("memory",)))
        if node_id[:12] not in out:
            raise AssertionError(f"list nodes misses {node_id}:\n{out}")
        used = [line for line in metrics_out.splitlines() if line.startswith(
            'ray_tpu_resource_used{resource="GPU"}')]
        if not used:
            raise AssertionError("metrics has no GPU usage:\n"
                                 + metrics_out[-3000:])
        stats["metrics_gpu_used"] = float(used[0].split()[-1])
        out = memory_out
        node_line = [line for line in out.splitlines()
                     if line.startswith(f"node {node_id[:12]}  store")]
        if not node_line:
            raise AssertionError(f"memory misses node {node_id}:\n{out}")
        stats["memory_gpu_node"] = node_line[0]

        nodes = _dash(dash, "/api/nodes")
        metrics = _dash(dash, "/api/metrics")
        names = {m["name"] for m in metrics}
        series = {(m["name"], m["tags"].get("resource")) for m in metrics}
        grafana = _dash(dash, "/api/grafana_dashboard")
        gpu_panels = [p for p in grafana["panels"] if "GPU" in p["title"]
                      or "HBM" in p["title"]]
        wanted = set().union(*(_panel_metrics(p) for p in gpu_panels))
        if not any(n["node_id"] == node_id and n["state"] == "ALIVE"
                   for n in nodes) or len(gpu_panels) < 3 or \
                not wanted <= names or not {
                    ("ray_tpu_resource_used", "GPU"),
                    ("ray_tpu_resource_total", "GPU")} <= series:
            raise AssertionError(f"dashboard: panels "
                                 f"{[p['title'] for p in gpu_panels]} name "
                                 f"{sorted(wanted - names)} missing")
        stats["dashboard"] = {"gpu_panels": [p["title"] for p in gpu_panels],
                              "panel_metrics": sorted(wanted)}

        # A profile of the worker while its actor decodes.
        events.next("decoding")
        deadline = time.monotonic() + OP_TIMEOUT_S
        while not os.path.exists(args["start_path"]):
            if time.monotonic() > deadline or proc.poll() is not None:
                raise AssertionError("the actor never started decoding")
            time.sleep(0.05)
        t_prof = time.time()
        out, prof_s = _cli(address, "--json", "profile", "--node",
                           node_id[:12], "--worker", info["worker_id"],
                           "--duration", str(OP_PROFILE_S))
        t_prof_end = time.time()
        open(args["stop_path"], "w").close()
        prof = json.loads(out)
        decoded = events.next("decoded")
        with open(os.path.join(prof["path"], "trace.json")) as f:
            trace = json.load(f)
        shutil.rmtree(prof["path"], ignore_errors=True)
        kevents = [e for e in trace.get("traceEvents", [])
                   if e.get("cat") == "kernel"]
        device_fn = (PAGED_KERNELS[kernel].source.rsplit(".", 1)[0]
                     + "_kernel" if kernel in PAGED_KERNELS else None)
        named = [e for e in kevents
                 if device_fn and device_fn in e.get("name", "")]
        w0, w1 = decoded["window"]
        if prof.get("worker_id") != info["worker_id"] or \
                (device_fn and not named) or not w0 <= t_prof or \
                not w1 >= t_prof_end:
            raise AssertionError(
                f"profile of {prof.get('worker_id')}: {len(named)} "
                f"{device_fn} of {len(kevents)} kernel events; decoding "
                f"{w0}-{w1}, capture {t_prof}-{t_prof_end}")
        stats["profile"] = {
            "cli_s": prof_s, "duration_s": OP_PROFILE_S,
            "kernel_events": len(kevents), "device_function": device_fn,
            "device_function_events": len(named),
            "decoding_rounds": decoded["rounds"],
            "decoding_steps": decoded["decode_steps"]}

        events.next("done")
        if proc.wait(timeout=60) != 0:
            raise AssertionError(f"driver exited {proc.returncode}")
        t_exit = time.time()
        stats["driver_s"] = time.perf_counter() - t_driver

        # The session goes with the driver; the worker's fence, then the
        # idle node's termination.
        deadline = time.monotonic() + OP_IDLE_S + OP_TERMINATE_SLACK_S
        worker_gone = None
        while time.monotonic() < deadline and (not terminated
                                               or worker_gone is None):
            if worker_gone is None and not os.path.exists(
                    f"/proc/{info['pid']}"):
                worker_gone = time.time()
            time.sleep(0.1)
        if server._sessions or not terminated or worker_gone is None or \
                worker_gone > terminated[0][1]:
            raise AssertionError(
                f"sessions {list(server._sessions)}; node terminated "
                f"{terminated}, worker gone at {worker_gone}, driver exit "
                f"{t_exit}")
        out, _ = _cli(address, "status")
        gpus, pending = _status_gpu(out)
        if gpus or pending or provider.non_terminated_nodes():
            raise AssertionError(f"after the termination:\n{out}")
        stats["worker_gone_after_exit_s"] = worker_gone - t_exit
        stats["terminated_after_exit_s"] = terminated[0][1] - t_exit
        stats["status_after_terminate"] = out.splitlines()
    finally:
        scaler.stop()
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        stop_dashboard()
        server.stop()
        try:
            rt.shutdown()
        finally:
            cluster.shutdown()
            shutil.rmtree(work, ignore_errors=True)
    deadline = time.monotonic() + 20.0
    while _worker_pids() and time.monotonic() < deadline:
        time.sleep(0.2)
    left = _worker_pids()
    if left:
        raise AssertionError(f"worker processes left after shutdown: {left}")

    want, local = _in_process_tokens(prompts, WF_NEW, seed)
    if streamed["tokens"] != want:
        raise AssertionError("the ray:// tokens differ from an in-process "
                             "engine's")
    emit("operator", preset=APP_PRESET, requests=len(prompts),
         new_tokens=WF_NEW, node_type={OP_NODE_TYPE: OP_NODE},
         idle_timeout_s=OP_IDLE_S, actor=info,
         first_token_s=streamed["first_token_s"],
         stream_wall_s=streamed["wall_s"], chunks=streamed["chunks"],
         tokens_per_sec=streamed["tokens_per_sec"],
         in_process=local, tokens_equal_in_process=True,
         decode_steps=streamed["decode_steps"],
         kernel_launches=streamed["launches"], expected_launches=expected,
         workers_left=0, phase_s=time.perf_counter() - t_phase, **stats)
    return streamed["launches"]


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
    train_launches, train_stats = phase_train()
    fit_launches = phase_train_fit(train_stats)
    loop_launches = phase_train_loop()
    parity_launches = phase_train_parity()
    launches, serve_stats = phase_serve()
    deadline_launches = phase_deadline()
    paged_parity_launches = phase_parity()
    spec_parity_launches = phase_spec_parity()
    verify_launches = phase_speculate()
    lora_parity_launches = phase_lora_parity()
    lora_launches = phase_lora_serve()
    mig_parity_launches = phase_migrate_parity()
    mig_launches = phase_migrate()
    weights_launches = phase_weights()
    app_launches, app_stats = phase_serve_app(serve_stats)
    leg = phase_serve_leg(app_stats)
    ladder_launches = phase_fleet_ladder()
    lib_launches = phase_libraries(train_stats)
    op_launches = phase_operator()
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
            # the deadline phase's run (bf16, `deadline`)
            "launches_deadline": deadline_launches[name],
            # the speculative runs (`speculate`, bf16) and the f32
            # speculative parity runs (`spec_parity`)
            "launches_verify": verify_launches[name],
            "launches_f32_spec_parity": spec_parity_launches[name],
            # the LoRA serve run (`lora_serve`, bf16) and the f32 LoRA
            # parity batch (`lora_parity`)
            "launches_lora_serve": lora_launches[name],
            "launches_f32_lora_parity": lora_parity_launches[name],
            # the bf16 migration and weights phases, and the f32
            # migration parity cases (`migrate_parity`)
            "launches_migrate": mig_launches[name],
            "launches_weights": weights_launches[name],
            "launches_f32_migrate_parity": mig_parity_launches[name],
            # the LLM app's replica, a worker process leased the card,
            # over the 8 HTTP requests (`serve_app`, bf16)
            "launches_serve_app": app_launches[name],
            # the rest of the serve leg on the runtime, counted in each
            # process that decoded: the disaggregated app's decode replica
            # (its prefill replica launches none), the fleet app's replica
            # over a request and the wake after its park, the in-process
            # promotion ladder's requests, and the batch engine actor
            # (`disagg_app`, `fleet_app`, `fleet_ladder`, `batch`, bf16)
            "launches_disagg_app": leg["disagg_app"][name],
            "launches_fleet_app": leg["fleet_app"][name],
            "launches_fleet_ladder": ladder_launches[name],
            "launches_batch": leg["batch"][name],
            # the f32 disaggregated app's decode replica (`disagg_parity`)
            "launches_f32_disagg_parity": leg["disagg_parity"][name],
            # the submitted job's workflow step leased the card, counted
            # in its worker (`libraries`, bf16)
            "launches_workflow": lib_launches["workflow"][name],
            # the ray:// driver's actor on the autoscaler-launched node,
            # counted in its worker (`operator`, bf16)
            "launches_operator": op_launches[name],
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
            # the Train library's worker, a process leased the card
            # (`train_fit`, bf16)
            "launches_train_fit": fit_launches[name],
            # the compiled train loop's step stage, a process leased the
            # card (`train_loop`, bf16, TrainLoopConfig's default drive)
            "launches_train_loop": loop_launches[name],
            # the two Tune trials' fit workers, each leased half of the
            # card, summed (`libraries`, bf16)
            "launches_tune": lib_launches["tune"][name],
            "launches_f32_train_parity": parity_launches[name],
            "max_abs_err": flash_err[name], **flash_times[name]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
