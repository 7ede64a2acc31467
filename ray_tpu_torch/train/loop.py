"""Structured-step training: a step spec driven through three stage actors.

A structured step spec (:class:`TrainLoopConfig`) runs as THREE resident
stage actors —

    data-loader  →  train-step  →  checkpoint-snapshot

— and the ``AsyncCheckpointManager`` host snapshot commits in its OWN
stage. The port drives the stages **eagerly**: one dynamically
dispatched ``.remote()`` chain per step (the submit→lease→push path every
iteration). The JAX package's other drive, the persistent compiled loop
(``use_compiled_loop=True``, parked on ``dag/loop.py``), is not ported
yet (ROADMAP queue A item 4) and raises.

The classic ``train_fn`` + ``train.report()`` API is untouched; the loop
mode is opt-in via ``DataParallelTrainer(TrainLoopConfig(...),
use_compiled_loop=False)``. Loop-mode step metrics reach the controller
through the same ingest path (``Result.metrics_history`` is shaped
identically).

Failure story: a stage death surfaces on a bounded ``get()`` and the
controller's normal failure policy restarts the attempt from the latest
GCS-registered async checkpoint — ``recovery_ckpt_lag_steps`` is bounded
by ``snapshot_every``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable

from ..core import api as ray


@dataclasses.dataclass
class TrainLoopConfig:
    """Structured step spec for stage-driven training.

    ``use_compiled_loop`` defaults to True, as in the JAX package, but the
    compiled loop is not ported yet (ROADMAP queue A item 4): pass
    ``use_compiled_loop=False`` here or to the trainer, or it raises.

    step_fn:  ``(state, batch) -> (state, metrics)`` — one training step.
              Runs inside the train-step stage actor; the state pytree
              never leaves it except as checkpoint snapshots.
    init_fn:  ``(config: dict) -> state`` — build (or re-build) the
              initial state. On a restart the resumed checkpoint tree
              overwrites it (``load_checkpoint(like=init_fn(config))``).
    num_steps: total steps for the run (global — a resumed attempt
              continues from the checkpointed step).
    data_fn:  ``(config) -> iterable`` yielding one batch per step in the
              data-loader stage; ``None`` feeds the bare step index
              (steps that synthesize their own batch). Must be
              deterministic for the loop-vs-eager parity contract.
    snapshot_every: every N completed steps the train-step stage emits a
              HOST snapshot downstream and the checkpoint stage commits
              it atomically + registers it with the GCS
              (``resilience.AsyncCheckpointManager``); 0 disables
              checkpointing entirely.
    use_compiled_loop: default drive mode (the trainer's
              ``use_compiled_loop=`` overrides it); only False runs.
    keep_k:   committed checkpoint versions retained (keep-K GC).
    stage_init_hook: ``(stage_name, config) -> None`` run in each stage
              actor's constructor (``stage_name`` ∈ {"data", "step",
              "ckpt"}) — the injection seam chaos tests use to install a
              ``kill_loop_stage`` FaultPlan inside the train-step stage.
    """

    step_fn: Callable
    init_fn: Callable
    num_steps: int
    data_fn: Callable | None = None
    snapshot_every: int = 0
    use_compiled_loop: bool = True
    keep_k: int = 2
    stage_init_hook: Callable | None = None


COMPILED_LOOP_ITEM = ("the compiled train loop (use_compiled_loop=True) is "
                      "not ported yet: ROADMAP queue A item 4 (dag/loop.py); "
                      "pass use_compiled_loop=False")


def check_drive(spec: TrainLoopConfig, use_compiled_loop: bool | None) -> None:
    """Raise unless the run would take the eager drive."""
    compiled = (spec.use_compiled_loop if use_compiled_loop is None
                else use_compiled_loop)
    if compiled:
        raise NotImplementedError(COMPILED_LOOP_ITEM)


def _block_on(tree) -> None:
    """Wait for the work queued on every card that holds a tensor of
    ``tree`` — step/wall windows must measure compute, not dispatch."""
    import torch

    from .checkpoint import map_tree

    devices = set()
    map_tree(lambda x: devices.add(x.device) if isinstance(x, torch.Tensor)
             and x.device.type == "cuda" else None, tree)
    for device in devices:
        torch.cuda.synchronize(device)


def _host_snapshot(tree):
    from ..resilience.checkpoint import _snapshot

    return _snapshot(tree)


class DataLoaderStage:
    """Resident data-loader: tick ``i`` emits ``(i, batch_i)``."""

    def __init__(self, spec: TrainLoopConfig, config: dict):
        if spec.stage_init_hook is not None:
            spec.stage_init_hook("data", config)
        self._it = iter(spec.data_fn(config)) if spec.data_fn else None

    def next_batch(self, i: int):
        return (i, next(self._it) if self._it is not None else i)


class TrainStepStage:
    """Resident train step: holds the state pytree; tick ``(i, batch)``
    runs ``step_fn`` and — every ``snapshot_every`` steps — attaches a
    host snapshot for the downstream checkpoint stage."""

    def __init__(self, spec: TrainLoopConfig, config: dict,
                 resume_path: str | None):
        if spec.stage_init_hook is not None:
            spec.stage_init_hook("step", config)
        self._spec = spec
        self._state = spec.init_fn(config)
        self._start = 0
        if resume_path:
            from ..resilience.checkpoint import load_checkpoint

            tree, meta = load_checkpoint(resume_path, like=self._state)
            self._state = tree
            self._start = int(meta.get("step", -1)) + 1

    def start_step(self) -> int:
        """First step this attempt runs (0, or resumed-step + 1)."""
        return self._start

    def train_step(self, msg):
        i, batch = msg
        t0 = time.time()
        self._state, metrics = self._spec.step_fn(self._state, batch)
        _block_on(self._state)
        t1 = time.time()
        out = {"step": i, "metrics": dict(metrics or {}),
               "step_window": (t0, t1)}
        every = self._spec.snapshot_every
        if every and (i + 1) % every == 0:
            s0 = time.time()
            out["snapshot"] = _host_snapshot(self._state)
            out["snapshot_ms"] = round((time.time() - s0) * 1e3, 3)
        return out

    def state_snapshot(self):
        """Host copy of the current state (parity tests / final fetch)."""
        return _host_snapshot(self._state)


class CkptStage:
    """Resident checkpoint committer: ticks WITHOUT a snapshot pass
    through untouched; ticks WITH one ride the atomic commit path
    (tmp + fsync + COMMITTED marker + rename, GCS-registered). The commit
    WINDOW is stamped so the driver can measure how much of it overlapped
    step compute."""

    def __init__(self, spec: TrainLoopConfig, config: dict,
                 storage_path: str, run_name: str):
        if spec.stage_init_hook is not None:
            spec.stage_init_hook("ckpt", config)
        self._mgr = None
        if spec.snapshot_every:
            from ..resilience import AsyncCheckpointManager

            self._mgr = AsyncCheckpointManager(
                os.path.join(storage_path, "async_ckpts"),
                run_name=run_name, keep_k=spec.keep_k)

    def commit(self, out: dict) -> dict:
        snap = out.pop("snapshot", None)
        if snap is not None and self._mgr is not None:
            t0 = time.time()
            block_ms = self._mgr.save(out["step"], snap,
                                      metrics=out["metrics"])
            # The tick returns once the commit is on disk.
            self._mgr.wait(timeout=300.0)
            out["ckpt_window"] = (t0, time.time())
            out["ckpt_save_block_ms"] = round(block_ms, 3)
        return out


def _overlap_s(window: tuple, others: list[tuple]) -> float:
    s0, e0 = window
    total = 0.0
    for s1, e1 in others:
        total += max(0.0, min(e0, e1) - max(s0, s1))
    return total


class TrainLoopRunner:
    """Drives the three stages start→num_steps eagerly and folds the
    per-step entries into overlap/dispatch statistics."""

    def __init__(self, group, spec: TrainLoopConfig,
                 use_compiled_loop: bool | None = None):
        check_drive(spec, use_compiled_loop)
        self._group = group
        self._spec = spec
        self.stats: dict[str, Any] = {}

    # ------------------------------------------------------------------
    def run(self, on_report: Callable[[dict], None]) -> dict:
        g = self._group
        start = ray.get(g.step.start_step.remote(), timeout=120)
        total = max(0, self._spec.num_steps - start)
        step_windows: list[tuple] = []
        ckpt_windows: list[tuple] = []
        save_block_ms = 0.0

        def handle(entry: dict) -> None:
            nonlocal save_block_ms
            step_windows.append(tuple(entry.get("step_window", (0.0, 0.0))))
            if "ckpt_window" in entry:
                ckpt_windows.append(tuple(entry["ckpt_window"]))
                save_block_ms = max(save_block_ms,
                                    entry.get("ckpt_save_block_ms", 0.0))
            on_report(entry)

        t_run0 = time.perf_counter()
        if total:
            self._run_eager(start, total, handle)
        wall = time.perf_counter() - t_run0

        overlap = sum(_overlap_s(w, step_windows) for w in ckpt_windows)
        ckpt_total = sum(e - s for s, e in ckpt_windows)
        # Steady-state window: end of step 0 → end of the last step.
        # Excludes the first step's warm-up (kernel builds, allocator
        # growth), so per-step numbers measure the DRIVE, not warmup.
        steady_steps = max(0, len(step_windows) - 1)
        steady_wall = (step_windows[-1][1] - step_windows[0][1]
                       if steady_steps else 0.0)
        self.stats = {
            "mode": "eager",
            "steps": total,
            "start_step": start,
            "wall_s": round(wall, 4),
            "step_wall_us": round(wall / total * 1e6, 1) if total else 0.0,
            "steady_steps": steady_steps,
            "steady_wall_s": round(steady_wall, 4),
            "steady_step_wall_us": (
                round(steady_wall / steady_steps * 1e6, 1)
                if steady_steps else 0.0),
            "step_compute_s": round(
                sum(e - s for s, e in step_windows), 4),
            "ckpt_commits": len(ckpt_windows),
            "ckpt_total_s": round(ckpt_total, 4),
            "ckpt_save_block_ms": round(save_block_ms, 3),
            "train_ckpt_overlap_frac": (
                round(overlap / ckpt_total, 4) if ckpt_total > 0 else None),
        }
        return self.stats

    # ------------------------------------------------------------------
    def _run_eager(self, start: int, total: int, handle) -> None:
        """Dynamic per-step dispatch — the dag bench's "dynamic" cell
        shape: one ``.remote()`` chain + one ``get`` per step, paying
        the full submit→lease→push path every iteration, with the
        checkpoint commit serialized against the next step."""
        g = self._group
        for i in range(start, start + total):
            entry = ray.get(
                g.ckpt.commit.remote(
                    g.step.train_step.remote(
                        g.data.next_batch.remote(i))),
                timeout=600)
            handle(entry)

    # ------------------------------------------------------------------
    def final_state(self):
        """Host copy of the step stage's final state. Valid after
        ``run()`` returned (the actor is idle)."""
        return ray.get(self._group.step.state_snapshot.remote(), timeout=300)
