"""TrainController: the driver-side control loop.

Reference: ``python/ray/train/v2/_internal/execution/controller/
controller.py:91`` (run:453, loop:430) with pluggable ScalingPolicy
(``execution/scaling_policy/``) and FailurePolicy
(``execution/failure_handling/``). The worker group is the atomic
failure unit (SURVEY.md §7.3-4): any worker failure tears the whole group
down and restarts it from the latest checkpoint.
"""

from __future__ import annotations

import logging
import os
import tempfile
import time

from ..chaos import clock as chaos_clock
from .checkpoint import Checkpoint, CheckpointManager
from .config import Result, RunConfig, ScalingConfig
from .loop import TrainLoopConfig, TrainLoopRunner
from .worker_group import LoopWorkerGroup, WorkerGroup

logger = logging.getLogger(__name__)


class FixedScalingPolicy:
    """Reference: execution/scaling_policy/fixed.py."""

    def __init__(self, scaling_config: ScalingConfig):
        self._config = scaling_config

    def group_size(self, current: int | None = None) -> int:
        return self._config.num_workers

    def monitor(self, current: int) -> int | None:
        return None  # never resizes


class ElasticScalingPolicy:
    """Size the group to observed cluster capacity within
    ``[min_workers, num_workers]`` (reference v2
    ``execution/scaling_policy/scaling_policy.py:29`` ResizeDecision).

    The worker group is atomic, so a resize is a whole-group restart from
    the latest checkpoint — never an in-place membership change
    (collectives can't survive one)."""

    def __init__(self, scaling_config: ScalingConfig, *,
                 check_interval_s: float = 2.0, clock=None):
        self._config = scaling_config
        self.min = max(1, scaling_config.min_workers or 1)
        self.max = scaling_config.num_workers
        self._check_interval = check_interval_s
        # Injectable clock so the debounce is testable without wall-time
        # sleeps (load-sensitive timing was a full-suite flake source).
        # Default: the chaos clock (wall time unless a VirtualClock is
        # installed — chaos/clock.py), generalizing the PR-1 fake clock.
        if clock is None:
            from ..chaos import clock as chaos_clock

            clock = chaos_clock.now
        self._clock = clock
        self._next_check = 0.0
        self._pending_target: int | None = None

    def _feasible_workers(self, holding: int = 0) -> int:
        """Workers the cluster can host NOW: floor over each required
        resource of available/required, plus what the current group holds."""
        from ..core import api as ray

        need = self._config.worker_resources()
        try:
            avail = ray.available_resources()
        except Exception:
            return holding or self.min
        fits = min(
            int(avail.get(res, 0.0) / amount) for res, amount in need.items()
        ) if need else self.max
        return max(0, fits) + holding

    def group_size(self, current: int | None = None) -> int:
        feasible = self._feasible_workers(holding=current or 0)
        size = max(self.min, min(self.max, feasible))
        return size

    def monitor(self, current: int) -> int | None:
        """While the group runs: return a new size when capacity changed
        enough to justify a group-atomic restart, else None. Debounced:
        the target must hold for two consecutive checks — node-death
        detection lags heartbeats, and a dying node's resources would
        otherwise read as phantom upscale capacity."""
        now = self._clock()
        if now < self._next_check:
            return None
        self._next_check = now + self._check_interval
        target = max(self.min, min(self.max, self._feasible_workers(holding=current)))
        if target == current:
            self._pending_target = None
            return None
        if target == self._pending_target:
            self._pending_target = None
            return target
        self._pending_target = target
        return None


class _ResizeSignal(Exception):
    def __init__(self, new_size: int):
        super().__init__(f"resize to {new_size}")
        self.new_size = new_size


class MaxFailurePolicy:
    """Restart the whole group up to max_failures times (-1 = unlimited)."""

    def __init__(self, max_failures: int):
        self._max = max_failures
        self.failures = 0

    def should_restart(self) -> bool:
        self.failures += 1
        return self._max == -1 or self.failures <= self._max


class WorkerGroupError(RuntimeError):
    pass


class TrainController:
    def __init__(
        self,
        train_fn,
        *,
        train_loop_config: dict | None,
        scaling_config: ScalingConfig,
        run_config: RunConfig,
        resume_from_checkpoint: Checkpoint | None = None,
        poll_interval_s: float = 0.2,
        datasets: dict | None = None,
        scaling_policy=None,
        use_compiled_loop: bool | None = None,
    ):
        self._train_fn = train_fn
        # Structured-step mode (round 15): a TrainLoopConfig instead of a
        # closure routes the attempt through the stage-actor pipeline —
        # eager per-step dispatch or the persistent compiled loop.
        self._loop_spec = train_fn if isinstance(train_fn, TrainLoopConfig) \
            else None
        self._use_compiled_loop = use_compiled_loop
        self.loop_stats: dict | None = None
        self._config = train_loop_config or {}
        self._datasets = datasets or {}
        self._scaling = scaling_config
        self._run_config = run_config
        # scaling_policy overrides the config-derived default — tests
        # inject an ElasticScalingPolicy with a fake clock so the resize
        # debounce is call-count-driven, not wall-clock-sensitive.
        self._scaling_policy = scaling_policy or (
            ElasticScalingPolicy(scaling_config)
            if scaling_config.min_workers is not None
            else FixedScalingPolicy(scaling_config)
        )
        self._failure_policy = MaxFailurePolicy(run_config.failure_config.max_failures)
        self._ckpt_manager = CheckpointManager(run_config.checkpoint_config)
        self._resume = resume_from_checkpoint
        self._poll_interval = poll_interval_s
        self._metrics_history: list[dict] = []
        self._experiment_name: str = ""
        # Recovery accounting (resilience subsystem): one entry per
        # group restart, chaos-clock stamped at the failure and at the
        # first report of the resumed attempt — the recovery bench and
        # tests derive `recovery_train_resume_s` from these.
        self.recovery_events: list[dict] = []
        self._pending_recovery: dict | None = None

    def run(self) -> Result:
        name = self._run_config.name or f"train_{int(time.time())}"
        self._experiment_name = name
        storage = self._run_config.storage_path or os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch", "results")
        run_dir = os.path.join(storage, name)
        os.makedirs(run_dir, exist_ok=True)

        last_error: Exception | None = None
        size = self._scaling_policy.group_size()
        while True:
            group = None
            try:
                # Group creation can fail too (e.g. the placement group is
                # unschedulable because a node died and the size is stale):
                # route it through the same failure/re-size path.
                if self._loop_spec is not None:
                    # Structured-step mode: the group is the 3 resident
                    # stage actors; the step stage loads the resume
                    # checkpoint at construction.
                    resume = self._resolve_resume()
                    try:
                        group = LoopWorkerGroup.create(
                            self._scaling, name, run_dir, self._loop_spec,
                            self._config,
                            resume.path if resume else None)
                    except Exception as e:
                        raise WorkerGroupError(
                            f"train-loop stage creation failed: {e}") from e
                    self._run_attempt_loop(group)
                    break
                try:
                    group = WorkerGroup.create(
                        self._scaling, name, run_dir, num_workers=size)
                except Exception as e:
                    raise WorkerGroupError(f"worker group creation failed: {e}") from e
                # Fresh streaming splits per attempt: a restarted group must
                # not consume a dead attempt's half-drained stream.
                group.setup_datasets(self._datasets)
                self._run_attempt(group, size)
                break
            except _ResizeSignal as rs:
                # Not a failure: group-atomic restart at the new size from
                # the latest checkpoint (reference ResizeDecision handling).
                logger.info("Elastic resize: %d -> %d workers (restarting from "
                            "latest checkpoint)", size, rs.new_size)
                size = rs.new_size
                continue
            except WorkerGroupError as e:
                last_error = e
                if self._failure_policy.should_restart():
                    resume = self._resolve_resume()
                    self._pending_recovery = {
                        "failed_clock": chaos_clock.now(),
                        "attempt": self._failure_policy.failures,
                        "resume_path": resume.path if resume else None,
                        "resumed_clock": None,
                    }
                    self.recovery_events.append(self._pending_recovery)
                    logger.warning(
                        "Worker group failed (attempt %d); restarting whole "
                        "group from %s: %s",
                        self._failure_policy.failures, resume, e,
                    )
                    # Re-size on restart: a lost node may have shrunk the
                    # feasible group (elastic policies adapt, fixed repeats).
                    size = self._scaling_policy.group_size(current=0)
                    continue
                return Result(
                    metrics=self._metrics_history[-1] if self._metrics_history else None,
                    checkpoint=self._final_checkpoint(),
                    path=run_dir,
                    error=last_error,
                    metrics_history=self._metrics_history,
                    recovery_events=self.recovery_events,
                    loop_stats=self.loop_stats,
                )
            finally:
                if group is not None:
                    group.shutdown()

        return Result(
            metrics=self._metrics_history[-1] if self._metrics_history else None,
            checkpoint=self._final_checkpoint(),
            path=run_dir,
            error=None,
            metrics_history=self._metrics_history,
            recovery_events=self.recovery_events,
            loop_stats=self.loop_stats,
        )

    # ------------------------------------------------------------------
    def _resolve_resume(self) -> Checkpoint | None:
        """The checkpoint the next attempt resumes from. With async_save,
        the GCS-registered latest committed version wins — it is found
        through the control plane, so a dead worker node cannot hide it;
        the report()-registered manager is the sync-mode fallback."""
        ckpt_cfg = self._run_config.checkpoint_config
        loop_snapshots = (self._loop_spec is not None
                          and self._loop_spec.snapshot_every > 0)
        if (getattr(ckpt_cfg, "async_save", False) or loop_snapshots) \
                and self._experiment_name:
            try:
                from ..resilience import latest_registered

                entry = latest_registered(self._experiment_name)
            except Exception:
                entry = None
            if entry is not None:
                return Checkpoint(entry["path"])
        return self._ckpt_manager.latest or self._resume

    def _run_attempt_loop(self, group: LoopWorkerGroup) -> None:
        """One attempt of the structured-step pipeline. Entries flow
        through the SAME ingest as closure-mode reports (identical
        ``metrics_history``/recovery-stamp shape); any stage failure —
        creation, mid-loop death, channel teardown — maps onto
        ``WorkerGroupError`` so the controller's failure policy and
        checkpoint-resume path apply unchanged."""
        runner = TrainLoopRunner(group, self._loop_spec,
                                 use_compiled_loop=self._use_compiled_loop)

        def on_report(entry: dict) -> None:
            report = {"rank": 0,
                      "metrics": dict(entry.get("metrics") or {})}
            if "ckpt_save_block_ms" in entry:
                report["ckpt_save_block_ms"] = entry["ckpt_save_block_ms"]
            self._ingest([{"reports": [report]}])

        try:
            self.loop_stats = runner.run(on_report)
        except Exception as e:
            raise WorkerGroupError(f"train loop attempt failed: {e}") from e

    def _final_checkpoint(self):
        """Result.checkpoint: loop-mode runs resolve the latest
        GCS-registered async commit; closure mode keeps the manager."""
        if self._loop_spec is not None and self._loop_spec.snapshot_every:
            try:
                from ..resilience import latest_registered

                entry = latest_registered(self._experiment_name)
                if entry is not None:
                    return Checkpoint(entry["path"])
            except Exception:
                pass
        return self._ckpt_manager.best

    def _run_attempt(self, group: WorkerGroup, size: int) -> None:
        resume = self._resolve_resume()
        resume_path = resume.path if resume else None
        ckpt_cfg = self._run_config.checkpoint_config
        ckpt_meta = {
            "async_save": getattr(ckpt_cfg, "async_save", False),
            "every_n_steps": getattr(ckpt_cfg, "every_n_steps", 1),
            "keep_k": ckpt_cfg.num_to_keep,
        }
        try:
            group.run_on_all("run_train_fn", self._train_fn, self._config,
                             resume_path, ckpt_meta)
        except Exception as e:
            raise WorkerGroupError(f"failed to start train_fn: {e}") from e

        while True:
            try:
                polls = group.poll()
            except Exception as e:
                raise WorkerGroupError(f"lost contact with worker group: {e}") from e
            self._ingest(polls)
            for i, p in enumerate(polls):
                if p.get("error"):
                    raise WorkerGroupError(f"worker {i} failed:\n{p['error']}")
            if all(p.get("done") for p in polls):
                return
            new_size = self._scaling_policy.monitor(size)
            if new_size is not None:
                raise _ResizeSignal(new_size)
            time.sleep(self._poll_interval)

    def _ingest(self, polls: list[dict]) -> None:
        for p in polls:
            for entry in p.get("reports", []):
                if entry["rank"] == 0:
                    metrics = entry["metrics"]
                    if self._pending_recovery is not None:
                        # First report after a restart: the run has
                        # resumed — this stamp closes the recovery window.
                        self._pending_recovery["resumed_clock"] = chaos_clock.now()
                        self._pending_recovery["resume_step"] = metrics.get("step")
                        self._pending_recovery = None
                    self._metrics_history.append(metrics)
                    if "checkpoint_path" in entry:
                        self._ckpt_manager.register(
                            Checkpoint(entry["checkpoint_path"]), metrics
                        )
