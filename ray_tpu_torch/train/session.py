"""Worker-side training session: ``report()`` and ``get_context()``.

Reference: ``python/ray/train/_internal/session.py:112,405,672``
(_TrainSession.report) and v2 ``train_fn_utils.py:13``. The session lives
inside each TrainWorker actor process; ``report`` enqueues metrics (and an
optional checkpoint directory) for the controller's next poll.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import threading
import time
import uuid
from typing import Any

from .checkpoint import Checkpoint

# Per-step training gauges pushed through the metrics pipeline from each
# worker's report() (reference: ray.train step metrics on the dashboard).
_metrics_lock = threading.Lock()
_metrics: dict = {}

# report() keys mapped onto the exported tokens/s gauge, first match wins.
_TOKENS_KEYS = ("tokens_per_s", "tokens_per_sec", "tokens_per_sec_per_chip")


def _train_metrics() -> dict:
    with _metrics_lock:
        if not _metrics:
            from ..util.metrics import Gauge

            tags = ("experiment", "rank")
            _metrics["step_time"] = Gauge(
                "train_step_time_s", "Wall time between report() calls",
                tag_keys=tags)
            _metrics["tokens_per_s"] = Gauge(
                "train_tokens_per_s", "Reported training token throughput",
                tag_keys=tags)
            _metrics["mfu"] = Gauge(
                "train_mfu", "Reported model FLOPs utilization", tag_keys=tags)
        return _metrics


@dataclasses.dataclass
class TrainContext:
    world_rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    node_rank: int
    experiment_name: str
    storage_path: str

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_world_size(self) -> int:
        return self.world_size

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_local_world_size(self) -> int:
        return self.local_world_size

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_experiment_name(self) -> str:
        return self.experiment_name


class _Session:
    def __init__(self, context: TrainContext, resume_checkpoint: Checkpoint | None,
                 dataset_shards: dict | None = None, async_ckpt=None,
                 ckpt_every: int = 1):
        self.context = context
        self.resume_checkpoint = resume_checkpoint
        self.dataset_shards = dataset_shards or {}
        self._lock = threading.Lock()
        self._reports: list[dict] = []
        self._step = 0
        self._last_report_t: float | None = None
        # Async checkpointing (resilience subsystem): rank 0 holds the
        # manager; report(state=...) snapshots + background-commits every
        # `ckpt_every` reports without blocking the train step.
        self._async_ckpt = async_ckpt
        self._ckpt_every = max(1, int(ckpt_every or 1))

    def _export_step_metrics(self, metrics: dict) -> None:
        """Per-step gauges (step_time_s / tokens_per_s / mfu) so training
        progress is visible on the metrics/Grafana path, not only in the
        controller's result log. Never raises into the train loop."""
        try:
            tags = {"experiment": self.context.experiment_name,
                    "rank": str(self.context.world_rank)}
            m = _train_metrics()
            now = time.monotonic()
            if self._last_report_t is not None:
                m["step_time"].set(now - self._last_report_t, tags)
            self._last_report_t = now
            for key in _TOKENS_KEYS:
                if key in metrics:
                    m["tokens_per_s"].set(float(metrics[key]), tags)
                    break
            if "mfu" in metrics:
                m["mfu"].set(float(metrics["mfu"]), tags)
        except Exception:
            pass

    def report(self, metrics: dict, checkpoint: Checkpoint | None = None,
               state=None) -> None:
        entry: dict[str, Any] = {"metrics": dict(metrics or {}), "rank": self.context.world_rank}
        self._export_step_metrics(entry["metrics"])
        if state is not None and self._async_ckpt is not None:
            if self._step % self._ckpt_every == 0:
                block_ms = self._async_ckpt.save(
                    self._step, state, metrics=entry["metrics"])
                entry["ckpt_save_block_ms"] = round(block_ms, 3)
        if checkpoint is not None:
            # persist into run storage so it outlives the worker's tmpdir
            dest = os.path.join(
                self.context.storage_path,
                f"checkpoint_{self._step:06d}_{uuid.uuid4().hex[:6]}",
            )
            if os.path.abspath(checkpoint.path) != dest:
                shutil.copytree(checkpoint.path, dest, dirs_exist_ok=True)
            entry["checkpoint_path"] = dest
        self._step += 1
        with self._lock:
            self._reports.append(entry)

    def drain(self) -> list[dict]:
        with self._lock:
            out, self._reports = self._reports, []
        return out


_session: _Session | None = None


def _set_session(s: _Session | None) -> None:
    global _session
    _session = s


def _get_session() -> _Session:
    if _session is None:
        raise RuntimeError(
            "No training session active — report()/get_context() are only "
            "valid inside a train_fn launched by a Trainer"
        )
    return _session


def report(metrics: dict, checkpoint: Checkpoint | None = None,
           state=None) -> None:
    """Report metrics (+ optional checkpoint) from the train loop.
    Reference: v2/api/train_fn_utils.py:13.

    With ``CheckpointConfig(async_save=True, every_n_steps=N)``, pass the
    train-state pytree as ``state=`` — rank 0 snapshots it and commits a
    checkpoint from a background thread every N reports (atomic commit +
    GCS registration; the step never blocks on I/O). Put everything
    recovery needs inside the tree: parameters, the step counter, the
    data-iterator position."""
    _get_session().report(metrics, checkpoint, state=state)


def get_context() -> TrainContext:
    """Reference: ray.train.get_context()."""
    return _get_session().context


def get_checkpoint() -> Checkpoint | None:
    """Checkpoint to resume from, if the controller restored one."""
    return _get_session().resume_checkpoint


def get_dataset_shard(name: str = "train"):
    """This rank's streaming DataIterator for the named dataset passed to
    the Trainer (reference: ``ray.train.get_dataset_shard``,
    ``python/ray/train/_internal/session.py:672``)."""
    shard = _get_session().dataset_shards.get(name)
    if shard is None:
        raise KeyError(
            f"No dataset {name!r} was passed to the Trainer "
            f"(available: {sorted(_get_session().dataset_shards)})"
        )
    return shard
