"""Train configuration objects.

Reference: AIR ``python/ray/air/config.py`` (ScalingConfig:103,
FailureConfig:398, CheckpointConfig:448, RunConfig:597). A worker holds
one CUDA card (``use_gpu``, the default); the worker group is the atomic
scheduling/failure unit (SURVEY.md §7.3-4).
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class ScalingConfig:
    """How many workers and what each one holds.

    num_workers: worker processes.
    use_gpu: request one ``GPU`` for each worker (default True: the card,
      as every entry point of the port; tests pass ``use_gpu=False``). A
      node without a free card leaves the group's placement unscheduled,
      and the group fails to start after its 60 s wait.
    topology: multi-host groups; not ported yet (``torch.distributed``
      groups come with ROADMAP queue A item 7) and raises.
    """

    num_workers: int = 1
    use_gpu: bool = True
    resources_per_worker: dict | None = None
    topology: str | None = None
    placement_strategy: str = "PACK"
    # Elastic training (reference v2 scaling_policy/scaling_policy.py:29):
    # when set, `num_workers` becomes the MAX and the controller sizes the
    # group to observed cluster capacity in [min_workers, num_workers],
    # restarting slice-atomically from the latest checkpoint on resize.
    min_workers: int | None = None
    # Per-worker runtime env ({"env_vars": {...}}). A worker that holds a
    # GPU gets CUDA_VISIBLE_DEVICES unset by the runtime (other workers
    # see no card).
    worker_runtime_env: dict | None = None

    def __post_init__(self):
        if self.topology is not None:
            raise NotImplementedError(
                "ScalingConfig(topology=...) is not ported yet: multi-host "
                "torch.distributed groups come with ROADMAP queue A item 7")

    def worker_resources(self) -> dict:
        res = dict(self.resources_per_worker or {})
        if not res:
            res = {"CPU": 1.0}
        if self.use_gpu and "GPU" not in res:
            res["GPU"] = 1.0
        return res


@dataclasses.dataclass
class FailureConfig:
    """max_failures: group-level restarts; -1 = unlimited. The whole worker
    group (slice) restarts together — per-worker restart is meaningless
    under SPMD (a dead host invalidates every peer's collectives)."""

    max_failures: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: int | None = None
    checkpoint_score_attribute: str | None = None
    checkpoint_score_order: str = "max"
    # Async checkpointing (resilience/checkpoint.py): rank 0
    # snapshots the ``state=`` tree passed to ``train.report`` and
    # commits it from a background thread every ``every_n_steps`` reports
    # — the train step never blocks on I/O, commits are atomic (tmp dir +
    # commit marker + rename, keep-K via num_to_keep), and each committed
    # version registers with the GCS so recovery after node loss resolves
    # the latest checkpoint without touching the dead node.
    async_save: bool = False
    every_n_steps: int = 1


@dataclasses.dataclass
class RunConfig:
    name: str | None = None
    storage_path: str | None = None
    checkpoint_config: CheckpointConfig = dataclasses.field(default_factory=CheckpointConfig)
    failure_config: FailureConfig = dataclasses.field(default_factory=FailureConfig)
    # Tune lifecycle callbacks (tune.Callback instances — e.g. the
    # bundled Json/CSV/TBX logger callbacks); ignored by bare Train runs.
    callbacks: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Result:
    """What ``fit()`` returns. Reference: ``ray/air/result.py``."""

    metrics: dict[str, Any] | None
    checkpoint: Any | None
    path: str | None
    error: Exception | None = None
    metrics_history: list[dict] = dataclasses.field(default_factory=list)
    # One entry per group restart (resilience): chaos-clock stamps of the
    # failure and of the first resumed report, plus the resume path — the
    # recovery bench derives `recovery_train_resume_s` from these.
    recovery_events: list[dict] = dataclasses.field(default_factory=list)
    # TrainLoopConfig runs only (train/loop.py): per-run drive statistics —
    # mode, per-step wall, checkpoint-commit windows and
    # `train_ckpt_overlap_frac` (fraction of checkpoint commit time that
    # overlapped step compute; the bench records it as a guarded cell).
    loop_stats: dict | None = None

    @property
    def best_checkpoints(self) -> list:
        return [self.checkpoint] if self.checkpoint else []
