"""Worker group: N worker actors placed as one atomic unit.

Reference: ``python/ray/train/v2/_internal/execution/worker_group/
worker_group.py:102`` and v1 ``backend_executor.py:226`` (placement
group creation). The group is scheduled with a placement group so its
resources (a ``GPU`` per worker by default) are claimed atomically. A
worker that holds a ``GPU`` starts cold (never forked from a zygote: CUDA
does not survive a fork) and sees the host's cards. Workers of one group
share no process group yet: ``torch.distributed`` groups (the reference's
``_setup_torch_process_group``, ``torch/config.py:66``) come with ROADMAP
queue A item 7.
"""

from __future__ import annotations

import logging
import threading
import traceback

from ..core import api as ray
from ..util import PlacementGroupSchedulingStrategy, placement_group, remove_placement_group
from .checkpoint import Checkpoint
from .session import TrainContext, _Session, _set_session

logger = logging.getLogger(__name__)


class TrainWorker:
    """Actor hosting one process of the training job. ``train_fn`` runs on
    a thread of the actor (CUDA work on it is fine)."""

    def __init__(self, world_rank: int, world_size: int, experiment_name: str,
                 storage_path: str):
        self._context = TrainContext(
            world_rank=world_rank,
            world_size=world_size,
            local_rank=0,
            local_world_size=1,
            node_rank=world_rank,
            experiment_name=experiment_name,
            storage_path=storage_path,
        )
        self._dataset_shards: dict = {}
        self._thread: threading.Thread | None = None
        self._session: _Session | None = None
        self._error: str | None = None
        self._done = False

    def set_dataset_shards(self, shards: dict) -> bool:
        """Receive this rank's DataIterator per dataset name (reference:
        ``dataset.py:1598`` streaming_split → per-worker iterators)."""
        self._dataset_shards = shards
        return True

    def run_train_fn(self, train_fn, config: dict, resume_path: str | None,
                     ckpt: dict | None = None) -> bool:
        import os

        resume = Checkpoint(resume_path) if resume_path else None
        ckpt = ckpt or {}
        async_mgr = None
        if ckpt.get("async_save") and self._context.world_rank == 0:
            # Rank 0 owns the async checkpoint stream (state is
            # replicated or reassembled by the train_fn; one writer keeps
            # commits linear). Root lives in run storage so checkpoints
            # outlive the worker — and the node.
            from ..resilience import AsyncCheckpointManager

            async_mgr = AsyncCheckpointManager(
                os.path.join(self._context.storage_path, "async_ckpts"),
                run_name=self._context.experiment_name,
                keep_k=ckpt.get("keep_k") or 2,
            )
        self._session = _Session(
            self._context, resume, dataset_shards=self._dataset_shards,
            async_ckpt=async_mgr,
            ckpt_every=int(ckpt.get("every_n_steps") or 1))
        self._error = None
        self._done = False

        def runner():
            _set_session(self._session)
            try:
                train_fn(config)
            except BaseException:
                self._error = traceback.format_exc()
            finally:
                if async_mgr is not None:
                    # A clean exit must not lose the tail checkpoint that
                    # is still in the writer queue.
                    try:
                        async_mgr.close(timeout=30.0)
                    except Exception:
                        pass
                self._done = True
                _set_session(None)

        self._thread = threading.Thread(target=runner, daemon=True)
        self._thread.start()
        return True

    def poll(self) -> dict:
        reports = self._session.drain() if self._session else []
        return {"reports": reports, "done": self._done, "error": self._error}

    def shutdown(self) -> bool:
        return True


class LoopWorkerGroup:
    """Structured-step mode: instead of N closure-driven
    workers, the group is the THREE resident stage actors of
    ``train/loop.py`` — data-loader, train-step, checkpoint-snapshot —
    placed as one atomic unit so the controller's group-atomic
    failure/restart discipline applies unchanged: any stage death tears
    the whole pipeline down and the next attempt resumes from the
    latest GCS-registered async checkpoint."""

    STAGE_NAMES = ("data", "step", "ckpt")

    def __init__(self, data, step, ckpt, pg):
        self.data = data
        self.step = step
        self.ckpt = ckpt
        self._pg = pg

    @classmethod
    def create(cls, scaling_config, experiment_name: str, storage_path: str,
               spec, config: dict, resume_path: str | None
               ) -> "LoopWorkerGroup":
        from .loop import CkptStage, DataLoaderStage, TrainStepStage

        # The step stage owns the devices (the trainer's worker
        # resources); loader + committer are host-side helpers.
        bundles = [{"CPU": 0.5}, dict(scaling_config.worker_resources()),
                   {"CPU": 0.5}]
        pg = placement_group(bundles,
                             strategy=scaling_config.placement_strategy)
        if not pg.wait(timeout_seconds=60.0):
            remove_placement_group(pg)
            raise TimeoutError(
                "placement group for the 3 train-loop stages not ready "
                "within 60s")

        def make(cls_, idx, name, *args):
            return ray.remote(cls_).options(
                resources=dict(bundles[idx]),
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    placement_group=pg, placement_group_bundle_index=idx),
                name=f"train_loop_{experiment_name}_{name}",
                runtime_env=scaling_config.worker_runtime_env,
            ).remote(*args)

        data = make(DataLoaderStage, 0, "data", spec, config)
        step = make(TrainStepStage, 1, "step", spec, config, resume_path)
        ckpt = make(CkptStage, 2, "ckpt", spec, config, storage_path,
                    experiment_name)
        group = cls(data, step, ckpt, pg)
        try:
            # Readiness probe: constructor errors (bad init_fn, corrupt
            # resume checkpoint) surface HERE, as a group-creation
            # failure, not mid-loop.
            ray.get(step.start_step.remote(), timeout=120)
        except Exception:
            group.shutdown()
            raise
        return group

    @property
    def actors(self) -> list:
        return [self.data, self.step, self.ckpt]

    def shutdown(self) -> None:
        for a in self.actors:
            try:
                ray.kill(a)
            except Exception:
                pass
        try:
            remove_placement_group(self._pg)
        except Exception:
            pass


class WorkerGroup:
    """Creates, polls and tears down the worker actors as one unit."""

    def __init__(self, workers, pg):
        self.workers = workers
        self._pg = pg
        self._splits: dict = {}

    @classmethod
    def create(cls, scaling_config, experiment_name: str, storage_path: str,
               num_workers: int | None = None) -> "WorkerGroup":
        n = num_workers if num_workers is not None else scaling_config.num_workers
        res = scaling_config.worker_resources()
        bundles = [dict(res) for _ in range(n)]
        pg = placement_group(bundles, strategy=scaling_config.placement_strategy)
        if not pg.wait(timeout_seconds=60.0):
            remove_placement_group(pg)
            raise TimeoutError(
                f"placement group for {n} train workers not ready within 60s"
            )
        actor_cls = ray.remote(TrainWorker)
        workers = [
            actor_cls.options(
                resources=dict(bundles[i]),
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    placement_group=pg, placement_group_bundle_index=i
                ),
                name=f"train_worker_{experiment_name}_{i}",
                runtime_env=scaling_config.worker_runtime_env,
            ).remote(i, n, experiment_name, storage_path)
            for i in range(n)
        ]
        return cls(workers, pg)

    def setup_datasets(self, datasets: dict) -> None:
        """streaming_split each dataset across the group; worker i consumes
        split i. The split iterators are pinned on this group so their
        coordinator actors live exactly as long as the attempt."""
        if not datasets:
            return
        n = len(self.workers)
        self._splits = {name: ds.streaming_split(n) for name, ds in datasets.items()}
        refs = []
        for i, w in enumerate(self.workers):
            shards = {name: splits[i] for name, splits in self._splits.items()}
            refs.append(w.set_dataset_shards.remote(shards))
        ray.get(refs, timeout=120)

    def run_on_all(self, method: str, *args, timeout: float = 120.0):
        refs = [getattr(w, method).remote(*args) for w in self.workers]
        return ray.get(refs, timeout=timeout)

    def poll(self, timeout: float = 60.0) -> list[dict]:
        """Per-worker harvest: a dead worker yields an ``error`` entry
        instead of discarding the whole batch — reports already produced
        by surviving workers (rank-0 metrics + checkpoint registrations)
        must still reach the controller's ingest before the group failure
        is raised, or the attempt's progress is silently lost."""
        refs = [w.poll.remote() for w in self.workers]
        out = []
        for i, ref in enumerate(refs):
            try:
                out.append(ray.get(ref, timeout=timeout))
            except Exception as e:
                out.append({"error": f"worker {i} poll failed: {e}"})
        return out

    def shutdown(self) -> None:
        try:
            self.run_on_all("shutdown", timeout=10.0)
        except Exception:
            pass
        for w in self.workers:
            try:
                ray.kill(w)
            except Exception:
                pass
        for splits in self._splits.values():
            for it in splits:
                try:
                    ray.kill(it._coord)
                except Exception:
                    pass
        self._splits = {}
        try:
            remove_placement_group(self._pg)
        except Exception:
            pass
