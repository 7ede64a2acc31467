"""Tuner + TuneController: concurrent trial execution with schedulers.

Reference: ``python/ray/tune/tuner.py:312`` (Tuner.fit) →
``execution/tune_controller.py:68`` (step:666). Trials run as actors
(the Train worker actor is reused — a trial is a one-worker train run);
the controller polls results, feeds searcher/scheduler, and enforces
stop decisions. PBT restarts trials in place with exploited configs.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable

from ..core import api as ray
from ..train.checkpoint import Checkpoint, CheckpointManager
from ..train.config import CheckpointConfig, Result, RunConfig
from ..train.worker_group import TrainWorker
from .callback import CallbackList
from .schedulers import CONTINUE, STOP, FIFOScheduler, PopulationBasedTraining
from .search import BasicVariantGenerator


@dataclasses.dataclass
class TuneConfig:
    metric: str | None = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int = 4
    scheduler: Any = None
    search_alg: Any = None
    seed: int | None = None


class Trial:
    _counter = 0

    def __init__(self, config: dict, trial_dir: str):
        Trial._counter += 1
        self.trial_id = f"trial_{Trial._counter:05d}"
        self.config = config
        self.dir = trial_dir
        self.actor = None
        self.state = "PENDING"
        self.last_metrics: dict | None = None
        self.metrics_history: list[dict] = []
        self.error: str | None = None
        self.ckpt_manager: CheckpointManager | None = None
        self.resume_path: str | None = None


class ResultGrid:
    def __init__(self, results: list[Result]):
        self._results = results

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    @property
    def errors(self):
        return [r.error for r in self._results if r.error]

    def get_best_result(self, metric: str | None = None, mode: str = "max") -> Result:
        sign = 1.0 if mode == "max" else -1.0
        scored = [r for r in self._results if r.metrics and metric in r.metrics]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        return max(scored, key=lambda r: sign * float(r.metrics[metric]))

    def get_dataframe(self):
        import pandas as pd

        return pd.DataFrame([r.metrics or {} for r in self._results])


class Tuner:
    def __init__(
        self,
        trainable: Callable[[dict], None],
        *,
        param_space: dict | None = None,
        tune_config: TuneConfig | None = None,
        run_config: RunConfig | None = None,
    ):
        self._trainable = trainable
        self._param_space = param_space or {}
        self._tune_config = tune_config or TuneConfig()
        self._run_config = run_config or RunConfig()
        self._restore_dir: str | None = None

    @classmethod
    def restore(cls, path: str, trainable: Callable[[dict], None], *,
                tune_config: TuneConfig | None = None,
                run_config: RunConfig | None = None) -> "Tuner":
        """Reattach to an interrupted experiment (reference
        ``Tuner.restore``): completed trials keep their results; pending,
        running, and errored trials re-run, resuming from their latest
        checkpoint when one was registered. Pass the SAME tune_config /
        run_config as the original run — scheduler and checkpoint policy
        are code, not persisted state (defaults: FIFO scheduler, default
        checkpoint retention)."""
        tuner = cls(trainable, tune_config=tune_config, run_config=run_config)
        tuner._restore_dir = path
        return tuner

    # ------------------------------------------------------- state snapshot
    @staticmethod
    def _save_experiment_state(exp_dir: str, trials: list[Trial]) -> None:
        from .._vendor import cloudpickle

        state = [
            {
                "trial_id": t.trial_id,
                "config": t.config,
                "dir": t.dir,
                "state": t.state,
                "last_metrics": t.last_metrics,
                "metrics_history": t.metrics_history,
                "error": t.error,
                "latest_checkpoint": (
                    t.ckpt_manager.latest.path
                    if t.ckpt_manager and t.ckpt_manager.latest else None
                ),
            }
            for t in trials
        ]
        tmp = os.path.join(exp_dir, "experiment_state.pkl.tmp")
        with open(tmp, "wb") as f:
            cloudpickle.dump(state, f)
        os.replace(tmp, os.path.join(exp_dir, "experiment_state.pkl"))

    def _load_trials_for_restore(self, ckpt_cfg) -> list[Trial]:
        import pickle

        with open(os.path.join(self._restore_dir, "experiment_state.pkl"), "rb") as f:
            state = pickle.load(f)
        trials = []
        for entry in state:
            t = Trial(entry["config"], entry["dir"])
            t.trial_id = entry["trial_id"]
            t.metrics_history = entry["metrics_history"]
            t.last_metrics = entry["last_metrics"]
            t.ckpt_manager = CheckpointManager(ckpt_cfg)
            if entry["latest_checkpoint"] and os.path.exists(entry["latest_checkpoint"]):
                t.ckpt_manager.register(
                    Checkpoint(entry["latest_checkpoint"]), entry["last_metrics"] or {}
                )
            if entry["state"] == "TERMINATED" and not entry["error"]:
                t.state = "TERMINATED"  # keep its result; don't re-run
            else:
                t.state = "PENDING"
                t.error = None
                t.resume_path = entry["latest_checkpoint"]
                # Fresh attempt: stale history would double-count and make
                # schedulers see training_iteration jump backwards.
                t.metrics_history = []
                t.last_metrics = None
            trials.append(t)
        return trials

    def fit(self) -> ResultGrid:
        tc = self._tune_config
        ckpt_cfg = self._run_config.checkpoint_config or CheckpointConfig()
        callbacks = CallbackList(getattr(self._run_config, "callbacks", None))
        searcher = None  # sequential (suggest/on_trial_complete) searcher
        to_suggest = 0
        if self._restore_dir is not None:
            exp_dir = self._restore_dir
            name = os.path.basename(exp_dir.rstrip("/"))
            trials = self._load_trials_for_restore(ckpt_cfg)
            scheduler = tc.scheduler or FIFOScheduler()
        else:
            name = self._run_config.name or f"tune_{int(time.time())}"
            storage = self._run_config.storage_path or os.path.join(
                tempfile.gettempdir(), "ray_tpu_torch", "results")
            exp_dir = os.path.join(storage, name)
            os.makedirs(exp_dir, exist_ok=True)

            search = tc.search_alg or BasicVariantGenerator(seed=tc.seed)
            scheduler = tc.scheduler or FIFOScheduler()
            if hasattr(search, "suggest"):
                # Sequential model-based search (TPE/BO): configs are
                # proposed one at a time, informed by completed trials
                # (reference: SearchGenerator over a Searcher).
                searcher = search
                searcher.set_space(self._param_space)
                to_suggest = tc.num_samples
                trials = []
            else:
                configs = search.generate(self._param_space, tc.num_samples)
                trials = [
                    Trial(cfg, os.path.join(exp_dir, f"trial_{i:05d}"))
                    for i, cfg in enumerate(configs)
                ]
                for t in trials:
                    os.makedirs(t.dir, exist_ok=True)
                    t.ckpt_manager = CheckpointManager(ckpt_cfg)
        self._save_experiment_state(exp_dir, trials)
        callbacks.setup(experiment_dir=exp_dir)

        def new_trial(cfg: dict) -> Trial:
            t = Trial(cfg, os.path.join(exp_dir, f"trial_{len(trials):05d}"))
            os.makedirs(t.dir, exist_ok=True)
            t.ckpt_manager = CheckpointManager(ckpt_cfg)
            trials.append(t)
            return t

        pending = [t for t in trials if t.state == "PENDING"]
        running: list[Trial] = []
        worker_cls = ray.remote(TrainWorker)

        def start(trial: Trial) -> None:
            trial.actor = worker_cls.options(name=f"tune_{name}_{trial.trial_id}_{time.monotonic_ns()}").remote(
                0, 1, trial.trial_id, trial.dir
            )
            ray.get(
                trial.actor.run_train_fn.remote(self._trainable, trial.config, trial.resume_path),
                timeout=60,
            )
            trial.state = "RUNNING"
            callbacks.on_trial_start(trial)

        def finish(trial: Trial) -> None:
            nonlocal to_suggest
            if searcher is not None:
                searcher.on_trial_complete(trial.config, trial.last_metrics)
            if trial.state == "ERROR":
                callbacks.on_trial_error(trial)
            else:
                callbacks.on_trial_complete(trial)

        try:
            while pending or running or to_suggest > 0:
                while to_suggest > 0 and len(running) + len(pending) < tc.max_concurrent_trials:
                    pending.append(new_trial(searcher.suggest()))
                    to_suggest -= 1
                while pending and len(running) < tc.max_concurrent_trials:
                    trial = pending.pop(0)
                    start(trial)
                    running.append(trial)

                time.sleep(0.1)
                for trial in list(running):
                    try:
                        poll = ray.get(trial.actor.poll.remote(), timeout=30)
                    except Exception as e:
                        trial.state = "ERROR"
                        trial.error = str(e)
                        running.remove(trial)
                        finish(trial)
                        continue
                    decision = CONTINUE
                    for entry in poll["reports"]:
                        metrics = entry["metrics"]
                        trial.last_metrics = metrics
                        trial.metrics_history.append(metrics)
                        callbacks.on_trial_result(trial, metrics)
                        if "checkpoint_path" in entry:
                            trial.ckpt_manager.register(Checkpoint(entry["checkpoint_path"]), metrics)
                        decision = scheduler.on_result(trial, metrics)
                        if decision == STOP:
                            break
                        if isinstance(scheduler, PopulationBasedTraining):
                            new_cfg = scheduler.maybe_exploit(trial, metrics, trials)
                            if new_cfg is not None:
                                donor = next(
                                    t for t in trials
                                    if t.trial_id == new_cfg["_pbt_exploit_from"]
                                )
                                trial.config = {k: v for k, v in new_cfg.items()
                                                if k != "_pbt_exploit_from"}
                                donor_ckpt = donor.ckpt_manager.latest if donor.ckpt_manager else None
                                trial.resume_path = donor_ckpt.path if donor_ckpt else None
                                ray.kill(trial.actor)
                                start(trial)
                                decision = CONTINUE
                                break
                    if decision == STOP:
                        trial.state = "TERMINATED"
                        ray.kill(trial.actor)
                        running.remove(trial)
                        finish(trial)
                        self._save_experiment_state(exp_dir, trials)
                    elif poll.get("error"):
                        trial.state = "ERROR"
                        trial.error = poll["error"]
                        ray.kill(trial.actor)
                        running.remove(trial)
                        finish(trial)
                        self._save_experiment_state(exp_dir, trials)
                    elif poll.get("done"):
                        trial.state = "TERMINATED"
                        ray.kill(trial.actor)
                        running.remove(trial)
                        finish(trial)
                        self._save_experiment_state(exp_dir, trials)

        finally:
            # error paths (actor-start timeout, Ctrl-C) must still
            # close logger files / flush TB writers
            callbacks.on_experiment_end(trials)
        self._save_experiment_state(exp_dir, trials)
        results = [
            Result(
                metrics=t.last_metrics,
                checkpoint=t.ckpt_manager.best if t.ckpt_manager else None,
                path=t.dir,
                error=RuntimeError(t.error) if t.error else None,
                metrics_history=t.metrics_history,
            )
            for t in trials
        ]
        return ResultGrid(results)
