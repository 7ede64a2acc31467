"""Tune callbacks and file loggers.

Equivalent of the reference's callback/logger stack —
``python/ray/tune/callback.py`` (Callback interface),
``tune/logger/json.py``, ``logger/csv.py``, ``logger/tensorboardx.py``.
Callbacks hang off ``RunConfig.callbacks`` and the TuneController calls
them at trial lifecycle points; the bundled loggers write per-trial
``result.json`` / ``progress.csv`` / TensorBoard event files into each
trial's directory, so standard dashboards point at the experiment dir
unchanged.
"""

from __future__ import annotations

import csv
import json
import numbers
import os
from typing import Any


class Callback:
    """Lifecycle hooks (subset of reference tune.Callback): override any."""

    def setup(self, **info) -> None:
        pass

    def on_trial_start(self, trial) -> None:
        pass

    def on_trial_result(self, trial, result: dict) -> None:
        pass

    def on_trial_complete(self, trial) -> None:
        pass

    def on_trial_error(self, trial) -> None:
        pass

    def on_experiment_end(self, trials: list) -> None:
        pass


class CallbackList:
    """Fans every hook out to each callback; one callback's failure is
    logged, not fatal to the experiment (reference behavior)."""

    def __init__(self, callbacks: list[Callback] | None):
        self._callbacks = list(callbacks or [])

    def __bool__(self) -> bool:
        return bool(self._callbacks)

    def _fan(self, hook: str, *args, **kwargs) -> None:
        import logging

        for cb in self._callbacks:
            try:
                getattr(cb, hook)(*args, **kwargs)
            except Exception:
                logging.getLogger(__name__).exception(
                    "tune callback %s.%s failed", type(cb).__name__, hook)

    def setup(self, **info):
        self._fan("setup", **info)

    def on_trial_start(self, trial):
        self._fan("on_trial_start", trial)

    def on_trial_result(self, trial, result):
        self._fan("on_trial_result", trial, result)

    def on_trial_complete(self, trial):
        self._fan("on_trial_complete", trial)

    def on_trial_error(self, trial):
        self._fan("on_trial_error", trial)

    def on_experiment_end(self, trials):
        self._fan("on_experiment_end", trials)


class JsonLoggerCallback(Callback):
    """One JSON line per reported result: ``<trial.dir>/result.json``."""

    def __init__(self):
        self._files: dict[str, Any] = {}

    def on_trial_start(self, trial) -> None:
        if trial.trial_id in self._files:
            return  # PBT exploit restart: keep the open file
        os.makedirs(trial.dir, exist_ok=True)
        # "w": a restore re-runs the trial with reset history, so stale
        # lines from the aborted attempt must not double-count
        self._files[trial.trial_id] = open(
            os.path.join(trial.dir, "result.json"), "w")

    def on_trial_result(self, trial, result: dict) -> None:
        f = self._files.get(trial.trial_id)
        if f is None:
            return
        json.dump(result, f, default=str)
        f.write("\n")
        f.flush()

    def _close(self, trial) -> None:
        f = self._files.pop(trial.trial_id, None)
        if f is not None:
            f.close()

    on_trial_complete = _close
    on_trial_error = _close

    def on_experiment_end(self, trials) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()


class CSVLoggerCallback(Callback):
    """``<trial.dir>/progress.csv`` — header from the FIRST result; later
    keys outside it are dropped (the reference's CSV logger contract)."""

    def __init__(self):
        self._writers: dict[str, tuple[Any, Any, list[str]]] = {}

    def on_trial_start(self, trial) -> None:
        os.makedirs(trial.dir, exist_ok=True)

    def on_trial_result(self, trial, result: dict) -> None:
        entry = self._writers.get(trial.trial_id)
        if entry is None:
            # "w": restore re-runs reset trials; appending would write a
            # second header mid-file (in-process PBT restarts reuse the
            # live writer entry, so nothing is lost there)
            f = open(os.path.join(trial.dir, "progress.csv"), "w", newline="")
            fields = list(result.keys())
            w = csv.DictWriter(f, fieldnames=fields, extrasaction="ignore")
            w.writeheader()
            self._writers[trial.trial_id] = entry = (f, w, fields)
        f, w, _fields = entry
        w.writerow({k: result.get(k) for k in _fields})
        f.flush()

    def _close(self, trial) -> None:
        entry = self._writers.pop(trial.trial_id, None)
        if entry is not None:
            entry[0].close()

    on_trial_complete = _close
    on_trial_error = _close

    def on_experiment_end(self, trials) -> None:
        for f, _w, _f2 in self._writers.values():
            f.close()
        self._writers.clear()


class TBXLoggerCallback(Callback):
    """TensorBoard event files per trial (scalar metrics only), via
    ``torch.utils.tensorboard`` (present in this image; the reference
    uses tensorboardX)."""

    def __init__(self):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except Exception as e:  # pragma: no cover - env without torch tb
            raise ImportError(
                "TBXLoggerCallback needs torch.utils.tensorboard "
                f"(unavailable: {e})") from e
        self._writer_cls = SummaryWriter
        self._writers: dict[str, Any] = {}
        self._steps: dict[str, int] = {}

    def on_trial_start(self, trial) -> None:
        if trial.trial_id in self._writers:
            return  # PBT exploit restart: keep writer and step counter
        self._writers[trial.trial_id] = self._writer_cls(log_dir=trial.dir)
        self._steps[trial.trial_id] = 0

    def on_trial_result(self, trial, result: dict) -> None:
        w = self._writers.get(trial.trial_id)
        if w is None:
            return
        step = int(result.get("training_iteration",
                              self._steps[trial.trial_id]))
        self._steps[trial.trial_id] += 1
        for k, v in result.items():
            if isinstance(v, numbers.Number) and not isinstance(v, bool):
                w.add_scalar(k, float(v), global_step=step)
        w.flush()

    def _close(self, trial) -> None:
        w = self._writers.pop(trial.trial_id, None)
        if w is not None:
            w.close()
        self._steps.pop(trial.trial_id, None)

    on_trial_complete = _close
    on_trial_error = _close

    def on_experiment_end(self, trials) -> None:
        for w in self._writers.values():
            w.close()
        self._writers.clear()


DEFAULT_LOGGERS = (JsonLoggerCallback, CSVLoggerCallback)
