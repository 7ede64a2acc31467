"""Trial schedulers: FIFO, ASHA, PBT.

Reference: ``python/ray/tune/schedulers/`` — ``async_hyperband.py``
(ASHA), ``pbt.py`` (PopulationBasedTraining). Decisions are made on each
reported result: CONTINUE / STOP; PBT additionally mutates a trial's
config from a better trial's checkpoint at perturbation intervals.
"""

from __future__ import annotations

import random
from typing import Any

CONTINUE = "CONTINUE"
STOP = "STOP"


class FIFOScheduler:
    def on_result(self, trial, metrics: dict) -> str:
        return CONTINUE


class AsyncHyperBandScheduler:
    """ASHA: promote only the top 1/reduction_factor of trials past each
    rung milestone; stop the rest at the rung. Reference:
    schedulers/async_hyperband.py."""

    def __init__(
        self,
        *,
        metric: str,
        mode: str = "max",
        time_attr: str = "training_iteration",
        max_t: int = 100,
        grace_period: int = 1,
        reduction_factor: int = 4,
    ):
        self._metric = metric
        self._sign = 1.0 if mode == "max" else -1.0
        self._time_attr = time_attr
        self._max_t = max_t
        # rung milestones: grace_period * rf^k up to max_t
        self._rungs: list[int] = []
        t = grace_period
        while t < max_t:
            self._rungs.append(t)
            t *= reduction_factor
        self._rf = reduction_factor
        self._rung_scores: dict[int, list[float]] = {r: [] for r in self._rungs}
        self._trial_rung: dict[Any, int] = {}

    def on_result(self, trial, metrics: dict) -> str:
        t = metrics.get(self._time_attr, 0)
        score = self._sign * float(metrics.get(self._metric, float("-inf")))
        for rung in self._rungs:
            if t >= rung and self._trial_rung.get(trial, -1) < rung:
                self._trial_rung[trial] = rung
                scores = self._rung_scores[rung]
                scores.append(score)
                if len(scores) >= 2:
                    import numpy as np

                    # promote only the top 1/rf fraction recorded so far
                    cutoff = float(np.percentile(scores, (1 - 1 / self._rf) * 100))
                    if score < cutoff:
                        return STOP
        return CONTINUE


class HyperBandScheduler:
    """Multi-bracket HyperBand (stop-based, ASHA-promotion variant):
    trials are dealt round-robin into ``s_max+1`` brackets with different
    initial budgets; within a bracket, each rung keeps the top
    1/``reduction_factor``. Brackets with small grace periods kill bad
    configs early; the conservative bracket never early-stops — the
    hedge that distinguishes HyperBand from single-bracket ASHA.
    Reference: ``tune/schedulers/hyperband.py`` (bracket structure) with
    async stop decisions (``async_hyperband.py:187`` _Bracket rungs).
    """

    def __init__(self, *, metric: str, mode: str = "max",
                 time_attr: str = "training_iteration", max_t: int = 81,
                 reduction_factor: int = 3):
        import math

        self._sign = 1.0 if mode == "max" else -1.0
        self._metric = metric
        self._time_attr = time_attr
        s_max = int(math.log(max_t, reduction_factor))
        # bracket s: grace period rf^s (s = s_max is the no-early-stop one)
        self._brackets = [
            AsyncHyperBandScheduler(
                metric=metric, mode=mode, time_attr=time_attr, max_t=max_t,
                grace_period=reduction_factor ** s,
                reduction_factor=reduction_factor,
            )
            for s in range(s_max + 1)
        ]
        self._assignment: dict[Any, int] = {}
        self._next = 0

    def on_result(self, trial, metrics: dict) -> str:
        idx = self._assignment.get(trial)
        if idx is None:
            idx = self._assignment[trial] = self._next % len(self._brackets)
            self._next += 1
        return self._brackets[idx].on_result(trial, metrics)


class MedianStoppingRule:
    """Stop a trial whose best result so far is worse than the median of
    the other trials' RUNNING MEANS at the same step (reference
    ``tune/schedulers/median_stopping_rule.py``)."""

    def __init__(self, *, metric: str, mode: str = "max",
                 time_attr: str = "training_iteration",
                 grace_period: int = 5, min_samples_required: int = 3):
        self._metric = metric
        self._sign = 1.0 if mode == "max" else -1.0
        self._time_attr = time_attr
        self._grace = grace_period
        self._min_samples = min_samples_required
        self._history: dict[Any, list[float]] = {}
        self._best: dict[Any, float] = {}

    def on_result(self, trial, metrics: dict) -> str:
        score = self._sign * float(metrics.get(self._metric, float("-inf")))
        self._history.setdefault(trial, []).append(score)
        self._best[trial] = max(self._best.get(trial, float("-inf")), score)
        t = metrics.get(self._time_attr, len(self._history[trial]))
        if t < self._grace:
            return CONTINUE
        other_means = [
            sum(h) / len(h) for tr, h in self._history.items() if tr is not trial and h
        ]
        if len(other_means) < self._min_samples:
            return CONTINUE
        other_means.sort()
        median = other_means[len(other_means) // 2]
        if self._best[trial] < median:
            return STOP
        return CONTINUE


class PopulationBasedTraining:
    """PBT: at each perturbation interval, bottom-quantile trials exploit a
    top-quantile trial's checkpoint + config and explore by mutation.
    Reference: schedulers/pbt.py."""

    def __init__(
        self,
        *,
        metric: str,
        mode: str = "max",
        time_attr: str = "training_iteration",
        perturbation_interval: int = 5,
        hyperparam_mutations: dict | None = None,
        quantile_fraction: float = 0.25,
        seed: int | None = None,
    ):
        self._metric = metric
        self._sign = 1.0 if mode == "max" else -1.0
        self._time_attr = time_attr
        self._interval = perturbation_interval
        self._mutations = hyperparam_mutations or {}
        self._quantile = quantile_fraction
        self._rng = random.Random(seed)
        self._last_perturb: dict[Any, int] = {}
        self._scores: dict[Any, float] = {}

    def on_result(self, trial, metrics: dict) -> str:
        self._scores[trial] = self._sign * float(metrics.get(self._metric, float("-inf")))
        return CONTINUE

    def maybe_exploit(self, trial, metrics: dict, population: list) -> dict | None:
        """Returns a new (exploited+explored) config if the trial should
        restart from a better trial, else None. Controller applies it."""
        t = metrics.get(self._time_attr, 0)
        if t - self._last_perturb.get(trial, 0) < self._interval:
            return None
        self._last_perturb[trial] = t
        if len(self._scores) < 2:
            return None
        ranked = sorted(population, key=lambda tr: self._scores.get(tr, float("-inf")))
        k = max(1, int(len(ranked) * self._quantile))
        bottom, top = ranked[:k], ranked[-k:]
        if trial not in bottom:
            return None
        donor = self._rng.choice(top)
        if donor is trial:
            return None
        new_config = dict(donor.config)
        for key, mut in self._mutations.items():
            if callable(mut):
                new_config[key] = mut()
            elif isinstance(mut, list):
                new_config[key] = self._rng.choice(mut)
            else:  # numeric perturbation: x0.8 or x1.2
                base = new_config.get(key, trial.config.get(key))
                new_config[key] = base * self._rng.choice([0.8, 1.2])
        new_config["_pbt_exploit_from"] = donor.trial_id
        return new_config


class PB2(PopulationBasedTraining):
    """Population-Based Bandits (reference ``tune/schedulers/pb2.py``,
    Parker-Holder et al. 2020): PBT's exploit step, but EXPLORE selects
    the new hyperparameters by GP-UCB over observed (config -> reward
    improvement) data instead of random multiplicative perturbation —
    markedly more sample-efficient for small populations.

    ``hyperparam_bounds``: {name: (low, high)} continuous ranges the GP
    models (categorical mutations are not supported — PBT handles those).
    """

    def __init__(self, *, metric: str, mode: str = "max",
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_bounds: dict | None = None,
                 quantile_fraction: float = 0.25,
                 seed: int | None = None,
                 ucb_beta: float = 1.5,
                 n_candidates: int = 128):
        super().__init__(metric=metric, mode=mode, time_attr=time_attr,
                         perturbation_interval=perturbation_interval,
                         hyperparam_mutations={},
                         quantile_fraction=quantile_fraction, seed=seed)
        self._bounds = hyperparam_bounds or {}
        self._beta = ucb_beta
        self._n_candidates = n_candidates
        self._prev_score: dict[Any, float] = {}
        # GP dataset: (normalized config vector, reward improvement)
        self._X: list[list[float]] = []
        self._y: list[float] = []

    # -------------------------------------------------------------- data
    def _vec(self, config: dict) -> list[float]:
        out = []
        for k, (lo, hi) in self._bounds.items():
            v = float(config.get(k, lo))
            out.append((v - lo) / (hi - lo) if hi > lo else 0.0)
        return out

    def on_result(self, trial, metrics: dict) -> str:
        score = self._sign * float(metrics.get(self._metric, float("-inf")))
        prev = self._prev_score.get(trial)
        if prev is not None and prev != float("-inf") and score != float("-inf"):
            self._X.append(self._vec(trial.config))
            self._y.append(score - prev)
        self._prev_score[trial] = score
        return super().on_result(trial, metrics)

    # ---------------------------------------------------------------- GP
    def _gp_ucb(self, donor_config: dict) -> dict:
        import numpy as np

        keys = list(self._bounds)
        cand = np.asarray(
            [[self._rng.random() for _ in keys]
             for _ in range(self._n_candidates)])
        if len(self._y) >= 3:
            X = np.asarray(self._X)
            y = np.asarray(self._y)
            y = (y - y.mean()) / (y.std() + 1e-9)
            ls = 0.3
            def k(a, b):
                d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
                return np.exp(-d2 / (2 * ls * ls))
            K = k(X, X) + 1e-3 * np.eye(len(X))
            Kinv_y = np.linalg.solve(K, y)
            Ks = k(cand, X)                        # [n_cand, n_obs]
            mu = Ks @ Kinv_y
            # diag of posterior cov
            v = np.linalg.solve(K, Ks.T)
            var = np.clip(1.0 - (Ks * v.T).sum(1), 1e-9, None)
            scores = mu + self._beta * np.sqrt(var)
            best = cand[int(np.argmax(scores))]
        else:
            best = cand[0]                         # no data yet: random
        out = dict(donor_config)
        for i, kname in enumerate(keys):
            lo, hi = self._bounds[kname]
            val = lo + float(best[i]) * (hi - lo)
            if isinstance(donor_config.get(kname), int):
                val = int(round(val))
            out[kname] = val
        return out

    def maybe_exploit(self, trial, metrics: dict, population: list) -> dict | None:
        t = metrics.get(self._time_attr, 0)
        if t - self._last_perturb.get(trial, 0) < self._interval:
            return None
        self._last_perturb[trial] = t
        if len(self._scores) < 2:
            return None
        ranked = sorted(population,
                        key=lambda tr: self._scores.get(tr, float("-inf")))
        k = max(1, int(len(ranked) * self._quantile))
        bottom, top = ranked[:k], ranked[-k:]
        if trial not in bottom:
            return None
        donor = self._rng.choice(top)
        if donor is trial:
            return None
        new_config = self._gp_ucb(donor.config)
        new_config["_pbt_exploit_from"] = donor.trial_id
        # the exploited trial restarts: its next improvement baseline resets
        self._prev_score.pop(trial, None)
        return new_config
