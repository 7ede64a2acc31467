"""Search spaces and suggestion algorithms.

Reference: ``python/ray/tune/search/`` — sample-space primitives
(``tune.uniform``/``choice``/``grid_search``) and the default
``BasicVariantGenerator`` (grid expansion × random sampling). External
searchers (Optuna/HyperOpt/...) are separate pip packages in the
reference; here they gate on import availability.
"""

from __future__ import annotations

import itertools
import random
from typing import Any


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Uniform(Domain):
    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class LogUniform(Domain):
    def __init__(self, low: float, high: float):
        import math

        self._lo, self._hi = math.log(low), math.log(high)

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(self._lo, self._hi))


class RandInt(Domain):
    def __init__(self, low: int, high: int):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


class Choice(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class GridSearch:
    def __init__(self, values):
        self.values = list(values)


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def randint(low: int, high: int) -> RandInt:
    return RandInt(low, high)


def choice(categories) -> Choice:
    return Choice(categories)


def grid_search(values) -> GridSearch:
    return GridSearch(values)


class TPESearcher:
    """Sequential model-based search, Tree-structured Parzen Estimator
    style (the role Optuna's default sampler plays behind the reference's
    ``OptunaSearch``, ``tune/search/optuna/optuna_search.py:81`` — Optuna
    itself is not available in this image, so the estimator is native).

    ``suggest()`` proposes configs one at a time; completed trials are fed
    back via ``on_trial_complete``. Numeric params: candidates are drawn
    from a Parzen window over the top-``gamma`` configs and ranked by the
    good/bad density ratio. Categoricals: weighted by goodness counts.
    Falls back to random sampling until ``n_startup`` observations exist.
    """

    def __init__(self, metric: str, mode: str = "max", *, seed: int | None = None,
                 gamma: float = 0.25, n_startup: int = 6, n_candidates: int = 24):
        self.metric = metric
        self.sign = 1.0 if mode == "max" else -1.0
        self._rng = random.Random(seed)
        self.gamma = gamma
        self.n_startup = n_startup
        self.n_candidates = n_candidates
        self._observations: list[tuple[dict, float]] = []
        self._space: dict | None = None

    # --------------------------------------------------- sequential protocol
    def set_space(self, param_space: dict) -> None:
        self._space = {
            k: (GridSearch(v["grid_search"])
                if isinstance(v, dict) and set(v) == {"grid_search"} else v)
            for k, v in param_space.items()
        }

    def on_trial_complete(self, config: dict, metrics: dict) -> None:
        if metrics and self.metric in metrics:
            self._observations.append((config, self.sign * float(metrics[self.metric])))

    def suggest(self) -> dict:
        assert self._space is not None, "set_space() first"
        if len(self._observations) < self.n_startup:
            return self._random_config()
        ranked = sorted(self._observations, key=lambda o: -o[1])
        n_good = max(1, int(len(ranked) * self.gamma))
        good = [c for c, _ in ranked[:n_good]]
        bad = [c for c, _ in ranked[n_good:]] or good
        best, best_score = None, float("-inf")
        for _ in range(self.n_candidates):
            cand = self._sample_near(good)
            score = self._density(cand, good) - self._density(cand, bad)
            if score > best_score:
                best, best_score = cand, score
        return best

    # ------------------------------------------------------------- internals
    def _numeric_value(self, key, value) -> float | None:
        dom = self._space[key]
        import math

        if isinstance(dom, (Uniform, RandInt)):
            return float(value)
        if isinstance(dom, LogUniform):
            return math.log(max(value, 1e-300))
        return None

    def _random_config(self) -> dict:
        cfg = {}
        for k, v in self._space.items():
            if isinstance(v, GridSearch):
                cfg[k] = self._rng.choice(v.values)
            elif isinstance(v, Domain):
                cfg[k] = v.sample(self._rng)
            else:
                cfg[k] = v
        return cfg

    def _domain_range(self, dom) -> tuple[float, float]:
        if isinstance(dom, Uniform):
            return dom.low, dom.high
        if isinstance(dom, RandInt):
            return float(dom.low), float(dom.high)
        return dom._lo, dom._hi  # LogUniform: log domain

    def _bandwidth(self, xs: list[float], dom) -> float:
        lo, hi = self._domain_range(dom)
        # Parzen bandwidth: shrinks as evidence accumulates (Scott-rule
        # style n^-1/5) but with a PRIOR FLOOR so a collapsed good-set
        # never freezes the search (TPE mixes the uniform prior in).
        n = max(len(self._observations), 1)
        return max((max(xs) - min(xs)) * 0.5,
                   (hi - lo) / 8.0 * n ** -0.2)

    def _sample_near(self, good: list[dict]) -> dict:
        import math

        cfg = {}
        for k, dom in self._space.items():
            if not isinstance(dom, Domain) and not isinstance(dom, GridSearch):
                cfg[k] = dom
                continue
            cats = dom.values if isinstance(dom, GridSearch) else (
                dom.categories if isinstance(dom, Choice) else None)
            if cats is not None:
                # categorical: sample weighted by goodness counts (+1 prior)
                weights = [1 + sum(1 for g in good if g.get(k) == c) for c in cats]
                cfg[k] = self._rng.choices(cats, weights=weights)[0]
                continue
            if self._rng.random() < 0.35:
                # exploration: draw from the prior (TPE's prior mixture)
                cfg[k] = dom.sample(self._rng)
                continue
            xs = [self._numeric_value(k, g[k]) for g in good if k in g]
            # rank-weighted anchor: the BEST point (good[0]) pulls hardest
            anchor = xs[0] if self._rng.random() < 0.5 else self._rng.choice(xs)
            x = self._rng.gauss(anchor, self._bandwidth(xs, dom))
            if isinstance(dom, Uniform):
                cfg[k] = min(max(x, dom.low), dom.high)
            elif isinstance(dom, RandInt):
                cfg[k] = int(min(max(round(x), dom.low), dom.high - 1))
            else:  # LogUniform
                cfg[k] = min(max(math.exp(x), math.exp(dom._lo)), math.exp(dom._hi))
        return cfg

    def _density(self, cand: dict, configs: list[dict]) -> float:
        import math

        total = 0.0
        for k, dom in self._space.items():
            if isinstance(dom, GridSearch) or isinstance(dom, Choice):
                cats = dom.values if isinstance(dom, GridSearch) else dom.categories
                count = sum(1 for c in configs if c.get(k) == cand[k])
                total += math.log((count + 1) / (len(configs) + len(cats)))
            elif isinstance(dom, Domain):
                xs = [self._numeric_value(k, c[k]) for c in configs if k in c]
                if not xs:
                    continue
                x = self._numeric_value(k, cand[k])
                bw = self._bandwidth(xs, dom)
                total += math.log(sum(
                    math.exp(-0.5 * ((x - xi) / bw) ** 2) for xi in xs
                ) / len(xs) + 1e-12)
        return total


class BasicVariantGenerator:
    """Grid axes are expanded exhaustively; Domain axes sampled num_samples
    times. Reference: search/basic_variant.py."""

    def __init__(self, *, seed: int | None = None):
        self._rng = random.Random(seed)

    def generate(self, param_space: dict, num_samples: int) -> list[dict]:
        # Reference-compatible dict form: {"grid_search": [...]}.
        param_space = {
            k: (GridSearch(v["grid_search"])
                if isinstance(v, dict) and set(v) == {"grid_search"} else v)
            for k, v in param_space.items()
        }
        grid_keys = [k for k, v in param_space.items() if isinstance(v, GridSearch)]
        grids = [param_space[k].values for k in grid_keys]
        configs: list[dict] = []
        grid_combos = list(itertools.product(*grids)) if grid_keys else [()]
        for _ in range(num_samples):
            for combo in grid_combos:
                cfg = {}
                for k, v in param_space.items():
                    if isinstance(v, GridSearch):
                        cfg[k] = combo[grid_keys.index(k)]
                    elif isinstance(v, Domain):
                        cfg[k] = v.sample(self._rng)
                    else:
                        cfg[k] = v
                configs.append(cfg)
        return configs


class Searcher:
    """Sequential-searcher protocol the controller drives (reference
    ``tune/search/searcher.py``): ``set_space`` once, then alternate
    ``suggest`` / ``on_trial_complete``. ``TPESearcher`` is the native
    implementation; ``OptunaSearch`` adapts an external library through
    the same three methods — write an adapter with this surface to plug
    in any external optimizer (HyperOpt/Ax/BOHB equivalents)."""

    def set_space(self, param_space: dict) -> None:
        raise NotImplementedError

    def suggest(self) -> dict:
        raise NotImplementedError

    def on_trial_complete(self, config: dict, metrics: dict) -> None:
        raise NotImplementedError


class OptunaSearch(Searcher):
    """Adapter over Optuna's ask/tell interface (reference
    ``tune/search/optuna/optuna_search.py``): Domain objects map to
    Optuna distributions; each ``suggest`` asks a trial, each completion
    tells its objective value. Requires ``optuna`` (not bundled in this
    image — the import is deferred and raises a clear error)."""

    def __init__(self, metric: str, mode: str = "max", *, seed: int | None = None,
                 sampler=None):
        try:
            import optuna  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "OptunaSearch requires the `optuna` package; install it or "
                "use the native TPESearcher (same protocol)") from e
        self._optuna = optuna
        self.metric = metric
        self._direction = "maximize" if mode == "max" else "minimize"
        self._sampler = sampler or optuna.samplers.TPESampler(seed=seed)
        self._study = None
        self._space: dict = {}
        self._live: dict[int, Any] = {}  # config-id -> optuna trial

    def set_space(self, param_space: dict) -> None:
        optuna = self._optuna
        self._study = optuna.create_study(
            direction=self._direction, sampler=self._sampler)
        dist = optuna.distributions
        self._space = {}
        for k, v in param_space.items():
            if isinstance(v, Uniform):
                self._space[k] = dist.FloatDistribution(v.low, v.high)
            elif isinstance(v, LogUniform):
                self._space[k] = dist.FloatDistribution(v.low, v.high, log=True)
            elif isinstance(v, RandInt):
                self._space[k] = dist.IntDistribution(v.low, v.high - 1)
            elif isinstance(v, Choice):
                self._space[k] = dist.CategoricalDistribution(list(v.categories))
            elif isinstance(v, GridSearch):
                self._space[k] = dist.CategoricalDistribution(list(v.values))
            else:
                self._space[k] = dist.CategoricalDistribution([v])

    @staticmethod
    def _key(config: dict):
        return tuple(sorted((k, repr(v)) for k, v in config.items()))

    def suggest(self) -> dict:
        trial = self._study.ask(self._space)
        config = dict(trial.params)
        # identical configs may be suggested twice: a list per key
        self._live.setdefault(self._key(config), []).append(trial)
        return config

    def on_trial_complete(self, config: dict, metrics: dict) -> None:
        trials = self._live.get(self._key(config))
        if trials and metrics and self.metric in metrics:
            self._study.tell(trials.pop(0), float(metrics[self.metric]))
