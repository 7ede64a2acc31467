"""The port's Tune searchers, schedulers and file loggers
(``ray_tpu_torch.tune``) against the JAX package's (``ray_tpu.tune``),
with no cluster: each case runs both packages on the same inputs and the
results must be equal (PB2's suggestion within 1e-12)."""

import csv
import json
import math
import os

import pytest

from ray_tpu import tune as jax_tune
from ray_tpu_torch import tune as port_tune


class StandIn:
    """A trial as the schedulers and loggers see it: a hashable object
    with an id, a config and a directory."""

    def __init__(self, i: int, config: dict | None = None, root: str = ""):
        self.trial_id = f"t{i:02d}"
        self.config = dict(config or {})
        self.dir = os.path.join(root, self.trial_id)


def _space(tune):
    return {"lr": tune.grid_search([0.1, 0.01, 0.001]),
            "u": tune.uniform(-2.0, 3.0),
            "l": tune.loguniform(1e-4, 1e-1),
            "r": tune.randint(2, 17),
            "c": tune.choice(["adam", "sgd", "lion"]),
            "fixed": 7}


def basic_variants(tune, tmp_path):
    return tune.BasicVariantGenerator(seed=11).generate(_space(tune), 4)


def basic_variants_dict_grid(tune, tmp_path):
    space = {"x": {"grid_search": [1, 2]}, "y": tune.uniform(0, 1)}
    return tune.BasicVariantGenerator(seed=3).generate(space, 2)


def tpe_rounds(tune, tmp_path):
    space = {"x": tune.uniform(-10.0, 10.0), "lr": tune.loguniform(1e-4, 1.0),
             "n": tune.randint(1, 9), "opt": tune.choice(["a", "b", "c"])}
    searcher = tune.TPESearcher("score", "max", seed=5)
    searcher.set_space(space)
    out = []
    for _ in range(12):
        cfg = searcher.suggest()
        score = -(cfg["x"] - 3.0) ** 2 - abs(math.log10(cfg["lr"]) + 2) \
            + (cfg["opt"] == "b") - 0.1 * cfg["n"]
        searcher.on_trial_complete(cfg, {"score": score})
        out.append(cfg)
    return out


def _streams(n_trials: int = 8, n_iters: int = 9) -> list:
    """Round-robin results of 8 stand-in trials: each trial's metric grows
    with its iteration at its own rate, with a fixed wobble."""
    out = []
    for it in range(1, n_iters + 1):
        for i in range(n_trials):
            rate = 0.2 + 0.13 * ((i * 5) % n_trials)
            acc = rate * it + 0.05 * math.sin(3.0 * i + it)
            out.append((i, {"training_iteration": it, "acc": acc}))
    return out


def _decisions(scheduler) -> list:
    trials = [StandIn(i) for i in range(8)]
    stopped, out = set(), []
    for i, metrics in _streams():
        if i in stopped:
            continue
        decision = scheduler.on_result(trials[i], metrics)
        out.append((i, metrics["training_iteration"], decision))
        if decision == "STOP":
            stopped.add(i)
    return out


def asha_decisions(tune, tmp_path):
    return _decisions(tune.ASHAScheduler(
        metric="acc", mode="max", max_t=9, grace_period=1,
        reduction_factor=2))


def hyperband_decisions(tune, tmp_path):
    return _decisions(tune.HyperBandScheduler(
        metric="acc", mode="max", max_t=9, reduction_factor=3))


def median_stopping_decisions(tune, tmp_path):
    return _decisions(tune.MedianStoppingRule(
        metric="acc", mode="max", grace_period=3, min_samples_required=3))


def pbt_exploit(tune, tmp_path):
    pbt = tune.PopulationBasedTraining(
        metric="acc", mode="max", perturbation_interval=2, seed=7,
        hyperparam_mutations={"lr": [0.1, 0.01, 0.001],
                              "momentum": 0.9},
        quantile_fraction=0.25)
    trials = [StandIn(i, {"lr": 0.1 / (i + 1), "momentum": 0.5 + 0.05 * i})
              for i in range(8)]
    out = []
    for i, metrics in _streams(n_iters=6):
        pbt.on_result(trials[i], metrics)
        new = pbt.maybe_exploit(trials[i], metrics, trials)
        out.append((i, metrics["training_iteration"], new))
        if new is not None:
            trials[i].config = {k: v for k, v in new.items()
                                if k != "_pbt_exploit_from"}
    return out


def pb2_suggestion(tune, tmp_path):
    pb2 = tune.PB2(metric="acc", mode="max", perturbation_interval=2,
                   hyperparam_bounds={"lr": (0.0, 1.0), "wd": (1e-4, 1e-1)},
                   seed=9, n_candidates=64)
    trials = [StandIn(i, {"lr": 0.11 * (i + 1), "wd": 0.01 * (i + 1)})
              for i in range(8)]
    out = []
    for i, metrics in _streams(n_iters=6):
        pb2.on_result(trials[i], metrics)
        new = pb2.maybe_exploit(trials[i], metrics, trials)
        if new is not None:
            out.append((i, metrics["training_iteration"], new))
            trials[i].config = {k: v for k, v in new.items()
                                if k != "_pbt_exploit_from"}
    return out


def logger_files(tune, tmp_path):
    root = tmp_path / tune.__name__.split(".")[0]
    trials = [StandIn(i, root=str(root)) for i in range(2)]
    callbacks = [tune.JsonLoggerCallback(), tune.CSVLoggerCallback()]
    for cb in callbacks:
        cb.setup(experiment_dir=str(root))
        for t in trials:
            cb.on_trial_start(t)
    for it in range(1, 4):
        for t in trials:
            result = {"training_iteration": it,
                      "loss": 1.0 / it + int(t.trial_id[1:]),
                      "tag": f"{t.trial_id}-{it}", "extra": [it, it * 2]}
            if it == 3:
                result["late_key"] = it  # outside the CSV header: dropped
            for cb in callbacks:
                cb.on_trial_result(t, result)
    for cb in callbacks:
        cb.on_trial_complete(trials[0])
        cb.on_experiment_end(trials)
    return {os.path.relpath(os.path.join(d, f), root):
            open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(root) for f in sorted(files)}


CASES = [basic_variants, basic_variants_dict_grid, tpe_rounds,
         asha_decisions, hyperband_decisions, median_stopping_decisions,
         pbt_exploit, logger_files]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_port_equals_jax(case, tmp_path):
    want = case(jax_tune, tmp_path)
    got = case(port_tune, tmp_path)
    assert got == want


def test_logger_files_read_back(tmp_path):
    files = logger_files(port_tune, tmp_path)
    lines = [json.loads(x) for x in files["t00/result.json"].splitlines()]
    assert [x["training_iteration"] for x in lines] == [1, 2, 3]
    assert lines[-1]["late_key"] == 3
    rows = list(csv.DictReader(files["t01/progress.csv"].decode()
                               .splitlines()))
    assert len(rows) == 3 and "late_key" not in rows[0]


def test_decisions_stop_someone():
    # the cases above compare something: each scheduler stops a trial
    for case in (asha_decisions, hyperband_decisions,
                 median_stopping_decisions):
        assert any(d == "STOP" for *_, d in case(port_tune, None)), case
    assert any(new is not None for *_, new in pbt_exploit(port_tune, None))


def test_pb2_suggestion_within_1e_12(tmp_path):
    want = pb2_suggestion(jax_tune, tmp_path)
    got = pb2_suggestion(port_tune, tmp_path)
    assert want and len(got) == len(want)
    for (gi, gt, gcfg), (wi, wt, wcfg) in zip(got, want):
        assert (gi, gt) == (wi, wt)
        assert gcfg["_pbt_exploit_from"] == wcfg["_pbt_exploit_from"]
        for key in ("lr", "wd"):
            assert abs(gcfg[key] - wcfg[key]) <= 1e-12, (key, gcfg, wcfg)


@pytest.mark.parametrize("name", ["OptunaSearch", "TBXLoggerCallback"])
def test_gated_imports_alike(name):
    """Each package's gated class builds, or raises ImportError, alike."""
    def build(tune):
        cls = getattr(tune, name)
        args = ("score", "max") if name == "OptunaSearch" else ()
        try:
            cls(*args)
        except ImportError as e:
            return ("ImportError", str(e).split(";")[0].split("(")[0])
        return ("built", None)

    assert build(port_tune) == build(jax_tune)


def test_exports_equal():
    assert sorted(port_tune.__all__) == sorted(jax_tune.__all__)
    assert port_tune.ASHAScheduler is port_tune.AsyncHyperBandScheduler
