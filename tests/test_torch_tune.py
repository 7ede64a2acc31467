"""Tune as a whole on a port cluster (``ray_tpu_torch.tune.Tuner``), on
the CPU: the same numpy trainable under ASHA with the same seed through
the JAX package's ``Tuner.fit`` (on ``ray_cluster``) and the port's must
give the same configs, metric histories, stopped trials and best config;
and ``tests/test_tune.py``'s error isolation and ``Tuner.restore`` cases
on the port."""

import os

import pytest

import ray_tpu_torch as rt
from ray_tpu import tune as jax_tune
from ray_tpu.train import RunConfig as JaxRunConfig
from ray_tpu_torch import tune
from ray_tpu_torch.train import RunConfig

MAX_T = 8


@pytest.fixture(scope="module")
def cluster():
    # tests/conftest.py shuts down only ray_tpu's cluster, so this module
    # shuts its own down.
    rt.init(num_cpus=4)
    try:
        yield
    finally:
        rt.shutdown()


def _noisy_quadratic(tune_mod):
    """A trainable reporting a noisy quadratic in ``x`` that falls over its
    iterations; the noise comes from the trial's own seed. Made inside a
    function, so that it is pickled by value for the trial's worker."""
    def trainable(config):
        import numpy as np

        rng = np.random.default_rng(config["seed"])
        for it in range(1, MAX_T + 1):
            loss = (config["x"] - 1.5) ** 2 + 2.0 / it \
                + 0.05 * rng.standard_normal()
            tune_mod.report({"training_iteration": it, "loss": float(loss)})

    return trainable


def _asha_run(tune_mod, run_config_cls, storage) -> dict:
    # One trial at a time, so that ASHA's rungs fill in the same order in
    # both packages.
    tuner = tune_mod.Tuner(
        _noisy_quadratic(tune_mod),
        param_space={"x": tune_mod.uniform(-2.0, 5.0),
                     "seed": tune_mod.randint(0, 1000)},
        tune_config=tune_mod.TuneConfig(
            metric="loss", mode="min", num_samples=6, seed=3,
            max_concurrent_trials=1,
            scheduler=tune_mod.ASHAScheduler(
                metric="loss", mode="min", max_t=MAX_T, grace_period=1,
                reduction_factor=2)),
        run_config=run_config_cls(name="asha", storage_path=str(storage)))
    grid = tuner.fit()
    results = list(grid)
    return {
        "configs": _configs(grid),
        "histories": [r.metrics_history for r in results],
        "stopped": sorted(i for i, r in enumerate(results)
                          if len(r.metrics_history) < MAX_T),
        "best": grid.get_best_result("loss", "min").metrics_history[-1],
        "errors": grid.errors,
    }


def _configs(grid) -> list:
    """Each trial's config, from the experiment state the Tuner saved
    (a ``Result`` keeps none)."""
    import pickle

    exp_dir = os.path.dirname(grid[0].path)
    with open(os.path.join(exp_dir, "experiment_state.pkl"), "rb") as f:
        return [entry["config"] for entry in pickle.load(f)]


def test_asha_tuner_equals_jax(ray_cluster, cluster, tmp_path):
    want = _asha_run(jax_tune, JaxRunConfig, tmp_path / "jax")
    got = _asha_run(tune, RunConfig, tmp_path / "port")
    assert got == want
    # the comparison holds something: ASHA stopped some trials early, and
    # the best trial ran to the end
    assert got["stopped"] and len(got["stopped"]) < 6
    assert got["best"]["training_iteration"] == MAX_T


def test_trial_error_isolated(cluster, tmp_path):
    def trainable(config):
        from ray_tpu_torch import tune as t

        if config["x"] == 1:
            raise ValueError("bad trial")
        t.report({"ok": config["x"]})

    results = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([0, 1, 2])},
        run_config=RunConfig(name="err", storage_path=str(tmp_path)),
    ).fit()
    assert len(results.errors) == 1
    assert "bad trial" in str(results.errors[0])
    assert sorted(r.metrics["ok"] for r in results if r.metrics) == [0, 2]


def test_restore_reruns_only_incomplete(cluster, tmp_path):
    """``Tuner.restore``: finished trials keep their results without
    re-running; the failed trial runs again."""
    marker_dir = str(tmp_path / "markers")
    os.makedirs(marker_dir, exist_ok=True)

    def trainable(config):
        import os as _os

        from ray_tpu_torch import train

        mark = _os.path.join(config["marker_dir"], f"ran-{config['x']}")
        with open(mark, "a") as f:
            f.write("x")
        if config["x"] == 2 and not _os.path.exists(
                _os.path.join(config["marker_dir"], "fixed")):
            raise RuntimeError("flaky trial")
        train.report({"score": float(config["x"] * 10)})

    tuner = tune.Tuner(
        trainable,
        param_space={"x": {"grid_search": [1, 2, 3]}, "marker_dir": marker_dir},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(name="restore_exp", storage_path=str(tmp_path)),
    )
    assert len(tuner.fit().errors) == 1  # trial x=2 failed

    open(os.path.join(marker_dir, "fixed"), "w").close()
    grid = tune.Tuner.restore(str(tmp_path / "restore_exp"), trainable).fit()
    assert not grid.errors
    assert grid.get_best_result("score").metrics["score"] == 30.0
    sizes = {x: os.path.getsize(os.path.join(marker_dir, f"ran-{x}"))
             for x in (1, 2, 3)}
    assert sizes == {1: 1, 2: 2, 3: 1}


def test_default_storage_is_the_ports(cluster, monkeypatch, tmp_path):
    """Without a ``storage_path`` the port writes under its own results
    directory, never into a JAX experiment directory."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))

    def trainable(config):
        from ray_tpu_torch import tune as t

        t.report({"v": 1})

    grid = tune.Tuner(trainable, run_config=RunConfig(name="where")).fit()
    assert grid[0].path.startswith(
        os.path.join(str(tmp_path), "ray_tpu_torch", "results", "where"))


def test_concurrent_trials_start_distinct_actors(cluster, tmp_path):
    """Two trials at once each start an actor from the trainable's thread,
    as a trial's nested fit starts its worker: the actors' ids differ, and
    the first trial killing its own leaves the second's alive (with ids
    derived from a parent that every worker shared, the second trial's
    actor was the first's, and died with it)."""
    def trainable(config):
        import time

        import ray_tpu_torch as rt
        from ray_tpu_torch import tune as t

        @rt.remote
        class Echo:
            def ping(self):
                return config["x"]

        actor = Echo.remote()
        first = rt.get(actor.ping.remote(), timeout=60)
        time.sleep(1.0 + 1.5 * config["x"])
        if config["x"] == 0:
            rt.kill(actor)
            second = None
        else:
            second = rt.get(actor.ping.remote(), timeout=60)
        t.report({"actor": actor._actor_id.hex(), "first": first,
                  "second": second})

    grid = tune.Tuner(
        trainable, param_space={"x": tune.grid_search([0, 1])},
        tune_config=tune.TuneConfig(max_concurrent_trials=2),
        run_config=RunConfig(name="actors", storage_path=str(tmp_path)),
    ).fit()
    assert not grid.errors, grid.errors
    rows = sorted((r.metrics for r in grid), key=lambda m: m["first"])
    assert [(m["first"], m["second"]) for m in rows] == [(0, None), (1, 1)]
    assert rows[0]["actor"] != rows[1]["actor"]
