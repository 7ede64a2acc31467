"""The compiled train loop (``TrainLoopConfig``'s default drive) on the
CPU: three stage actors parked over shm rings by ``compile_loop``.

* A numpy step spec through the JAX package's ``DataParallelTrainer``
  (``use_compiled_loop=True``, on ``ray_cluster``) and through the port's
  with no drive argument (on a port cluster): equal ``metrics_history``
  and equal final checkpoint trees, bit for bit.
* The port's llama ``debug`` f32 SGD step, params carried from a numpy
  tree by ``params_from_numpy``, 3 steps with a snapshot each under both
  of the port's drives: bit-equal losses, commits and params.
* A ``kill_loop_stage`` plan armed in the step stage by its
  ``stage_init_hook``: the attempt dies mid-loop and the next resumes
  from the GCS-registered checkpoint, leaving no stage actor behind.
"""

import os
import time

import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.resilience.checkpoint import load_checkpoint as jax_load
from ray_tpu.train import DataParallelTrainer as JaxTrainer
from ray_tpu.train import RunConfig as JaxRunConfig
from ray_tpu.train import ScalingConfig as JaxScalingConfig
from ray_tpu.train import TrainLoopConfig as JaxLoopConfig
from ray_tpu_torch.core.worker import global_worker
from ray_tpu_torch.models.llama import PRESETS
from ray_tpu_torch.resilience import latest_registered, load_checkpoint
from ray_tpu_torch.train import (DataParallelTrainer, FailureConfig,
                                 RunConfig, ScalingConfig, TrainLoopConfig)
from _torch_parity import numpy_params

CPU = ScalingConfig(num_workers=1, use_gpu=False)


@pytest.fixture(scope="module")
def cluster():
    # tests/conftest.py shuts down only ray_tpu's cluster, so this module
    # shuts its own down.
    rt.init(num_cpus=4)
    try:
        yield
    finally:
        rt.shutdown()


def _numpy_fns(as_tensor: bool):
    """init/data/step functions whose arithmetic is numpy float64 alone.
    The port's checkpoints hold tensors, so its state keeps ``w`` as a
    tensor viewing the same float64 array. Made inside a function, so
    that cloudpickle ships them by value to the stage actors."""

    def wrap(w):
        if as_tensor:
            import torch

            return torch.from_numpy(w)
        return w

    def init_fn(config):
        import numpy as np

        rng = np.random.default_rng(config["seed"])
        return {"w": wrap(rng.standard_normal(config["dim"])), "count": 0}

    def data_fn(config):
        import numpy as np

        def gen():
            rng = np.random.default_rng(123)
            while True:
                yield rng.standard_normal(config["dim"])
        return gen()

    def step_fn(state, batch):
        import numpy as np

        w = np.asarray(state["w"])
        w = w - 0.01 * (w - batch)
        count = state["count"] + 1
        loss = float(np.square(w - batch).mean())
        return ({"w": wrap(w), "count": count},
                {"loss": loss, "step": count - 1, "count": count})

    return init_fn, data_fn, step_fn


def _numpy_spec(config_cls, as_tensor: bool, **kw):
    init_fn, data_fn, step_fn = _numpy_fns(as_tensor)
    return config_cls(step_fn=step_fn, init_fn=init_fn, data_fn=data_fn,
                      num_steps=6, snapshot_every=2, credits=2, **kw)


def _no_stage_left(name: str) -> bool:
    """True once every stage actor of run ``name`` is dead in the GCS."""
    prefix = f"train_loop_{name}_"
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        actors = global_worker()._gcs_call("ListActors", {})["actors"]
        stages = [a for a in actors if (a.get("name") or "").startswith(prefix)]
        if len(stages) >= 3 and all(a["state"] == "DEAD" for a in stages):
            return True
        time.sleep(0.2)
    return False


def test_default_drive_equals_the_jax_compiled_loop(ray_cluster, cluster,
                                                    tmp_path):
    config = {"seed": 7, "dim": 64}
    jax_result = JaxTrainer(
        _numpy_spec(JaxLoopConfig, False), train_loop_config=config,
        scaling_config=JaxScalingConfig(num_workers=1),
        run_config=JaxRunConfig(name="jax_loop", storage_path=str(tmp_path)),
        use_compiled_loop=True).fit()
    assert jax_result.error is None, jax_result.error
    result = DataParallelTrainer(
        _numpy_spec(TrainLoopConfig, True), train_loop_config=config,
        scaling_config=CPU,
        run_config=RunConfig(name="port_loop",
                             storage_path=str(tmp_path))).fit()
    assert result.error is None, result.error
    assert jax_result.loop_stats["mode"] == result.loop_stats["mode"] == "loop"
    assert len(result.metrics_history) == 6
    assert result.metrics_history == jax_result.metrics_history
    assert result.loop_stats["ckpt_commits"] == \
        jax_result.loop_stats["ckpt_commits"] == 3
    tree_j, meta_j = jax_load(jax_result.checkpoint.path)
    tree_p, meta_p = load_checkpoint(result.checkpoint.path)
    assert meta_p["step"] == meta_j["step"] == 5
    assert tree_p["count"] == tree_j["count"] == 6
    assert tree_p["w"].dtype == torch.float64
    assert tree_p["w"].numpy().tobytes() == tree_j["w"].tobytes()
    stall = result.loop_stats["loop_stall"]
    assert set(stall["stages"]) == {"next_batch", "train_step", "commit"}
    assert stall["bottleneck"] in stall["stages"]
    assert result.loop_stats["loop_torn_down_in_s"] < 30.0
    assert _no_stage_left("port_loop")


def _debug_fns():
    """llama ``debug`` in f32 from the numpy tree in ``config``, one SGD
    step a batch. Made inside a function, so that it is pickled by value."""

    def init_fn(config):
        import torch

        from ray_tpu_torch.llm.weights import params_from_numpy

        params = params_from_numpy(config["tree"], "cpu", torch.float32)
        return {"params": params, "step": 0}

    def data_fn(config):
        import numpy as np

        rng = np.random.default_rng(config["data_seed"])
        return iter([rng.integers(0, config["vocab"], (2, 16)).astype(
            np.int64) for _ in range(config["steps"])])

    def step_fn(state, batch):
        import dataclasses

        import torch

        from ray_tpu_torch.models.llama import PRESETS, loss_fn
        from ray_tpu_torch.train.checkpoint import map_tree

        cfg = dataclasses.replace(PRESETS["debug"], dtype=torch.float32,
                                  remat_policy="attn")
        leaves = []
        map_tree(leaves.append, state["params"])
        for p in leaves:
            p.requires_grad_()
        loss = loss_fn(state["params"], {"tokens": torch.tensor(batch)},
                       cfg, chunk_tokens=7)
        loss.backward()
        with torch.no_grad():
            for p in leaves:
                p.sub_(0.5 * p.grad)
                p.grad = None
                p.requires_grad_(False)
        return ({"params": state["params"], "step": state["step"] + 1},
                {"loss": loss.item()})

    return init_fn, data_fn, step_fn


def test_debug_llama_steps_are_bit_equal_under_both_drives(cluster, tmp_path):
    tree = numpy_params(PRESETS["debug"], seed=0)
    config = {"tree": tree, "data_seed": 1, "steps": 3,
              "vocab": PRESETS["debug"].vocab_size}
    runs = {}
    for mode, drive in (("loop", None), ("eager", False)):
        init_fn, data_fn, step_fn = _debug_fns()
        runs[mode] = DataParallelTrainer(
            TrainLoopConfig(step_fn=step_fn, init_fn=init_fn,
                            data_fn=data_fn, num_steps=3, snapshot_every=1,
                            credits=2),
            train_loop_config=config, scaling_config=CPU,
            run_config=RunConfig(name=f"debug_{mode}",
                                 storage_path=str(tmp_path)),
            use_compiled_loop=drive).fit()
        assert runs[mode].error is None, runs[mode].error
        assert runs[mode].loop_stats["mode"] == mode
        assert runs[mode].loop_stats["ckpt_commits"] == 3
    loop, eager = runs["loop"], runs["eager"]
    losses = [m["loss"] for m in loop.metrics_history]
    assert losses == [m["loss"] for m in eager.metrics_history]
    assert len(losses) == 3 and losses[2] < losses[0]
    trees = [load_checkpoint(r.checkpoint.path) for r in (loop, eager)]
    assert trees[0][1]["step"] == trees[1][1]["step"] == 2
    a, b = trees[0][0]["params"], trees[1][0]["params"]
    assert a["embed"].dtype == torch.float32
    for name in ("embed", "final_norm", "lm_head"):
        assert torch.equal(a[name], b[name]), name
    for name in a["layers"]:
        assert torch.equal(a["layers"][name], b["layers"][name]), name
    assert not torch.equal(a["embed"], torch.from_numpy(tree["embed"]))
    for name in ("debug_loop", "debug_eager"):
        assert latest_registered(name)["step"] == 2
        assert _no_stage_left(name)


def _chaos_hook(marker_path):
    def hook(stage_name, config):
        if stage_name != "step" or os.path.exists(marker_path):
            return
        open(marker_path, "w").write("x")
        from ray_tpu_torch import chaos

        plan = {"name": "train-step-kill", "faults": [
            {"kind": "kill_loop_stage", "nth": 4, "max_injections": 1}]}
        chaos.install(chaos.FaultPlan.from_dict(plan), 0, publish=False)
    return hook


def test_step_stage_death_resumes_from_the_registered_checkpoint(cluster,
                                                                  tmp_path):
    """kill_loop_stage fires inside the train-step stage at its 4th tick:
    the loop tears down, the controller restarts the stage group, and the
    resumed attempt continues from the latest GCS-registered checkpoint,
    at most the credit window behind."""
    init_fn, data_fn, step_fn = _numpy_fns(True)
    spec = TrainLoopConfig(
        step_fn=step_fn, init_fn=init_fn, data_fn=data_fn, num_steps=8,
        snapshot_every=1, credits=2,
        stage_init_hook=_chaos_hook(str(tmp_path / "chaos_installed_once")))
    result = DataParallelTrainer(
        spec, train_loop_config={"seed": 7, "dim": 64}, scaling_config=CPU,
        run_config=RunConfig(name="chaos_loop", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1))
    ).fit()
    assert result.error is None, result.error
    assert result.loop_stats["mode"] == "loop"
    # `count` rides the checkpointed state: a lossless resume ends at 8
    assert result.metrics_history[-1]["count"] == 8
    assert len(result.recovery_events) == 1
    ev = result.recovery_events[0]
    assert ev["resume_path"], "the resume did not come from a registered ckpt"
    assert ev["resumed_clock"] is not None
    # the kill fired at the 4th step tick (steps 0-2 done); the committed
    # horizon trails by at most the credit window
    assert ev["resume_step"] is not None and 1 <= ev["resume_step"] <= 4, ev
    assert latest_registered("chaos_loop")["step"] == 7
    assert _no_stage_left("chaos_loop")
