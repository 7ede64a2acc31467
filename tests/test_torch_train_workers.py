"""The port's Train library (``ray_tpu_torch.train``) on a port cluster,
on the CPU: ranks and shards of two workers, ``report(checkpoint=)`` in
run storage, ``TrainLoopConfig``'s eager and compiled-loop drives
alike, and ``ScalingConfig``'s ``GPU`` default."""

import json
import os

import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import data
from ray_tpu_torch.resilience import load_checkpoint
from ray_tpu_torch.train import (DataParallelTrainer, RunConfig,
                                 ScalingConfig, TorchTrainer,
                                 TrainLoopConfig, TrainLoopRunner)

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


def test_two_workers_see_their_ranks_and_disjoint_shards(cluster, tmp_path):
    def train_fn(config):
        import json
        import os

        from ray_tpu_torch import train

        ctx = train.get_context()
        ids = [int(i) for b in train.get_dataset_shard("train").iter_batches(
            batch_size=4) for i in b["id"]]
        with open(os.path.join(ctx.storage_path,
                               f"rank{ctx.get_world_rank()}.json"), "w") as f:
            json.dump({"world_size": ctx.get_world_size(), "ids": ids}, f)
        train.report({"rank": ctx.get_world_rank()})

    result = TorchTrainer(
        train_fn, scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(name="two", storage_path=str(tmp_path)),
        datasets={"train": data.range(40, parallelism=8)}).fit()
    assert result.error is None, result.error
    seen = [json.load(open(tmp_path / "two" / f"rank{r}.json"))
            for r in (0, 1)]
    assert [s["world_size"] for s in seen] == [2, 2]
    a, b = set(seen[0]["ids"]), set(seen[1]["ids"])
    assert a and b and not a & b and sorted(a | b) == list(range(40))


def test_report_checkpoint_lands_in_run_storage(cluster, tmp_path):
    def train_fn(config):
        import os
        import tempfile

        from ray_tpu_torch import train

        for step in range(2):
            d = tempfile.mkdtemp()
            with open(os.path.join(d, "weights.txt"), "w") as f:
                f.write(f"step {step}")
            train.report({"step": step},
                         checkpoint=train.Checkpoint.from_directory(d))

    result = TorchTrainer(
        train_fn, scaling_config=CPU,
        run_config=RunConfig(name="ck", storage_path=str(tmp_path))).fit()
    assert result.error is None, result.error
    path = result.checkpoint.path
    assert path.startswith(str(tmp_path / "ck") + os.sep)
    with result.checkpoint.as_directory() as d:
        assert open(os.path.join(d, "weights.txt")).read() == "step 1"
    assert json.load(open(os.path.join(path, ".metrics.json"))) == \
        {"metrics": {"step": 1}}


def _loop_spec(**kw) -> TrainLoopConfig:
    def init_fn(config):
        import torch

        return {"w": torch.zeros(4), "n": 0}

    def data_fn(config):
        import numpy as np

        return iter(np.arange(8, dtype=np.float32).reshape(4, 2))

    def step_fn(state, batch):
        import torch

        w = state["w"] + torch.from_numpy(batch).repeat(2)
        return {"w": w, "n": state["n"] + 1}, {"w0": float(w[0])}

    return TrainLoopConfig(step_fn=step_fn, init_fn=init_fn, num_steps=4,
                           data_fn=data_fn, snapshot_every=2, **kw)


def test_train_loop_config_runs_eager_and_compiled_alike(cluster, tmp_path):
    result = DataParallelTrainer(
        _loop_spec(use_compiled_loop=False), scaling_config=CPU,
        run_config=RunConfig(name="loop", storage_path=str(tmp_path))).fit()
    assert result.error is None, result.error
    assert [m["w0"] for m in result.metrics_history] == [0.0, 2.0, 6.0, 12.0]
    assert result.loop_stats["mode"] == "eager"
    assert result.loop_stats["ckpt_commits"] == 2
    tree, meta = load_checkpoint(result.checkpoint.path)
    assert meta["step"] == 3 and tree["n"] == 4
    assert torch.equal(tree["w"], torch.tensor([12.0, 16.0, 12.0, 16.0]))
    # The default drive is the compiled loop: the same stages parked over
    # shm rings give the same metrics, commits and checkpoint tree.
    compiled = DataParallelTrainer(
        _loop_spec(), scaling_config=CPU,
        run_config=RunConfig(name="compiled",
                             storage_path=str(tmp_path))).fit()
    assert compiled.error is None, compiled.error
    assert compiled.loop_stats["mode"] == "loop"
    assert compiled.metrics_history == result.metrics_history
    assert compiled.loop_stats["ckpt_commits"] == 2
    tree_l, meta_l = load_checkpoint(compiled.checkpoint.path)
    assert meta_l["step"] == meta["step"] and tree_l["n"] == tree["n"]
    assert torch.equal(tree_l["w"], tree["w"])
    # the trainer's argument overrides the spec's default, both ways
    runner = TrainLoopRunner(None, _loop_spec(), use_compiled_loop=False)
    assert runner.use_compiled_loop is False
    assert TrainLoopRunner(None, _loop_spec()).use_compiled_loop is True


def test_scaling_config_defaults_to_a_gpu_and_topology_raises():
    assert ScalingConfig().worker_resources() == {"CPU": 1.0, "GPU": 1.0}
    assert ScalingConfig(use_gpu=False).worker_resources() == {"CPU": 1.0}
    assert ScalingConfig(resources_per_worker={"CPU": 2.0}) \
        .worker_resources() == {"CPU": 2.0, "GPU": 1.0}
    with pytest.raises(NotImplementedError, match="item 7"):
        ScalingConfig(num_workers=2, topology="v5litepod-16")
