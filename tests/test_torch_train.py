"""The slice as a whole on the CPU: ``TorchTrainer.fit`` on a port cluster
trains the ``debug`` preset in f32 from a Data shard in a worker process,
and its losses equal the JAX package's ``loss_fn`` + ``jax.grad`` + SGD
on the same numpy params and batches; its async checkpoints commit and
register, and a failed group restarts from them with the same losses.

Tolerances, relative: 1e-5 for losses (as the port's training parity
tests), 1e-4 for the trained params."""

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.models.llama import PRESETS as JAX_PRESETS
from ray_tpu.models.llama import loss_fn as jax_loss_fn
from ray_tpu_torch import data, train
from ray_tpu_torch.models.llama import PRESETS
from ray_tpu_torch.resilience import load_checkpoint
from ray_tpu_torch.train import (CheckpointConfig, FailureConfig, RunConfig,
                                 ScalingConfig, TorchTrainer)
from _torch_parity import numpy_params

CPU = ScalingConfig(num_workers=1, use_gpu=False)
LR = 0.5
BATCH, SEQ = 2, 16


@pytest.fixture(scope="module")
def cluster():
    # tests/conftest.py shuts down only ray_tpu's cluster, so this module
    # shuts its own down.
    rt.init(num_cpus=4)
    try:
        yield
    finally:
        rt.shutdown()


def _sgd_train_fn():
    """llama ``debug`` in f32 from the numpy tree in ``config``: one SGD
    step a batch of the Data shard, the state reported at every step, and
    a resumed attempt continuing from its checkpoint's step. Made inside
    a function, so that it is pickled by value for the worker."""
    def train_fn(config):
        import os

        import torch

        from ray_tpu_torch import train
        from ray_tpu_torch.llm.weights import params_from_numpy
        from ray_tpu_torch.models.llama import PRESETS, loss_fn
        from ray_tpu_torch.resilience import load_checkpoint

        cfg = dataclasses.replace(PRESETS["debug"], dtype=torch.float32,
                                  remat_policy="attn")
        params = params_from_numpy(config["tree"], "cpu", torch.float32)
        start = 0
        resumed = train.get_checkpoint()
        if resumed is not None:
            state, _ = load_checkpoint(resumed.path, like={
                "params": params, "step": 0})
            params, start = state["params"], state["step"] + 1
        leaves = [params["embed"], params["final_norm"], params["lm_head"],
                  *params["layers"].values()]
        for p in leaves:
            p.requires_grad_()
        shard = train.get_dataset_shard("train")
        for step, batch in enumerate(shard.to_device_batches(
                batch_size=config["batch"], device="cpu")):
            if step < start:
                continue
            if step == config.get("fail_at") and not os.path.exists(
                    config["marker"]):
                open(config["marker"], "w").write("x")
                raise RuntimeError("injected failure")
            loss = loss_fn(params, {"tokens": batch["tokens"]}, cfg,
                           chunk_tokens=7)
            loss.backward()
            with torch.no_grad():
                for p in leaves:
                    p.sub_(config["lr"] * p.grad)
                    p.grad = None
            train.report({"step": step, "loss": loss.item(),
                          "rank": train.get_context().get_world_rank()},
                         state={"params": params, "step": step})

    return train_fn


def _tokens(n_batches: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, PRESETS["debug"].vocab_size, (n_batches * BATCH, SEQ)).astype(
            np.int32)


def _jax_sgd(tree: dict, tokens: np.ndarray) -> tuple:
    """The JAX package's loss_fn, jax.grad and SGD on the same batches."""
    jcfg = dataclasses.replace(JAX_PRESETS["debug"], dtype=jnp.float32,
                               attn_impl="reference")
    grad = jax.jit(jax.value_and_grad(
        lambda p, t: jax_loss_fn(p, {"tokens": t}, jcfg, chunk_tokens=7)))
    params = jax.tree.map(jnp.asarray, tree)
    losses = []
    for i in range(0, len(tokens), BATCH):
        loss, g = grad(params, jnp.asarray(tokens[i:i + BATCH]))
        params = jax.tree.map(lambda a, b: a - LR * b, params, g)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params)


def _fit(tmp_path, name, tokens, **config):
    tree = numpy_params(dataclasses.replace(PRESETS["debug"]), seed=0)
    return TorchTrainer(
        _sgd_train_fn(),
        train_loop_config={"tree": tree, "lr": LR, "batch": BATCH, **config},
        scaling_config=CPU,
        run_config=RunConfig(
            name=name, storage_path=str(tmp_path),
            checkpoint_config=CheckpointConfig(async_save=True, num_to_keep=2),
            failure_config=FailureConfig(max_failures=1)),
        datasets={"train": data.from_numpy(tokens, column="tokens")},
    ).fit(), tree


def _close(got, want, tol) -> bool:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) <= tol * float(np.abs(want).max())


@pytest.fixture(scope="module")
def unbroken(cluster, tmp_path_factory):
    """One fit over 4 batches, never failed: the run the other tests hold
    their losses to."""
    tokens = _tokens(4)
    result, tree = _fit(tmp_path_factory.mktemp("unbroken"), "sgd", tokens)
    return result, tree, tokens


def test_fit_trains_debug_from_a_data_shard_as_jax_does(unbroken):
    result, tree, tokens = unbroken
    assert result.error is None, result.error
    losses = [m["loss"] for m in result.metrics_history]
    want, want_params = _jax_sgd(tree, tokens)
    assert len(losses) == 4 and losses[3] < losses[0]
    assert _close(losses, want, 1e-5), (losses, want)
    # the last state= was committed, and registered under the run's name
    entry = rt.resilience.latest_registered("sgd")
    state, meta = load_checkpoint(entry["path"])
    assert state["step"] == meta["step"] == 3
    for name in ("embed", "lm_head"):
        assert _close(state["params"][name].numpy(), want_params[name], 1e-4)
    assert _close(state["params"]["layers"]["wq"].numpy(),
                  want_params["layers"]["wq"], 1e-4)


def test_a_failed_group_resumes_from_its_checkpoint(unbroken, tmp_path):
    """The first attempt dies before step 2; the restarted group loads the
    committed step 1 and its losses continue those of the unbroken run."""
    want, _, tokens = unbroken
    broken, _ = _fit(tmp_path, "broken", tokens, fail_at=2,
                     marker=str(tmp_path / "failed_once"))
    assert broken.error is None, broken.error
    assert [m["step"] for m in broken.metrics_history] == [0, 1, 2, 3]
    assert len(broken.recovery_events) == 1
    assert broken.recovery_events[0]["resume_step"] == 2
    assert _close([m["loss"] for m in broken.metrics_history],
                  [m["loss"] for m in want.metrics_history], 1e-6)
