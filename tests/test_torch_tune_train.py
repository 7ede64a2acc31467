"""A Tune trial that trains through the Train library, on a port cluster
on the CPU: the trial's trainable runs a nested ``TorchTrainer.fit``
(``use_gpu=False``) whose worker builds llama ``debug`` in f32 from a
numpy tree (``params_from_numpy(..., "cpu")``) and takes two SGD steps;
the loss the trial reports after them must equal the JAX package's
``loss_fn`` on the same tree after the same two SGD steps (relative
1e-5, as the port's other training parity tests), computed here."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu.models.llama import PRESETS as JAX_PRESETS
from ray_tpu.models.llama import loss_fn as jax_loss_fn
from ray_tpu_torch import tune
from ray_tpu_torch.models.llama import PRESETS
from ray_tpu_torch.train import RunConfig
from _torch_parity import numpy_params

LR = 0.5
BATCH, SEQ, STEPS = 2, 16, 2


@pytest.fixture(scope="module")
def cluster():
    # tests/conftest.py shuts down only ray_tpu's cluster, so this module
    # shuts its own down.
    rt.init(num_cpus=4)
    try:
        yield
    finally:
        rt.shutdown()


def _fit_trainable():
    """A trainable that runs ``TorchTrainer.fit`` and reports the fit's
    last metrics and the processes involved. Made inside a function, so
    that it (and the ``train_fn`` in it) is pickled by value."""
    def trainable(config):
        import os

        from ray_tpu_torch import tune as t
        from ray_tpu_torch.train import (RunConfig, ScalingConfig,
                                         TorchTrainer)

        def train_fn(cfg):
            import dataclasses
            import os

            import torch

            from ray_tpu_torch import train
            from ray_tpu_torch.llm.weights import params_from_numpy
            from ray_tpu_torch.models.llama import PRESETS, loss_fn

            mcfg = dataclasses.replace(PRESETS["debug"], dtype=torch.float32,
                                       remat_policy="attn")
            params = params_from_numpy(cfg["tree"], "cpu", torch.float32)
            leaves = [params["embed"], params["final_norm"],
                      params["lm_head"], *params["layers"].values()]
            for p in leaves:
                p.requires_grad_()
            tokens = torch.from_numpy(cfg["tokens"])
            losses = []
            for step in range(cfg["steps"]):
                batch = tokens[step * cfg["batch"]:(step + 1) * cfg["batch"]]
                loss = loss_fn(params, {"tokens": batch}, mcfg,
                               chunk_tokens=7)
                loss.backward()
                with torch.no_grad():
                    for p in leaves:
                        p.sub_(cfg["lr"] * p.grad)
                        p.grad = None
                losses.append(loss.item())
            with torch.no_grad():
                final = loss_fn(params, {"tokens": tokens[:cfg["batch"]]},
                                mcfg, chunk_tokens=7).item()
            train.report({"losses": losses, "loss": final,
                          "fit_pid": os.getpid(),
                          "device": str(params["embed"].device)})

        result = TorchTrainer(
            train_fn, train_loop_config=config,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
            run_config=RunConfig(name="nested", storage_path=config["storage"]),
        ).fit()
        if result.error is not None:
            raise result.error
        t.report({**result.metrics, "trial_pid": os.getpid()})

    return trainable


def _jax_sgd_then_loss(tree: dict, tokens: np.ndarray) -> tuple:
    jcfg = dataclasses.replace(JAX_PRESETS["debug"], dtype=jnp.float32,
                               attn_impl="reference")

    def loss(p, t):
        return jax_loss_fn(p, {"tokens": t}, jcfg, chunk_tokens=7)

    grad = jax.jit(jax.value_and_grad(loss))
    params = jax.tree.map(jnp.asarray, tree)
    losses = []
    for step in range(STEPS):
        value, g = grad(params, jnp.asarray(tokens[step * BATCH:
                                                   (step + 1) * BATCH]))
        params = jax.tree.map(lambda a, b: a - LR * b, params, g)
        losses.append(float(value))
    return losses, float(loss(params, jnp.asarray(tokens[:BATCH])))


def _close(got, want, tol) -> bool:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) <= tol * float(np.abs(want).max())


def test_trial_reports_the_nested_fits_loss_as_jax(cluster, tmp_path):
    tree = numpy_params(PRESETS["debug"], seed=0)
    tokens = np.random.default_rng(1).integers(
        0, PRESETS["debug"].vocab_size, (STEPS * BATCH, SEQ)).astype(np.int32)
    grid = tune.Tuner(
        _fit_trainable(),
        param_space={"tree": tree, "tokens": tokens, "lr": LR,
                     "batch": BATCH, "steps": STEPS,
                     "storage": str(tmp_path / "fit")},
        tune_config=tune.TuneConfig(metric="loss", mode="min"),
        run_config=RunConfig(name="nested_fit",
                             storage_path=str(tmp_path / "tune")),
    ).fit()
    assert not grid.errors, grid.errors
    got = grid.get_best_result("loss", "min").metrics
    want_losses, want_loss = _jax_sgd_then_loss(tree, tokens)
    assert _close(got["losses"], want_losses, 1e-5), (got, want_losses)
    assert _close(got["loss"], want_loss, 1e-5), (got["loss"], want_loss)
    assert got["loss"] < got["losses"][0]
    # the fit's worker is a process of its own, beside the trial's and
    # this driver's
    assert got["device"] == "cpu"
    assert len({got["fit_pid"], got["trial_pid"], os.getpid()}) == 3
