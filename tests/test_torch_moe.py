"""Parity of the port's Mixture-of-Experts (``ray_tpu_torch.models.moe``
and the MoE branch of ``models.llama``) with the JAX package's, on the
CPU.

``moe_block`` against the JAX ``moe_block`` in float32 and bfloat16,
with nothing dropped (capacity factor 4.0) and with drops (1.0);
``moe_aux_loss``; ``init_moe_params``' shapes and dtypes; and
``llama-moe-debug``'s ``loss_fn`` and every gradient against
``jax.value_and_grad`` under the ``"attn"``, ``"full"`` and ``"dots"``
remat policies. One numpy tree (``tests/_torch_parity.py``) feeds both
sides; the JAX side takes ``attn_impl="reference"`` (no Pallas compile),
the port the flash path (the kernels' plain versions on a CPU tensor).

Tolerances, relative to the largest magnitude of the reference: bf16
``moe_block`` outputs are bit-equal (each slot copies one token, each
output row sums at most ``top_k`` float32-exact products, rounded once);
float32 outputs and aux terms 1e-6 (the expert products sum in another
order); losses 1e-5 and gradients 1e-4 (float32 sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import moe as jax_moe
from ray_tpu.models.llama import PRESETS as JAX_PRESETS
from ray_tpu.models.llama import loss_fn as jax_loss_fn
from ray_tpu.models.llama import param_axes as jax_param_axes
from ray_tpu_torch.llm.weights import params_from_numpy
from ray_tpu_torch.models import moe
from ray_tpu_torch.models.llama import (PRESETS, forward_hidden, init_params,
                                        loss_fn, param_axes)
from _torch_parity import numpy_params, tree_to_numpy

TOL_OUT = 1e-6
TOL_FWD = 1e-5
TOL_GRAD = 1e-4
CHUNK = 7   # does not divide B * (S - 1) = 62: a padded tail


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                1e-30)
    assert err <= tol, f"{what}: relative error {err} > {tol}"


def _block_inputs(seed=0, b=2, s=16, e=64, m=128, x=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, e)).astype(np.float32), {
        "router": (rng.standard_normal((e, x)) * e ** -0.5).astype(np.float32),
        "w_gate": (rng.standard_normal((x, e, m)) * e ** -0.5).astype(np.float32),
        "w_up": (rng.standard_normal((x, e, m)) * e ** -0.5).astype(np.float32),
        "w_down": (rng.standard_normal((x, m, e)) * m ** -0.5).astype(np.float32),
    })


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [4.0, 1.0])
def test_moe_block_matches_jax(dtype, capacity_factor):
    x, p = _block_inputs()
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(v, jnp.float32 if k == "router" else jdt)
          for k, v in p.items()}
    want, want_aux = jax_moe.moe_block(jnp.asarray(x, jdt), jp, top_k=2,
                                       capacity_factor=capacity_factor)
    tp = params_from_numpy(p, "cpu", tdt)
    assert tp["router"].dtype == torch.float32
    got, aux = moe.moe_block(torch.from_numpy(x).to(tdt), tp, top_k=2,
                             capacity_factor=capacity_factor)
    assert got.dtype == tdt and aux.dtype == torch.float32
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        _close(got, want, TOL_OUT, "out")
    _close(aux, float(want_aux), TOL_OUT, "aux")
    # the two factors route the same tokens; 1.0 leaves some with no
    # expert (a zero row) and 4.0 none
    n, top_k, n_experts = x.shape[0] * x.shape[1], 2, p["router"].shape[1]
    capacity = max(1, int(capacity_factor * n * top_k / n_experts))
    _, _, idx = moe._route(torch.from_numpy(x).reshape(n, -1),
                           torch.from_numpy(p["router"]), top_k)
    dropped = int((moe._positions(idx, n_experts) >= capacity).sum())
    assert (dropped > 0) == (capacity_factor == 1.0)


def test_moe_aux_loss_matches_jax():
    x, p = _block_inputs(seed=1)
    want = jax_moe.moe_aux_loss(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                                top_k=2)
    got = moe.moe_aux_loss(torch.from_numpy(x),
                           params_from_numpy(p, "cpu"), top_k=2)
    _close(got, float(want), TOL_OUT, "aux loss")


@pytest.mark.parametrize("n_layers", [None, 3])
def test_init_moe_params_shapes_and_dtypes(n_layers):
    want = jax_moe.init_moe_params(jax.random.PRNGKey(0), hidden=32,
                                   expert_mlp=48, n_experts=4,
                                   dtype=jnp.bfloat16, n_layers=n_layers)
    got = moe.init_moe_params(torch.Generator().manual_seed(0), hidden=32,
                              expert_mlp=48, n_experts=4,
                              dtype=torch.bfloat16, n_layers=n_layers)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
    assert moe.moe_param_axes(("layers",)) == jax_moe.moe_param_axes(
        ("layers",))


def test_llama_moe_debug_init_and_axes():
    cfg = PRESETS["llama-moe-debug"]
    params = init_params(cfg, torch.Generator().manual_seed(0))
    axes = param_axes(cfg)
    assert axes == jax_param_axes(JAX_PRESETS["llama-moe-debug"])
    for name, t in params["layers"].items():
        assert t.dim() == len(axes["layers"][name]), name
    assert params["layers"]["router"].dtype == torch.float32
    assert params["layers"]["w_gate"].shape == (2, 4, 64, 128)


def _pair(policy: str, seed: int, **kw):
    jcfg = dataclasses.replace(JAX_PRESETS["llama-moe-debug"],
                               dtype=jnp.float32, attn_impl="reference",
                               remat_policy=policy, **kw)
    tcfg = dataclasses.replace(PRESETS["llama-moe-debug"],
                               dtype=torch.float32, remat_policy=policy, **kw)
    tree = numpy_params(tcfg, seed)
    tparams = params_from_numpy(tree, "cpu", torch.float32)
    for t in jax.tree.leaves(tparams):
        t.requires_grad_()
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, tparams


def _batch(seed, b=2, s=32):
    tokens = np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)
    mask = np.ones(tokens.shape, np.int32)
    mask[1, :5] = 0
    return {"tokens": tokens, "mask": mask}


def _grads(params):
    return {k: _grads(v) if isinstance(v, dict) else v.grad
            for k, v in params.items()}


def _tree_close(got, want, tol, path=""):
    assert set(got) == set(want), path
    for k in got:
        if isinstance(got[k], dict):
            _tree_close(got[k], want[k], tol, f"{path}/{k}")
        else:
            _close(got[k], want[k], tol, f"{path}/{k}")


@pytest.mark.parametrize("policy", ["attn", "full", "dots"])
def test_llama_moe_loss_and_grads_match_jax(policy):
    """``loss_fn`` (cross entropy + 0.01 aux, a mask, a padded chunk) and
    every gradient leaf, router and experts included."""
    jcfg, jparams, tcfg, tparams = _pair(policy, seed=2)
    batch = _batch(3)
    want, want_grads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(p, b, jcfg, chunk_tokens=CHUNK)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss = loss_fn(tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
                   tcfg, chunk_tokens=CHUNK)
    loss.backward()
    _close(loss, float(want), TOL_FWD, "loss")
    _tree_close(tree_to_numpy(_grads(tparams)),
                jax.tree.map(np.asarray, want_grads), TOL_GRAD)


def test_forward_hidden_returns_the_summed_aux():
    jcfg, jparams, tcfg, tparams = _pair("attn", seed=4)
    tokens = _batch(5)["tokens"]
    from ray_tpu.models.llama import forward_hidden as jax_forward_hidden

    want_h, want_aux = jax_forward_hidden(jparams, jnp.asarray(tokens), jcfg,
                                          return_aux=True)
    with torch.no_grad():
        h, aux = forward_hidden(tparams, torch.from_numpy(tokens), tcfg,
                                return_aux=True)
        dense = dataclasses.replace(PRESETS["debug"], dtype=torch.float32)
        _, zero = forward_hidden(params_from_numpy(numpy_params(dense), "cpu"),
                                 torch.from_numpy(tokens), dense,
                                 return_aux=True)
    _close(h, want_h, TOL_FWD, "hidden")
    _close(aux, float(want_aux), TOL_FWD, "aux")
    assert zero.item() == 0.0
