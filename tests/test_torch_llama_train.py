"""Parity of the port's training path (``ray_tpu_torch.models.llama``:
``forward_hidden``, ``forward``, ``loss_fn`` and their gradients) with the
JAX package's, on the CPU at float32.

One numpy parameter tree (``tests/_torch_parity.py``) feeds both sides.
Attention is ``attn_impl="flash"`` on both: the JAX Pallas kernels in
interpret mode, the port's kernels' plain versions (a CPU tensor). JAX
gradients come from ``jax.value_and_grad``, the port's from
``torch.autograd``.

Tolerances, relative to the largest magnitude of the reference: 1e-5 for
hidden states, logits and losses, 1e-4 for gradients (float32 sums in
another order; attention and the chunked loss sum in another grouping).
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from ray_tpu.models.llama import PRESETS as JAX_PRESETS
from ray_tpu.models.llama import forward_hidden as jax_forward_hidden
from ray_tpu.models.llama import loss_fn as jax_loss_fn
from ray_tpu.models.llama import train_flops_per_token as jax_flops
from ray_tpu_torch.llm.weights import params_from_numpy
from ray_tpu_torch.ops import attention
from ray_tpu_torch.models.llama import (PRESETS, forward, forward_hidden,
                                        init_params, lm_head_grads_f32,
                                        loss_fn, train_flops_per_token)
from _torch_parity import numpy_params, tree_to_numpy

TOL_FWD = 1e-5
TOL_GRAD = 1e-4


def _configs(preset, **kw):
    jcfg = dataclasses.replace(JAX_PRESETS[preset], dtype=jnp.float32,
                               attn_impl="flash", **kw)
    tcfg = dataclasses.replace(PRESETS[preset], dtype=torch.float32,
                               attn_impl="flash", **kw)
    return jcfg, tcfg


def _params(tcfg, seed=0):
    """The same numpy tree as JAX arrays and as port tensors that take
    gradients."""
    tree = numpy_params(tcfg, seed)
    tparams = params_from_numpy(tree, "cpu", torch.float32)
    for t in jax.tree.leaves(tparams):
        t.requires_grad_()
    return jax.tree.map(jnp.asarray, tree), tparams


def _tokens(cfg, b=2, s=32, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _assert_close(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: relative error {err} > {tol}"


def _assert_tree_close(got: dict, want: dict, tol, path=""):
    assert set(got) == set(want), path
    for name in got:
        if isinstance(got[name], dict):
            _assert_tree_close(got[name], want[name], tol, f"{path}/{name}")
        else:
            _assert_close(got[name], want[name], tol, f"{path}/{name}")


def _grads(params: dict) -> dict:
    return {k: _grads(v) if isinstance(v, dict) else v.grad
            for k, v in params.items()}


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(preset: str, chunk_tokens: int):
    """One compiled JAX loss-and-grad per preset and chunk size, shared by
    the tests (the JAX kernels in interpret mode compile slowly). The
    batch always carries a mask, so masked and unmasked calls share it."""
    jcfg, _ = _configs(preset)
    return jax.jit(jax.value_and_grad(
        lambda p, batch: jax_loss_fn(p, batch, jcfg,
                                     chunk_tokens=chunk_tokens)))


def _batch(tokens, masked: bool) -> dict:
    mask = np.ones(tokens.shape, np.int32)
    if masked:
        mask[0, 20:] = 0
        mask[1, :5] = 0
    return {"tokens": tokens, "mask": mask}


def _jax_loss_and_grads(preset, jparams, batch, chunk_tokens):
    loss, grads = _jax_value_and_grad(preset, chunk_tokens)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), jax.tree.map(np.asarray, grads)


def _port_loss_and_grads(tcfg, tparams, batch, chunk_tokens):
    loss = loss_fn(tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
                   tcfg, chunk_tokens=chunk_tokens)
    loss.backward()
    return loss, tree_to_numpy(_grads(tparams))


# chunk_tokens that do not divide B * (S - 1) = 2 * 31 = 62
CHUNK = {"debug": 7, "debug-128": 24}


@pytest.mark.parametrize("preset", ["debug", "debug-128"])
def test_forward_hidden_and_forward_match_jax(preset):
    jcfg, tcfg = _configs(preset, remat=False)
    jparams, tparams = _params(tcfg)
    tokens = _tokens(tcfg)
    with torch.no_grad():
        got_h = forward_hidden(tparams, torch.from_numpy(tokens), tcfg)
        got_logits = forward(tparams, torch.from_numpy(tokens), tcfg)
    want_h = jax_forward_hidden(jparams, jnp.asarray(tokens), jcfg)
    # ray_tpu.models.llama.forward's own arithmetic on that hidden state
    want_logits = jnp.einsum("bse,ev->bsv", want_h,
                             jparams["lm_head"]).astype(jnp.float32)
    assert got_logits.dtype == torch.float32
    _assert_close(got_h, want_h, TOL_FWD, "hidden")
    _assert_close(got_logits, want_logits, TOL_FWD, "logits")


@pytest.mark.parametrize("preset", ["debug", "debug-128"])
def test_masked_chunked_loss_and_grads_match_jax(preset):
    """``loss_fn`` with a mask and chunks that leave a padded tail, and
    every gradient; the port under its training policy ``"attn"``."""
    _, tcfg = _configs(preset, remat_policy="attn")
    jparams, tparams = _params(tcfg)
    batch = _batch(_tokens(tcfg), masked=True)
    want_loss, want_grads = _jax_loss_and_grads(preset, jparams, batch,
                                                CHUNK[preset])
    loss, grads = _port_loss_and_grads(tcfg, tparams, batch, CHUNK[preset])
    assert loss.dtype == torch.float32
    _assert_close(loss, want_loss, TOL_FWD, "loss")
    _assert_tree_close(grads, want_grads, TOL_GRAD)


@pytest.mark.parametrize("remat,policy", [(False, "full"), (True, "full"),
                                          (True, "attn")])
def test_remat_policies_give_the_same_grads(remat, policy):
    """No remat, ``"full"`` and ``"attn"`` each against the JAX package's
    gradients."""
    _, tcfg = _configs("debug", remat=remat, remat_policy=policy)
    jparams, tparams = _params(tcfg, seed=2)
    batch = _batch(_tokens(tcfg, seed=3), masked=False)
    want_loss, want_grads = _jax_loss_and_grads("debug", jparams, batch,
                                                CHUNK["debug"])
    loss, grads = _port_loss_and_grads(tcfg, tparams, batch, CHUNK["debug"])
    _assert_close(loss, want_loss, TOL_FWD, "loss")
    _assert_tree_close(grads, want_grads, TOL_GRAD)


@pytest.mark.parametrize("policy,fwd_per_layer", [("attn", 1), ("full", 2)])
def test_attention_forward_runs_once_per_layer_under_attn(
        monkeypatch, policy, fwd_per_layer):
    """``"attn"`` keeps the attention output: its forward runs once per
    layer per step; ``"full"`` runs it again in the backward."""
    calls = []
    plain = attention.flash_forward_plain

    def counting(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(attention, "flash_forward_plain", counting)
    _, tcfg = _configs("debug", remat_policy=policy)
    _, tparams = _params(tcfg)
    loss = loss_fn(tparams, {"tokens": torch.from_numpy(_tokens(tcfg))}, tcfg)
    assert len(calls) == tcfg.n_layers
    loss.backward()
    assert len(calls) == fwd_per_layer * tcfg.n_layers


@pytest.mark.parametrize("preset", ["debug", "debug-128"])
def test_three_sgd_steps_match_jax(preset):
    lr = 0.5
    _, tcfg = _configs(preset, remat_policy="attn")
    jparams, tparams = _params(tcfg, seed=4)
    batch = _batch(_tokens(tcfg, seed=5), masked=False)
    leaves = jax.tree.leaves(tparams)
    want, got = [], []
    for _ in range(3):
        loss, grads = _jax_value_and_grad(preset, CHUNK[preset])(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
        jparams = jax.tree.map(lambda a, b: a - lr * b, jparams, grads)
        want.append(float(loss))
        loss = loss_fn(tparams, {k: torch.from_numpy(v)
                                 for k, v in batch.items()},
                       tcfg, chunk_tokens=CHUNK[preset])
        loss.backward()
        with torch.no_grad():
            for p in leaves:
                p.sub_(lr * p.grad)
                p.grad = None
        got.append(loss.item())
    assert got[2] < got[0]
    _assert_close(torch.tensor(got), np.asarray(want), TOL_FWD, "losses")
    _assert_tree_close(tree_to_numpy(tparams),
                       jax.tree.map(np.asarray, jparams), TOL_GRAD)


@pytest.mark.parametrize("preset", ["llama3-8b", "llama3-1b",
                                    "llama3-8b-proxy", "debug", "debug-128"])
def test_train_flops_per_token_matches_jax(preset):
    for seq in (2048, 33):
        assert train_flops_per_token(PRESETS[preset], seq) == \
            jax_flops(JAX_PRESETS[preset], seq)


@pytest.mark.parametrize("preset", ["llama-moe-debug", "mixtral-8x7b-ish"])
def test_moe_presets_raise(preset):
    cfg = PRESETS[preset]
    tokens = torch.zeros(1, 4, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="MoE"):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="MoE"):
        forward_hidden({}, tokens, cfg)
    with pytest.raises(NotImplementedError, match="MoE"):
        train_flops_per_token(cfg, 16)


@pytest.mark.parametrize("what", ["mesh", "ring"])
def test_unported_options_raise(what):
    _, tcfg = _configs("debug")
    _, tparams = _params(tcfg)
    tokens = torch.from_numpy(_tokens(tcfg, s=8))
    kw = {}
    if what == "mesh":
        kw["mesh"] = object()
    else:
        tcfg = dataclasses.replace(tcfg, attn_impl="ring")
    with pytest.raises(NotImplementedError):
        loss_fn(tparams, {"tokens": tokens}, tcfg, **kw)


def _lm_head_inputs(c, e, v, seed):
    """A float32 logit gradient and bf16 h [C, E], w [E, V]."""
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.standard_normal((c, v), np.float32) * 1e-4)
    h = torch.from_numpy(rng.standard_normal((c, e), np.float32))
    w = torch.from_numpy(rng.standard_normal((e, v), np.float32) * e ** -0.5)
    return g, h.bfloat16(), w.bfloat16()


def _rel_frobenius(got, want) -> float:
    return float(torch.linalg.norm(got.double() - want)
                 / torch.linalg.norm(want))


# the last case splits dh's reduction over V in three pieces
@pytest.mark.parametrize("c,e,v", [(64, 32, 256), (48, 64, 1000),
                                   (8, 16, 40_000)])
def test_bf16_lm_head_grads_keep_the_f32_gradient(c, e, v):
    """The bf16 lm_head backward's float32 products, before their final
    rounding, against float64 products of the float32 g with the exact
    bf16 h and w: within 1e-4 (relative Frobenius). Rounding g to bf16
    before the products (the arithmetic this replaced) is ~2e-3 off."""
    g, h, w = _lm_head_inputs(c, e, v, seed=c + v)
    want_dh = g.double() @ w.double().t()
    want_dw = h.double().t() @ g.double()
    dh, dw = lm_head_grads_f32(g, h, w)
    assert dh.dtype == dw.dtype == torch.float32
    assert dh.shape == (c, e) and dw.shape == (e, v)
    assert _rel_frobenius(dh, want_dh) <= 1e-4
    assert _rel_frobenius(dw, want_dw) <= 1e-4
    g16 = g.bfloat16().float()
    assert _rel_frobenius(g16 @ w.float().t(), want_dh) > 1e-3
    assert _rel_frobenius(h.float().t() @ g16, want_dw) > 1e-3
