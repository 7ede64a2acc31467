"""The ``"dots"`` remat policy of the port's llama (``_DotsBlock``) on the
CPU at float32: the same loss and gradients as ``"full"`` and ``"attn"``,
what it keeps for the backward, how often the attention forward runs, and
its loss against the JAX package's ``loss_fn`` under
``dots_with_no_batch_dims_saveable`` on one numpy tree.

Tolerances, relative to the largest magnitude of the reference: 1e-6 for
the loss and 1e-5 for gradients between the port's policies (one
arithmetic, recomputed in another grouping), 1e-5 for the loss against
JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models.llama import PRESETS as JAX_PRESETS
from ray_tpu.models.llama import loss_fn as jax_loss_fn
from ray_tpu_torch.llm.weights import params_from_numpy
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.llama import PRESETS, loss_fn
from ray_tpu_torch.ops import apply_rope, attention, rms_norm
from _torch_parity import numpy_params

TOL_LOSS = 1e-6
TOL_GRAD = 1e-5
TOL_JAX = 1e-5


def _config(policy: str, **kw):
    return dataclasses.replace(PRESETS["debug"], dtype=torch.float32,
                               remat_policy=policy, **kw)


def _tokens(cfg, b=2, s=32, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)))


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _loss_and_grads(policy: str, tree: dict, tokens):
    cfg = _config(policy)
    params = params_from_numpy(tree, "cpu", torch.float32)
    for p in _leaves(params):
        p.requires_grad_()
    loss = loss_fn(params, {"tokens": tokens}, cfg, chunk_tokens=7)
    loss.backward()
    return loss.item(), [p.grad for p in _leaves(params)]


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("other", ["full", "attn"])
def test_dots_gives_the_loss_and_grads_of(other):
    tree = numpy_params(_config("full"), seed=0)
    tokens = _tokens(_config("full"))
    loss, grads = _loss_and_grads("dots", tree, tokens)
    want_loss, want_grads = _loss_and_grads(other, tree, tokens)
    assert abs(loss - want_loss) <= TOL_LOSS * abs(want_loss)
    assert len(grads) == len(want_grads) == 12
    for got, want in zip(grads, want_grads):
        assert _rel(got, want) <= TOL_GRAD


def test_dots_keeps_the_products_and_no_elementwise_output():
    """Every tensor the block saves for its backward, caught by
    ``saved_tensors_hooks``: the block input, the outputs of the q, k, v
    (before RoPE), wo, gate and up products, and the layer's weights;
    neither norm's output, RoPE's, the attention's nor the SiLU's. The
    down product's output only feeds the residual add, whose backward
    never reads it, so it is not kept either."""
    cfg = _config("dots")
    params = params_from_numpy(numpy_params(cfg, seed=3), "cpu",
                               torch.float32)
    layer = {k: w[0].requires_grad_() for k, w in params["layers"].items()}
    x = torch.randn(2, 16, cfg.hidden, generator=torch.Generator()
                    .manual_seed(4)).requires_grad_()
    positions = torch.arange(16)

    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        out = llama._apply_remat(cfg, positions)(x, layer)

    with torch.no_grad():
        h = rms_norm(x, layer["attn_norm"], eps=cfg.norm_eps)
        q = torch.einsum("bse,ehd->bhsd", h, layer["wq"])
        k = torch.einsum("bse,ehd->bhsd", h, layer["wk"])
        v = torch.einsum("bse,ehd->bhsd", h, layer["wv"])
        qr = apply_rope(q, positions, theta=cfg.rope_theta)
        kr = apply_rope(k, positions, theta=cfg.rope_theta)
        attn = attention.mha_reference(qr, kr, v, causal=True)
        wo = torch.einsum("bhsd,hde->bse", attn, layer["wo"])
        h2 = rms_norm(x + wo, layer["mlp_norm"], eps=cfg.norm_eps)
        gate = torch.einsum("bse,em->bsm", h2, layer["w_gate"])
        up = torch.einsum("bse,em->bsm", h2, layer["w_up"])
        ff = torch.nn.functional.silu(gate) * up
        down = torch.einsum("bsm,me->bse", ff, layer["w_down"])
    products = {"q": q, "k": k, "v": v, "wo": wo, "gate": gate, "up": up}
    elementwise = {"attn_norm": h, "q_rope": qr, "k_rope": kr,
                   "attention": attn, "mlp_norm": h2, "silu": ff,
                   "down": down, "block_out": x + wo + down}

    def close(a, b):
        return a.shape == b.shape and torch.allclose(a, b, rtol=1e-5,
                                                     atol=1e-6)

    weights = {k: w for k, w in layer.items()}
    kinds = []
    for t in saved:
        if t is x:
            kinds.append("x")
            continue
        w = next((n for n, w in weights.items() if t.data_ptr() == w.data_ptr()
                  and t.shape == w.shape), None)
        if w is not None:
            kinds.append(f"weight:{w}")
            continue
        p = next((n for n, want in products.items() if close(t, want)), None)
        assert p is not None, f"saved a tensor of shape {tuple(t.shape)} " \
            f"that is no product output"
        assert not any(close(t, e) for e in elementwise.values())
        kinds.append(p)
    assert sorted(kinds) == sorted(
        ["x", *products, *(f"weight:{n}" for n in weights)])
    assert close(out.detach(), elementwise["block_out"])
    assert llama.DOTS_SAVED == tuple(products)


@pytest.mark.parametrize("policy,fwd_per_layer", [("dots", 2), ("attn", 1)])
def test_dots_recomputes_the_attention_forward(monkeypatch, policy,
                                               fwd_per_layer):
    """The flash kernel is not a product, so ``"dots"`` runs its forward
    again in the backward, as JAX's policy recomputes the Pallas call; the
    backward's dQ and dK/dV run once per layer under either policy."""
    calls = {"fwd": 0, "dq": 0, "dkdv": 0}

    def counting(step, plain):
        def run(*args):
            calls[step] += 1
            return plain(*args)
        return run

    for step, name in (("fwd", "flash_forward_plain"),
                       ("dq", "flash_dq_plain"),
                       ("dkdv", "flash_dkdv_plain")):
        monkeypatch.setattr(attention, name,
                            counting(step, getattr(attention, name)))
    cfg = _config(policy)
    params = params_from_numpy(numpy_params(cfg, seed=5), "cpu",
                               torch.float32)
    for p in _leaves(params):
        p.requires_grad_()
    loss = loss_fn(params, {"tokens": _tokens(cfg, s=16)}, cfg)
    assert calls == {"fwd": cfg.n_layers, "dq": 0, "dkdv": 0}
    loss.backward()
    n = cfg.n_layers
    assert calls == {"fwd": fwd_per_layer * n, "dq": n, "dkdv": n}


def test_dots_loss_matches_the_jax_dots_policy():
    tcfg = _config("dots")
    jcfg = dataclasses.replace(JAX_PRESETS["debug"], dtype=jnp.float32,
                               attn_impl="reference", remat_policy="dots")
    tree = numpy_params(tcfg, seed=6)
    tokens = np.random.default_rng(7).integers(
        0, tcfg.vocab_size, (2, 32)).astype(np.int32)
    want, want_grads = jax.value_and_grad(
        lambda p: jax_loss_fn(p, {"tokens": jnp.asarray(tokens)}, jcfg,
                              chunk_tokens=7))(jax.tree.map(jnp.asarray, tree))
    params = params_from_numpy(tree, "cpu", torch.float32)
    params["lm_head"].requires_grad_()
    loss = loss_fn(params, {"tokens": torch.from_numpy(tokens)}, tcfg,
                   chunk_tokens=7)
    loss.backward()
    assert abs(loss.item() - float(want)) <= TOL_JAX * abs(float(want))
    assert _rel(params["lm_head"].grad,
                torch.from_numpy(np.array(want_grads["lm_head"]))) <= 1e-4
