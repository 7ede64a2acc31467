"""Shared inputs for the port's parity tests (``tests/test_torch_*.py``):
one parameter tree made with numpy from a seed, handed to the JAX package
as ``jnp`` arrays and to the port through ``params_from_numpy``. Only
``model_pair`` imports JAX."""

import dataclasses

import numpy as np
import torch

from ray_tpu_torch.llm.weights import params_from_numpy
from ray_tpu_torch.models.llama import PRESETS


def numpy_params(cfg, seed: int = 0) -> dict:
    """Fan-in-scaled normal weights in the stacked [L, ...] layout (the
    MoE tree's router and experts where ``cfg.moe_experts`` > 0)."""
    rng = np.random.default_rng(seed)
    L, H, E = cfg.n_layers, cfg.n_heads, cfg.hidden
    KH, D, M, V = cfg.n_kv_heads, cfg.head_dim, cfg.intermediate, cfg.vocab_size

    def w(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(np.float32)

    embed = w((V, E), E)
    attn = {"wq": w((L, E, H, D), E), "wk": w((L, E, KH, D), E),
            "wv": w((L, E, KH, D), E), "wo": w((L, H, D, E), H * D)}
    X = getattr(cfg, "moe_experts", 0)
    if X:
        mlp = {"router": w((L, E, X), E), "w_gate": w((L, X, E, M), E),
               "w_up": w((L, X, E, M), E), "w_down": w((L, X, M, E), M)}
    else:
        mlp = {"w_gate": w((L, E, M), E), "w_up": w((L, E, M), E),
               "w_down": w((L, M, E), M)}
    return {
        "embed": embed,
        "layers": {
            "attn_norm": np.ones((L, E), np.float32), **attn,
            "mlp_norm": np.ones((L, E), np.float32), **mlp,
        },
        "final_norm": np.ones((E,), np.float32),
        "lm_head": w((E, V), E),
    }


def tree_to_numpy(tree):
    """Tensors -> float32 (or integer) numpy arrays, for comparisons."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy()


def model_pair(preset: str = "debug", seed: int = 0):
    """``(jax_config, jax_params), (torch_config, torch_params)`` at f32."""
    # JAX is imported here, so that processes that take only the numpy
    # tree (the gloo workers) never import it
    import jax
    import jax.numpy as jnp

    from ray_tpu.models.llama import PRESETS as JAX_PRESETS

    jcfg = dataclasses.replace(JAX_PRESETS[preset], dtype=jnp.float32,
                               attn_impl="reference")
    tcfg = dataclasses.replace(PRESETS[preset], dtype=torch.float32)
    tree = numpy_params(tcfg, seed)
    return ((jcfg, jax.tree.map(jnp.asarray, tree)),
            (tcfg, params_from_numpy(tree, "cpu", torch.float32)))
