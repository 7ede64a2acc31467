"""Llama-3-family decoder configuration and parameters.

Keeps the JAX package's preset names and its stacked parameter layout
(``wq`` [L, E, H, D], ``wo`` [L, H, D, E], MLP weights [L, E, M] /
[L, M, E]), so params carried across with ``llm.weights.params_from_numpy``
drop in unchanged. The training forward and loss are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    hidden: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    intermediate: int = 14_336
    head_dim: int = 128
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # MoE: n_experts > 0 selects a routed expert MLP (not ported yet).
    moe_experts: int = 0


PRESETS: dict[str, LlamaConfig] = {
    "llama3-8b": LlamaConfig(),
    "llama3-1b": LlamaConfig(hidden=2048, n_layers=16, n_heads=32, n_kv_heads=8,
                             intermediate=8192, head_dim=64),
    "llama3-8b-proxy": LlamaConfig(n_layers=8),
    "debug": LlamaConfig(vocab_size=256, hidden=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, intermediate=128, head_dim=16),
    "debug-128": LlamaConfig(vocab_size=512, hidden=128, n_layers=2, n_heads=4,
                             n_kv_heads=2, intermediate=256, head_dim=32),
    "llama-moe-debug": LlamaConfig(vocab_size=256, hidden=64, n_layers=2, n_heads=4,
                                   n_kv_heads=2, intermediate=128, head_dim=16,
                                   moe_experts=4),
    "mixtral-8x7b-ish": LlamaConfig(hidden=4096, n_layers=32, n_heads=32,
                                    n_kv_heads=8, intermediate=14_336, head_dim=128,
                                    moe_experts=8),
}


def init_params(config: LlamaConfig, generator: torch.Generator) -> dict:
    """Random init (truncated-normal fan-in scaling), stacked over layers,
    on the generator's device. Draws in the JAX package's order (embed, wq,
    wk, wv, wo, w_gate, w_up, w_down, lm_head); the numbers differ from
    JAX's, which tests carry across instead."""
    c = config
    if c.moe_experts > 0:
        raise NotImplementedError("MoE presets are not ported yet")
    L, H, E = c.n_layers, c.n_heads, c.hidden
    KH, D, M = c.n_kv_heads, c.head_dim, c.intermediate
    device = generator.device

    def norm_init(shape, fan_in):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return (t * fan_in ** -0.5).to(c.dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=c.dtype, device=device)

    embed = norm_init((c.vocab_size, E), E)
    wq = norm_init((L, E, H, D), E)
    wk = norm_init((L, E, KH, D), E)
    wv = norm_init((L, E, KH, D), E)
    wo = norm_init((L, H, D, E), H * D)
    w_gate = norm_init((L, E, M), E)
    w_up = norm_init((L, E, M), E)
    w_down = norm_init((L, M, E), M)
    lm_head = norm_init((E, c.vocab_size), E)
    return {
        "embed": embed,
        "layers": {
            "attn_norm": ones(L, E),
            "wq": wq, "wk": wk, "wv": wv, "wo": wo,
            "mlp_norm": ones(L, E),
            "w_gate": w_gate, "w_up": w_up, "w_down": w_down,
        },
        "final_norm": ones(E),
        "lm_head": lm_head,
    }
