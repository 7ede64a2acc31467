"""Mixture-of-Experts block with expert parallelism over the ``ep`` axis.

Top-k routing with a static per-expert capacity (Switch/Mixtral style),
experts' weights stacked on their leading axis:

    router_logits [N, X]   -> top-k probs, renormalised gates
    position of each (token, k) in its expert's buffer of C slots: a
    cumulative count over the flattened [N*K, X] choices; tokens past C
    are dropped
    expert_in  [X, C, E]   <- the kept tokens, gathered to their slots
    expert_out = SwiGLU(expert_in)                   # per expert
    out[n]     = sum_k bf16(gate[n, k]) * expert_out[slot(n, k)]

The JAX package builds one-hot dispatch and combine tensors [N, X, C]
and contracts them with einsums; here the same slots are indices: a
gather into the experts' buffers and an ``index_add_`` back. The values
are the same: each slot holds one token, whose copy is exact, and each
output row sums at most ``top_k`` products of two numbers of the
activation dtype, each exact in float32, rounded once to that dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def moe_param_axes(prefix: tuple = ()):
    """Logical axes; ``prefix`` prepends e.g. ("layers",) for stacked use."""
    return {
        "router": prefix + ("embed", "experts"),
        "w_gate": prefix + ("experts", "embed", "expert_mlp"),
        "w_up": prefix + ("experts", "embed", "expert_mlp"),
        "w_down": prefix + ("experts", "expert_mlp", "embed"),
    }


def init_moe_params(generator: torch.Generator, hidden: int, expert_mlp: int,
                    n_experts: int, dtype, n_layers: int | None = None):
    """The single source of MoE init (llama.py stacks it per layer via
    ``n_layers``), on the generator's device. Draws router, w_gate, w_up,
    w_down in turn, truncated normal with fan-in scaling."""
    lead = () if n_layers is None else (n_layers,)
    device = generator.device

    def init(shape, fan_in, out_dtype=dtype):
        t = torch.empty(lead + shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return (t * fan_in ** -0.5).to(out_dtype)

    return {
        # router stays f32: routing logits are precision-sensitive
        "router": init((hidden, n_experts), hidden, torch.float32),
        "w_gate": init((n_experts, hidden, expert_mlp), hidden),
        "w_up": init((n_experts, hidden, expert_mlp), hidden),
        "w_down": init((n_experts, expert_mlp, hidden), expert_mlp),
    }


def _route(tokens, router, top_k: int):
    """f32 routing: probs [N, X], renormalised gates and experts [N, K]."""
    probs = torch.softmax(tokens.float() @ router, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, expert_idx


def _aux(probs, expert_idx, n_experts: int, top_k: int):
    """Switch load balance: X * sum(frac_tokens * mean_prob), where
    frac_tokens counts every choice, dropped ones too."""
    counts = torch.bincount(expert_idx.reshape(-1), minlength=n_experts)
    frac_tokens = counts.float() / expert_idx.shape[0] / top_k
    return n_experts * torch.sum(frac_tokens * probs.mean(0))


def _positions(expert_idx, n_experts: int):
    """Each (token, k) choice's slot in its expert's buffer [N*K]: how many
    earlier choices, in the flattened [N*K] order, took the same expert."""
    flat = expert_idx.reshape(-1)
    onehot = F.one_hot(flat, n_experts)
    return onehot.cumsum(0).gather(1, flat[:, None])[:, 0] - 1


def moe_block(x, params, *, top_k: int = 2, capacity_factor: float = 1.25,
              ep_axis: str | None = None, n_experts_global: int | None = None,
              mesh=None):
    """x: [B, S, E] -> ([B, S, E], aux). Routing in f32; expert FFN in
    x.dtype.

    With ``ep_axis`` set, ``params`` hold only this rank's share of the
    experts (``n_experts_global`` / ep of them, in rank order). Routing
    stays global (the router is replicated): this rank computes only its
    experts' part of the output, rounded to x.dtype, and an all-reduce
    over ``ep_axis`` (resolved against ``mesh`` or the current
    ``parallel.axis_env``) adds the parts."""
    b, s, e = x.shape
    n = b * s
    tokens = x.reshape(n, e)
    n_experts = n_experts_global or params["router"].shape[1]
    capacity = max(1, int(capacity_factor * n * top_k / n_experts))

    probs, gate_vals, expert_idx = _route(tokens, params["router"], top_k)
    pos = _positions(expert_idx, n_experts)
    experts = expert_idx.reshape(-1)
    keep = pos < capacity

    x_local = params["w_gate"].shape[0]
    first = 0
    if ep_axis is not None:
        from ..parallel.collectives import axis_index

        first = axis_index(ep_axis, mesh=mesh) * x_local
        keep = keep & (experts >= first) & (experts < first + x_local)
    choice = keep.nonzero()[:, 0]                 # kept (token, k), in order
    token = torch.div(choice, top_k, rounding_mode="floor")
    slot = (experts[choice] - first) * capacity + pos[choice]

    expert_in = tokens.new_zeros(x_local * capacity, e).index_copy(
        0, slot, tokens[token]).view(x_local, capacity, e)
    gate = torch.bmm(expert_in, params["w_gate"])
    up = torch.bmm(expert_in, params["w_up"])
    act = F.silu(gate.float()).to(x.dtype) * up
    expert_out = torch.bmm(act, params["w_down"]).view(-1, e)

    combine = gate_vals.reshape(-1)[choice].to(x.dtype)
    terms = expert_out[slot].float() * combine.float()[:, None]
    out = torch.zeros(n, e, dtype=torch.float32, device=x.device).index_add(
        0, token, terms).to(x.dtype)
    if ep_axis is not None:
        from ..parallel.collectives import all_reduce

        out = all_reduce(out, ep_axis, mesh=mesh)
    return out.reshape(b, s, e), _aux(probs, expert_idx, n_experts, top_k)


def moe_aux_loss(x, params, *, top_k: int = 2):
    """Load-balancing auxiliary loss (Switch: X * sum(frac_tokens * frac_probs))."""
    b, s, e = x.shape
    probs, _, expert_idx = _route(x.reshape(b * s, e), params["router"], top_k)
    return _aux(probs, expert_idx, probs.shape[-1], top_k)
