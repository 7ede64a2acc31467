"""Llama-3-family decoder: configuration, parameters, training forward
and loss.

Keeps the JAX package's preset names and its stacked parameter layout
(``wq`` [L, E, H, D], ``wo`` [L, H, D, E], MLP weights [L, E, M] /
[L, M, E]), so params carried across with ``llm.weights.params_from_numpy``
drop in unchanged. ``forward_hidden``, ``forward`` and ``loss_fn`` are the
training path; attention there is ``ops.flash_attention`` (the CUDA
kernels on a CUDA tensor) or ``ops.mha_reference``. bf16 params and
activations, f32 norm and softmax statistics and loss. Layers run in a
Python loop over the stacked weights (the JAX package scans them).

MoE presets (``moe_experts`` > 0: ``llama-moe-debug``,
``mixtral-8x7b-ish``) replace the MLP with ``models.moe.moe_block``
(top-k routing, per-expert capacity), and the loss adds
``moe_aux_weight`` times the layers' summed load-balancing term.

Remat policies: ``"full"``, ``"attn"`` (keep q, k, v and the attention
output) and ``"dots"`` (keep the products' outputs, recompute the rest).

``attn_impl`` ``"ring"`` and ``"ulysses"`` take the flash kernels when no
sequence-parallel mesh is given, as the JAX package's do. Not ported yet:
meshes and pipeline stages (a ``mesh`` raises).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import apply_rope, flash_attention, mha_reference, rms_norm
from .moe import init_moe_params, moe_block, moe_param_axes


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
    # attention implementation of the training path: "flash" | "ring" |
    # "ulysses" | "reference" ("ring" and "ulysses" without a mesh: flash)
    attn_impl: str = "flash"
    remat: bool = True
    # "full": recompute the whole block in backward; "attn": keep q, k, v
    # and the attention output, recompute the rest (the attention forward
    # never runs twice); "dots": keep the outputs of the products that the
    # backward reads, recompute the norms, RoPE, SiLU and attention.
    remat_policy: str = "full"
    # MoE: when n_experts > 0 the MLP becomes a top-k routed expert layer.
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_aux_weight: float = 0.01
    moe_capacity_factor: float = 1.25


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


def param_axes(config: LlamaConfig):
    """Tree of logical-axis tuples matching ``init_params`` output."""
    if config.moe_experts > 0:
        mlp_axes = moe_param_axes(prefix=("layers",))
    else:
        mlp_axes = {
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        }
    return {
        "embed": ("vocab_in", "embed"),
        "layers": {
            "attn_norm": ("layers", "norm"),
            "wq": ("layers", "embed", "heads", "head_dim"),
            "wk": ("layers", "embed", "kv_heads", "head_dim"),
            "wv": ("layers", "embed", "kv_heads", "head_dim"),
            "wo": ("layers", "heads", "head_dim", "embed"),
            "mlp_norm": ("layers", "norm"),
            **mlp_axes,
        },
        "final_norm": ("norm",),
        "lm_head": ("embed", "vocab"),
    }


def init_params(config: LlamaConfig, generator: torch.Generator) -> dict:
    """Random init (truncated-normal fan-in scaling), stacked over layers,
    on the generator's device. Draws in the JAX package's order (embed, wq,
    wk, wv, wo, the MLP's weights — w_gate, w_up, w_down, or MoE's router,
    w_gate, w_up, w_down — then lm_head); the numbers differ from JAX's,
    which tests carry across instead."""
    c = config
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
    if c.moe_experts > 0:
        mlp = init_moe_params(generator, hidden=E, expert_mlp=M,
                              n_experts=c.moe_experts, dtype=c.dtype,
                              n_layers=L)
    else:
        mlp = {"w_gate": norm_init((L, E, M), E),
               "w_up": norm_init((L, E, M), E),
               "w_down": norm_init((L, M, E), M)}
    lm_head = norm_init((E, c.vocab_size), E)
    return {
        "embed": embed,
        "layers": {
            "attn_norm": ones(L, E),
            "wq": wq, "wk": wk, "wv": wv, "wo": wo,
            "mlp_norm": ones(L, E),
            **mlp,
        },
        "final_norm": ones(E),
        "lm_head": lm_head,
    }


def _layer(params: dict, l: int) -> dict:
    """Layer ``l``'s weights: views into the stacked [L, ...] tensors."""
    return {name: w[l] for name, w in params["layers"].items()}


# The block's products: q, k and v, wo, the MLP's gate and up, and down.
_QKV_EQ = "bse,ehd->bhsd"
_WO_EQ = "bhsd,hde->bse"
_UP_EQ = "bse,em->bsm"
_DOWN_EQ = "bsm,me->bse"


def _einsum(name, eq, a, w):
    """One of the block's products; ``name`` says which (the "dots"
    policy keeps some of them by name)."""
    return torch.einsum(eq, a, w)


def _project_qkv(h, layer, product=_einsum):
    return tuple(product(n, _QKV_EQ, h, layer[f"w{n}"]) for n in "qkv")


def _gated(x, layer, c: LlamaConfig, product=_einsum):
    """RMSNorm, then the SwiGLU's gated product input, silu in f32."""
    h = rms_norm(x, layer["mlp_norm"], eps=c.norm_eps)
    gate = product("gate", _UP_EQ, h, layer["w_gate"])
    up = product("up", _UP_EQ, h, layer["w_up"])
    return F.silu(gate.float()).to(c.dtype) * up


def _mlp(x, layer, c: LlamaConfig):
    """Residual SwiGLU MLP with the silu in f32."""
    return x + torch.einsum(_DOWN_EQ, _gated(x, layer, c), layer["w_down"])


def _moe_mlp(x, layer, c: LlamaConfig):
    """Residual routed-expert MLP; returns (x, aux)."""
    h = rms_norm(x, layer["mlp_norm"], eps=c.norm_eps)
    down, aux = moe_block(h, layer, top_k=c.moe_top_k,
                          n_experts_global=c.moe_experts,
                          capacity_factor=c.moe_capacity_factor)
    return x + down, aux


def _check_supported(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "meshes (dp/tp/sp/pp sharding) are not ported yet; pass "
            "mesh=None")


def _attention(q, k, v, config: LlamaConfig, mesh=None):
    # "ring" and "ulysses" shard the sequence over a mesh's sp axis; with
    # no mesh they are the flash kernel, as in the JAX package
    _check_supported(mesh)
    if config.attn_impl in ("flash", "ring", "ulysses"):
        return flash_attention(q, k, v, causal=True)
    if config.attn_impl == "reference":
        return mha_reference(q, k, v, causal=True)
    if config.attn_impl == "none":
        raise NotImplementedError("attn_impl 'none' is not ported yet")
    raise ValueError(f"unknown attn_impl {config.attn_impl!r}")


def _attn_inputs(x, layer, positions, c: LlamaConfig, product=_einsum):
    """x -> RMSNorm -> q/k/v projections -> RoPE on q and k."""
    h = rms_norm(x, layer["attn_norm"], eps=c.norm_eps)
    q, k, v = _project_qkv(h, layer, product)
    q = apply_rope(q, positions, theta=c.rope_theta)
    k = apply_rope(k, positions, theta=c.rope_theta)
    return q, k, v


def _attn_out_and_mlp(x, attn, layer, c: LlamaConfig):
    """Output projection and residual, then the residual MLP. Returns
    (x, aux): MoE's load-balancing term, None for a dense MLP."""
    x = x + torch.einsum(_WO_EQ, attn, layer["wo"])
    if c.moe_experts > 0:
        return _moe_mlp(x, layer, c)
    return _mlp(x, layer, c), None


def _block(x, layer, positions, config: LlamaConfig, mesh=None):
    """One decoder block. x: [B, S, E] in config.dtype -> (the same, aux):
    the MoE aux loss, None for a dense block (the JAX block's 0.0)."""
    q, k, v = _attn_inputs(x, layer, positions, config)
    attn = _attention(q, k, v, config, mesh)
    return _attn_out_and_mlp(x, attn, layer, config)


_ATTN_NAMES = ("attn_norm", "wq", "wk", "wv", "wo")
_LAYER_NAMES = _ATTN_NAMES + ("mlp_norm", "w_gate", "w_up", "w_down")
# The products whose outputs "dots" keeps, in the order it saves them.
# The down product's output only feeds the residual add, whose backward
# never reads it, so it is not kept (nor is it by JAX's remat, which
# saves only the residuals its backward reads).
DOTS_SAVED = ("q", "k", "v", "wo", "gate", "up")
# Under MoE the "dots" Function covers the attention half only.
_DOTS_SAVED_MOE = DOTS_SAVED[:4]


def _dots_names(c: LlamaConfig) -> tuple:
    """(the layer weights the "dots" Function takes, the products it
    keeps)."""
    if c.moe_experts > 0:
        return _ATTN_NAMES, _DOTS_SAVED_MOE
    return _LAYER_NAMES, DOTS_SAVED


def _product_grads(eq: str, a, w, g):
    """The gradients of ``einsum(eq, a, w)`` in a and w for cotangent g."""
    ins, out = eq.split("->")
    ia, iw = ins.split(",")
    return (torch.einsum(f"{out},{iw}->{ia}", g, w),
            torch.einsum(f"{ia},{out}->{iw}", a, g))


class _SavedProduct(torch.autograd.Function):
    """``einsum(eq, a, w)`` whose value was kept by the forward: the
    "dots" backward's recompute takes the product from there, and the
    gradients still reach a and w."""

    @staticmethod
    def forward(ctx, a, w, out, eq):
        ctx.save_for_backward(a, w)
        ctx.eq = eq
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        da, dw = _product_grads(ctx.eq, a, w, g)
        return da, dw, None, None


def _dots_body(x, layer, positions, c: LlamaConfig, product):
    """The block up to the down product, with each product made by
    ``product(name, eq, a, w)``. Returns the residual after attention and
    the SiLU-gated MLP input (None under MoE, whose MLP is not here)."""
    q, k, v = _attn_inputs(x, layer, positions, c, product)
    x = x + product("wo", _WO_EQ, _attention(q, k, v, c), layer["wo"])
    if c.moe_experts > 0:
        return x, None
    return x, _gated(x, layer, c, product)


class _DotsBlock(torch.autograd.Function):
    """The decoder block under JAX's ``dots_with_no_batch_dims_saveable``.

    The forward keeps the block input and the outputs of the products in
    ``DOTS_SAVED``. The backward recomputes both RMSNorms, RoPE, the
    attention forward (a launch of its kernel) and the SiLU from them,
    with every product taken from the forward's copy, then runs autograd
    over that recompute. The flash kernel is not a product, so it is
    recomputed, as the Pallas call is in JAX."""

    @staticmethod
    def forward(ctx, x, positions, c, *weights):
        names, saved = _dots_names(c)
        layer = dict(zip(names, weights))
        kept = {}

        def product(name, eq, a, w):
            kept[name] = torch.einsum(eq, a, w)
            return kept[name]

        x1, ff = _dots_body(x, layer, positions, c, product)
        ctx.save_for_backward(x, *(kept[n] for n in saved), *weights)
        ctx.positions, ctx.c = positions, c
        if ff is None:
            return x1
        return x1 + torch.einsum(_DOWN_EQ, ff, layer["w_down"])

    @staticmethod
    def backward(ctx, g):
        names, saved = _dots_names(ctx.c)
        x, *rest = ctx.saved_tensors
        kept = dict(zip(saved, rest[:len(saved)]))
        weights = rest[len(saved):]
        with torch.enable_grad():
            x = x.detach().requires_grad_()
            leaves = [w.detach().requires_grad_() for w in weights]
            layer = dict(zip(names, leaves))
            x1, ff = _dots_body(
                x, layer, ctx.positions, ctx.c,
                lambda name, eq, a, w: _SavedProduct.apply(a, w, kept[name],
                                                           eq))
            if ff is None:
                grads = torch.autograd.grad(x1, [x, *leaves], g)
                return (grads[0], None, None, *grads[1:])
            dff, dw_down = _product_grads(_DOWN_EQ, ff, layer["w_down"], g)
            inputs = [x, *leaves[:-1]]
            grads = torch.autograd.grad([x1, ff], inputs, [g, dff])
        return (grads[0], None, None, *grads[1:], dw_down)


def _apply_remat(config: LlamaConfig, positions, mesh=None):
    """The decoder block ``(x, layer) -> (x, aux)`` under the configured
    rematerialisation policy (``torch.utils.checkpoint``).

    ``"attn"`` keeps what the JAX policy ``save_only_these_names("q", "k",
    "v", "attn_out")`` keeps. Selective checkpointing cannot see into the
    kernels' autograd function, so the policy is built from the block's
    structure: one checkpoint over x -> q/k/v (its recompute runs the norm,
    projections and RoPE again), the attention outside any checkpoint (it
    saves q, k, v, its output and lse, and its forward runs once per
    step), and one checkpoint over (x, attn) -> the block output.
    ``"dots"`` is ``_DotsBlock``; under MoE it covers the attention half,
    and the MoE MLP runs under a checkpoint that keeps only its input,
    recomputing the norm, the routing, the gather, the expert products
    and the combine in the backward (JAX's policy would also keep the
    router logits, the gathered ``expert_in`` and the combined output,
    whose dispatch and combine einsums have no batch dimension).
    Every policy computes the same values."""
    c = config
    if not c.remat:
        return lambda x, layer: _block(x, layer, positions, c, mesh)
    if c.remat_policy == "full":
        return lambda x, layer: checkpoint(
            _block, x, layer, positions, c, mesh, use_reentrant=False)
    if c.remat_policy == "attn":
        def block(x, layer):
            q, k, v = checkpoint(_attn_inputs, x, layer, positions, c,
                                 use_reentrant=False)
            attn = _attention(q, k, v, c, mesh)
            return checkpoint(_attn_out_and_mlp, x, attn, layer, c,
                              use_reentrant=False)
        return block
    if c.remat_policy == "dots":
        names, _ = _dots_names(c)

        def block(x, layer):
            _check_supported(mesh)
            x = _DotsBlock.apply(x, positions, c, *(layer[n] for n in names))
            if c.moe_experts > 0:
                return checkpoint(_moe_mlp, x, layer, c, use_reentrant=False)
            return x, None
        return block
    raise ValueError(f"unknown remat_policy {c.remat_policy!r}")


def forward_hidden(params, tokens, config: LlamaConfig, *, mesh=None,
                   return_aux: bool = False):
    """tokens [B, S] int -> final hidden states [B, S, E] in config.dtype.

    ``return_aux=True`` additionally returns the summed MoE load-balancing
    loss (0.0 for dense configs)."""
    c = config
    _check_supported(mesh)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = params["embed"][tokens].to(c.dtype)
    block = _apply_remat(c, positions, mesh)
    aux = None
    for l in range(params["layers"]["wq"].shape[0]):
        x, a = block(x, _layer(params, l))
        if a is not None:
            aux = a if aux is None else aux + a
    out = rms_norm(x, params["final_norm"], eps=c.norm_eps)
    if not return_aux:
        return out
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return out, aux


def forward(params, tokens, config: LlamaConfig, *, mesh=None):
    """tokens [B, S] -> logits [B, S, vocab] f32. For inference and tests;
    training uses ``loss_fn``, which never makes the full logits."""
    x = forward_hidden(params, tokens, config, mesh=mesh)
    return torch.einsum("bse,ev->bsv", x, params["lm_head"]).float()


def train_flops_per_token(config: LlamaConfig, seq: int) -> float:
    """Model FLOPs per trained token (6N active-param matmul + causal
    attention), the numerator of MFU. Embedding gather excluded (standard
    accounting); MoE counts the top_k ACTIVE experts plus the router."""
    c = config
    if c.moe_experts > 0:
        mlp = c.moe_top_k * 3 * c.hidden * c.intermediate + c.hidden * c.moe_experts
    else:
        mlp = 3 * c.hidden * c.intermediate
    n_params = c.n_layers * (
        c.hidden * c.head_dim * (c.n_heads * 2 + c.n_kv_heads * 2) + mlp
    ) + c.hidden * c.vocab_size
    attn = 6 * c.n_layers * c.n_heads * c.head_dim * seq  # causal fwd+bwd
    return 6.0 * n_params + attn


# dh = g·wᵀ reduces over the whole vocabulary. cuBLAS's bf16 products on
# an H100 accumulate with an error that grows in proportion to the
# reduction's length (chip_smoke.py's lm_head_grad phase shows it at the
# full vocabulary), so that reduction runs in pieces of at most this many
# terms, each product float32, summed in float32.
LM_HEAD_MAX_K = 16_384


def _mm_f32(a, b):
    """a @ b with a float32 result from bf16 operands: cuBLAS with a
    float32 output on the card; widened operands elsewhere (the CPU has
    no ``out_dtype``), which gives the same numbers, since products of
    bf16 values are exact in float32."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def lm_head_grads_f32(g, h, w):
    """The bf16 lm_head backward's two products, ``dh = g·wᵀ`` and
    ``dw = hᵀ·g``, in float32 before their final rounding. g [C, V] is the
    float32 logit gradient, h [C, E] and w [E, V] bf16.

    JAX's transpose of the f32-result einsum multiplies the float32 g by
    the bf16 operand. cuBLAS takes one operand dtype, and widening w to
    float32 would copy [E, V] every chunk, so g is split in two bf16 terms,
    ``g_hi = bf16(g)`` and ``g_lo = bf16(g - g_hi)``, and each product is
    the sum of the two terms' products: g keeps about 16 mantissa bits,
    and h and w stay exact. dh's reduction over V runs in pieces of at
    most ``LM_HEAD_MAX_K`` terms."""
    g_hi = g.to(h.dtype)
    g_lo = (g - g_hi).to(h.dtype)
    dh = torch.zeros(g.shape[0], w.shape[0], dtype=torch.float32,
                     device=g.device)
    for part in (g_hi, g_lo):
        for a, b in zip(part.split(LM_HEAD_MAX_K, dim=1),
                        w.split(LM_HEAD_MAX_K, dim=1)):
            dh += _mm_f32(a, b.t())
    dw = _mm_f32(h.t(), g_hi)
    dw += _mm_f32(h.t(), g_lo)
    return dh, dw


class _F32Logits(torch.autograd.Function):
    """h [C, E] @ w [E, V] with a float32 result from inputs of any float
    dtype: the JAX loss's ``preferred_element_type=f32``.

    bf16 inputs on the card go to cuBLAS as bf16 operands with a float32
    output; elsewhere h and w are widened first, which gives the same
    numbers. The backward keeps the float32 logit gradient at float32
    precision in both products, as the JAX transpose does: widened off the
    card and at float32, two bf16 terms on the card at bf16
    (``lm_head_grads_f32``). Only the results are rounded."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        ctx.wide = h.dtype == torch.float32 or h.device.type != "cuda"
        if ctx.wide:
            return torch.matmul(h.float(), w.float())
        return torch.mm(h, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        if ctx.wide:
            dh = torch.matmul(g, w.float().t())
            dw = torch.matmul(h.float().t(), g)
        else:
            dh, dw = lm_head_grads_f32(g, h, w)
        return dh.to(h.dtype), dw.to(w.dtype)


def _chunk_loss(h, t, m, lm_head):
    """Masked log-likelihood sum of one chunk of tokens."""
    logits = _F32Logits.apply(h, lm_head)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, t[:, None].long())[:, 0] - lse
    return (ll * m).sum()


def loss_fn(params, batch, config: LlamaConfig, *, mesh=None,
            chunk_tokens: int = 512):
    """Next-token cross entropy. batch: {"tokens": [B, S], "mask": [B, S]
    (optional)}.

    The lm_head product runs per chunk of ``chunk_tokens`` tokens, each
    chunk under a checkpoint, so the [B, S, vocab] logits never exist;
    tokens are padded (mask 0) to a whole number of chunks. MoE configs
    add ``moe_aux_weight`` times the summed load-balancing term."""
    tokens = batch["tokens"]
    aux = None
    if config.moe_experts > 0:
        hidden, aux = forward_hidden(params, tokens, config, mesh=mesh,
                                     return_aux=True)
    else:
        hidden = forward_hidden(params, tokens, config, mesh=mesh)
    targets = tokens[:, 1:]
    hidden = hidden[:, :-1]
    mask = batch.get("mask")
    mask = (torch.ones(targets.shape, dtype=torch.float32,
                       device=tokens.device) if mask is None
            else mask[:, 1:].float())

    b, s, e = hidden.shape
    n = b * s
    flat_h = hidden.reshape(n, e)
    flat_t = targets.reshape(n)
    flat_m = mask.reshape(n)
    chunk = min(chunk_tokens, n)
    if n % chunk:
        pad = chunk - n % chunk
        flat_h = F.pad(flat_h, (0, 0, 0, pad))
        flat_t = F.pad(flat_t, (0, pad))
        flat_m = F.pad(flat_m, (0, pad))
        n += pad
    total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i in range(0, n, chunk):
        total = total + checkpoint(
            _chunk_loss, flat_h[i:i + chunk], flat_t[i:i + chunk],
            flat_m[i:i + chunk], params["lm_head"], use_reentrant=False)
    ce = -total / torch.clamp(flat_m.sum(), min=1.0)
    return ce if aux is None else ce + config.moe_aux_weight * aux
