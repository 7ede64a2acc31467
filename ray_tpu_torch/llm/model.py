"""Paged-KV prefill / decode forward passes.

The port of ``ray_tpu/llm/model.py``. The KV cache is a shared page pool

    k_pages / v_pages: [layers, num_pages, kv_heads, page_size, head_dim]

and each sequence owns an int32 block table of page ids. Layouts, masks
and rounding points are the JAX package's, so the two agree on the same
inputs; the differences are PyTorch's:

  * The functions run eagerly. ``lax.scan`` over layers and decode steps
    is a Python loop.
  * Where JAX donated the pool and returned an updated one, these
    functions update the pool tensors IN PLACE (indexed assignment, i.e.
    ``index_put_``) and return the same dict. The staging carry is
    updated in place too.
  * ``jax.random`` keys become a ``torch.Generator``; greedy decoding
    draws nothing from it.

Invariant: before any step at position ``pos``, pages hold K/V for
``[0, pos)``; the step writes ``pos`` and attends over ``[0, pos]``.
Inactive or finished slots write to a private trash page (slot i's trash
page is page i), so their writes never touch live pages.

Paged decode (``paged=True``): the pool is read-only across a K-step
dispatch. Each step's fresh K/V goes to a staging carry
``[L, slots, KH, SC, D]`` that the decode kernel folds in after the pool
pages, and ``commit_staging`` writes the carry back with one scatter at
the dispatch boundary. The speculative verify (``verify_block``) runs the
same schedule over the K+1 drafted positions of every slot in one forward
and commits only the accepted rows.

Multi-LoRA (``lora.py``): ``prefill_chunk(lora=, lora_slot=)`` adds one
adapter's deltas to a prompt; the decode programs (``lora=``,
``lora_idx=``) add each slot's own, from rows gathered once a call.
``verify_block`` takes none, as in the JAX package.
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from ..models.llama import LlamaConfig, _layer, _mlp, _project_qkv
from ..ops import apply_rope, paged_decode_attention, rms_norm, stage_rows
from .lora import add_qkv_deltas, add_wo_delta_, lora_delta_single, slot_rows


def init_pages(config: LlamaConfig, num_pages: int, page_size: int,
               device=None) -> dict:
    """A zeroed ``{"k", "v"}`` pool [L, P, KH, page, D] in the config's
    dtype on ``device`` (``None``: the card, raising where there is
    none)."""
    c = config
    device = resolve_device(device)
    shape = (c.n_layers, num_pages, c.n_kv_heads, page_size, c.head_dim)
    return {"k": torch.zeros(shape, dtype=c.dtype, device=device),
            "v": torch.zeros(shape, dtype=c.dtype, device=device)}


def _gather_ctx(pool, l: int, tables):
    """Layer-indexed page gather: pool [L, P, KH, page, D], tables
    [..., B] -> [..., KH, B*page, D]."""
    g = pool[l][tables.long()]                 # [..., B, KH, page, D]
    g = g.transpose(-4, -3)                    # [..., KH, B, page, D]
    return g.reshape(*g.shape[:-3], -1, g.shape[-1])


def prefill_chunk(params, pages: dict, block_table, tokens, start_pos: int,
                  config: LlamaConfig, page_size: int,
                  live_pages: int | None = None, lora=None, lora_slot=None):
    """Process one prompt chunk.

    tokens [C] int32; block_table [max_pages] int32; ``start_pos`` need not
    be page-aligned (a prefix-cache partial hit starts mid-page after a COW
    fork), so K/V lands by a row-granular ``(page, offset)`` scatter.
    ``live_pages`` caps the context gather at the pages that can hold
    ``[0, start_pos)``.

    Attends over the context ``[0, start_pos)`` plus the chunk itself
    (causal), writes the chunk's K/V into its pages in place, and returns
    ``(pages, hidden [C, E])``.

    ``lora`` (the adapter stack, ``lora.init_lora_stack``) with
    ``lora_slot`` (an int) adds that adapter's deltas to q, k and v before
    RoPE, so the prompt's K/V carries it, and to the attention output's
    projection.
    """
    c = config
    dev = tokens.device
    C = tokens.shape[0]
    positions = start_pos + torch.arange(C, dtype=torch.int32, device=dev)
    gather_table = block_table
    if live_pages is not None and live_pages < block_table.shape[0]:
        gather_table = block_table[:live_pages]
    max_ctx = gather_table.shape[0] * page_size
    ctx_live = torch.arange(max_ctx, device=dev) < start_pos         # [ctx]
    ar = torch.arange(C, device=dev)
    causal = ar[:, None] >= ar[None, :]
    kh, g = c.n_kv_heads, c.n_heads // c.n_kv_heads
    # Row-granular write destinations: position p -> (its page, offset).
    # The clamp keeps pad rows past the table in range; they land at
    # future offsets of the last page and stay masked until overwritten.
    write_pages = block_table.long()[torch.clamp(
        positions.long() // page_size, max=block_table.shape[0] - 1)]  # [C]
    write_offs = positions.long() % page_size                          # [C]
    scale = c.head_dim ** -0.5

    x = params["embed"][tokens.long()][None].to(c.dtype)     # [1, C, E]
    kf, vf = pages["k"], pages["v"]
    for l in range(c.n_layers):
        layer = _layer(params, l)
        h = rms_norm(x, layer["attn_norm"], eps=c.norm_eps)
        q, k, v = _project_qkv(h, layer)                     # [1, H|KH, C, D]
        if lora is not None:
            def add(t, p):
                d = lora_delta_single(h, lora[f"{p}.A"], lora[f"{p}.B"], l,
                                      lora_slot)
                return t + d.reshape(1, C, t.shape[1], c.head_dim).transpose(
                    1, 2).to(t.dtype)

            q, k, v = add(q, "wq"), add(k, "wk"), add(v, "wv")
        q = apply_rope(q, positions, theta=c.rope_theta)
        k = apply_rope(k, positions, theta=c.rope_theta)
        ck = _gather_ctx(kf, l, gather_table)                # [KH, ctx, D]
        cv = _gather_ctx(vf, l, gather_table)
        qg = q[0].reshape(kh, g, C, c.head_dim)
        s_ctx = torch.einsum("kgcd,ktd->kgct", qg, ck).float()
        s_self = torch.einsum("kgcd,ktd->kgct", qg, k[0]).float()
        s_ctx = (s_ctx * scale).masked_fill(~ctx_live, float("-inf"))
        s_self = (s_self * scale).masked_fill(~causal, float("-inf"))
        probs = torch.softmax(torch.cat([s_ctx, s_self], dim=-1), dim=-1)
        p_ctx = probs[..., :max_ctx].to(c.dtype)
        p_self = probs[..., max_ctx:].to(c.dtype)
        attn = (torch.einsum("kgct,ktd->kgcd", p_ctx, cv)
                + torch.einsum("kgct,ktd->kgcd", p_self, v[0]))
        attn = attn.reshape(1, c.n_heads, C, c.head_dim)
        out = torch.einsum("bhsd,hde->bse", attn, layer["wo"])
        if lora is not None:
            flat = attn.transpose(1, 2).reshape(1, C, -1)    # (head, d) order
            out = out + lora_delta_single(flat, lora["wo.A"], lora["wo.B"], l,
                                          lora_slot).to(out.dtype)
        x = _mlp(x + out, layer, c)
        # In place: distinct positions give distinct (page, offset) rows.
        kf[l, write_pages, :, write_offs, :] = k[0].transpose(0, 1)
        vf[l, write_pages, :, write_offs, :] = v[0].transpose(0, 1)
    hidden = rms_norm(x, params["final_norm"], eps=c.norm_eps)[0]  # [C, E]
    return pages, hidden


def decode_block(x, layer, kf, vf, l: int, block_tables, pos, write_idx,
                 c: LlamaConfig, page_size: int, paged: bool = False,
                 live_pages: int | None = None, stage=None,
                 stage_step: int | None = None, lora_rows=None):
    """One decoder block for a [n, 1, E] single-token batch against the
    full page pool (kf/vf [L, P, KH, page, D], ``l`` this layer's index).

    ``paged=True`` runs the paged decode kernel. With the staging carry
    ``stage`` of the fused decode loop, this layer's fresh K/V goes to
    staging row ``stage_step`` and the kernel folds rows [0, stage_step]
    after the pool pages; the pool is not written. Without ``stage`` (the
    single step, ``decode_step``) the fresh K/V rides the kernel's compat
    mode (``k_cur``/``v_cur``) and is written to the pool after the
    kernel, so the pool is never a kernel operand and a write target at
    once. ``paged=False`` is the dense gather, width capped by
    ``live_pages``, which writes the pool first. ``lora_rows``
    (``lora.slot_rows``: each slot's adapter, gathered once a dispatch)
    adds the per-slot deltas to q, k and v before RoPE and to the output
    projection, on either route.
    Returns the block's output; pool or staging is updated in place.
    """
    n = x.shape[0]
    kh, g = kf.shape[2], c.n_heads // c.n_kv_heads
    h = rms_norm(x, layer["attn_norm"], eps=c.norm_eps)
    q, k, v = _project_qkv(h, layer)                   # [n, H|KH, 1, D]
    if lora_rows is not None:
        q, k, v = add_qkv_deltas(q, k, v, h, lora_rows, l)
    q = apply_rope(q, pos[:, None], theta=c.rope_theta)
    k = apply_rope(k, pos[:, None], theta=c.rope_theta)
    qg = q[:, :, 0].reshape(n, kh, g, c.head_dim)
    if paged:
        k_tok, v_tok = k[:, :, 0], v[:, :, 0]          # [n, KH, D]
        if stage is not None:
            ks, vs = stage
            ks[l, :, :, stage_step] = k_tok.to(ks.dtype)
            vs[l, :, :, stage_step] = v_tok.to(vs.dtype)
            attn = paged_decode_attention(
                qg, kf, vf, block_tables, pos, page_size=page_size,
                live_pages=live_pages, layer=l, k_stage=ks, v_stage=vs,
                stage_idx=stage_step)
        else:
            attn = paged_decode_attention(
                qg, kf, vf, block_tables, pos, k_tok, v_tok,
                page_size=page_size, live_pages=live_pages, layer=l)
            write_idx, offset = write_idx.long(), pos.long() % page_size
            kf[l, write_idx, :, offset, :] = k_tok
            vf[l, write_idx, :, offset, :] = v_tok
        attn = attn.reshape(n, 1, kh * g * c.head_dim)
    else:
        # Write each slot's new K/V at (its current page, offset), then
        # attend over the gathered context [0, pos]. Distinct slots own
        # distinct pages (trash pages for inactive ones).
        write_idx, offset = write_idx.long(), pos.long() % page_size
        kf[l, write_idx, :, offset, :] = k[:, :, 0]
        vf[l, write_idx, :, offset, :] = v[:, :, 0]
        if live_pages is not None and live_pages < block_tables.shape[1]:
            block_tables = block_tables[:, :live_pages]
        max_ctx = block_tables.shape[1] * page_size
        live = (torch.arange(max_ctx, device=x.device)[None]
                <= pos.long()[:, None])                  # [n, ctx]
        ck = _gather_ctx(kf, l, block_tables)            # [n, KH, ctx, D]
        cv = _gather_ctx(vf, l, block_tables)
        scores = torch.einsum("nkgd,nktd->nkgt", qg, ck).float()
        scores = scores * c.head_dim ** -0.5
        scores = scores.masked_fill(~live[:, None, None], float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(c.dtype)
        attn = torch.einsum("nkgt,nktd->nkgd", probs, cv).reshape(
            n, 1, kh * g * c.head_dim)
    out = torch.einsum("bsf,fe->bse", attn, layer["wo"].reshape(-1, c.hidden))
    if lora_rows is not None:
        add_wo_delta_(out, attn, lora_rows, l)
    return _mlp(x + out, layer, c)


def _decode_logits(params, pages: dict, block_tables, tokens, pos,
                   config: LlamaConfig, page_size: int, write_page_idx=None,
                   paged: bool = False, live_pages: int | None = None,
                   stage=None, stage_step: int | None = None, lora_rows=None):
    """One batched decode step over all slots. tokens/pos [slots];
    ``write_page_idx`` overrides the page each slot writes to (finished
    slots go to their trash page); ``lora_rows`` carries each slot's
    adapter (``lora.slot_rows``). Returns logits [slots, vocab] f32; the
    pool (dense, or paged without ``stage``) or the staging carry (paged
    with ``stage``) is updated in place."""
    c = config
    x = params["embed"][tokens.long()][:, None].to(c.dtype)   # [slots, 1, E]
    if write_page_idx is None:
        write_page_idx = block_tables.long().gather(
            1, (pos.long() // page_size)[:, None])[:, 0]
    for l in range(c.n_layers):
        x = decode_block(x, _layer(params, l), pages["k"], pages["v"], l,
                         block_tables, pos, write_page_idx, c, page_size,
                         paged=paged, live_pages=live_pages, stage=stage,
                         stage_step=stage_step, lora_rows=lora_rows)
    hidden = rms_norm(x, params["final_norm"], eps=c.norm_eps)
    logits = torch.einsum("bse,ev->bsv", hidden, params["lm_head"])[:, 0]
    return logits.float()


def commit_staging(pages: dict, stage, write_idx_steps, pos0, n_steps: int,
                   page_size: int) -> dict:
    """Dispatch-boundary commit: one scatter writes the staging carry back
    into the pool, in place.

    stage: (k_stage, v_stage) [L, slots, KH, SC, D] — row j of slot s holds
    the K/V of position pos0_s + j. write_idx_steps: [n_steps, slots] — the
    page each slot wrote at each step (trash pages for finished slots).
    """
    k_stage, v_stage = stage
    L, n, kh, _, d = k_stage.shape
    steps = torch.arange(n_steps, device=pos0.device)
    off = ((pos0.long()[None, :] + steps[:, None]) % page_size).reshape(-1)
    widx = write_idx_steps.long().reshape(-1)                     # [K*S]

    def rows(s):
        # [L, S, KH, SC, D] -> [K*S, L, KH, D] in (step, slot) order, the
        # shape of pool[:, widx, :, off, :] (index dims first).
        r = s[:, :, :, :n_steps].permute(3, 1, 0, 2, 4)
        return r.reshape(n_steps * n, L, kh, d)

    pages["k"][:, widx, :, off, :] = rows(k_stage).to(pages["k"].dtype)
    pages["v"][:, widx, :, off, :] = rows(v_stage).to(pages["v"].dtype)
    return pages


def copy_pages(pages: dict, src, dst) -> dict:
    """Copy-on-write fork: duplicate pages ``src`` into pages ``dst``
    across every layer, in place."""
    src, dst = src.long(), dst.long()
    for name in ("k", "v"):
        pages[name][:, dst] = pages[name][:, src]
    return pages


def write_pages(pages: dict, dst, k_rows, v_rows) -> dict:
    """KV-migration import: scatter transferred page contents into pages
    ``dst`` across every layer, in place, cast to the pool's dtype (the
    inverse of the export gather). dst: [m] page ids; k_rows/v_rows:
    [L, m, KH, page, D]."""
    dst = dst.long()
    pages["k"][:, dst] = k_rows.to(pages["k"].dtype)
    pages["v"][:, dst] = v_rows.to(pages["v"].dtype)
    return pages


def _rows(lora, lora_idx):
    return None if lora is None else slot_rows(lora, lora_idx)


def decode_step(params, pages: dict, block_tables, tokens, pos,
                config: LlamaConfig, page_size: int, write_page_idx=None,
                paged: bool = False, live_pages: int | None = None,
                lora=None, lora_idx=None):
    """One batched decode step over all slots, writing each slot's fresh
    K/V at ``pos`` into the pool (paged: the kernel's compat mode, then the
    write). ``lora`` (the adapter stack) with ``lora_idx`` [slots] (each
    slot's adapter, 0 = base) adds the per-slot adapter deltas. Returns
    (logits [slots, vocab] f32, pages)."""
    logits = _decode_logits(params, pages, block_tables, tokens, pos, config,
                            page_size, write_page_idx=write_page_idx,
                            paged=paged, live_pages=live_pages,
                            lora_rows=_rows(lora, lora_idx))
    return logits, pages


def _sample(logits, temps, generator: torch.Generator, sample: bool):
    """Greedy where temp <= 0, tempered categorical elsewhere. ``sample``
    False (no slot has temp > 0) skips the draw."""
    greedy = logits.argmax(dim=-1)
    if not sample:
        return greedy.to(torch.int32)
    probs = torch.softmax(logits / temps.clamp(min=1e-6)[:, None], dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(temps > 0.0, sampled, greedy).to(torch.int32)


def decode_and_sample(params, pages: dict, block_tables, tokens, pos, temps,
                      generator: torch.Generator, config: LlamaConfig,
                      page_size: int, paged: bool = False,
                      live_pages: int | None = None, lora=None,
                      lora_idx=None):
    """``decode_step`` and sampling in one call: greedy where temp <= 0,
    tempered categorical elsewhere. Returns (tokens [slots] int32,
    pages)."""
    logits, pages = decode_step(params, pages, block_tables, tokens, pos,
                                config, page_size, paged=paged,
                                live_pages=live_pages, lora=lora,
                                lora_idx=lora_idx)
    return _sample(logits, temps, generator, True), pages


def sample_first_token(last_hidden, lm_head, temp: float,
                       generator: torch.Generator):
    """First-token sampling after prefill: last_hidden [E] -> token []
    int32, greedy at temp <= 0. ``temp`` is a host number."""
    logits = (last_hidden @ lm_head).float()[None]
    temps = torch.full((1,), float(temp), device=logits.device)
    return _sample(logits, temps, generator, temp > 0)[0]


def sample_first_batch(hiddens, lm_head, temps, generator: torch.Generator):
    """Batched first-token sampling for just-prefilled requests.
    hiddens [m, E] -> tokens [m] int32."""
    logits = (hiddens @ lm_head).float()
    return _sample(logits, temps, generator, bool((temps > 0).any()))


def decode_loop(params, pages: dict, block_tables, tokens, pos, temps,
                eos_ids, remaining, generator: torch.Generator,
                config: LlamaConfig, page_size: int, n_steps: int,
                paged: bool = False, live_pages: int | None = None,
                lora=None, lora_idx=None):
    """``n_steps`` decode+sample iterations in one call.

    Slots whose sequence finishes mid-loop (EOS, or ``remaining`` spent)
    keep computing but redirect their KV writes to their trash page; the
    caller discards their surplus tokens. ``paged=True`` runs the staging
    schedule: the pool is read-only across all steps and ``commit_staging``
    writes the carry back once at the end.

    eos_ids [slots] int32 (-1 = none); remaining [slots] int32. For dense,
    ``live_pages`` must cover ``max(pos) + n_steps - 1``; for paged only
    the pool context ``max(pos)``. ``lora`` (the adapter stack) with
    ``lora_idx`` [slots] int32 (0 = base) adds each slot's adapter; the
    slots' rows are gathered once for all steps. Returns (tokens
    [n_steps, slots] int32, pages).
    """
    n = tokens.shape[0]
    dev = tokens.device
    lora_rows = _rows(lora, lora_idx)
    trash = torch.arange(n, device=dev)    # slot i's trash page is page i
    stage = None
    if paged:
        c = config
        shape = (c.n_layers, n, c.n_kv_heads, stage_rows(n_steps), c.head_dim)
        stage = (torch.zeros(shape, dtype=pages["k"].dtype, device=dev),
                 torch.zeros(shape, dtype=pages["v"].dtype, device=dev))
    sample = bool((temps > 0).any())
    tables = block_tables.long()
    last_page = block_tables.shape[1] - 1
    cur, done = pos, remaining <= 0
    out_tokens, out_widx = [], []
    for j in range(n_steps):
        real_page = tables.gather(1, torch.clamp(
            cur.long() // page_size, max=last_page)[:, None])[:, 0]
        write_idx = torch.where(done, trash, real_page)
        logits = _decode_logits(
            params, pages, block_tables, tokens, cur, config, page_size,
            write_page_idx=write_idx, paged=paged, live_pages=live_pages,
            stage=stage, stage_step=j if paged else None, lora_rows=lora_rows)
        new_tok = _sample(logits, temps, generator, sample)
        remaining = remaining - (~done).to(remaining.dtype)
        done = done | (new_tok == eos_ids) | (remaining <= 0)
        out_tokens.append(new_tok)
        out_widx.append(write_idx)
        tokens, cur = new_tok, cur + 1
    if paged:
        # The one pool write of the whole dispatch.
        commit_staging(pages, stage, torch.stack(out_widx), pos, n_steps,
                       page_size)
    return torch.stack(out_tokens), pages


def mixed_dispatch(params, pages: dict, prefill_ops, block_tables, tokens,
                   pos, temps, eos_ids, remaining, generator: torch.Generator,
                   config: LlamaConfig, page_size: int, n_steps: int,
                   paged: bool = False, live_pages: int | None = None,
                   prefill_live_pages: tuple = (), lora=None, lora_idx=None):
    """Token-budget mixed step: prefill chunk(s), then the full-batch decode
    burst, in one call. prefill_ops: ``(block_table, tokens, start_pos)``
    per admitted prompt; their pages are disjoint from every decoding
    slot's. ``lora``/``lora_idx`` reach the decode burst only: a prompt
    with an adapter prefills on its own (``prefill_chunk(lora_slot=)``).
    Returns ``(decode_tokens [n_steps, slots], pages, hiddens)`` with one
    ``[C_i, E]`` hidden per prefill op."""
    hiddens = []
    for (p_bt, p_tokens, p_start), lp in zip(prefill_ops, prefill_live_pages):
        _, hidden = prefill_chunk(params, pages, p_bt, p_tokens, p_start,
                                  config=config, page_size=page_size,
                                  live_pages=lp)
        hiddens.append(hidden)
    toks, pages = decode_loop(
        params, pages, block_tables, tokens, pos, temps, eos_ids, remaining,
        generator, config=config, page_size=page_size, n_steps=n_steps,
        paged=paged, live_pages=live_pages, lora=lora, lora_idx=lora_idx)
    return toks, pages, tuple(hiddens)


def verify_block(params, pages: dict, block_tables, tokens_mat, pos, temps,
                 eos_ids, remaining, generator: torch.Generator,
                 config: LlamaConfig, page_size: int, n_draft: int,
                 paged: bool = False, live_pages: int | None = None,
                 sample: bool = True):
    """Speculative verify: score all ``n_draft + 1`` positions of every
    slot's drafted continuation in one forward.

    tokens_mat [slots, S] int32, S = n_draft + 1: column 0 is each slot's
    current token (the one plain decode would feed at ``pos``), columns
    1..K its draft; -1 pads a short draft (rejected, never emitted). pos
    [slots]: the pool holds K/V for [0, pos), as before a decode step.

    The forward is a small batched prefill chunk. Its K/V goes only to a
    staging carry [L, slots, KH, stage_rows(S), D]; the paged route calls
    the decode kernel once per position j with staging rows [0, j] (the
    decode loop's step-j schedule), the dense route masks the pool gather
    strictly below ``pos`` and adds the causal self block. Acceptance:

      * temp <= 0: position j emits ``argmax(p_j)`` and draft j+1 is
        accepted iff it equals it, so every emitted token is the one plain
        greedy decode would emit;
      * temp > 0: rejection sampling. Draft d is accepted with probability
        ``p_j(d)``; a rejection emits a sample of the residual
        ``p_j * (1 - onehot(d))``, and the position after the last draft
        samples ``p_j`` itself, so the emitted distribution is the
        target's. Draws come from ``generator``; ``sample=False`` says no
        slot has temp > 0 (the caller knows from its host copy) and skips
        them.

    ``live[j, s]``: step j of slot s is emitted. live_0 = remaining > 0;
    live_{j+1} = live_j and accepted and not EOS and within ``remaining``.
    ``commit_staging`` writes live rows to their real (page, offset) and
    every other row to the slot's trash page, so a rejected branch never
    touches the pool and shared prefix pages stay as they were. A slot that
    accepts nothing still emits position 0's token.

    Returns ``(tokens [S, slots] int32, live [S, slots] bool, pages)``; the
    pool is updated in place.
    """
    c = config
    n, S = tokens_mat.shape
    if S != n_draft + 1:
        raise ValueError(f"tokens_mat has {S} columns, not n_draft + 1 = "
                         f"{n_draft + 1}")
    dev = tokens_mat.device
    kh, g, d = c.n_kv_heads, c.n_heads // c.n_kv_heads, c.head_dim
    steps = torch.arange(S, dtype=torch.int32, device=dev)
    positions = pos[:, None] + steps[None, :]                # [n, S]
    x = params["embed"][tokens_mat.clamp(min=0).long()].to(c.dtype)
    stage_shape = (c.n_layers, n, kh, stage_rows(S), d)
    ks = torch.zeros(stage_shape, dtype=pages["k"].dtype, device=dev)
    vs = torch.zeros(stage_shape, dtype=pages["v"].dtype, device=dev)
    kf, vf = pages["k"], pages["v"]
    if not paged:
        gather_tables = block_tables
        if live_pages is not None and live_pages < block_tables.shape[1]:
            gather_tables = block_tables[:, :live_pages]
        max_ctx = gather_tables.shape[1] * page_size
        ctx_live = (torch.arange(max_ctx, device=dev)[None, :]
                    < pos.long()[:, None])                   # [n, ctx]
        causal = steps[:, None] >= steps[None, :]            # [S, S]
        scale = d ** -0.5
    for l in range(c.n_layers):
        layer = _layer(params, l)
        h = rms_norm(x, layer["attn_norm"], eps=c.norm_eps)
        q, k, v = _project_qkv(h, layer)                     # [n, H|KH, S, D]
        q = apply_rope(q, positions, theta=c.rope_theta)
        k = apply_rope(k, positions, theta=c.rope_theta)
        # All S rows are staged; the commit, not the stage, gates the pool.
        ks[l, :, :, :S] = k.to(ks.dtype)
        vs[l, :, :, :S] = v.to(vs.dtype)
        if paged:
            # [S, n, KH, G, D]: each position's queries contiguous for the
            # kernel, which reads the pool [0, pos) and staged rows [0, j].
            qs = q.reshape(n, kh, g, S, d).permute(3, 0, 1, 2, 4).contiguous()
            attn = torch.stack([paged_decode_attention(
                qs[j], kf, vf, block_tables, pos + j, page_size=page_size,
                live_pages=live_pages, layer=l, k_stage=ks, v_stage=vs,
                stage_idx=j) for j in range(S)], dim=3)     # [n, KH, G, S, D]
        else:
            qg = q.reshape(n, kh, g, S, d)
            ck = _gather_ctx(kf, l, gather_tables)           # [n, KH, ctx, D]
            cv = _gather_ctx(vf, l, gather_tables)
            s_ctx = torch.einsum("nkgsd,nktd->nkgst", qg, ck).float()
            s_self = torch.einsum("nkgsd,nktd->nkgst", qg, k).float()
            s_ctx = (s_ctx * scale).masked_fill(
                ~ctx_live[:, None, None, None], float("-inf"))
            s_self = (s_self * scale).masked_fill(~causal, float("-inf"))
            probs = torch.softmax(torch.cat([s_ctx, s_self], dim=-1), dim=-1)
            p_ctx = probs[..., :max_ctx].to(c.dtype)
            p_self = probs[..., max_ctx:].to(c.dtype)
            attn = (torch.einsum("nkgst,nktd->nkgsd", p_ctx, cv)
                    + torch.einsum("nkgst,nktd->nkgsd", p_self, v))
        flat = attn.reshape(n, c.n_heads, S, d).transpose(1, 2).reshape(
            n, S, -1)
        out = torch.einsum("nsf,fe->nse", flat,
                           layer["wo"].reshape(c.n_heads * d, c.hidden))
        x = _mlp(x + out, layer, c)
    hidden = rms_norm(x, params["final_norm"], eps=c.norm_eps)   # [n, S, E]
    logits = torch.einsum("nse,ev->nsv", hidden, params["lm_head"]).float()

    # ----- acceptance and emission, on the device -----
    # The draft considered at step j is tokens_mat[:, j + 1]; the last step
    # has none, and its emission is the bonus token.
    d_ext = torch.cat([tokens_mat[:, 1:], torch.full(
        (n, 1), -1, dtype=tokens_mat.dtype, device=dev)], dim=1)
    valid = d_ext >= 0
    d_clip = d_ext.clamp(min=0).long()
    greedy = logits.argmax(dim=-1)                           # [n, S]
    o = greedy
    accept = valid & (greedy == d_clip)
    if sample:
        p = torch.softmax(logits / temps.clamp(min=1e-6)[:, None, None],
                          dim=-1)
        p_draft = p.gather(-1, d_clip[..., None])[..., 0]
        u = torch.rand(p_draft.shape, generator=generator, device=dev)
        accept_sampled = valid & (u < p_draft)
        # The residual for a one-hot proposal: p with the draft zeroed.
        padj = p.scatter(-1, d_clip[..., None], torch.where(
            valid, torch.zeros_like(p_draft), p_draft)[..., None])
        resample = torch.multinomial(
            (padj + 1e-30).reshape(n * S, -1), 1,
            generator=generator).reshape(n, S)
        sampled_on = (temps > 0.0)[:, None]
        o = torch.where(sampled_on,
                        torch.where(accept_sampled, d_clip, resample), greedy)
        accept = torch.where(sampled_on, accept_sampled, accept)
    o = o.to(torch.int32)
    cont = (accept & (o != eos_ids[:, None])
            & (remaining[:, None] > steps[None, :] + 1))
    live = torch.cat([torch.ones(n, 1, dtype=torch.bool, device=dev),
                      cont[:, :-1].int().cumprod(dim=1).bool()], dim=1)
    live &= (remaining > 0)[:, None]                         # [n, S]

    # The commit: live rows to their real (page, offset), the rest to the
    # slot's trash page (slot i's is page i).
    page_of = block_tables.long().gather(1, torch.clamp(
        positions.long() // page_size, max=block_tables.shape[1] - 1))
    trash = torch.arange(n, device=dev)
    widx = torch.where(live, page_of, trash[:, None])        # [n, S]
    commit_staging(pages, (ks, vs), widx.t(), pos, S, page_size)
    return o.t(), live.t(), pages
