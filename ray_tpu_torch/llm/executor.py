"""Engine executor: the device half of the inference engine.

The port of ``ray_tpu/llm/executor.py`` for one device. The
``InferenceEngine`` (engine.py) is a host-side scheduler; every device
interaction goes through ``LocalEngineExecutor``:

  * ``prefill(block_table, tokens, start_pos, handle, take)`` — one prompt
    chunk; the last real position's hidden state is kept under ``handle``;
  * ``sample_first(handles, temps)`` — batched first-token sampling;
  * ``decode(...)`` — K fused decode+sample steps, one host sync;
  * ``mixed(...)`` — prefill chunks plus the decode burst in one call;
  * ``verify(...)`` — the speculative verify of every slot's draft, one
    host sync;
  * ``copy_pages(src, dst)`` — the prefix cache's copy-on-write fork.

Meshes, pipeline stages, LoRA stacks, KV migration and weight residency
are not ported yet; the ``supports_*`` flags say so.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..models.llama import PRESETS, LlamaConfig, init_params
from .model import (copy_pages, decode_loop, init_pages, mixed_dispatch,
                    prefill_chunk, sample_first_batch, verify_block)


def resolve_attention_impl(attention_impl: str = "auto",
                           device=None) -> str:
    """``"auto"`` picks the paged decode kernel (``"paged"``) on a CUDA
    device and the bucketed dense gather (``"dense"``) elsewhere; an
    explicit choice passes through, so ``"paged"`` on the CPU runs the
    kernel's plain version."""
    if attention_impl not in ("auto", "paged", "dense"):
        raise ValueError(f"unknown attention_impl {attention_impl!r}")
    if attention_impl != "auto":
        return attention_impl
    kind = torch.device("cuda" if device is None else device).type
    return "paged" if kind == "cuda" else "dense"


class LocalEngineExecutor:
    """Params, page pool, sampling generator and hidden-state stash on one
    device."""

    supports_speculation = True
    supports_kv_migration = False
    supports_weight_residency = False
    supports_prefix_cow = True
    supports_mixed_dispatch = True

    def __init__(
        self,
        config: LlamaConfig | str,
        params=None,
        *,
        max_slots: int,
        num_pages: int,
        page_size: int,
        seed: int = 0,
        attention_impl: str = "auto",
        device=None,
    ):
        self.device = resolve_device(device)
        self.config = PRESETS[config] if isinstance(config, str) else config
        if params is None:
            params = init_params(
                self.config, torch.Generator(self.device).manual_seed(seed))
        self.params = params
        self.max_slots = max_slots
        self.page_size = page_size
        self.attention_impl = resolve_attention_impl(attention_impl,
                                                     self.device)
        self.paged_attention = self.attention_impl == "paged"
        self.pages = init_pages(self.config, num_pages, page_size, self.device)
        self._generator = torch.Generator(self.device).manual_seed(
            seed ^ 0x5EED)
        # handle -> device hidden state [E] awaiting first-token sampling
        self._hidden: dict[int, torch.Tensor] = {}

    def _put(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x)).to(self.device)

    @staticmethod
    def _bucket_pages(needed: int, max_pages: int) -> int:
        """Round a live-page requirement up to a power of two (>= 8), as
        the JAX executor does, so both sides read the same widths."""
        b = 8
        while b < needed:
            b *= 2
        return min(b, max_pages)

    # ------------------------------------------------------------ operations
    def prefill(self, block_table: np.ndarray, tokens: np.ndarray,
                start_pos: int, handle: int | None, take: int) -> None:
        live = self._bucket_pages(-(-int(start_pos) // self.page_size),
                                  block_table.shape[0])
        _, hidden = prefill_chunk(
            self.params, self.pages, self._put(block_table.astype(np.int32)),
            self._put(tokens.astype(np.int32)), int(start_pos),
            config=self.config, page_size=self.page_size, live_pages=live)
        if handle is not None:  # final chunk: stash for first-token sampling
            self._hidden[handle] = hidden[take - 1]

    def drop_handle(self, handle: int) -> None:
        self._hidden.pop(handle, None)

    def sample_first(self, handles: list[int],
                     temps: np.ndarray) -> np.ndarray:
        """One call and one sync for every pending first token."""
        hiddens = torch.stack([self._hidden.pop(h) for h in handles])
        toks = sample_first_batch(
            hiddens, self.params["lm_head"],
            self._put(np.asarray(temps[:len(handles)], np.float32)),
            self._generator)
        return toks.cpu().numpy()

    def _decode_kwargs(self, pos: np.ndarray, n_steps: int,
                       block_tables: np.ndarray) -> dict:
        if self.paged_attention:
            # The kernel reads pool context [0, pos) only: tokens made
            # inside the dispatch ride the staging carry.
            needed = max(1, (int(pos.max()) + self.page_size - 1)
                         // self.page_size)
        else:
            # Dense attends in-pool up to max(pos) + n_steps - 1.
            needed = (int(pos.max()) + n_steps - 1) // self.page_size + 1
        return {"paged": self.paged_attention,
                "live_pages": self._bucket_pages(needed,
                                                 block_tables.shape[1])}

    def _decode_args(self, block_tables, tokens, pos, temps, eos_ids,
                     remaining) -> tuple:
        return (self._put(block_tables.astype(np.int32)),
                self._put(tokens.astype(np.int32)),
                self._put(pos.astype(np.int32)),
                self._put(temps.astype(np.float32)),
                self._put(eos_ids.astype(np.int32)),
                self._put(remaining.astype(np.int32)))

    def decode(self, block_tables: np.ndarray, tokens: np.ndarray,
               pos: np.ndarray, temps: np.ndarray, eos_ids: np.ndarray,
               remaining: np.ndarray, n_steps: int) -> np.ndarray:
        toks, _ = decode_loop(
            self.params, self.pages,
            *self._decode_args(block_tables, tokens, pos, temps, eos_ids,
                               remaining),
            self._generator, config=self.config, page_size=self.page_size,
            n_steps=n_steps, **self._decode_kwargs(pos, n_steps, block_tables))
        return toks.cpu().numpy()  # [n_steps, slots] — the one sync

    def verify(self, block_tables: np.ndarray, tokens_mat: np.ndarray,
               pos: np.ndarray, temps: np.ndarray, eos_ids: np.ndarray,
               remaining: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Score one drafted continuation per slot in one call.
        tokens_mat [slots, K+1]: column 0 the current token, columns 1..K
        the draft (-1 pads). Returns ``(tokens [K+1, slots], live [K+1,
        slots])`` (see ``model.verify_block``)."""
        # The verify reads pool context [0, pos) only (the drafted rows
        # ride the staging carry), so the page bound ignores the depth.
        needed = max(1, (int(pos.max()) + self.page_size - 1)
                     // self.page_size)
        toks, live, _ = verify_block(
            self.params, self.pages,
            *self._decode_args(block_tables, tokens_mat, pos, temps, eos_ids,
                               remaining),
            self._generator, config=self.config, page_size=self.page_size,
            n_draft=int(tokens_mat.shape[1]) - 1, paged=self.paged_attention,
            live_pages=self._bucket_pages(needed, block_tables.shape[1]),
            sample=bool((temps > 0).any()))
        # tokens and live cross to the host in one copy: the one sync
        out = torch.stack([toks, live.to(torch.int32)]).cpu().numpy()
        return out[0], out[1].astype(bool)

    def copy_pages(self, src, dst) -> None:
        copy_pages(self.pages, self._put(np.asarray(src, np.int64)),
                   self._put(np.asarray(dst, np.int64)))

    def mixed(self, prefill_plans: list, block_tables: np.ndarray,
              tokens: np.ndarray, pos: np.ndarray, temps: np.ndarray,
              eos_ids: np.ndarray, remaining: np.ndarray,
              n_steps: int) -> np.ndarray:
        """One call carrying the decode burst plus prompt chunks.
        prefill_plans: dicts ``{"block_table", "tokens", "start_pos",
        "handle", "take"}``; a plan with a handle is its prompt's final
        chunk and stashes position ``take - 1``'s hidden state."""
        ops, op_live = [], []
        for p in prefill_plans:
            bt = np.asarray(p["block_table"], np.int32)
            ops.append((self._put(bt),
                        self._put(np.asarray(p["tokens"], np.int32)),
                        int(p["start_pos"])))
            op_live.append(self._bucket_pages(
                -(-int(p["start_pos"]) // self.page_size), bt.shape[0]))
        toks, _, hiddens = mixed_dispatch(
            self.params, self.pages, tuple(ops),
            *self._decode_args(block_tables, tokens, pos, temps, eos_ids,
                               remaining),
            self._generator, config=self.config, page_size=self.page_size,
            n_steps=n_steps, prefill_live_pages=tuple(op_live),
            **self._decode_kwargs(pos, n_steps, block_tables))
        for p, hidden in zip(prefill_plans, hiddens):
            if p.get("handle") is not None:
                self._hidden[p["handle"]] = hidden[p["take"] - 1]
        return toks.cpu().numpy()
