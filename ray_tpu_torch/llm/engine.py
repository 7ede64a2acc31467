"""Continuous-batching inference engine over a paged KV cache.

The port of ``ray_tpu/llm/engine.py``: the host-side scheduler. Requests
arrive at any time, chunked prefill rides along with batched decode under
a token budget (mixed dispatch), finished sequences free their pages at
once, and hash-matched prompt prefixes reuse computed pages — full token
blocks and partial tail blocks, shared read-only with a copy-on-write fork
at the first conflicting write.

Decode always runs the full ``[max_slots]`` batch; inactive slots write to
private trash pages (pages ``0 .. max_slots-1``). With a
``speculation_config`` each decode tick drafts K tokens per slot on the
host and one verify call scores them all (``model.verify_block``).

Not ported yet (later slices): LoRA and tenancy, KV migration and
disaggregated prefill, the host-RAM KV tier, weight residency, request
deadlines, and the flight recorder and tracing spans (among them the
speculation round's event and the ``llm.speculate`` span).
"""

from __future__ import annotations

import hashlib
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ..models.llama import PRESETS, LlamaConfig
from .executor import LocalEngineExecutor
from .speculative import SpeculationConfig

# Extra free-page headroom admission keeps on top of each request's
# worst-case reservation (the JAX package's serve default).
ADMISSION_WATERMARK_PAGES = 0


@dataclass
class Request:
    request_id: str
    prompt: list[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_id: int | None = None
    stop_ids: list[int] = field(default_factory=list)
    # runtime state
    generated: list[int] = field(default_factory=list)
    slot: int = -1
    pos: int = 0                 # next position to write
    prefill_pos: int = 0         # prompt tokens already prefilled
    block_table: list[int] = field(default_factory=list)
    done: bool = False
    finish_reason: str = ""
    arrived_at: float = field(default_factory=time.monotonic)
    first_token_at: float | None = None
    cached_prefix_tokens: int = 0
    # Prefix sharing: the first `shared_pages` block-table entries are
    # refcounted read-only cache pages; `cow_page` is the page reserved at
    # admission to receive the fork of a shared partial tail block.
    shared_pages: int = 0
    partial_len: int = 0
    cow_page: int | None = None
    # Speculation: drafted tokens verified for this request, drafts
    # accepted, and verify rounds that rolled a draft back.
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_rollbacks: int = 0


class QueueFullError(RuntimeError):
    """The bounded admission queue (``max_queued_requests``) refused the
    request; ``retry_after`` (seconds) is the backlog over the slots."""

    def __init__(self, message: str, retry_after: int = 1):
        super().__init__(message)
        self.retry_after = max(1, int(retry_after))


class PageAllocator:
    """Page pool bookkeeping: free list, per-page refcounts, and a prefix
    trie keyed on token-block chain hashes.

    Full-block nodes (``prefix_map``: chain hash -> page id, with
    parent/children edges) are matched block by block; partial tail blocks
    (``_partials``: the raw token tuple of a sequence's last, partly filled
    page, under its parent node) are matched by longest common prefix, and
    the reader COW-forks the page before its first write. Eviction is LRU
    over refcount-0 cached pages, leaf entries first; evicting an interior
    node returns its unreachable cached descendants to the free list.
    """

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self.free: list[int] = list(range(num_pages))
        self.refcount: dict[int, int] = {}
        self.prefix_map: dict[bytes, int] = {}
        self.page_hash: dict[int, bytes] = {}
        self.last_used: dict[int, float] = {}
        self._children: dict[bytes, set[bytes]] = {}
        self._parent: dict[bytes, bytes] = {}
        self._partials: dict[bytes, dict[tuple, int]] = {}
        self._partial_pages: dict[int, tuple[bytes, tuple]] = {}

    def available(self) -> int:
        return len(self.free) + sum(
            1 for p in self.page_hash if self.refcount.get(p, 0) == 0
        ) + sum(
            1 for p in self._partial_pages if self.refcount.get(p, 0) == 0
        )

    def alloc(self, n: int) -> list[int] | None:
        if self.available() < n:
            return None
        out = []
        for _ in range(n):
            pid = self.free.pop() if self.free else self._evict_one()
            self.refcount[pid] = 1
            out.append(pid)
        return out

    def _unlink(self, page_id: int) -> None:
        """Drop every cache entry for ``page_id``; the page is not freed."""
        h = self.page_hash.pop(page_id, None)
        if h is not None:
            self.prefix_map.pop(h, None)
            parent = self._parent.pop(h, None)
            if parent is not None and parent in self._children:
                self._children[parent].discard(h)
                if not self._children[parent]:
                    del self._children[parent]
        entry = self._partial_pages.pop(page_id, None)
        if entry is not None:
            parent, key = entry
            sub = self._partials.get(parent)
            if sub is not None:
                sub.pop(key, None)
                if not sub:
                    del self._partials[parent]

    def _evict_one(self) -> int:
        """LRU victim among refcount-0 cached pages, leaf entries first."""
        best = None
        for h, p in self.prefix_map.items():
            if self.refcount.get(p, 0):
                continue
            leaf = 0 if (h not in self._children
                         and h not in self._partials) else 1
            key = (leaf, self.last_used.get(p, 0.0))
            if best is None or key < best[0]:
                best = (key, p, h)
        for p in self._partial_pages:
            if self.refcount.get(p, 0):
                continue
            key = (0, self.last_used.get(p, 0.0))
            if best is None or key < best[0]:
                best = (key, p, None)
        _, victim, victim_hash = best
        descendants = []
        if victim_hash is not None and victim_hash in self._children:
            stack = [victim_hash]
            while stack:
                h = stack.pop()
                stack.extend(self._children.pop(h, ()))
                for p in self._partials.pop(h, {}).values():
                    descendants.append(p)
                    self._partial_pages.pop(p, None)
                if h != victim_hash:
                    p = self.prefix_map.pop(h, None)
                    self._parent.pop(h, None)
                    if p is not None:
                        self.page_hash.pop(p, None)
                        descendants.append(p)
        self._unlink(victim)
        for p in descendants:
            # Unreachable now: refcount-0 ones go straight back to the
            # pool, pinned ones free on their final release.
            if not self.refcount.get(p, 0) and p != victim \
                    and p not in self.free:
                self.free.append(p)
        return victim

    def share(self, page_id: int) -> None:
        self.refcount[page_id] = self.refcount.get(page_id, 0) + 1
        self.last_used[page_id] = time.monotonic()

    def release(self, page_id: int) -> None:
        count = self.refcount.get(page_id, 1) - 1
        self.refcount[page_id] = count
        if count <= 0:
            self.refcount.pop(page_id, None)
            if page_id in self.page_hash or page_id in self._partial_pages:
                self.last_used[page_id] = time.monotonic()  # cached, evictable
            else:
                self.free.append(page_id)

    def register_prefix(self, page_id: int, chain_hash: bytes,
                        parent_hash: bytes = b"") -> None:
        if chain_hash in self.prefix_map or page_id in self.page_hash \
                or page_id in self._partial_pages:
            return
        self.prefix_map[chain_hash] = page_id
        self.page_hash[page_id] = chain_hash
        self.last_used[page_id] = time.monotonic()
        self._parent[chain_hash] = parent_hash
        self._children.setdefault(parent_hash, set()).add(chain_hash)

    def register_partial(self, parent_hash: bytes, tokens: tuple,
                         page_id: int) -> None:
        """Cache a sequence's partly filled tail page under its parent."""
        if not tokens or page_id in self.page_hash \
                or page_id in self._partial_pages:
            return
        sub = self._partials.setdefault(parent_hash, {})
        if tokens in sub:
            return
        sub[tokens] = page_id
        self._partial_pages[page_id] = (parent_hash, tokens)
        self.last_used[page_id] = time.monotonic()

    def match_prefix(self, chain_hashes: list[bytes]) -> list[int]:
        """Longest cached chain: one page per matched full block."""
        hits: list[int] = []
        for h in chain_hashes:
            pid = self.prefix_map.get(h)
            if pid is None:
                break
            hits.append(pid)
        return hits

    def match_partial(self, parent_hash: bytes, tokens: tuple,
                      cap: int) -> tuple[int, int] | None:
        """Best partial tail block under ``parent_hash``: the longest
        common prefix with ``tokens``, capped at ``cap`` rows. Returns
        ``(page_id, matched_len)`` or None."""
        best = None
        for entry, pid in self._partials.get(parent_hash, {}).items():
            n = 0
            for a, b in zip(entry, tokens):
                if a != b:
                    break
                n += 1
            n = min(n, cap)
            if n > 0 and (best is None or n > best[1]):
                best = (pid, n)
        return best


class InferenceEngine:
    """Paged-KV engine: the host-side scheduler (slots, pages, prefix
    cache, admission) over a ``LocalEngineExecutor``. ``add_request`` and
    ``cancel`` are thread-safe; ``step`` runs on one thread at a time.

    ``device=None`` means the CUDA card and raises where there is none;
    pass ``device="cpu"`` to run on the CPU. ``speculation_config`` (None,
    a dict or a ``SpeculationConfig``) turns on speculative decoding.
    """

    def __init__(
        self,
        config: LlamaConfig | str = "debug",
        params=None,
        *,
        max_slots: int = 8,
        max_len: int = 512,
        page_size: int = 16,
        num_pages: int | None = None,
        prefill_chunk_size: int = 128,
        decode_steps_per_dispatch: int = 8,
        enable_prefix_cache: bool = True,
        executor=None,
        seed: int = 0,
        attention_impl: str = "auto",
        prefill_token_budget: int | None = None,
        max_prefill_seqs_per_step: int = 2,
        decode_starvation_limit: int = 8,
        max_queued_requests: int = 0,
        speculation_config=None,
        device=None,
    ):
        self.config = PRESETS[config] if isinstance(config, str) else config
        self.max_slots = max_slots
        self.page_size = page_size
        if max_len % page_size:
            raise ValueError("max_len must be a multiple of page_size")
        self.max_len = max_len
        self.max_pages_per_seq = max_len // page_size
        self.prefill_chunk_size = min(prefill_chunk_size, max_len)
        if self.prefill_chunk_size % page_size:
            raise ValueError("prefill_chunk_size must be a multiple of "
                             "page_size")
        self.enable_prefix_cache = enable_prefix_cache
        self.decode_steps_per_dispatch = max(1, decode_steps_per_dispatch)
        # Token-budget mixed dispatch: each step carries the full decode
        # batch plus up to `prefill_token_budget` prompt tokens (at most
        # `max_prefill_seqs_per_step` prompts). 0 = strict prefill-first,
        # where `decode_starvation_limit` forces a decode burst after that
        # many prefill-only steps with live decoders.
        if prefill_token_budget is None:
            prefill_token_budget = self.prefill_chunk_size
        self.prefill_token_budget = (
            max(page_size, prefill_token_budget) if prefill_token_budget else 0)
        self.max_prefill_seqs_per_step = max(1, max_prefill_seqs_per_step)
        self.decode_starvation_limit = max(0, decode_starvation_limit)
        self._starved_steps = 0
        self.num_pages = self.total_pages(max_slots, max_len, page_size,
                                          num_pages)
        if executor is None:
            executor = LocalEngineExecutor(
                self.config, params, max_slots=max_slots,
                num_pages=self.num_pages, page_size=page_size, seed=seed,
                attention_impl=attention_impl, device=device)
        self.executor = executor
        self.attention_impl = getattr(executor, "attention_impl", "dense")
        # Speculative decoding: a host-side drafter proposes K tokens per
        # active slot each decode tick and one verify call scores all K+1
        # positions. None: plain decode, exactly the path without it.
        self.speculation = SpeculationConfig.normalize(speculation_config)
        self._drafter = (self.speculation.build_drafter()
                         if self.speculation is not None else None)
        self.allocator = PageAllocator(self.num_pages)
        # Trash pages 0..max_slots-1 are permanently owned by their slot.
        for s in range(max_slots):
            self.allocator.free.remove(s)
        self._free_slots = list(range(max_slots))
        self.max_queued_requests = max(0, max_queued_requests)
        self._active: dict[int, Request] = {}       # decoding
        self._prefilling: deque[Request] = deque()  # admitted, chunks pending
        # Prefilled requests awaiting their batched first-token sample.
        self._pending_first: list[tuple[Request, Any]] = []
        self._waiting: deque[Request] = deque()
        self._lock = threading.Lock()
        self._counter = itertools.count()
        self._handle_counter = itertools.count(1)
        # Host mirrors of the decode inputs. Block tables default to the
        # slot's trash page so inactive slots never touch live pages.
        self._tokens = np.zeros(max_slots, np.int32)
        self._pos = np.zeros(max_slots, np.int32)
        self._block_tables = np.tile(
            np.arange(max_slots, dtype=np.int32)[:, None],
            (1, self.max_pages_per_seq))
        self._cow_enabled = (enable_prefix_cache and
                             getattr(executor, "supports_prefix_cow", False))
        self.metrics = {"prefix_hit_pages": 0, "prefix_lookup_pages": 0,
                        "prefix_cached_tokens": 0, "prompt_tokens": 0,
                        "cow_forks": 0, "prefill_chunks": 0,
                        "decode_steps": 0, "decode_dispatches": 0,
                        # How many steps ran fused prefill+decode, either
                        # alone, or only flushed first-token samples.
                        "engine_step_mix": {"mixed": 0, "prefill": 0,
                                            "decode": 0, "flush": 0},
                        # Steps where live decode streams waited behind a
                        # prefill-only dispatch.
                        "decode_stall_steps": 0,
                        "queue_rejects": 0, "admission_rejects": 0,
                        # Speculation: drafted tokens verified, drafts
                        # accepted, tokens emitted by verify calls, verify
                        # calls, (call, active slot) pairs (the denominator
                        # of spec_tokens_per_dispatch), and slot-rounds that
                        # rolled back at least one drafted token (its
                        # staged K/V went to the trash page).
                        "spec_drafted_tokens": 0,
                        "spec_accepted_tokens": 0,
                        "spec_emitted_tokens": 0,
                        "spec_dispatches": 0,
                        "spec_slot_rounds": 0,
                        "spec_rollbacks": 0}

    @staticmethod
    def total_pages(max_slots: int, max_len: int, page_size: int,
                    num_pages: int | None = None) -> int:
        """Pool size: per-slot trash pages + usable pages (default: enough
        for every slot to hold a full-length sequence)."""
        usable = (num_pages if num_pages is not None
                  else max_slots * (max_len // page_size))
        return max_slots + usable

    # ------------------------------------------------------------- admission
    def add_request(self, request: Request) -> None:
        if len(request.prompt) >= self.max_len:
            raise ValueError(f"prompt of {len(request.prompt)} tokens >= "
                             f"max_len {self.max_len}")
        if not request.prompt:
            raise ValueError("empty prompt")
        with self._lock:
            if self.max_queued_requests and \
                    len(self._waiting) >= self.max_queued_requests:
                self.metrics["queue_rejects"] += 1
                backlog = (len(self._waiting) + len(self._prefilling)
                           + len(self._active) + 1)
                raise QueueFullError(
                    f"engine admission queue is full ({len(self._waiting)} "
                    f"waiting, bound {self.max_queued_requests})",
                    retry_after=max(1, min(60, -(-backlog // self.max_slots))))
            self._waiting.append(request)

    def cancel(self, request_id: str) -> None:
        with self._lock:
            keep: deque[Request] = deque()
            for r in self._waiting:
                if r.request_id == request_id:
                    r.done, r.finish_reason = True, "cancelled"
                else:
                    keep.append(r)
            self._waiting = keep
            keep = deque()
            for r in self._prefilling:
                if r.request_id == request_id:
                    r.done, r.finish_reason = True, "cancelled"
                    self._retire_locked(r)
                else:
                    keep.append(r)
            self._prefilling = keep
            for r in list(self._active.values()):
                if r.request_id == request_id:
                    r.done, r.finish_reason = True, "cancelled"
                    self._retire_locked(r)
            for r, _h in self._pending_first:
                if r.request_id == request_id and not r.done:
                    r.done, r.finish_reason = True, "cancelled"
                    self._retire_locked(r)  # the flush skips done entries

    @property
    def has_work(self) -> bool:
        with self._lock:
            return bool(self._waiting or self._prefilling or self._active
                        or self._pending_first)

    def _retire_locked(self, r: Request) -> None:
        """Free the request's slot and pages (idempotent). Pages whose K/V
        was computed enter the prefix cache instead of the free list."""
        if r.slot >= 0 and r.slot in self._active:
            self._active.pop(r.slot, None)
            self._free_slots.append(r.slot)
            self._block_tables[r.slot, :] = r.slot  # back to trash page
            # A stale pos would inflate every later batch's live_pages.
            self._pos[r.slot] = 0
        elif r.slot >= 0 and r.slot not in self._free_slots:
            self._free_slots.append(r.slot)
            self._block_tables[r.slot, :] = r.slot
            self._pos[r.slot] = 0
        if r.block_table:
            if self.enable_prefix_cache:
                # The chain covers prompt + generated tokens whose K/V was
                # written (the last generated token was emitted, never fed
                # back); a cancel mid-prefill caches only what was prefilled.
                ps = self.page_size
                seq = list(r.prompt) + list(r.generated)
                if r.prefill_pos < len(r.prompt):
                    valid = r.prefill_pos
                else:
                    valid = len(r.prompt) + max(0, len(r.generated) - 1)
                valid = min(valid, len(r.block_table) * ps)
                full_pages = valid // ps
                h = hashlib.sha1()
                parent = h.digest()
                for i in range(full_pages):
                    h.update(np.asarray(seq[i * ps:(i + 1) * ps],
                                        np.int32).tobytes())
                    self.allocator.register_prefix(
                        r.block_table[i], h.digest(), parent)
                    parent = h.digest()
                if self._cow_enabled and full_pages < len(r.block_table):
                    tail = tuple(int(t) for t in seq[full_pages * ps:valid])
                    if tail:
                        self.allocator.register_partial(
                            parent, tail, r.block_table[full_pages])
            for pid in r.block_table:
                self.allocator.release(pid)
            r.block_table = []
        if r.cow_page is not None:
            # Reserved fork page never used: back to the pool.
            self.allocator.release(r.cow_page)
            r.cow_page = None
        r.slot = -1

    # ------------------------------------------------------------------ step
    @property
    def speculation_enabled(self) -> bool:
        """True when decode ticks run draft + verify: a speculation config
        is set and the executor has the verify entry point."""
        return (self.speculation is not None
                and getattr(self.executor, "supports_speculation", False))

    @property
    def spec_accept_rate(self) -> float:
        """Fraction of drafted tokens the target model accepted (0 before
        any draft)."""
        drafted = self.metrics["spec_drafted_tokens"]
        return (self.metrics["spec_accepted_tokens"] / drafted
                if drafted else 0.0)

    @property
    def spec_tokens_per_dispatch(self) -> float:
        """Tokens emitted per slot per verify call: 1.0 is what one plain
        decode step yields per sequence, and an accept-0 round still emits
        one, so it never falls below 1.0."""
        n = self.metrics["spec_slot_rounds"]
        return self.metrics["spec_emitted_tokens"] / n if n else 0.0

    @property
    def mixed_dispatch_enabled(self) -> bool:
        return (self.prefill_token_budget > 0
                and getattr(self.executor, "supports_mixed_dispatch", False))

    def step(self) -> list[dict]:
        """Advance one tick: admit waiting requests while slots and pages
        allow, then dispatch. With mixed dispatch, a step with live
        decoders and pending prefill runs one fused call; otherwise one
        prefill chunk runs ahead of decode. Returns emission events
        ``{"request_id", "token", "done", "finish_reason"}``."""
        self._admit()
        mix = self.metrics["engine_step_mix"]
        with self._lock:
            r = self._prefilling[0] if self._prefilling else None
            has_active = bool(self._active)
        if r is not None and has_active and self.mixed_dispatch_enabled:
            events = self._mixed_step()
            if events is not None:
                mix["mixed"] += 1
                self._starved_steps = 0
                if self._pending_first:
                    events = events + self._flush_first_samples()
                return events
        if r is not None:
            if (has_active and self.decode_starvation_limit
                    and self._starved_steps >= self.decode_starvation_limit):
                self._starved_steps = 0
                mix["decode"] += 1
                return self._decode_all()
            if has_active:
                self._starved_steps += 1
                self.metrics["decode_stall_steps"] += 1
            events = self._prefill_chunk_one(r)
            mix["prefill"] += 1
            with self._lock:
                drained = not self._prefilling
            if drained and self._pending_first:
                events = events + self._flush_first_samples()
            return events
        self._starved_steps = 0
        if self._pending_first:
            mix["flush"] += 1
            return self._flush_first_samples()
        if self._active:
            mix["decode"] += 1
            return self._decode_all()
        return []

    def _admit(self) -> None:
        with self._lock:
            while self._waiting and self._free_slots:
                r = self._waiting[0]
                # Worst-case pages, so a running request never runs out of
                # pages mid-decode.
                n_pages = min(
                    -(-(len(r.prompt) + r.max_new_tokens) // self.page_size),
                    self.max_pages_per_seq)
                hits: list[int] = []
                partial: tuple[int, int] | None = None
                if self.enable_prefix_cache:
                    # Hit pages arrive pinned, before any alloc can evict.
                    hits, partial = self._prefix_hits(r)
                # A partial hit keeps the reservation: fresh[0] becomes the
                # reserved COW fork target.
                if self.allocator.available() < \
                        n_pages - len(hits) + ADMISSION_WATERMARK_PAGES:
                    self._unpin_hits_locked(hits, partial)
                    self.metrics["admission_rejects"] += 1
                    break  # head-of-line: wait for pages to free
                self._waiting.popleft()
                fresh = self.allocator.alloc(n_pages - len(hits))
                if fresh is None:
                    self._unpin_hits_locked(hits, partial)
                    r.done, r.finish_reason = True, "admission_failed"
                    continue
                if partial is not None:
                    r.cow_page = fresh[0]
                    r.partial_len = partial[1]
                    r.block_table = hits + [partial[0]] + fresh[1:]
                else:
                    r.block_table = hits + fresh
                r.shared_pages = len(hits) + (1 if partial is not None else 0)
                r.prefill_pos = len(hits) * self.page_size + (
                    partial[1] if partial is not None else 0)
                r.cached_prefix_tokens = r.prefill_pos
                self.metrics["prefix_hit_pages"] += len(hits)
                self.metrics["prefix_cached_tokens"] += r.prefill_pos
                self.metrics["prompt_tokens"] += len(r.prompt)
                r.slot = self._free_slots.pop()
                self._block_tables[r.slot, :len(r.block_table)] = r.block_table
                self._prefilling.append(r)

    def _prefix_hits(self, r: Request) -> tuple[list[int],
                                                tuple[int, int] | None]:
        """Longest cached chain covering the prompt (full blocks), plus the
        best partial tail block at its end — capped so at least one prompt
        token is computed (its hidden state seeds sampling)."""
        ps = self.page_size
        max_hit_pages = (len(r.prompt) - 1) // ps
        self.metrics["prefix_lookup_pages"] += max_hit_pages
        root, chain = self._chain_hashes(r.prompt)
        hashes = chain[:max_hit_pages]
        hits = self.allocator.match_prefix(hashes)
        for pid in hits:
            self.allocator.share(pid)
        partial = None
        if self._cow_enabled:
            parent = hashes[len(hits) - 1] if hits else root
            remainder = r.prompt[len(hits) * ps:]
            cap = min(len(remainder) - 1, ps - 1)
            if cap > 0:
                partial = self.allocator.match_partial(
                    parent, tuple(int(t) for t in remainder), cap)
                if partial is not None:
                    self.allocator.share(partial[0])
        return hits, partial

    def _unpin_hits_locked(self, hits: list[int],
                           partial: tuple[int, int] | None) -> None:
        for pid in hits:
            self.allocator.release(pid)
        if partial is not None:
            self.allocator.release(partial[0])

    def _chain_hashes(self, tokens) -> tuple[bytes, list[bytes]]:
        """Root hash plus the chain hash of every full token block."""
        ps = self.page_size
        h = hashlib.sha1()
        root = h.digest()
        hashes: list[bytes] = []
        for i in range(len(tokens) // ps):
            h.update(np.asarray(tokens[i * ps:(i + 1) * ps],
                                np.int32).tobytes())
            hashes.append(h.digest())
        return root, hashes

    def _chunk_bucket(self, n: int) -> int:
        b = self.page_size
        while b < n and b < self.prefill_chunk_size:
            b *= 2
        return min(b, self.prefill_chunk_size)

    def _maybe_cow(self, r: Request) -> None:
        """Write-triggered copy-on-write: when the next chunk's first page
        is still a shared partial tail block, copy it into the fork page
        reserved at admission and swap the table entry."""
        if r.cow_page is None:
            return
        with self._lock:
            if r.done or not r.block_table:
                return
            idx = r.prefill_pos // self.page_size
            if idx >= r.shared_pages:
                self.allocator.release(r.cow_page)
                r.cow_page = None
                return
            old, new = r.block_table[idx], r.cow_page
            self.executor.copy_pages([old], [new])
            r.block_table[idx] = new
            self._block_tables[r.slot, idx] = new
            self.allocator.release(old)
            r.shared_pages = idx
            r.cow_page = None
            self.metrics["cow_forks"] += 1

    def _prefill_chunk_one(self, r: Request) -> list[dict]:
        self._maybe_cow(r)
        remaining = len(r.prompt) - r.prefill_pos
        bt = np.full(self.max_pages_per_seq, r.slot, np.int32)  # trash-pad
        bt[:len(r.block_table)] = r.block_table
        # Bucket, clamped so the chunk's pages never run past the table.
        chunk = min(self._chunk_bucket(remaining),
                    self.max_len - r.prefill_pos)
        tokens = np.zeros(chunk, np.int32)
        take = min(remaining, chunk)
        tokens[:take] = r.prompt[r.prefill_pos:r.prefill_pos + take]
        final = r.prefill_pos + take >= len(r.prompt)
        handle = next(self._handle_counter) if final else None
        self.executor.prefill(bt, tokens, r.prefill_pos, handle, take)
        self.metrics["prefill_chunks"] += 1
        r.prefill_pos += take
        if not final:
            return []
        with self._lock:
            if r.done:  # cancelled mid-prefill
                self.executor.drop_handle(handle)
                if self._prefilling and self._prefilling[0] is r:
                    self._prefilling.popleft()
                return []
            self._prefilling.popleft()
        self._pending_first.append((r, handle))
        return []

    def _flush_first_samples(self) -> list[dict]:
        """One call and one sync sample the first token of every pending
        just-prefilled request."""
        pending, self._pending_first = self._pending_first, []
        live = [(r, h) for r, h in pending if not r.done]
        for r, h in pending:
            if r.done:
                self.executor.drop_handle(h)
        if not live:
            return []
        temps = np.asarray([r.temperature for r, _ in live], np.float32)
        tokens = self.executor.sample_first([h for _, h in live], temps)
        events = []
        now = time.monotonic()
        for i, (r, _) in enumerate(live):
            with self._lock:
                if r.done:  # cancelled while sampling
                    continue
                self._active[r.slot] = r
            r.pos = len(r.prompt)
            r.first_token_at = now
            events.append(self._emit(r, int(tokens[i])))
        return events

    def _decode_batch_args(self, active: dict):
        """Fill the host mirrors for one decode burst over ``active`` and
        return the per-slot (temps, eos_ids, remaining) arrays."""
        temps = np.ones(self.max_slots, np.float32)
        eos_ids = np.full(self.max_slots, -1, np.int32)
        remaining = np.zeros(self.max_slots, np.int32)
        for slot, r in active.items():
            self._tokens[slot] = r.generated[-1]
            self._pos[slot] = r.pos
            temps[slot] = r.temperature
            eos_ids[slot] = -1 if r.eos_id is None else r.eos_id
            remaining[slot] = min(r.max_new_tokens - len(r.generated),
                                  len(r.block_table) * self.page_size - r.pos)
        return temps, eos_ids, remaining

    def _emit_decode_events(self, active: dict, tokens, K: int) -> list[dict]:
        events = []
        for k in range(K):
            for slot, r in active.items():
                if r.done:
                    continue
                r.pos += 1
                events.append(self._emit(r, int(tokens[k, slot])))
        return events

    def _decode_all(self) -> list[dict]:
        if self.speculation_enabled:
            events = self._speculative_decode()
            if events is not None:
                return events
            # No slot drafted: the plain fused burst beats a verify that
            # could only emit one token a slot.
        with self._lock:
            active = dict(self._active)
        if not active:
            return []
        temps, eos_ids, remaining = self._decode_batch_args(active)
        K = self.decode_steps_per_dispatch
        tokens = self.executor.decode(
            self._block_tables, self._tokens, self._pos, temps, eos_ids,
            remaining, K)  # [K, slots]
        self.metrics["decode_steps"] += K
        self.metrics["decode_dispatches"] += 1
        return self._emit_decode_events(active, tokens, K)

    def _speculative_decode(self) -> list[dict] | None:
        """One speculation round: draft K tokens per active slot on the host
        (the drafter over the request's own tokens), then one verify call
        scores all K+1 positions of every slot and emits the accepted run
        plus one corrected or bonus token. A slot whose draft is wholly
        rejected still advances one token. None when no slot drafted
        anything (the caller runs the plain burst instead)."""
        with self._lock:
            active = dict(self._active)
        if not active:
            return []
        K = self.speculation.num_draft_tokens
        temps, eos_ids, remaining = self._decode_batch_args(active)
        tok_mat = np.full((self.max_slots, K + 1), -1, np.int32)
        tok_mat[:, 0] = self._tokens
        drafted: dict[int, int] = {}
        for slot, r in active.items():
            d = self._drafter.draft(list(r.prompt) + list(r.generated), K)[:K]
            if d:
                tok_mat[slot, 1:1 + len(d)] = d
                drafted[slot] = len(d)
        if not drafted:
            return None
        toks, live = self.executor.verify(
            self._block_tables, tok_mat, self._pos, temps, eos_ids,
            remaining)  # [K+1, slots] each
        self.metrics["spec_dispatches"] += 1
        self.metrics["decode_dispatches"] += 1
        return self._emit_speculative_events(active, toks, live, drafted)

    def _emit_speculative_events(self, active: dict, toks, live,
                                 drafted: dict) -> list[dict]:
        """Emit each slot's verified run in step order: a slot stops at its
        first non-live step, and host-side terminators (``_emit``) drop any
        surplus rows, as in the plain burst."""
        events: list[dict] = []
        for slot, r in active.items():
            emitted = 0
            for j in range(toks.shape[0]):
                if r.done or not live[j, slot]:
                    break
                r.pos += 1
                events.append(self._emit(r, int(toks[j, slot])))
                emitted += 1
            dr = drafted.get(slot, 0)
            accepted = min(max(0, emitted - 1), dr)
            r.spec_drafted += dr
            r.spec_accepted += accepted
            m = self.metrics
            m["spec_drafted_tokens"] += dr
            m["spec_accepted_tokens"] += accepted
            m["spec_emitted_tokens"] += emitted
            m["spec_slot_rounds"] += 1
            if dr and accepted < dr:
                r.spec_rollbacks += 1
                m["spec_rollbacks"] += 1
        return events

    def _select_prefill_plans(self) -> list[dict]:
        """Chunks riding the next mixed dispatch: one chunk per prompt in
        admission order until the token budget or the per-step prompt
        count is spent, at the standalone path's bucket sizes."""
        plans: list[dict] = []
        budget = self.prefill_token_budget
        with self._lock:
            queue = [r for r in self._prefilling if not r.done]
        for r in queue:
            if len(plans) >= self.max_prefill_seqs_per_step:
                break
            if budget < self.page_size:
                break
            self._maybe_cow(r)  # fork a shared tail before writing it
            remaining = len(r.prompt) - r.prefill_pos
            chunk = self._chunk_bucket(remaining)
            if chunk > budget:
                b = self.page_size
                while b * 2 <= budget:
                    b *= 2
                chunk = b
            chunk = min(chunk, self.max_len - r.prefill_pos)
            take = min(remaining, chunk)
            if take <= 0:
                continue
            bt = np.full(self.max_pages_per_seq, r.slot, np.int32)
            bt[:len(r.block_table)] = r.block_table
            tokens = np.zeros(chunk, np.int32)
            tokens[:take] = r.prompt[r.prefill_pos:r.prefill_pos + take]
            final = r.prefill_pos + take >= len(r.prompt)
            plans.append({
                "request": r, "block_table": bt, "tokens": tokens,
                "start_pos": r.prefill_pos,
                "handle": next(self._handle_counter) if final else None,
                "take": take, "final": final,
            })
            budget -= chunk
        return plans

    def _mixed_step(self) -> list[dict] | None:
        """One fused call: the decode burst plus the selected prefill
        chunks. None when no chunk was selected."""
        plans = self._select_prefill_plans()
        if not plans:
            return None
        with self._lock:
            active = dict(self._active)
        if not active:
            return None
        temps, eos_ids, remaining = self._decode_batch_args(active)
        K = self.decode_steps_per_dispatch
        wire = [{k: p[k] for k in ("block_table", "tokens", "start_pos",
                                   "handle", "take")} for p in plans]
        tokens = self.executor.mixed(
            wire, self._block_tables, self._tokens, self._pos, temps,
            eos_ids, remaining, K)  # [K, slots]
        self.metrics["decode_steps"] += K
        self.metrics["decode_dispatches"] += 1
        for p in plans:
            r = p["request"]
            self.metrics["prefill_chunks"] += 1
            r.prefill_pos = p["start_pos"] + p["take"]
            if not p["final"]:
                continue
            with self._lock:
                try:
                    self._prefilling.remove(r)
                except ValueError:
                    pass  # cancel() already rebuilt the queue without it
                if r.done:  # cancelled mid-dispatch
                    self.executor.drop_handle(p["handle"])
                    continue
            self._pending_first.append((r, p["handle"]))
        return self._emit_decode_events(active, tokens, K)

    def _emit(self, r: Request, token: int) -> dict:
        r.generated.append(token)
        if (r.eos_id is not None and token == r.eos_id) or token in r.stop_ids:
            r.done, r.finish_reason = True, "stop"
        elif len(r.generated) >= r.max_new_tokens:
            r.done, r.finish_reason = True, "length"
        elif r.pos >= min(self.max_len,
                          len(r.block_table) * self.page_size) - 1:
            r.done, r.finish_reason = True, "max_len"
        if r.done:
            with self._lock:
                self._retire_locked(r)  # idempotent if cancel() beat us
        return {"request_id": r.request_id, "token": token, "done": r.done,
                "finish_reason": r.finish_reason}

    def pool_stats(self) -> dict:
        """Page-pool snapshot: free, cached (trie) and pinned (refcount >
        0) pages, and the request counts by stage."""
        with self._lock:
            cached = len(self.allocator.page_hash) + \
                len(self.allocator._partial_pages)
            pinned = sum(1 for c in self.allocator.refcount.values() if c > 0)
            return {"num_pages": self.num_pages,
                    "free": len(self.allocator.free), "cached": cached,
                    "pinned": pinned, "active_slots": len(self._active),
                    "prefilling": len(self._prefilling),
                    "waiting": len(self._waiting)}

    def generate(self, prompt: list[int], max_new_tokens: int = 32,
                 temperature: float = 0.0,
                 eos_id: int | None = None) -> list[int]:
        """Blocking single-prompt helper."""
        r = Request(f"gen-{next(self._counter)}", list(prompt),
                    max_new_tokens, temperature, eos_id)
        self.add_request(r)
        while not r.done:
            self.step()
        return r.generated
