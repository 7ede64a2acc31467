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

With a ``lora_config`` the engine serves many LoRA adapters at once: a
request's ``model`` names its adapter, admission pins it into a slot of
the device stack (``lora.LoRAManager``; a request whose adapter finds
every slot pinned waits at the head of the queue), and each decode
burst or mixed dispatch carries every slot's adapter index, so slots of
different adapters decode together. A prompt with an adapter prefills
on its own, one chunk a step; prefix pages are cached per adapter; and
speculation stays off, as in the JAX package.

Pages and weights move between tiers:

  * **KV migration** (disaggregated prefill): a ``prefill_only`` request
    computes its prompt's KV and retires without sampling
    (``finish_reason "prefilled"``); ``pin_for_export`` keeps its pages
    until the exporter releases them. ``export_prefix_kv`` /
    ``import_prefix_kv`` move a cached prefix in one payload, and
    ``migration.py`` streams one over the loop wire; imported pages are
    registered under the chain hashes the source used, so the prompt's
    next admission maps them as prefix hits.
  * **Host-RAM KV tier** (``host_kv_cache_pages``): cached full-block
    pages evicted under pressure spill to host RAM, keyed by chain hash,
    and a later prefix match restores them.
  * **Weight residency**: ``demote_weights_to_host`` moves the weights to
    host RAM while the engine stands by, and ``promote_weights_from_host``
    (or the next request) brings them back; ``install_weights`` adopts a
    tree received over the broadcast wire (``weights.py``).

Overload and observability:

  * **Deadlines**: ``Request.deadline`` (wall clock) is swept at the top
    of every ``step``. A request that expires while waiting never touches
    a slot or a page (``deadline_expired_queued``); one that expires while
    prefilling, awaiting its first sample or decoding is retired that
    tick, its slot, pages and pins returned (``deadline_expired_running``).
    Either way its stream ends with finish reason ``"deadline"``.
  * **Flight recorder**: every request carries a bounded ``timeline``
    (``observability/loop_recorder.py``) of its admission, prefix hit, COW
    fork, prefill chunks, first token, tokens, speculation rounds, expiry
    or shed, and retire; a breach dumps it once as an
    ``llm.request_timeline`` span (``dump_timeline``, ``breach_samples``).
  * **Spans**: a request's trace context, captured at ``add_request``,
    parents its ``llm.prefix_match``, ``llm.prefill``, ``llm.decode`` and
    ``llm.speculate`` spans, and a cold adapter's ``llm.adapter_load``.

Not ported yet (later slices): tenant quotas and the fair queue, and the
serve layer's ``llm.kv_migrate`` span and migration event.
"""

from __future__ import annotations

import functools
import hashlib
import itertools
import logging
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ..models.llama import PRESETS, LlamaConfig
from ..observability import loop_recorder, tracing
from . import weights as wlib
from .executor import LocalEngineExecutor
from .lora import LoRAManager
from .speculative import SpeculationConfig
from .tenancy import AdapterCapacityError

logger = logging.getLogger(__name__)


@dataclass
class Request:
    request_id: str
    prompt: list[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_id: int | None = None
    stop_ids: list[int] = field(default_factory=list)
    # LoRA adapter id (None or "" = the base model), resolved to a stack
    # slot (``lora_slot``) at admission
    model: str | None = None
    # runtime state
    generated: list[int] = field(default_factory=list)
    slot: int = -1
    pos: int = 0                 # next position to write
    prefill_pos: int = 0         # prompt tokens already prefilled
    block_table: list[int] = field(default_factory=list)
    done: bool = False
    finish_reason: str = ""
    lora_slot: int = 0
    # Arrival and first token on the monotonic clock (latencies) and on
    # the wall clock (span and timeline times).
    arrived_at: float = field(default_factory=time.monotonic)
    arrived_wall: float = field(default_factory=time.time)
    first_token_at: float | None = None
    first_token_wall: float | None = None
    cached_prefix_tokens: int = 0
    # Prefix sharing: the first `shared_pages` block-table entries are
    # refcounted read-only cache pages; `cow_page` is the page reserved at
    # admission to receive the fork of a shared partial tail block.
    shared_pages: int = 0
    partial_len: int = 0
    cow_page: int | None = None
    # Disaggregated prefill: a prefill-only request computes its prompt's
    # KV and retires without sampling (finish_reason "prefilled").
    # ``pin_for_export`` keeps the retired pages refcounted in
    # ``export_pinned`` until the exporter releases them
    # (``InferenceEngine.release_export_pins``).
    prefill_only: bool = False
    pin_for_export: bool = False
    export_pinned: list[int] = field(default_factory=list)
    # End-to-end deadline, absolute on the ``time.time()`` scale; None
    # never expires. Swept at each step's start (``_expire_deadlines``).
    deadline: float | None = None
    # Trace context ({"trace_id", "span_id"}) captured from the submitting
    # thread at ``add_request``: the engine's spans parent onto it.
    trace: dict | None = None
    # Speculation: drafted tokens verified for this request, drafts
    # accepted, and verify rounds that rolled a draft back.
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_rollbacks: int = 0
    # Flight recorder: the request's bounded event log, dumped once on a
    # breach (``InferenceEngine.dump_timeline``).
    timeline: loop_recorder.RequestTimeline | None = None

    def __post_init__(self):
        if self.timeline is None:
            self.timeline = loop_recorder.RequestTimeline()


class QueueFullError(RuntimeError):
    """The bounded admission queue (``max_queued_requests``) refused the
    request; ``retry_after`` (seconds) is the backlog over the slots. The
    class attributes are the HTTP answer a serving proxy gives (503 with
    Retry-After)."""

    http_status = "503 Service Unavailable"
    reason = "replica_queue_full"

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
        # Host-RAM tier hook: ``on_evict(page_id, chain_hash)`` for every
        # cached full-block page about to be reused (the victim and its
        # unreachable cached descendants), while it still holds its K/V.
        self.on_evict = None

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
        if self.on_evict is not None and victim_hash is not None:
            self.on_evict(victim, victim_hash)  # before unlink and reuse
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
                        if self.on_evict is not None:
                            self.on_evict(p, h)
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

    def lookup_prefix(self, chain_hash: bytes) -> int | None:
        return self.prefix_map.get(chain_hash)

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
    a dict or a ``SpeculationConfig``) turns on speculative decoding;
    ``lora_config`` (a ``LoRAServingConfig``) multi-LoRA serving;
    ``host_kv_cache_pages`` > 0 the host-RAM KV tier of that many pages.
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
        lora_config=None,
        host_kv_cache_pages: int = 0,
        device=None,
        admission_watermark_pages: int | None = None,
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
                attention_impl=attention_impl, lora_config=lora_config,
                device=device)
        self.executor = executor
        self.attention_impl = getattr(executor, "attention_impl", "dense")
        # Speculative decoding: a host-side drafter proposes K tokens per
        # active slot each decode tick and one verify call scores all K+1
        # positions. None: plain decode, exactly the path without it.
        self.speculation = SpeculationConfig.normalize(speculation_config)
        self._drafter = (self.speculation.build_drafter()
                         if self.speculation is not None else None)
        self.lora_manager = None
        if lora_config is not None:
            self.lora_manager = LoRAManager(self.config, lora_config,
                                            executor.install_adapter)
        # Host mirror of each slot's adapter index (0 = base), sent with
        # every decode burst.
        self._lora_idx = np.zeros(max_slots, np.int32)
        self.allocator = PageAllocator(self.num_pages)
        # Trash pages 0..max_slots-1 are permanently owned by their slot.
        for s in range(max_slots):
            self.allocator.free.remove(s)
        self._free_slots = list(range(max_slots))
        self.max_queued_requests = max(0, max_queued_requests)
        # Extra free-page headroom admission keeps on top of each request's
        # worst-case reservation (room for in-flight KV imports); the
        # runtime config's serve default when not given.
        if admission_watermark_pages is None:
            from ..core.config import get_config

            admission_watermark_pages = \
                get_config().serve_admission_watermark_pages
        self.admission_watermark_pages = max(0, admission_watermark_pages)
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
        # Host-RAM KV tier: refcount-0 trie pages about to be evicted
        # spill to a bounded LRU host cache keyed by chain hash, and a
        # later prefix match restores them instead of recomputing.
        self.host_kv_cache_pages = max(0, host_kv_cache_pages)
        self._host_kv: OrderedDict[bytes, dict] = OrderedDict()
        # Weight residency: the host copy of the weights (kept after a
        # promotion), and the lock that orders demotion, promotion and a
        # request's re-promotion.
        self._host_params = None
        self._residency_lock = threading.Lock()
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
                        # Deadline expiries by where the request was:
                        # queued (never touched a slot or a page) or
                        # running (retired the tick it expired).
                        "deadline_expired_queued": 0,
                        "deadline_expired_running": 0,
                        "queue_rejects": 0, "admission_rejects": 0,
                        # Admissions deferred because every resident
                        # adapter was pinned by an in-flight request.
                        "adapter_defers": 0,
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
                        "spec_rollbacks": 0,
                        # KV migration: pages shipped out of and into this
                        # pool, migrations each way, import bytes, and
                        # reservation failures that fell back to a cold
                        # prefill.
                        "kv_pages_exported": 0, "kv_pages_imported": 0,
                        "kv_migrations_out": 0, "kv_migrations_in": 0,
                        "kv_import_failures": 0, "kv_import_bytes": 0,
                        # Host-RAM KV tier: evicted trie pages spilled to
                        # host RAM, and pages restored from it.
                        "host_kv_spilled_pages": 0,
                        "host_kv_restored_pages": 0,
                        # Weight residency: demotions to host RAM,
                        # promotions back, and the last promotion's time.
                        "weights_demoted": 0, "weights_promoted": 0,
                        "weight_promote_ms": 0.0,
                        # Flight recorder: timelines dumped as
                        # llm.request_timeline spans on a breach, at most
                        # one a request.
                        "timeline_dumps": 0}
        # The last few breach dumps (the full events are in the span).
        self._breach_samples: deque[dict] = deque(maxlen=8)
        if self.host_kv_cache_pages and enable_prefix_cache and \
                getattr(executor, "supports_kv_migration", False):
            # The hook holds what the spill needs, not the engine: a bound
            # method on the engine's own allocator would be a reference
            # cycle that keeps a dropped engine's pool on the card until
            # the cycle collector runs.
            self.allocator.on_evict = functools.partial(
                self._spill_page_to_host, executor, self._host_kv,
                self.host_kv_cache_pages, self.metrics)

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
        if request.trace is None:
            request.trace = tracing.current_wire()
        # The first request onto a demoted engine promotes the weights
        # before it queues: its TTFT carries the copy.
        self._ensure_weights_resident()
        with self._lock:
            if self.max_queued_requests and \
                    len(self._waiting) >= self.max_queued_requests:
                self.metrics["queue_rejects"] += 1
                err = QueueFullError(
                    f"engine admission queue is full ({len(self._waiting)} "
                    f"waiting, bound {self.max_queued_requests})",
                    retry_after=self._queue_retry_after_locked())
                request.timeline.add(loop_recorder.EV_SHED, 0)
                self.dump_timeline(request, "shed_queue_full")
                raise err
            request.timeline.add(loop_recorder.EV_ADMIT, len(request.prompt),
                                 now=request.arrived_wall)
            self._waiting.append(request)

    def _queue_retry_after_locked(self) -> int:
        """Retry-After of a shed: the backlog over the slots, in whole
        seconds between 1 and 60."""
        backlog = (len(self._waiting) + len(self._prefilling)
                   + len(self._active) + 1)
        return max(1, min(60, -(-backlog // self.max_slots)))

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
        if r.slot != -1 or r.block_table:  # the first retire only
            r.timeline.add(loop_recorder.EV_RETIRE, len(r.generated))
        if r.slot >= 0 and r.slot in self._active:
            self._active.pop(r.slot, None)
            self._free_slots.append(r.slot)
            self._block_tables[r.slot, :] = r.slot  # back to trash page
            # A stale pos would inflate every later batch's live_pages.
            self._pos[r.slot] = 0
            self._lora_idx[r.slot] = 0
        elif r.slot >= 0 and r.slot not in self._free_slots:
            self._free_slots.append(r.slot)
            self._block_tables[r.slot, :] = r.slot
            self._pos[r.slot] = 0
            self._lora_idx[r.slot] = 0
        if r.lora_slot and self.lora_manager is not None:
            self.lora_manager.release(r.lora_slot)
            r.lora_slot = 0
        if r.block_table:
            if r.pin_for_export and not r.export_pinned:
                # Migration source: one more ref per page past the retire,
                # until the exporter releases them (release_export_pins).
                for pid in r.block_table:
                    self.allocator.share(pid)
                r.export_pinned = list(r.block_table)
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
                # Pages computed under one adapter serve only that adapter.
                parent, chain = self._chain_hashes(seq[:valid], r.model)
                full_pages = len(chain)
                for i, digest in enumerate(chain):
                    self.allocator.register_prefix(
                        r.block_table[i], digest, parent)
                    parent = digest
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
        is set and the executor has the verify entry point (which it
        lacks while it holds a LoRA stack)."""
        return (self.speculation is not None
                and getattr(self.executor, "supports_speculation", False))

    @property
    def prefix_cache_hit_rate(self) -> float:
        """Cacheable prompt pages served from the prefix cache: hit pages
        over looked-up pages since the engine started."""
        lookups = self.metrics["prefix_lookup_pages"]
        return self.metrics["prefix_hit_pages"] / lookups if lookups else 0.0

    @property
    def prefill_suffix_frac(self) -> float:
        """Admitted prompt tokens actually prefilled (the cold suffix);
        1.0 = no prefix reuse."""
        total = self.metrics["prompt_tokens"]
        if not total:
            return 1.0
        return 1.0 - self.metrics["prefix_cached_tokens"] / total

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
        """True when steps fuse prefill chunks into the decode burst. A
        LoRA stack leaves it on: the burst carries every slot's adapter
        index, and only prompts with an adapter keep to the one-chunk
        prefill (plan selection skips them)."""
        return (self.prefill_token_budget > 0
                and getattr(self.executor, "supports_mixed_dispatch", False))

    def step(self) -> list[dict]:
        """Advance one tick: expire past deadlines, admit waiting requests
        while slots and pages allow, then dispatch. With mixed dispatch, a
        step with live decoders and pending prefill runs one fused call;
        otherwise one prefill chunk runs ahead of decode. Returns emission
        events ``{"request_id", "token", "done", "finish_reason"}``."""
        if self.has_work:
            # A demotion that raced admission: no dispatch ever runs
            # without weights.
            self._ensure_weights_resident()
        expired = self._expire_deadlines()
        if expired:
            return expired + self._step_scheduled()
        return self._step_scheduled()

    def _expire_deadlines(self) -> list[dict]:
        """Sweep past deadlines at the tick boundary (a deadline that
        passes inside a dispatch is seen at the next step). A waiting
        request leaves the queue without a slot or a page
        (``deadline_expired_queued``); a prefilling, decoding or
        first-sample-pending one is retired now, its slot, pages and pins
        returned (``deadline_expired_running``; the flush drops a pending
        sample's handle). Each expiry emits one terminal event with
        finish reason ``"deadline"`` and dumps its timeline."""
        events: list[dict] = []
        breached: list[Request] = []
        expired: list[Request] = []
        now = time.time()

        def past(r: Request) -> bool:
            return r.deadline is not None and now >= r.deadline

        def terminal(r: Request) -> None:
            r.done, r.finish_reason = True, "deadline"
            r.timeline.add(loop_recorder.EV_DEADLINE, 0, now=now)
            breached.append(r)
            events.append({"request_id": r.request_id, "token": -1,
                           "done": True, "finish_reason": "deadline"})

        with self._lock:
            if any(past(r) for r in self._waiting):
                keep: deque[Request] = deque()
                for r in self._waiting:
                    if past(r):
                        terminal(r)
                        self.metrics["deadline_expired_queued"] += 1
                    else:
                        keep.append(r)
                self._waiting = keep
            if any(past(r) for r in self._prefilling):
                keep = deque()
                for r in self._prefilling:
                    if past(r) and not r.done:
                        expired.append(r)
                    else:
                        keep.append(r)
                self._prefilling = keep
            expired += [r for r in self._active.values()
                        if past(r) and not r.done]
            expired += [r for r, _h in self._pending_first
                        if past(r) and not r.done]
            for r in expired:
                terminal(r)
                self._retire_locked(r)
                self.metrics["deadline_expired_running"] += 1
        for r in expired:
            self._record_decode_span(r)
        for r in breached:
            self.dump_timeline(r, "deadline")
        return events

    def _step_scheduled(self) -> list[dict]:
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
        admitted: list[Request] = []
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
                        n_pages - len(hits) + self.admission_watermark_pages:
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
                if r.model and self.lora_manager is not None:
                    try:
                        # A cold adapter loads here (file read and device
                        # copy), on the engine's thread.
                        r.lora_slot = self.lora_manager.acquire(r.model)
                    except AdapterCapacityError:
                        # Every resident adapter is pinned: the request
                        # waits at the head of the queue until a finishing
                        # request unpins one. The reuse accounting above
                        # is backed out so the retry counts it once.
                        self._release_admission_locked(r)
                        self.metrics["prefix_hit_pages"] -= len(hits)
                        self.metrics["prefix_cached_tokens"] -= \
                            r.cached_prefix_tokens
                        self.metrics["prompt_tokens"] -= len(r.prompt)
                        self._waiting.appendleft(r)
                        self.metrics["adapter_defers"] += 1
                        break
                    except Exception as e:
                        self._release_admission_locked(r)
                        r.done, r.finish_reason = True, "admission_failed"
                        logger.warning("adapter %r load failed: %s",
                                       r.model, e)
                        continue
                elif r.model:
                    # An adapter asked of an engine with no LoRA stack.
                    self._release_admission_locked(r)
                    r.done, r.finish_reason = True, "admission_failed"
                    continue
                r.slot = self._free_slots.pop()
                self._lora_idx[r.slot] = r.lora_slot
                self._block_tables[r.slot, :len(r.block_table)] = r.block_table
                self._prefilling.append(r)
                admitted.append(r)
        for r in admitted:
            if r.cached_prefix_tokens:
                r.timeline.add(loop_recorder.EV_PREFIX_HIT,
                               r.cached_prefix_tokens)
            self._record_prefix_match_span(r)

    def _release_admission_locked(self, r: Request) -> None:
        """Undo a half-admitted request's page state: its shared and
        fresh pages and the reserved COW fork."""
        for pid in r.block_table:
            self.allocator.release(pid)
        r.block_table = []
        if r.cow_page is not None:
            self.allocator.release(r.cow_page)
            r.cow_page = None
        r.shared_pages = 0
        r.partial_len = 0
        r.prefill_pos = 0

    @staticmethod
    def _record_span(r: Request, name: str, start: float, end: float,
                     **attrs) -> None:
        """One ``llm.*`` span of a request that has a trace, parented onto
        the context captured at ``add_request``."""
        if r.trace:
            tracing.record_span(tracing.make_span(
                name, "llm", start, end, r.trace.get("trace_id", ""),
                r.trace.get("span_id", ""),
                attrs={"request_id": r.request_id, **attrs}))

    def _record_prefix_match_span(self, r: Request) -> None:
        """One span an admission: how much of the prompt the prefix trie
        served (full-block hits and partial tail rows)."""
        self._record_span(r, "llm.prefix_match", r.arrived_wall, time.time(),
                          prompt_tokens=len(r.prompt),
                          cached_tokens=r.cached_prefix_tokens,
                          hit_pages=r.shared_pages,
                          partial_tokens=r.partial_len)

    def _prefix_hits(self, r: Request) -> tuple[list[int],
                                                tuple[int, int] | None]:
        """Longest cached chain covering the prompt (full blocks), plus the
        best partial tail block at its end — capped so at least one prompt
        token is computed (its hidden state seeds sampling)."""
        ps = self.page_size
        max_hit_pages = (len(r.prompt) - 1) // ps
        self.metrics["prefix_lookup_pages"] += max_hit_pages
        root, chain = self._chain_hashes(r.prompt, r.model)
        hashes = chain[:max_hit_pages]
        hits = self.allocator.match_prefix(hashes)
        for pid in hits:
            self.allocator.share(pid)
        if self._host_kv and len(hits) < len(hashes):
            hits = self._restore_host_hits(root, hashes, hits)
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

    def _chain_hashes(self, tokens, model: str | None = None
                      ) -> tuple[bytes, list[bytes]]:
        """Adapter-scoped root hash plus the chain hash of every full
        token block."""
        ps = self.page_size
        h = hashlib.sha1()
        h.update((model or "").encode())  # adapter-scoped prefix space
        root = h.digest()
        hashes: list[bytes] = []
        for i in range(len(tokens) // ps):
            h.update(np.asarray(tokens[i * ps:(i + 1) * ps],
                                np.int32).tobytes())
            hashes.append(h.digest())
        return root, hashes

    @staticmethod
    def _spill_page_to_host(executor, host_kv: OrderedDict, capacity: int,
                            metrics: dict, page_id: int,
                            chain_hash: bytes) -> None:
        """The host tier's eviction hook (under the engine lock, inside
        ``PageAllocator.alloc``): pull the doomed page's K/V to host RAM
        keyed by its chain hash, bounded LRU. One device sync a page."""
        try:
            data = executor.export_pages([page_id])
        except Exception:
            # Best effort: the eviction goes on without the spill.
            logger.warning("host KV spill of page %d failed", page_id,
                           exc_info=True)
            return
        host_kv[chain_hash] = data
        host_kv.move_to_end(chain_hash)
        while len(host_kv) > capacity:
            host_kv.popitem(last=False)
        metrics["host_kv_spilled_pages"] += 1

    def _restore_host_hits(self, root: bytes, hashes: list[bytes],
                           hits: list[int]) -> list[int]:
        """Extend a trie match with pages restored from the host tier:
        each is scattered back into a fresh page and registered under its
        chain hash, so the prefill skips it like a device-resident hit.
        Earlier hits are pinned and each restored page keeps its alloc
        ref (the pin), so an eviction a restore triggers never recycles
        a page of this match."""
        while len(hits) < len(hashes):
            h = hashes[len(hits)]
            data = self._host_kv.get(h)
            if data is None:
                break
            got = self.allocator.alloc(1)
            if got is None:
                break
            (pid,) = got
            del self._host_kv[h]  # one copy: it lives on the card again
            try:
                self.executor.import_pages([pid], data)
            except (RuntimeError, ValueError):
                logger.warning("host KV restore into page %d failed", pid,
                               exc_info=True)
                self.allocator.release(pid)
                break
            parent = hashes[len(hits) - 1] if hits else root
            self.allocator.register_prefix(pid, h, parent)
            hits.append(pid)
            self.metrics["host_kv_restored_pages"] += 1
        return hits

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
            r.timeline.add(loop_recorder.EV_COW_FORK, new)

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
        # A prefill-only prompt samples nothing: no first-token handle.
        handle = (next(self._handle_counter)
                  if final and not r.prefill_only else None)
        self.executor.prefill(bt, tokens, r.prefill_pos, handle, take,
                              lora_slot=r.lora_slot)
        self.metrics["prefill_chunks"] += 1
        r.prefill_pos += take
        r.timeline.add(loop_recorder.EV_PREFILL_CHUNK, take)
        if not final:
            return []
        with self._lock:
            if r.done:  # cancelled mid-prefill
                if handle is not None:
                    self.executor.drop_handle(handle)
                if self._prefilling and self._prefilling[0] is r:
                    self._prefilling.popleft()
                return []
            self._prefilling.popleft()
            if r.prefill_only:
                return [self._retire_prefilled_locked(r)]
        self._pending_first.append((r, handle))
        return []

    def _retire_prefilled_locked(self, r: Request) -> dict:
        """Disaggregated prefill: the prompt's KV is in the pool and, once
        retired, in the prefix trie; a decode engine imports the pages and
        samples."""
        r.done, r.finish_reason = True, "prefilled"
        self._retire_locked(r)
        return {"request_id": r.request_id, "token": -1, "done": True,
                "finish_reason": "prefilled"}

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
        now_wall = time.time()
        for i, (r, _) in enumerate(live):
            with self._lock:
                if r.done:  # cancelled while sampling
                    continue
                self._active[r.slot] = r
            r.pos = len(r.prompt)
            r.first_token_at = now
            r.first_token_wall = now_wall
            r.timeline.add(loop_recorder.EV_FIRST_TOKEN, r.prefill_pos,
                           now=now_wall)
            self._record_prefill_span(r)
            events.append(self._emit(r, int(tokens[i])))
        return events

    def _record_prefill_span(self, r: Request) -> None:
        """Arrival to first sampled token: the engine's TTFT (queue wait,
        chunked prefill and the first sample)."""
        self._record_span(r, "llm.prefill", r.arrived_wall,
                          r.first_token_wall or time.time(),
                          prompt_tokens=len(r.prompt),
                          cached_prefix_tokens=r.cached_prefix_tokens)

    # -------------------------------------------------------- flight recorder
    def dump_timeline(self, r: Request, reason: str) -> bool:
        """Dump one request's timeline as one ``llm.request_timeline``
        span whose attrs carry the whole event list (admission, prefix
        hit, prefill chunks, first token, tokens, the terminal event). At
        most once a request: the first breach wins, later calls return
        False."""
        tl = r.timeline
        if tl.dumped:
            return False
        tl.dumped = True
        payload = tl.to_payload()
        trace = r.trace or {}
        now = time.time()
        tracing.record_span(tracing.make_span(
            "llm.request_timeline", "llm",
            payload["start"] or r.arrived_wall, now,
            trace.get("trace_id") or tracing.new_trace_id(),
            trace.get("span_id", ""),
            attrs={"request_id": r.request_id, "reason": reason,
                   "model": r.model or "", **payload}))
        self.metrics["timeline_dumps"] += 1
        self._breach_samples.append({
            "request_id": r.request_id, "reason": reason, "ts": now,
            "model": r.model or "", "n_events": payload["n_events"],
            "overflowed": payload["overflowed"],
            "events": payload["events"][-16:]})
        return True

    def breach_samples(self) -> list[dict]:
        """The most recent breach dumps (at most 8), newest last."""
        return list(self._breach_samples)

    def _record_decode_span(self, r: Request) -> None:
        """First token to the end of the stream, and for a request that
        speculation touched an ``llm.speculate`` span of its drafts."""
        now = time.time()
        start = r.first_token_wall or now
        self._record_span(r, "llm.decode", start, now,
                          generated_tokens=len(r.generated),
                          finish_reason=r.finish_reason)
        if r.spec_drafted or r.spec_rollbacks:
            self._record_span(r, "llm.speculate", start, now,
                              drafted_tokens=r.spec_drafted,
                              accepted_tokens=r.spec_accepted,
                              rollbacks=r.spec_rollbacks)

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
            remaining, K, lora_idx=self._lora_idx)  # [K, slots]
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
            if dr:
                r.timeline.add(loop_recorder.EV_SPEC_ROUND, accepted)
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
            if r.lora_slot:
                continue  # a prompt with an adapter prefills on its own
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
                "handle": (next(self._handle_counter)
                           if final and not r.prefill_only else None),
                "take": take, "final": final,
            })
            budget -= chunk
        return plans

    def _mixed_step(self) -> list[dict] | None:
        """One fused call: the decode burst plus the selected prefill
        chunks. None when no chunk was selected (every pending prompt has
        an adapter, say): the step then runs the one-chunk schedule."""
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
            eos_ids, remaining, K, lora_idx=self._lora_idx)  # [K, slots]
        self.metrics["decode_steps"] += K
        self.metrics["decode_dispatches"] += 1
        prefilled: list[dict] = []
        for p in plans:
            r = p["request"]
            self.metrics["prefill_chunks"] += 1
            r.prefill_pos = p["start_pos"] + p["take"]
            r.timeline.add(loop_recorder.EV_PREFILL_CHUNK, p["take"])
            if not p["final"]:
                continue
            with self._lock:
                try:
                    self._prefilling.remove(r)
                except ValueError:
                    pass  # cancel() already rebuilt the queue without it
                if r.done:  # cancelled mid-dispatch
                    if p["handle"] is not None:
                        self.executor.drop_handle(p["handle"])
                    continue
                if r.prefill_only:
                    prefilled.append(self._retire_prefilled_locked(r))
                    continue
            self._pending_first.append((r, p["handle"]))
        return self._emit_decode_events(active, tokens, K) + prefilled

    def _emit(self, r: Request, token: int) -> dict:
        r.generated.append(token)
        # One event a token: the gaps between them are the inter-token
        # latencies in a dump.
        r.timeline.add(loop_recorder.EV_TOKEN, len(r.generated))
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
            self._record_decode_span(r)
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

    # ------------------------------------------------------ weight residency
    @property
    def supports_weight_residency(self) -> bool:
        """Host-tier weight demotion: the executor owns a ``params`` tree
        that it lets the engine swap."""
        return bool(getattr(self.executor, "supports_weight_residency",
                            False)) and hasattr(self.executor, "params")

    def weights_resident(self) -> bool:
        """True while the weights are on the device (normal serving)."""
        return getattr(self.executor, "params", None) is not None

    def demote_weights_to_host(self) -> dict:
        """Standby demotion: copy the weights to host RAM and drop the
        device reference, so their memory frees while the engine (pool,
        trie, adapters' files) stays warm. Idle adapters unload too.
        Refused while any request is in flight. The memory frees only if
        nothing else holds the device tensors (the ``params`` handed to
        the constructor, say)."""
        with self._residency_lock:
            if not self.supports_weight_residency:
                return {"ok": False, "reason": "unsupported"}
            if not self.weights_resident():
                return {"ok": True, "already": True, "bytes": 0,
                        "seconds": 0.0}
            if self.has_work:
                return {"ok": False, "reason": "busy"}
            t0 = time.monotonic()
            host = wlib.tree_to_host(self.executor.params)
            self._host_params = host
            self.executor.params = None
            self.metrics["weights_demoted"] += 1
            adapters = (self.lora_manager.unload_idle()
                        if self.lora_manager is not None else 0)
            return {"ok": True, "bytes": wlib.tree_bytes(host),
                    "adapters_unloaded": adapters,
                    "seconds": round(time.monotonic() - t0, 6)}

    def promote_weights_from_host(self) -> dict:
        """Standby promotion: copy the host weights back to the device.
        The host copy is kept (weights do not change under inference)."""
        with self._residency_lock:
            return self._promote_locked()

    def _promote_locked(self) -> dict:
        if self.weights_resident():
            return {"ok": True, "already": True, "seconds": 0.0}
        if self._host_params is None:
            return {"ok": False, "reason": "no_host_copy"}
        t0 = time.monotonic()
        # returns once the copies are done, so the time is the copy's
        params = wlib.host_to_device(self._host_params, self.executor.device)
        self.executor.params = params
        dt = time.monotonic() - t0
        self.metrics["weights_promoted"] += 1
        self.metrics["weight_promote_ms"] = round(dt * 1000.0, 3)
        return {"ok": True, "seconds": round(dt, 6)}

    def install_weights(self, host_tree) -> dict:
        """Adopt a weight tree delivered over the broadcast wire
        (``weights.receive_weight_stream``): it becomes the host copy,
        and a demoted engine promotes it. A resident engine only refreshes
        its host copy; its dispatches keep the device tree until the next
        demote/promote cycle."""
        with self._residency_lock:
            if not self.supports_weight_residency:
                return {"ok": False, "reason": "unsupported"}
            self._host_params = wlib.tree_to_host(host_tree)
            if self.weights_resident():
                return {"ok": True, "resident": True, "seconds": 0.0}
            return self._promote_locked()

    def _ensure_weights_resident(self) -> None:
        """First-request promotion: a request that lands on a demoted
        engine pays one host-to-device copy, never a failure."""
        if self.weights_resident() or self._host_params is None:
            return
        with self._residency_lock:
            self._promote_locked()

    # ---------------------------------------------------------- KV migration
    @property
    def supports_kv_migration(self) -> bool:
        """Page export and import between engines: needs the prefix trie
        (the registration target) and an executor with the host gather
        and scatter."""
        return bool(self.enable_prefix_cache and
                    getattr(self.executor, "supports_kv_migration", False))

    def pin_prefix_for_export(self, prompt,
                              model: str | None = None) -> dict | None:
        """Match ``prompt``'s longest cached chain (full trie blocks and
        the best partial tail) and pin its pages for export, one ref each,
        so pool pressure cannot recycle them mid-transfer. Returns the
        plan ``{"page_ids", "tokens", "full_pages", "partial_len",
        "model"}`` (release with ``release_export_pages``), or None when
        nothing is cached or migration is unsupported."""
        if not self.supports_kv_migration or len(prompt) < 2:
            return None
        ps = self.page_size
        with self._lock:
            root, chain = self._chain_hashes(prompt, model)
            hashes = chain[:(len(prompt) - 1) // ps]
            hits = self.allocator.match_prefix(hashes)
            partial = None
            if self._cow_enabled:
                parent = hashes[len(hits) - 1] if hits else root
                remainder = prompt[len(hits) * ps:]
                cap = min(len(remainder) - 1, ps - 1)
                if cap > 0:
                    partial = self.allocator.match_partial(
                        parent, tuple(int(t) for t in remainder), cap)
            if not hits and partial is None:
                return None
            ids = list(hits) + ([partial[0]] if partial is not None else [])
            for pid in ids:
                self.allocator.share(pid)  # pinned until released
        plen = partial[1] if partial is not None else 0
        covered = len(hits) * ps + plen
        return {"page_ids": ids,
                "tokens": [int(t) for t in prompt[:covered]],
                "full_pages": len(hits), "partial_len": plen,
                "model": model or ""}

    def release_export_pages(self, page_ids: list[int]) -> None:
        """Drop the pins ``pin_prefix_for_export`` took; the pages become
        ordinary evictable cache entries again."""
        with self._lock:
            for pid in page_ids:
                self.allocator.release(pid)

    def export_prefix_kv(self, prompt,
                         model: str | None = None) -> dict | None:
        """The cached KV covering ``prompt``'s longest prefix (full trie
        blocks and the best partial tail) as a host payload that
        ``import_prefix_kv`` on another engine adopts, in one pull (the
        chunked alternative is ``KVMigrationSource.for_cached_prefix``).
        None when nothing is cached or migration is unsupported."""
        plan = self.pin_prefix_for_export(prompt, model)
        if plan is None:
            return None
        ids = plan["page_ids"]
        try:
            data = self.executor.export_pages(ids)
        finally:
            self.release_export_pages(ids)
        self.metrics["kv_pages_exported"] += len(ids)
        self.metrics["kv_migrations_out"] += 1
        return {"page_size": self.page_size, "model": plan["model"],
                "tokens": plan["tokens"],
                "full_pages": plan["full_pages"],
                "partial_len": plan["partial_len"],
                "k": data["k"], "v": data["v"], "dtype": data["dtype"]}

    def import_prefix_kv(self, payload: dict | None) -> int:
        """Adopt a migrated KV payload (this engine's export or the JAX
        package's): reserve pages, scatter the data in and register the
        chain under the hashes the source used, so the next admission of
        the same prompt maps the pages as prefix hits. Returns the prompt
        tokens now servable from cache; 0 is a clean fallback (pressure,
        another page size, unsupported) and the request prefills cold."""
        if not payload or not self.supports_kv_migration \
                or payload.get("page_size") != self.page_size:
            return 0
        full_pages = int(payload.get("full_pages") or 0)
        plen = int(payload.get("partial_len") or 0)
        if not self._cow_enabled:
            plen = 0  # partial tails need row-granular suffix starts
        want = full_pages + (1 if plen else 0)
        if want <= 0:
            return 0
        with self._lock:
            pages = (self.allocator.alloc(want)
                     if self.allocator.available() >= want else None)
        if pages is None:
            # Import under pressure: never take live sequences' headroom
            # for a cache import.
            self.metrics["kv_import_failures"] += 1
            return 0
        data = {"k": np.asarray(payload["k"])[:, :want],
                "v": np.asarray(payload["v"])[:, :want],
                "dtype": payload.get("dtype")}
        try:
            self.executor.import_pages(pages, data)
        except (RuntimeError, ValueError):
            logger.warning("KV import failed", exc_info=True)
            with self._lock:
                for pid in pages:
                    self.allocator.release(pid)
            self.metrics["kv_import_failures"] += 1
            return 0
        return self.register_imported_chain(
            pages, payload["tokens"], full_pages, plen,
            model=payload.get("model") or None)

    def register_imported_chain(self, page_ids: list[int], tokens,
                                full_pages: int, partial_len: int,
                                model: str | None = None) -> int:
        """Register freshly imported pages in the prefix trie under chain
        hashes recomputed from their token ids. The caller holds one alloc
        ref per page; registration releases it, leaving the pages cached.
        A chain link already resident keeps the local page, and the
        duplicate frees back to the pool. Returns the prompt tokens the
        chain (existing and new) covers."""
        ps = self.page_size
        with self._lock:
            root, chain = self._chain_hashes(tokens, model)
            parent = root
            covered = 0
            kept = 0
            for i in range(min(full_pages, len(chain), len(page_ids))):
                h, pid = chain[i], page_ids[i]
                if self.allocator.lookup_prefix(h) is None:
                    self.allocator.register_prefix(pid, h, parent)
                    kept += 1
                self.allocator.release(pid)  # cached if registered, else freed
                parent = h
                covered = (i + 1) * ps
            if partial_len and len(page_ids) > full_pages:
                pid = page_ids[full_pages]
                tail = tuple(int(t) for t in tokens[
                    full_pages * ps:full_pages * ps + partial_len])
                if tail and self._cow_enabled:
                    self.allocator.register_partial(parent, tail, pid)
                self.allocator.release(pid)
                entry = self.allocator._partials.get(parent, {}).get(tail)
                if tail and entry is not None:
                    # Registered now, or an equal entry already resident:
                    # either way those rows are servable.
                    covered += len(tail)
                    if entry == pid:
                        kept += 1
            self.metrics["kv_pages_imported"] += kept
            if kept or covered:
                self.metrics["kv_migrations_in"] += 1
        return covered

    def release_export_pins(self, r: Request) -> None:
        """Drop the refs ``pin_for_export`` took at the retire; the pages
        become ordinary evictable cache entries. The exporter is done, so
        this also turns the request's export pinning off: a source that
        ends before its request retires (it died mid-prefill) leaves no
        pins behind, in whichever order the two threads get here."""
        with self._lock:
            r.pin_for_export = False
            pins, r.export_pinned = r.export_pinned, []
            for pid in pins:
                self.allocator.release(pid)

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
