"""Live KV-page migration between engines over the loop wire.

The port of ``ray_tpu/llm/migration.py``: the transfer half of
disaggregated prefill/decode serving. A prefill engine streams its
request's pages over a credit-based ``TcpLoopServer``
(``dag/channel.py``) while later chunks are still prefilling, and the
decode engine imports each chunk as it arrives, so most of the prompt's
KV is in the decode engine's pool by the time the prefill ends.

Wire protocol (pickled dicts, exactly once, in order):

    {"kind": "meta",  "page_size", "model", "prompt_len"}
    {"kind": "pages", "tokens": [...], "k", "v", "dtype"}  # full blocks
    {"kind": "tail",  "tokens": [...], "k", "v", "dtype"}  # partial tail
    {"kind": "end"}                                        # complete
    {"kind": "abort"}                                      # source failed

``k``/``v`` are numpy arrays [L, m, KH, page, D]; ``dtype`` names the
pool's dtype, which the JAX package's arrays carry themselves: a bfloat16
pool travels as raw 16-bit integers (``weights.tensor_to_host``).

Failure is graceful by construction: chunks arrive in chain order, so a
source death, timeout or reservation failure mid-stream leaves the
importer holding a contiguous prefix of the chain, which is itself a
valid chain: it registers what it has and the request prefills the rest.

One deliberate difference from the JAX package: a live source that ends
before its request retires (a source death mid-prefill) turns the
request's export pinning off under the engine lock
(``InferenceEngine.release_export_pins``), so the retire that follows
pins nothing that no one would release.

The sources and the importer run on threads beside the engine loop and
use PyTorch's current stream, as the loop does, so their copies stay in
order with its dispatches; every pool access holds the executor's
``_pages_lock``.
"""

from __future__ import annotations

import logging
import pickle
import threading
import time

import numpy as np

from ..dag.channel import (WIRE_TIMEOUT_S, ChannelClosed, TcpLoopReader,
                           TcpLoopServer)

logger = logging.getLogger(__name__)

# Pages a migration message carries (the JAX package's
# ``kv_migration_chunk_pages``).
KV_MIGRATION_CHUNK_PAGES = 8


class KVMigrationSource:
    """Prefill-side exporter: streams one (possibly still prefilling)
    request's prefix pages as they complete, or, in static mode
    (:meth:`for_cached_prefix`), a prompt's already cached trie pages.

    A live request must be admitted with ``pin_for_export=True`` so its
    pages survive the retire until the transfer ends; static plans pin
    their pages through ``engine.pin_prefix_for_export``. Pages are
    pinned once more around each device-to-host pull. One background
    thread per migration; :meth:`close` releases the server socket once
    the consumer is done."""

    def __init__(self, engine, request, chunk_pages: int | None = None,
                 advertise: str | None = None,
                 _die_after_chunks: int | None = None,
                 static_plan: dict | None = None):
        if static_plan is None and not request.pin_for_export:
            raise ValueError(
                "migration sources require pin_for_export=True requests")
        self.engine = engine
        self.request = request
        self._static_plan = static_plan
        self.chunk_pages = max(1, chunk_pages or KV_MIGRATION_CHUNK_PAGES)
        self._server = TcpLoopServer(n_slots=8, n_readers=1,
                                     advertise=advertise)
        # Test hook: hard-kill the channel after N chunks, as a dead
        # prefill engine would.
        self._die_after = _die_after_chunks
        self.stats = {"pages": 0, "bytes": 0, "chunks": 0}
        self._thread = threading.Thread(
            target=self._run_static if static_plan is not None else self._run,
            daemon=True, name="kv-migration-src")
        self._thread.start()

    @classmethod
    def for_cached_prefix(cls, engine, prompt_ids, model: str | None = None,
                          chunk_pages: int | None = None,
                          advertise: str | None = None,
                          _die_after_chunks: int | None = None
                          ) -> "KVMigrationSource | None":
        """A migration stream over the engine's cached pages covering
        ``prompt_ids``'s longest prefix. None when nothing is cached (the
        caller just prefills)."""
        plan = engine.pin_prefix_for_export(prompt_ids, model)
        if plan is None:
            return None
        return cls(engine, None, chunk_pages=chunk_pages,
                   advertise=advertise, _die_after_chunks=_die_after_chunks,
                   static_plan=plan)

    @property
    def address(self) -> str:
        return self._server.address

    def _send(self, msg: dict) -> None:
        blob = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
        self._server.write(blob, timeout=WIRE_TIMEOUT_S)
        self.stats["bytes"] += len(blob)

    def _export_pinned(self, page_ids: list[int]) -> dict:
        """Pull pages with a transient extra pin: a live request's own
        refcount usually covers them, but a cancel can retire mid-pull."""
        eng = self.engine
        with eng._lock:
            for pid in page_ids:
                eng.allocator.share(pid)
        try:
            return eng.executor.export_pages(page_ids)
        finally:
            with eng._lock:
                for pid in page_ids:
                    eng.allocator.release(pid)

    def _send_pages(self, kind: str, tokens, page_ids: list[int]) -> None:
        data = self._export_pinned(page_ids)
        self._send({"kind": kind, "tokens": [int(t) for t in tokens],
                    "k": data["k"], "v": data["v"], "dtype": data["dtype"]})
        self.stats["pages"] += len(page_ids)

    def _chunk_sent(self) -> bool:
        """Count a sent chunk; True when the test hook kills the wire."""
        self.stats["chunks"] += 1
        if self._die_after is not None \
                and self.stats["chunks"] >= self._die_after:
            self._server.close()  # simulated source death
            return True
        return False

    def _run(self) -> None:
        eng, r = self.engine, self.request
        ps = eng.page_size
        # The last prompt token's hidden state is always recomputed on the
        # importer (it seeds sampling), so full blocks are capped as
        # admission caps its matches.
        cap_full = (len(r.prompt) - 1) // ps
        sent = 0
        try:
            self._send({"kind": "meta", "page_size": ps,
                        "model": r.model or "",
                        "prompt_len": len(r.prompt)})
            while True:
                with eng._lock:
                    done, reason = r.done, r.finish_reason
                    pos = r.prefill_pos
                    table = list(r.block_table) or list(r.export_pinned)
                avail = min(pos // ps, cap_full)
                while sent < avail:
                    hi = min(sent + self.chunk_pages, avail)
                    self._send_pages("pages", r.prompt[sent * ps:hi * ps],
                                     table[sent:hi])
                    sent = hi
                    if self._chunk_sent():
                        return
                if done:
                    break
                time.sleep(0.002)
            if reason in ("prefilled", "stop", "length"):
                if len(r.prompt) > cap_full * ps and len(table) > cap_full:
                    self._send_pages("tail", r.prompt[cap_full * ps:],
                                     [table[cap_full]])
                self._send({"kind": "end"})
                eng.metrics["kv_pages_exported"] += self.stats["pages"]
                eng.metrics["kv_migrations_out"] += 1
            else:  # cancelled / admission_failed: nothing trustworthy
                self._send({"kind": "abort"})
        except Exception:
            # The source thread's boundary: the importer keeps the prefix
            # it received.
            logger.warning("KV migration source failed", exc_info=True)
            try:
                self._send({"kind": "abort"})
            except (ChannelClosed, TimeoutError):
                pass
        finally:
            # Close after drain: queued chunks (and the end marker) still
            # reach the reader, then it sees ChannelClosed.
            self._server.close_writer()
            eng.release_export_pins(r)

    def _run_static(self) -> None:
        """Stream an already cached prefix (pinned by the plan): full trie
        blocks chunk by chunk, then the partial tail, then end — the live
        path's wire shape."""
        eng, plan = self.engine, self._static_plan
        ps = eng.page_size
        ids = plan["page_ids"]
        full = plan["full_pages"]
        tokens = plan["tokens"]
        try:
            self._send({"kind": "meta", "page_size": ps,
                        "model": plan["model"] or "",
                        "prompt_len": len(tokens)})
            sent = 0
            while sent < full:
                hi = min(sent + self.chunk_pages, full)
                self._send_pages("pages", tokens[sent * ps:hi * ps],
                                 ids[sent:hi])
                sent = hi
                if self._chunk_sent():
                    return
            if plan["partial_len"] and len(ids) > full:
                self._send_pages("tail", tokens[full * ps:], [ids[full]])
                self.stats["chunks"] += 1
            self._send({"kind": "end"})
            eng.metrics["kv_pages_exported"] += self.stats["pages"]
            eng.metrics["kv_migrations_out"] += 1
        except Exception:
            logger.warning("KV migration source failed", exc_info=True)
            try:
                self._send({"kind": "abort"})
            except (ChannelClosed, TimeoutError):
                pass
        finally:
            self._server.close_writer()
            eng.release_export_pages(ids)

    def join(self, timeout: float | None = 30.0) -> None:
        self._thread.join(timeout)

    def close(self) -> None:
        """Release the server socket (after the consumer drained)."""
        self._thread.join(timeout=5.0)
        self._server.close()


def receive_kv_stream(engine, address: str,
                      timeout_s: float | None = None) -> dict:
    """Decode-side importer: pull a migration stream into ``engine``'s
    pool chunk by chunk (overlapping the source's prefill), then register
    the received chain so the next admission of the same prompt maps it
    as ordinary prefix hits.

    Degrades, never fails: an incompatible geometry drops the stream, and
    a reservation failure, a chunk that does not fit the pool or a source
    death mid-stream registers the contiguous prefix received so far; the
    request then prefills what is left. Returns ``{"cached_tokens", "pages", "bytes", "seconds",
    "complete", "status"}``."""
    t0 = time.monotonic()
    stats = {"cached_tokens": 0, "pages": 0, "bytes": 0, "seconds": 0.0,
             "complete": False, "status": "ok"}
    if timeout_s is None:
        timeout_s = WIRE_TIMEOUT_S
    page_ids: list[int] = []
    tokens: list[int] = []
    full_pages = 0
    partial_len = 0
    model = ""
    reader = None
    try:
        reader = TcpLoopReader(address)
        deadline = time.monotonic() + timeout_s
        while True:
            blob = reader.read(
                timeout=max(0.1, deadline - time.monotonic()))
            stats["bytes"] += len(blob)
            msg = pickle.loads(blob)
            kind = msg.get("kind")
            if kind == "meta":
                if msg.get("page_size") != engine.page_size \
                        or not engine.supports_kv_migration:
                    stats["status"] = "incompatible"
                    break
                model = msg.get("model") or ""
            elif kind in ("pages", "tail"):
                n = int(np.asarray(msg["k"]).shape[1])
                with engine._lock:
                    ids = (engine.allocator.alloc(n)
                           if engine.allocator.available() >= n else None)
                if ids is None:
                    # Pool pressure: keep the prefix already imported;
                    # never take live sequences' headroom for more.
                    engine.metrics["kv_import_failures"] += 1
                    stats["status"] = "pressure"
                    break
                try:
                    engine.executor.import_pages(ids, msg)
                except (RuntimeError, ValueError):
                    # A malformed chunk: keep the prefix already imported.
                    logger.warning("KV import failed", exc_info=True)
                    with engine._lock:
                        for pid in ids:
                            engine.allocator.release(pid)
                    engine.metrics["kv_import_failures"] += 1
                    stats["status"] = "import_failed"
                    break
                page_ids.extend(ids)
                tokens.extend(int(t) for t in msg["tokens"])
                stats["pages"] += n
                if kind == "tail":
                    partial_len = len(msg["tokens"])
                else:
                    full_pages += n
            elif kind == "end":
                stats["complete"] = True
                break
            elif kind == "abort":
                stats["status"] = "aborted"
                break
    except (ChannelClosed, TimeoutError, ConnectionError, OSError,
            EOFError, pickle.UnpicklingError) as e:
        stats["status"] = type(e).__name__
    finally:
        if reader is not None:
            reader.close()
    if page_ids:
        stats["cached_tokens"] = engine.register_imported_chain(
            page_ids, tokens, full_pages, partial_len,
            model=model or None)
        engine.metrics["kv_import_bytes"] += stats["bytes"]
    stats["seconds"] = round(time.monotonic() - t0, 6)
    return stats
