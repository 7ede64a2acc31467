"""Task events: per-task status timestamps buffered and flushed to the GCS.

Equivalent of the reference's ``TaskEventBuffer``
(``src/ray/core_worker/task_event_buffer.h:224,300``) feeding
``GcsTaskManager``: every worker batches status transitions
(SUBMITTED/LEASED/RUNNING/FINISHED/FAILED) and flushes them on an
interval; the GCS keeps a bounded ring of events that powers the state
API (``list_tasks``) and the chrome-trace timeline (``ray_tpu.timeline()``,
reference ``python/ray/_private/state.py:965``).
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Any

# Status transition names (reference rpc::TaskStatus).
SUBMITTED = "SUBMITTED"
LEASED = "LEASED"
RUNNING = "RUNNING"
FINISHED = "FINISHED"
FAILED = "FAILED"
# Pseudo-status carrying a finished trace span (observability/tracing.py)
# through the same buffered flush path; the GCS routes these to its span
# store instead of the task table.
SPAN = "SPAN"
# Pseudo-status carrying a worker memory summary (observability/memory.py)
# on the same flush path; the GCS routes these to its memory store.
MEMORY = "MEMORY"


def _resolve_state(events: dict) -> str:
    if FAILED in events:
        return FAILED
    if FINISHED in events:
        return FINISHED
    if RUNNING in events:
        return RUNNING
    if LEASED in events:
        return LEASED
    return SUBMITTED


# Fields every status event carries; anything else is a per-transition
# extra (error, trace_id, queue_wait_ms, a LEASED worker_id override...)
# and must survive coalescing on the transition entry itself.
_BASE_KEYS = ("task_id", "name", "status", "ts", "worker_id", "node_id", "kind")


def coalesce_events(events: list[dict], window_ms: float) -> list[dict]:
    """Merge one task's status transitions recorded within ``window_ms``
    into ONE wire event carrying a ``transitions`` list — a task that ran
    SUBMITTED→LEASED→FINISHED inside a flush interval ships as one dict
    instead of three. SPAN/MEMORY pseudo-events never coalesce (the GCS
    routes them to different stores). The GCS replays transitions in
    recorded order, so per-task records and the lease-stage histograms
    are byte-identical to the unbatched path."""
    window_s = window_ms / 1000.0
    out: list[dict] = []
    open_groups: dict[str, dict] = {}  # task_id -> coalesced event
    for ev in events:
        status = ev.get("status")
        tid = ev.get("task_id")
        if status in (SPAN, MEMORY) or not tid:
            out.append(ev)
            continue
        extras = {k: v for k, v in ev.items() if k not in _BASE_KEYS}
        # worker_id varies per transition on the owner's LEASED records:
        # keep any value that differs from the group base.
        group = open_groups.get(tid)
        if group is not None and ev["ts"] - group["transitions"][0]["ts"] > window_s:
            group = None  # beyond the window: start a fresh group
        if group is None:
            group = dict(ev)
            group.pop("status", None)
            for k in list(extras):
                group.pop(k, None)
            group["transitions"] = []
            open_groups[tid] = group
            out.append(group)
        tr = {"status": status, "ts": ev["ts"]}
        if ev.get("worker_id") != group.get("worker_id"):
            tr["worker_id"] = ev.get("worker_id")
        tr.update(extras)
        group["transitions"].append(tr)
        # The wire dict stays a valid single event too (status/ts = the
        # latest transition) so foreign consumers that predate coalescing
        # still see a sane record.
        group["status"] = status
        group["ts"] = ev["ts"]
    return out


def expand_event(ev: dict) -> list[dict]:
    """Inverse of :func:`coalesce_events` for one wire event: yield one
    plain event per transition (transition fields override the base)."""
    transitions = ev.get("transitions")
    if not transitions:
        return [ev]
    base = {k: v for k, v in ev.items() if k != "transitions"}
    out = []
    for tr in transitions:
        e = dict(base)
        e.update(tr)
        out.append(e)
    return out


class TaskEventBuffer:
    """Worker-side bounded buffer of task status events."""

    def __init__(self, worker_id: str, node_id: str, max_buffer: int = 10_000):
        self._worker_id = worker_id
        self._node_id = node_id
        self._max = max_buffer
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._dropped = 0

    def record(self, task_id: bytes, name: str, status: str, *,
               kind: int = 0, extra: dict | None = None) -> None:
        ev = {
            "task_id": task_id.hex() if isinstance(task_id, bytes) else task_id,
            "name": name,
            "status": status,
            "ts": time.time(),
            "worker_id": self._worker_id,
            "node_id": self._node_id,
            "kind": kind,
        }
        if extra:
            ev.update(extra)
        with self._lock:
            if len(self._events) >= self._max:
                self._dropped += 1
                return
            self._events.append(ev)

    def record_span(self, span: dict) -> None:
        """Buffer one finished trace span; it rides the same drain/flush
        batch as status events (status ``SPAN``)."""
        ev = {
            "task_id": span.get("trace_id", ""),
            "name": span.get("name", ""),
            "status": SPAN,
            "ts": span.get("end", time.time()),
            "worker_id": self._worker_id,
            "node_id": self._node_id,
            "kind": 0,
            "span": span,
        }
        with self._lock:
            if len(self._events) >= self._max:
                self._dropped += 1
                return
            self._events.append(ev)

    def record_memory(self, summary: dict) -> None:
        """Buffer one per-worker memory summary; rides the same drain/flush
        batch as status events (status ``MEMORY``)."""
        ev = {
            "task_id": "",
            "name": "memory_summary",
            "status": MEMORY,
            "ts": summary.get("ts", time.time()),
            "worker_id": self._worker_id,
            "node_id": self._node_id,
            "kind": 0,
            "memory": summary,
        }
        with self._lock:
            if len(self._events) >= self._max:
                self._dropped += 1
                return
            self._events.append(ev)

    def drain(self, coalesce_window_ms: float | None = None) -> tuple[list[dict], int]:
        """Take the buffered events. ``coalesce_window_ms`` (None = read
        the config knob) > 0 merges each task's transitions into one wire
        event — the flush RPC ships and the GCS ingests a fraction of the
        dicts for the same information."""
        with self._lock:
            events, self._events = self._events, []
            dropped, self._dropped = self._dropped, 0
        if coalesce_window_ms is None:
            from .config import get_config

            coalesce_window_ms = get_config().task_event_coalesce_ms
        if coalesce_window_ms and coalesce_window_ms > 0 and len(events) > 1:
            events = coalesce_events(events, coalesce_window_ms)
        return events, dropped


class _TaskShard:
    __slots__ = ("lock", "tasks")

    def __init__(self):
        self.lock = threading.Lock()
        # dict insertion order IS the per-shard ring order; records carry
        # a global "_seq" stamp so merged listings reconstruct the exact
        # 1-shard insertion order.
        self.tasks: dict[str, dict] = {}


class GcsTaskEventStore:
    """GCS-side bounded event log + per-task aggregation
    (reference ``gcs_task_manager.h``), SHARDED by task-id hash (the
    ``store_client/`` treatment): each shard has its own lock, so N
    raylets' flush batches ingest concurrently instead of convoying on
    one store lock, while per-task reads/writes stay linearizable (a
    task id always lands in exactly one shard). Listings merge across
    shards by global sequence stamp — byte-identical to the 1-shard
    store for the same input order."""

    def __init__(self, max_tasks: int = 100_000, on_stage=None,
                 shards: int | None = None):
        if shards is None:
            from .config import get_config

            shards = get_config().gcs_store_shards
        from .store_client import shard_index

        self._shard_index = shard_index
        self._n = max(1, int(shards))
        self._shards = [_TaskShard() for _ in range(self._n)]
        self._seq = itertools.count(1)
        self._max = max_tasks
        self.num_dropped = 0
        self._dropped_lock = threading.Lock()
        # Optional (stage, duration_ms, node_id) observer fed at ingest:
        # backs the per-raylet lease-stage histograms without a second
        # pass over the event log.
        self._on_stage = on_stage

    def add_events(self, events: list[dict], dropped: int = 0) -> None:
        # Coalesced events expand to their individual transitions here,
        # applied in recorded order, so the store (and the stage
        # observer) sees exactly the sequence the unbatched path would
        # have delivered. Each event takes only its own shard's lock.
        if dropped:
            with self._dropped_lock:
                self.num_dropped += dropped
        for wire in events:
            if wire.get("transitions"):
                for ev in expand_event(wire):
                    self._ingest(ev)
            else:
                self._ingest(wire)

    def _ingest(self, ev: dict) -> None:
        tid = ev["task_id"]
        if isinstance(tid, bytes):
            # Normalize at ingest: every reporter (worker buffer,
            # raylet, GCS-side stamps) must land on ONE record per
            # task, whatever id form it sends.
            tid = tid.hex()
        status = ev["status"]
        ts = ev["ts"]
        shard = self._shards[self._shard_index(tid, self._n)]
        with shard.lock:
            rec = shard.tasks.get(tid)
            if rec is None:
                rec = shard.tasks[tid] = {
                    "task_id": tid,
                    "name": ev.get("name", ""),
                    "kind": ev.get("kind", 0),
                    "events": {},
                    "_seq": next(self._seq),
                }
            self._observe_stages(rec, ev, status, ts)
            if status == LEASED:
                # Both the raylet (at grant) and the owner (at
                # dispatch) report LEASED: keep the earliest — the
                # actual grant time.
                rec["events"].setdefault(status, ts)
            else:
                rec["events"][status] = ts
            rec["name"] = ev.get("name") or rec["name"]
            for key in ("worker_id", "node_id", "error", "trace_id"):
                if ev.get(key):
                    rec[key] = ev[key]
        self._maybe_evict()

    def _maybe_evict(self) -> None:
        """Evict the globally-oldest record once over capacity — the same
        record the 1-shard ring would pop (its _seq is the global
        insertion order), found by peeking each shard's own oldest."""
        while sum(len(s.tasks) for s in self._shards) > self._max:
            oldest: tuple[int, _TaskShard, str] | None = None
            for shard in self._shards:
                with shard.lock:
                    head = next(iter(shard.tasks), None)
                    if head is None:
                        continue
                    seq = shard.tasks[head]["_seq"]
                if oldest is None or seq < oldest[0]:
                    oldest = (seq, shard, head)
            if oldest is None:
                return
            _, shard, tid = oldest
            with shard.lock:
                shard.tasks.pop(tid, None)

    def _observe_stages(self, rec: dict, ev: dict, status: str, ts: float) -> None:
        if self._on_stage is None:
            return
        node = ev.get("node_id", "")
        # Raylet-measured sub-stages ride the LEASED event itself.
        for key, stage in (("queue_wait_ms", "lease_queue_wait"),
                           ("spawn_ms", "worker_spawn")):
            if ev.get(key) is not None:
                self._on_stage(stage, float(ev[key]), node)
        events = rec["events"]
        if status == LEASED and LEASED not in events and SUBMITTED in events:
            self._on_stage("submit_to_lease", (ts - events[SUBMITTED]) * 1000.0, node)
        elif status == RUNNING and RUNNING not in events and LEASED in events:
            self._on_stage("lease_to_run", (ts - events[LEASED]) * 1000.0, node)

    def list_tasks(self, limit: int = 1000) -> list[dict]:
        # Merge shards by global sequence stamp: the exact insertion
        # order the 1-shard ring would have listed.
        rows: list[tuple[int, dict]] = []
        for shard in self._shards:
            with shard.lock:
                rows.extend((rec["_seq"], rec) for rec in shard.tasks.values())
        rows.sort(key=lambda r: r[0])
        out = []
        for _, rec in rows[-limit:] if limit else rows:
            events = rec["events"]
            out.append({
                "task_id": rec["task_id"],
                "name": rec["name"],
                "state": _resolve_state(events),
                "kind": rec.get("kind", 0),
                "worker_id": rec.get("worker_id", ""),
                "node_id": rec.get("node_id", ""),
                "error": rec.get("error", ""),
                "trace_id": rec.get("trace_id", ""),
                "events": dict(events),
            })
        return out

    def count_by_state(self) -> dict[str, int]:
        """State tallies without materializing record copies (metrics
        scrapes poll this every few seconds)."""
        out: dict[str, int] = {}
        for shard in self._shards:
            with shard.lock:
                for rec in shard.tasks.values():
                    state = _resolve_state(rec["events"])
                    out[state] = out.get(state, 0) + 1
        return out

    def chrome_trace(self) -> list[dict]:
        """Events in the chrome://tracing (Perfetto) JSON array format
        (reference ``state.py chrome_tracing_dump:442``)."""
        trace: list[dict] = []
        for rec in self.list_tasks(limit=self._max):
            events = rec["events"]
            start = events.get(RUNNING) or events.get(SUBMITTED)
            end = events.get(FINISHED) or events.get(FAILED)
            if start is None:
                continue
            dur_us = max(1.0, ((end or time.time()) - start) * 1e6)
            trace.append({
                "name": rec["name"],
                "cat": "task",
                "ph": "X",
                "ts": start * 1e6,
                "dur": dur_us,
                "pid": f"node:{rec.get('node_id', '?')[:8]}",
                "tid": f"worker:{rec.get('worker_id', '?')[:8]}",
                "args": {"task_id": rec["task_id"], "state": rec["state"],
                         "trace_id": rec.get("trace_id", "")},
            })
        return trace


def write_chrome_trace(events: list[dict], filename: str) -> str:
    with open(filename, "w") as f:
        json.dump(events, f)
    return filename
