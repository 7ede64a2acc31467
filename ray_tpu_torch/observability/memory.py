"""Cluster memory observability: reference debugging + accounting.

The space-side sibling of ``tracing.py`` (which made *time* observable).
Three layers, mirroring the reference's ``ray memory`` /
``memory_summary()`` surfaces:

  * **reference debugging** — every user-facing ``ObjectRef`` records a
    Python creation callsite (``capture_callsite``); the owner's
    ``ReferenceCounter`` classifies each entry
    (``LOCAL_REFERENCE`` / ``USED_BY_PENDING_TASK`` /
    ``CAPTURED_IN_OBJECT`` / ``ACTOR_HANDLE`` / ``PINNED_IN_STORE``) and
    per-worker summaries ride the existing TaskEventBuffer→GCS flush
    (status ``MEMORY``) into ``GcsMemoryStore``, queryable via
    ``state.memory_summary()`` / ``cli memory`` / ``/api/memory``.
  * **node accounting** — helpers for per-process RSS and CUDA
    ``memory_stats()`` the raylet folds into heartbeats and
    ``debug_state_*.txt`` (``ray_tpu_object_store_*`` /
    ``ray_tpu_hbm_*`` gauges).
  * **leak detection** — ``GcsMemoryStore.detect_leaks`` flags monotonic
    growth of a worker's refcount table (or a raylet's pinned bytes)
    across N report intervals; the GCS turns suspects into diagnostics
    ``ErrorEvent``s naming the top holders by callsite (ROADMAP 1c:
    tracing alone cannot root-cause a leak — pair it with resource
    accounting, Dapper + Monarch).
"""

from __future__ import annotations

import os
import sys
import threading
import time

# Ref-type classification (reference ``ray memory`` reference types,
# ``python/ray/util/memory.py``).
LOCAL_REFERENCE = "LOCAL_REFERENCE"
USED_BY_PENDING_TASK = "USED_BY_PENDING_TASK"
CAPTURED_IN_OBJECT = "CAPTURED_IN_OBJECT"
ACTOR_HANDLE = "ACTOR_HANDLE"
PINNED_IN_STORE = "PINNED_IN_STORE"
BORROWED = "BORROWED"


# ------------------------------------------------------------- callsites
def _creation_sites_enabled() -> bool:
    try:
        from ..core.config import get_config

        return bool(get_config().record_ref_creation_sites)
    except Exception:
        return True


_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep


def capture_callsite(skip: int = 1) -> str:
    """The first stack frame OUTSIDE ray_tpu, as ``file.py:line in fn``
    — the user line that created the ref (reference
    ``record_ref_creation_sites``). Returns "" when disabled."""
    if not _creation_sites_enabled():
        return ""
    try:
        frame = sys._getframe(skip)
    except ValueError:
        return ""
    while frame is not None:
        filename = frame.f_code.co_filename
        if not filename.startswith(_PKG_DIR):
            return (f"{os.path.basename(filename)}:{frame.f_lineno} "
                    f"in {frame.f_code.co_name}")
        frame = frame.f_back
    return ""


def classify_ref(*, local: int, submitted: int, contained_in: int,
                 borrowers: int, pinned: bool) -> str:
    """One reference-count shape → one ``ray memory`` ref type. Priority
    matches the reference: a ref both held locally and consumed by an
    in-flight task reads USED_BY_PENDING_TASK until the task settles."""
    if submitted > 0:
        return USED_BY_PENDING_TASK
    if contained_in > 0:
        return CAPTURED_IN_OBJECT
    if local > 0:
        return LOCAL_REFERENCE
    if borrowers > 0:
        return BORROWED
    return PINNED_IN_STORE if pinned else LOCAL_REFERENCE


# --------------------------------------------------------- node accounting
def process_rss_bytes(pid: int | None = None) -> int:
    """Resident set size of ``pid`` (default: this process) from
    ``/proc/<pid>/statm``; 0 if unreadable (dead pid, non-Linux)."""
    try:
        with open(f"/proc/{pid or os.getpid()}/statm") as f:
            return int(f.read().split()[1]) * (os.sysconf("SC_PAGE_SIZE") or 4096)
    except (OSError, IndexError, ValueError):
        return 0


def hbm_stats() -> dict:
    """Aggregate ``torch.cuda.memory_stats()`` over this process's cards:
    ``{"used", "limit", "peak", "devices"}``. Strictly passive — never
    imports torch or initializes CUDA (a process with a CUDA context can
    no longer fork workers safely); reports zeros until some code in
    this process has brought CUDA up."""
    out = {"used": 0, "limit": 0, "peak": 0, "devices": 0}
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return out  # CUDA not initialized: looking would initialize it
    try:
        for i in range(torch.cuda.device_count()):
            ms = torch.cuda.memory_stats(i)
            out["used"] += int(ms.get("allocated_bytes.all.current", 0))
            out["limit"] += int(torch.cuda.get_device_properties(i).total_memory)
            out["peak"] += int(ms.get("allocated_bytes.all.peak", 0))
            out["devices"] += 1
    except Exception:
        pass
    return out


# ----------------------------------------------------------- GCS retention
class GcsMemoryStore:
    """GCS-side retention of per-worker memory summaries plus the trend
    history the leak watcher scans (the accounting half of the
    Monarch-style model: gauges for state, histories for drift)."""

    def __init__(self, history: int = 64, stale_after_s: float = 30.0):
        self._lock = threading.Lock()
        self._workers: dict[str, dict] = {}  # worker_id -> latest summary
        # worker_id -> [(ts, num_refs, total_bytes), ...] bounded
        self._history: dict[str, list[tuple]] = {}
        # node_id -> [(ts, pinned_bytes), ...] bounded (fed from heartbeats)
        self._node_history: dict[str, list[tuple]] = {}
        self._reported: set[str] = set()  # keys already flagged as leaking
        self._max_history = history
        self._stale_after = stale_after_s
        self.leaks_flagged_total = 0

    def report(self, summary: dict) -> None:
        worker_id = summary.get("worker_id", "")
        if not worker_id:
            return
        with self._lock:
            self._workers[worker_id] = summary
            hist = self._history.setdefault(worker_id, [])
            hist.append((summary.get("ts", time.time()),
                         int(summary.get("num_refs", 0)),
                         int(summary.get("total_bytes", 0))))
            del hist[: max(0, len(hist) - self._max_history)]

    def report_node(self, node_id: str, pinned_bytes: int) -> None:
        with self._lock:
            hist = self._node_history.setdefault(node_id, [])
            hist.append((time.time(), int(pinned_bytes)))
            del hist[: max(0, len(hist) - self._max_history)]

    def _prune_locked(self) -> None:
        cutoff = time.time() - self._stale_after
        for wid, s in list(self._workers.items()):
            if s.get("ts", 0.0) < cutoff:
                del self._workers[wid]
                self._history.pop(wid, None)
                self._reported.discard("worker:" + wid)

    def summary(self) -> dict:
        """The merged cluster view behind ``state.memory_summary()``."""
        with self._lock:
            self._prune_locked()
            workers = [dict(s) for s in self._workers.values()]
        workers.sort(key=lambda s: s.get("total_bytes", 0), reverse=True)
        return {
            "ts": time.time(),
            "num_workers": len(workers),
            "total_bytes": sum(s.get("total_bytes", 0) for s in workers),
            "num_refs": sum(s.get("num_refs", 0) for s in workers),
            "workers": workers,
        }

    def size(self) -> int:
        with self._lock:
            return len(self._workers)

    def hbm_by_node(self) -> dict[str, dict]:
        """Per-node HBM view from worker reports: max across a node's
        workers (the device lock is exclusive per process, and max never
        double-counts a driver that shares the raylet's process)."""
        out: dict[str, dict] = {}
        with self._lock:
            reports = list(self._workers.values())
        for s in reports:
            hbm = s.get("hbm") or {}
            node = s.get("node_id", "")
            cur = out.setdefault(node, {"used": 0, "limit": 0, "peak": 0})
            for k in cur:
                cur[k] = max(cur[k], int(hbm.get(k, 0)))
        return out

    @staticmethod
    def _monotonic_growth(hist: list[tuple], intervals: int,
                          value_index: int) -> int:
        """Total growth when the last ``intervals`` deltas of
        ``hist[value_index]`` are all positive, else 0."""
        if len(hist) < intervals + 1:
            return 0
        window = hist[-(intervals + 1):]
        deltas = [window[i + 1][value_index] - window[i][value_index]
                  for i in range(intervals)]
        if all(d > 0 for d in deltas):
            return sum(deltas)
        return 0

    def detect_leaks(self, intervals: int = 4,
                     min_growth_bytes: int = 1 << 20,
                     min_growth_refs: int = 50,
                     top_k: int = 5) -> list[dict]:
        """Suspects whose refcount table / byte total / pinned bytes grew
        monotonically across the last ``intervals`` reports. Each suspect
        fires once; flat-or-shrinking history re-arms it."""
        suspects: list[dict] = []
        with self._lock:
            self._prune_locked()
            for wid, hist in self._history.items():
                key = "worker:" + wid
                ref_growth = self._monotonic_growth(hist, intervals, 1)
                byte_growth = self._monotonic_growth(hist, intervals, 2)
                if ref_growth < min_growth_refs and byte_growth < min_growth_bytes:
                    self._reported.discard(key)
                    continue
                if key in self._reported:
                    continue
                self._reported.add(key)
                self.leaks_flagged_total += 1
                latest = self._workers.get(wid, {})
                suspects.append({
                    "kind": "worker_refs",
                    "worker_id": wid,
                    "node_id": latest.get("node_id", ""),
                    "growth_refs": ref_growth,
                    "growth_bytes": byte_growth,
                    "num_refs": latest.get("num_refs", 0),
                    "total_bytes": latest.get("total_bytes", 0),
                    "top_holders": _top_holders(latest.get("entries") or [],
                                                top_k),
                })
            for node_id, hist in self._node_history.items():
                key = "node:" + node_id
                growth = self._monotonic_growth(hist, intervals, 1)
                if growth < min_growth_bytes:
                    self._reported.discard(key)
                    continue
                if key in self._reported:
                    continue
                self._reported.add(key)
                self.leaks_flagged_total += 1
                suspects.append({
                    "kind": "node_pinned_bytes",
                    "node_id": node_id,
                    "growth_bytes": growth,
                    "pinned_bytes": hist[-1][1],
                    "top_holders": [],
                })
        return suspects


def _top_holders(entries: list[dict], top_k: int) -> list[dict]:
    """Aggregate a summary's entries by creation callsite, biggest first
    — the "who is holding this and why" line of the leak report."""
    by_site: dict[str, dict] = {}
    for e in entries:
        site = e.get("callsite") or "(callsite unknown)"
        agg = by_site.setdefault(site, {"callsite": site, "count": 0,
                                        "bytes": 0, "ref_types": set()})
        agg["count"] += 1
        agg["bytes"] += int(e.get("size", 0))
        agg["ref_types"].add(e.get("ref_type", ""))
    out = sorted(by_site.values(), key=lambda a: (a["bytes"], a["count"]),
                 reverse=True)[:top_k]
    for agg in out:
        agg["ref_types"] = sorted(agg["ref_types"])
    return out


def leak_event_message(suspect: dict) -> str:
    """Human line for the diagnostics ErrorEvent."""
    if suspect.get("kind") == "node_pinned_bytes":
        return (f"possible object-store leak on node "
                f"{suspect.get('node_id', '')[:8]}: pinned bytes grew "
                f"{suspect.get('growth_bytes', 0)}B monotonically "
                f"(now {suspect.get('pinned_bytes', 0)}B)")
    holders = "; ".join(
        f"{h['callsite']} ({h['count']} refs, {h['bytes']}B)"
        for h in suspect.get("top_holders") or [])
    return (f"possible reference leak in worker "
            f"{suspect.get('worker_id', '')[:12]}: +{suspect.get('growth_refs', 0)} "
            f"refs / +{suspect.get('growth_bytes', 0)}B over the watch window "
            f"({suspect.get('num_refs', 0)} refs, "
            f"{suspect.get('total_bytes', 0)}B held). "
            f"Top holders: {holders or '(no callsites recorded)'}")


def format_memory_summary(summary: dict, nodes: list[dict] | None = None) -> str:
    """``cli memory`` rendering: per-node store/HBM header then a
    per-worker object table (object id, size, ref type, age, callsite) —
    the shape of the reference's ``ray memory`` output."""
    lines: list[str] = []
    for n in nodes or []:
        if n.get("state") != "ALIVE":
            continue
        store = n.get("store") or {}
        hbm = n.get("hbm") or {}
        lines.append(
            "node %s  store %s/%s B (pinned %s, spilled %s B)  hbm %s/%s B" % (
                n.get("node_id", "")[:12],
                store.get("used", 0),
                store.get("capacity", n.get("object_store_capacity", 0)),
                store.get("pinned_bytes", 0),
                store.get("spilled_bytes_total", 0),
                hbm.get("used", 0), hbm.get("limit", 0)))
    lines.append("%d workers, %d refs, %d bytes tracked" % (
        summary.get("num_workers", 0), summary.get("num_refs", 0),
        summary.get("total_bytes", 0)))
    header = ("OBJECT_ID", "SIZE", "REF_TYPE", "AGE_S", "CALLSITE")
    fmt = "%-28s %10s %-22s %8s  %s"
    for w in summary.get("workers") or []:
        lines.append("")
        lines.append("worker %s (node %s): %s refs, %s bytes" % (
            w.get("worker_id", "")[:12], w.get("node_id", "")[:8],
            w.get("num_refs", 0), w.get("total_bytes", 0)))
        lines.append(fmt % header)
        for e in w.get("entries") or []:
            lines.append(fmt % (
                e.get("object_id", "")[:28], e.get("size", 0),
                e.get("ref_type", ""), round(e.get("age_s", 0.0), 1),
                e.get("callsite", "")))
    return "\n".join(lines)
