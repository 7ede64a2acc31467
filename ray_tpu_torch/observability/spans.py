"""GCS-side span retention and rendering.

``GcsSpanStore`` keeps a bounded, trace-keyed log of finished spans
(the span half of ``GcsTaskManager``): workers flush spans through
``AddTaskEvents`` (status ``SPAN``) and the GCS routes them here. The
store powers ``state.list_spans()`` / ``cli trace`` and merges into the
chrome trace that ``ray_tpu.timeline()`` dumps.
"""

from __future__ import annotations

import threading


class GcsSpanStore:
    """Bounded span log aggregated per trace; whole-trace eviction in
    insertion order once the global span cap is hit."""

    def __init__(self, max_spans: int = 20_000):
        self._lock = threading.Lock()
        self._traces: dict[str, list[dict]] = {}  # insertion order = age
        self._total = 0
        self._max = max_spans
        self.num_dropped = 0

    def add(self, spans: list[dict]) -> None:
        with self._lock:
            for s in spans:
                tid = s.get("trace_id")
                if not tid:
                    self.num_dropped += 1
                    continue
                while self._total >= self._max and self._traces:
                    oldest = next(iter(self._traces))
                    if oldest == tid and len(self._traces) == 1:
                        break  # never evict the trace we are appending to
                    evicted = self._traces.pop(oldest)
                    self._total -= len(evicted)
                    self.num_dropped += len(evicted)
                self._traces.setdefault(tid, []).append(s)
                self._total += 1

    def size(self) -> int:
        with self._lock:
            return self._total

    def list_spans(self, trace_id: str | None = None, limit: int = 1000) -> list[dict]:
        with self._lock:
            if trace_id:
                out = list(self._traces.get(trace_id, []))
            else:
                out = [s for spans in self._traces.values() for s in spans]
        out.sort(key=lambda s: s.get("start", 0.0))
        return out[-limit:]

    def list_traces(self, limit: int = 100) -> list[dict]:
        """Per-trace summaries, most recent last."""
        rows = []
        with self._lock:
            items = list(self._traces.items())[-limit:]
        for tid, spans in items:
            start = min(s.get("start", 0.0) for s in spans)
            end = max(s.get("end", 0.0) for s in spans)
            ids = {s["span_id"] for s in spans}
            roots = [s for s in spans if s.get("parent_id", "") not in ids]
            root = min(roots or spans, key=lambda s: s.get("start", 0.0))
            rows.append({
                "trace_id": tid,
                "root": root.get("name", ""),
                "spans": len(spans),
                "start": start,
                "duration_ms": round((end - start) * 1000.0, 3),
            })
        return rows

    def chrome_trace(self) -> list[dict]:
        with self._lock:
            spans = [s for group in self._traces.values() for s in group]
        return spans_to_chrome(spans)


def spans_to_chrome(spans: list[dict]) -> list[dict]:
    """Chrome-trace slices + flow arrows for a span set. Each trace gets
    its own process row; within it spans group by (kind, recording
    worker), where parent/child spans nest by time on the shared track.
    Parent→child links are drawn as flow events keyed by the child span
    id so the serve request path reads as one connected tree."""
    trace: list[dict] = []
    by_id = {s["span_id"]: s for s in spans}
    for s in spans:
        pid = f"trace:{s['trace_id'][:8]}"
        tid = f"{s.get('kind', 'span')}:{(s.get('worker_id') or '?')[:8]}"
        ts = s.get("start", 0.0) * 1e6
        dur = max(1.0, (s.get("end", 0.0) - s.get("start", 0.0)) * 1e6)
        args = {"trace_id": s["trace_id"], "span_id": s["span_id"],
                "parent_id": s.get("parent_id", "")}
        args.update(s.get("attrs") or {})
        trace.append({
            "name": s.get("name", "span"), "cat": "span", "ph": "X",
            "ts": ts, "dur": dur, "pid": pid, "tid": tid, "args": args,
        })
        parent = by_id.get(s.get("parent_id", ""))
        if parent is not None:
            flow_id = int(s["span_id"][:12], 16)
            ppid = f"trace:{parent['trace_id'][:8]}"
            ptid = f"{parent.get('kind', 'span')}:{(parent.get('worker_id') or '?')[:8]}"
            trace.append({"name": "span_link", "cat": "span_flow", "ph": "s",
                          "id": flow_id, "ts": parent.get("start", 0.0) * 1e6,
                          "pid": ppid, "tid": ptid})
            trace.append({"name": "span_link", "cat": "span_flow", "ph": "f",
                          "bp": "e", "id": flow_id, "ts": ts,
                          "pid": pid, "tid": tid})
    return trace


def format_trace_tree(spans: list[dict]) -> str:
    """ASCII tree of one trace's spans for ``cli trace <id>``."""
    if not spans:
        return "(no spans)"
    ids = {s["span_id"] for s in spans}
    children: dict[str, list[dict]] = {}
    roots: list[dict] = []
    for s in sorted(spans, key=lambda s: s.get("start", 0.0)):
        parent = s.get("parent_id", "")
        if parent in ids:
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)
    lines: list[str] = []

    def _walk(s: dict, depth: int) -> None:
        dur_ms = (s.get("end", 0.0) - s.get("start", 0.0)) * 1000.0
        where = (s.get("node_id") or "")[:8]
        lines.append(
            f"{'  ' * depth}{s.get('name', 'span')}  "
            f"[{s.get('kind', '?')}] {dur_ms:.1f}ms"
            + (f"  node={where}" if where else ""))
        for c in children.get(s["span_id"], []):
            _walk(c, depth + 1)

    for r in roots:
        _walk(r, 0)
    return "\n".join(lines)
