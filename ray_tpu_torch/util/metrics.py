"""Metrics: counters/gauges/histograms pushed to the GCS.

Equivalent of the reference's C++ stats layer (``src/ray/stats/metric.h:105``
Gauge/Count/Histogram on OpenCensus + per-node metrics agent): here every
process keeps a local registry and a flusher thread pushes snapshots to the
GCS (``ReportMetrics``), which aggregates per (name, tags) — queryable via
``get_metrics()`` / the CLI, exportable in Prometheus text format.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from typing import Sequence


# Default histogram boundaries, millisecond-scale: suitable for the
# latency/TTFT metrics this framework emits (serve_ttft_ms,
# serve_queue_wait_ms, ray_tpu_lease_stage_ms, ...).
LATENCY_MS_BOUNDARIES = (
    1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)


class _Metric:
    def __init__(self, name: str, description: str = "", tag_keys: Sequence[str] = (),
                 register: bool = True):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}
        # register=False keeps the metric out of the global registry (no
        # flusher push) — used by GCS-internal aggregations that are
        # merged into GetMetrics directly.
        if register:
            _registry_add(self)

    def _key(self, tags: dict | None) -> tuple:
        tags = tags or {}
        return tuple(str(tags.get(k, "")) for k in self.tag_keys)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [
                {"name": self.name, "type": self.kind, "desc": self.description,
                 "tags": dict(zip(self.tag_keys, key)), "value": value}
                for key, value in self._values.items()
            ]


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, tags: dict | None = None) -> None:
        with self._lock:
            key = self._key(tags)
            self._values[key] = self._values.get(key, 0.0) + value


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, tags: dict | None = None) -> None:
        with self._lock:
            self._values[self._key(tags)] = float(value)


class Histogram(_Metric):
    """Fixed-boundary histogram; stores per-bucket counts + sum/count."""

    kind = "histogram"

    def __init__(self, name: str, description: str = "", boundaries: Sequence[float] = (),
                 tag_keys: Sequence[str] = (), register: bool = True):
        self.boundaries = tuple(boundaries) or LATENCY_MS_BOUNDARIES
        # set BEFORE super().__init__: registration makes this metric
        # visible to the flusher thread, which may snapshot immediately
        self._buckets: dict[tuple, list[int]] = {}
        self._counts: dict[tuple, int] = {}
        super().__init__(name, description, tag_keys, register)

    def observe(self, value: float, tags: dict | None = None) -> None:
        with self._lock:
            key = self._key(tags)
            buckets = self._buckets.setdefault(key, [0] * (len(self.boundaries) + 1))
            idx = sum(1 for b in self.boundaries if value > b)
            buckets[idx] += 1
            self._values[key] = self._values.get(key, 0.0) + value  # sum
            self._counts[key] = self._counts.get(key, 0) + 1

    def observe_many(self, values: Sequence[float],
                     tags: dict | None = None) -> None:
        """Bulk observe: one lock acquisition + tag-key resolution for a
        whole batch. The compiled-loop stall flush records ~192 samples
        per flush on a resident stage's tick path — per-sample observe()
        overhead there is recorder cost the ≤2% budget can't afford."""
        if not values:
            return
        boundaries = self.boundaries
        with self._lock:
            key = self._key(tags)
            buckets = self._buckets.setdefault(
                key, [0] * (len(boundaries) + 1))
            total = 0.0
            for v in values:
                # insertion point left of equals == |{b : b < v}|, the
                # same bucket observe()'s "v > b" scan picks
                buckets[bisect_left(boundaries, v)] += 1
                total += v
            self._values[key] = self._values.get(key, 0.0) + total
            self._counts[key] = self._counts.get(key, 0) + len(values)

    def snapshot(self) -> list[dict]:
        with self._lock:
            out = []
            for key, total in self._values.items():
                out.append({
                    "name": self.name, "type": "histogram",
                    "desc": self.description,
                    "tags": dict(zip(self.tag_keys, key)),
                    "value": total,
                    "count": self._counts.get(key, 0),
                    "buckets": list(self._buckets.get(key, [])),
                    "boundaries": list(self.boundaries),
                })
            return out


_registry_lock = threading.Lock()
_registry: list[_Metric] = []
_flusher: "_Flusher | None" = None


def _registry_add(metric: _Metric) -> None:
    with _registry_lock:
        _registry.append(metric)
    _ensure_flusher()


def snapshot_all() -> list[dict]:
    with _registry_lock:
        metrics = list(_registry)
    out: list[dict] = []
    for m in metrics:
        out.extend(m.snapshot())
    return out


class _Flusher:
    def __init__(self, interval_s: float = 5.0):
        self._interval = interval_s
        self._thread = threading.Thread(target=self._loop, daemon=True, name="raytpu-metrics")
        self._thread.start()

    def _loop(self) -> None:
        from ..core.worker import global_worker

        while True:
            time.sleep(self._interval)
            try:
                worker = global_worker()
                snap = snapshot_all()
                if not snap:
                    continue
                worker._gcs_call(
                    "ReportMetrics",
                    {"worker_id": worker.worker_id, "metrics": snap},
                    timeout=10.0,
                )
            except Exception:
                continue  # never let one bad cycle kill the flusher


def _ensure_flusher() -> None:
    global _flusher
    with _registry_lock:
        if _flusher is None:
            _flusher = _Flusher()


def get_metrics() -> list[dict]:
    """Cluster-wide aggregated metrics from the GCS."""
    from ..core.worker import global_worker

    return global_worker()._gcs_call("GetMetrics", {})["metrics"]


def prometheus_text(metrics: list[dict] | None = None) -> str:
    """Render metrics in the Prometheus exposition format: a ``# HELP`` /
    ``# TYPE`` header per metric family (Prometheus drops metadata — and
    Grafana shows no descriptions — without them), then the samples.
    Histograms emit the full ``_bucket``/``_sum``/``_count`` family
    (cumulative ``le`` buckets) so ``histogram_quantile`` works in
    Grafana."""
    def _esc(v) -> str:
        # Label-value escaping per the exposition format: one bad user tag
        # must not invalidate the whole scrape.
        return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")

    # Group rows by family so HELP/TYPE precede every sample of a name.
    families: dict[str, list[dict]] = {}
    for m in metrics if metrics is not None else get_metrics():
        families.setdefault(m["name"], []).append(m)

    lines = []
    for name, rows in families.items():
        kind = rows[0].get("type") or "gauge"
        kind = kind if kind in ("counter", "gauge", "histogram") else "untyped"
        desc = next((r.get("desc") for r in rows if r.get("desc")), "")
        if desc:
            lines.append(f"# HELP {name} {_esc(desc)}")
        lines.append(f"# TYPE {name} {kind}")
        for m in rows:
            tags = sorted((m.get("tags") or {}).items())
            base = ",".join(f'{k}="{_esc(v)}"' for k, v in tags)
            if m.get("type") == "histogram" and m.get("buckets"):
                cum = 0
                for bound, count in zip(
                        list(m.get("boundaries", [])) + ["+Inf"], m["buckets"]):
                    cum += count
                    le = f'le="{bound}"'
                    label = "{" + (base + "," if base else "") + le + "}"
                    lines.append(f"{name}_bucket{label} {cum}")
                label = f"{{{base}}}" if base else ""
                lines.append(f"{name}_sum{label} {m['value']}")
                lines.append(f"{name}_count{label} {m.get('count', cum)}")
                continue
            label = f"{{{base}}}" if base else ""
            lines.append(f"{name}{label} {m['value']}")
    return "\n".join(lines) + "\n"


def histogram_quantile(snapshot: dict, q: float) -> float | None:
    """Approximate quantile from one histogram snapshot row (linear
    interpolation within the bucket, the Prometheus convention). Returns
    None for an empty histogram."""
    buckets = snapshot.get("buckets") or []
    boundaries = list(snapshot.get("boundaries") or [])
    total = sum(buckets)
    if not total or not boundaries:
        return None
    target = q * total
    cum = 0
    lo = 0.0
    for i, count in enumerate(buckets):
        hi = boundaries[i] if i < len(boundaries) else boundaries[-1]
        if cum + count >= target and count > 0:
            frac = (target - cum) / count
            return lo + (hi - lo) * frac
        cum += count
        lo = hi
    return boundaries[-1]
