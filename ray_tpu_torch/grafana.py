"""Grafana dashboard factory.

Equivalent of the reference's generated Grafana dashboards
(``python/ray/dashboard/modules/metrics/grafana_dashboard_factory.py`` /
``dashboards/default_dashboard_panels.py``): emits a provisioning-ready
dashboard JSON over the Prometheus metrics this framework exports
(``ray_tpu_torch.util.metrics.prometheus_text`` — framework gauges
prefixed ``ray_tpu_`` plus user Counters/Gauges/Histograms).

Usage::

    python -m ray_tpu_torch.grafana > ray_tpu_dashboard.json
    # then import in Grafana, or drop into provisioning/dashboards/

The datasource is templated (``${datasource}``) so the same JSON works
against any Prometheus instance.

The port of ``ray_tpu/grafana.py``. The metric names stay ``ray_tpu_*``:
the port's GCS exports them under those names, ``ray_tpu_hbm_*`` for the
card's memory. The accelerator panels read ``resource="GPU"``.
"""

from __future__ import annotations

import json

_DS = {"type": "prometheus", "uid": "${datasource}"}

# Chart colors follow the validated default palette (one hue per series
# slot, fixed order — see the data-viz method): blue, orange, aqua, yellow.
_SLOT_COLORS = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100"]


def _panel(panel_id: int, title: str, targets: list[dict], *, grid: dict,
           unit: str = "short", kind: str = "timeseries") -> dict:
    return {
        "id": panel_id,
        "title": title,
        "type": kind,
        "datasource": _DS,
        "gridPos": grid,
        "fieldConfig": {
            "defaults": {
                "unit": unit,
                "custom": {
                    "lineWidth": 2,
                    "fillOpacity": 0,
                    "showPoints": "never",
                    "drawStyle": "line",
                },
                "color": {"mode": "palette-classic"},
            },
            "overrides": [
                {
                    "matcher": {"id": "byFrameRefID", "options": chr(ord("A") + i)},
                    "properties": [{
                        "id": "color",
                        "value": {"mode": "fixed", "fixedColor": _SLOT_COLORS[i % len(_SLOT_COLORS)]},
                    }],
                }
                for i in range(len(targets))
            ],
        },
        "targets": [
            {"refId": chr(ord("A") + i), "expr": t["expr"],
             "legendFormat": t.get("legend", "__auto"), "datasource": _DS}
            for i, t in enumerate(targets)
        ],
        "options": {
            "legend": {"displayMode": "list", "placement": "bottom",
                       # A templated legend ({{label}}) fans one target out
                       # into many series — those need the legend too.
                       "showLegend": len(targets) > 1
                       or "{{" in targets[0].get("legend", "")},
            "tooltip": {"mode": "multi", "sort": "desc"},
        },
    }


def _stat(panel_id: int, title: str, expr: str, *, grid: dict,
          unit: str = "short") -> dict:
    p = _panel(panel_id, title, [{"expr": expr}], grid=grid, unit=unit, kind="stat")
    p["options"] = {"reduceOptions": {"calcs": ["lastNotNull"]},
                    "colorMode": "none", "graphMode": "area"}
    return p


def generate_dashboard(title: str = "ray_tpu cluster") -> dict:
    """The default cluster dashboard: nodes / resources / tasks / actors /
    object store / serve, one row each (reference
    ``default_dashboard_panels.py`` panel inventory, GPU-scoped)."""
    W, H = 8, 7  # grid units per panel
    panels = [
        # Row 1: headline stats
        _stat(1, "Nodes alive", 'ray_tpu_nodes{state="ALIVE"}',
              grid={"x": 0, "y": 0, "w": 4, "h": 4}),
        _stat(2, "Actors alive", 'ray_tpu_actors{state="ALIVE"}',
              grid={"x": 4, "y": 0, "w": 4, "h": 4}),
        _stat(3, "Tasks running", 'ray_tpu_tasks{state="RUNNING"}',
              grid={"x": 8, "y": 0, "w": 4, "h": 4}),
        _stat(4, "GPU chips in use",
              "ray_tpu_resource_used{resource=\"GPU\"}",
              grid={"x": 12, "y": 0, "w": 4, "h": 4}),
        _stat(5, "Object store used",
              "sum(ray_tpu_object_store_used_bytes)",
              grid={"x": 16, "y": 0, "w": 4, "h": 4}, unit="bytes"),
        _stat(6, "Placement groups", 'ray_tpu_placement_groups{state="CREATED"}',
              grid={"x": 20, "y": 0, "w": 4, "h": 4}),
        # Row 2: utilization over time
        _panel(10, "CPU utilization", [
            {"expr": 'ray_tpu_resource_used{resource="CPU"}', "legend": "used"},
            {"expr": 'ray_tpu_resource_total{resource="CPU"}', "legend": "total"},
        ], grid={"x": 0, "y": 4, "w": W, "h": H}),
        _panel(11, "GPU utilization", [
            {"expr": 'ray_tpu_resource_used{resource="GPU"}', "legend": "used"},
            {"expr": 'ray_tpu_resource_total{resource="GPU"}', "legend": "total"},
        ], grid={"x": W, "y": 4, "w": W, "h": H}),
        _panel(12, "Object store bytes by node", [
            {"expr": "ray_tpu_object_store_used_bytes", "legend": "{{node_id}} used"},
        ], grid={"x": 2 * W, "y": 4, "w": W, "h": H}, unit="bytes"),
        # Row 3: scheduler / control plane
        _panel(20, "Tasks by state", [
            {"expr": "ray_tpu_tasks", "legend": "{{state}}"},
        ], grid={"x": 0, "y": 4 + H, "w": W, "h": H}),
        _panel(21, "Actors by state", [
            {"expr": "ray_tpu_actors", "legend": "{{state}}"},
        ], grid={"x": W, "y": 4 + H, "w": W, "h": H}),
        _panel(22, "Pending resource demand", [
            {"expr": "ray_tpu_pending_demand", "legend": "{{shape}}"},
        ], grid={"x": 2 * W, "y": 4 + H, "w": W, "h": H}),
        # Row 4: spill + serve
        _panel(30, "Spill / restore throughput", [
            {"expr": "rate(ray_tpu_spill_bytes_total[5m])", "legend": "spilled"},
            {"expr": "rate(ray_tpu_restore_bytes_total[5m])", "legend": "restored"},
        ], grid={"x": 0, "y": 4 + 2 * H, "w": W, "h": H}, unit="Bps"),
        _panel(31, "Serve requests", [
            {"expr": "rate(serve_num_requests_total[1m])", "legend": "{{deployment}}"},
        ], grid={"x": W, "y": 4 + 2 * H, "w": W, "h": H}, unit="reqps"),
        _panel(32, "Serve latency p50", [
            {"expr": "histogram_quantile(0.5, rate(serve_request_latency_ms_bucket[5m]))",
             "legend": "{{deployment}}"},
        ], grid={"x": 2 * W, "y": 4 + 2 * H, "w": W, "h": H}, unit="ms"),
        # Row 5: request-path observability: engine TTFT,
        # router queue wait, and the raylet lease pipeline stages.
        _panel(40, "Serve TTFT p50 / p95", [
            {"expr": "histogram_quantile(0.5, rate(serve_ttft_ms_bucket[5m]))",
             "legend": "p50 {{deployment}}"},
            {"expr": "histogram_quantile(0.95, rate(serve_ttft_ms_bucket[5m]))",
             "legend": "p95 {{deployment}}"},
        ], grid={"x": 0, "y": 4 + 3 * H, "w": W, "h": H}, unit="ms"),
        _panel(41, "Serve router queue wait p95", [
            {"expr": "histogram_quantile(0.95, rate(serve_queue_wait_ms_bucket[5m]))",
             "legend": "{{deployment}}"},
        ], grid={"x": W, "y": 4 + 3 * H, "w": W, "h": H}, unit="ms"),
        _panel(42, "Lease pipeline stage p95", [
            {"expr": "histogram_quantile(0.95, sum by (le, stage) "
                     "(rate(ray_tpu_lease_stage_ms_bucket[5m])))",
             "legend": "{{stage}}"},
        ], grid={"x": 2 * W, "y": 4 + 3 * H, "w": W, "h": H}, unit="ms"),
        # SLO-serving row: the prefix-cache gauge explains TTFT moves
        # (a hit-rate drop = cold prompts = slower prefill), and the
        # per-deployment TTFT p95 is the latency_slo autoscaler's own
        # trigger signal — the panel shows exactly what it reacts to.
        _panel(45, "Prefix cache hit rate", [
            {"expr": "serve_prefix_cache_hit_rate",
             "legend": "{{deployment}}"},
        ], grid={"x": 2 * W, "y": 4 + 4 * H, "w": W, "h": H},
            unit="percentunit"),
        # Chaos injections live NEXT TO the lease-stage / leak panels: a
        # spike here explains spikes there (injected pain vs real pain).
        _panel(43, "Chaos injections by kind", [
            {"expr": "sum by (kind) "
                     "(rate(ray_tpu_chaos_injections_total[5m]))",
             "legend": "{{kind}}"},
        ], grid={"x": 0, "y": 4 + 5 * H, "w": W, "h": H}, unit="ops"),
        _panel(44, "Chaos injections by RPC method", [
            {"expr": "sum by (method) "
                     "(rate(ray_tpu_chaos_injections_total[5m]))",
             "legend": "{{method}}"},
        ], grid={"x": W, "y": 4 + 5 * H, "w": W, "h": H}, unit="ops"),
        # Compiled-loop steady state (dag/loop.py): tick rate per stage
        # proves the zero-RPC path is doing the work; ring occupancy at
        # its credit ceiling pinpoints the backpressuring stage.
        _panel(46, "Compiled-loop ticks by stage", [
            {"expr": "sum by (stage) "
                     "(rate(ray_tpu_dag_loop_ticks_total[1m]))",
             "legend": "{{stage}}"},
        ], grid={"x": 2 * W, "y": 4 + 5 * H, "w": W, "h": H}, unit="ops"),
        _panel(47, "Compiled-loop channel occupancy", [
            {"expr": "ray_tpu_dag_loop_channel_occupancy",
             "legend": "{{stage}}"},
        ], grid={"x": 2 * W, "y": 4 + 6 * H, "w": W, "h": H}),
        # Tick stall attribution: where each resident
        # stage's tick time goes — waiting on upstream input, computing,
        # or waiting on downstream credits. A stage whose wait_down p95
        # tracks another stage's compute p95 IS being backpressured by
        # it; the p95 split names the bottleneck without a profiler.
        _panel(48, "Loop tick stall split p95 (wait_up/compute/wait_down)", [
            {"expr": "histogram_quantile(0.95, sum by (le, stage, bucket) "
                     "(rate(ray_tpu_dag_loop_tick_ms_bucket[5m])))",
             "legend": "{{stage}} {{bucket}}"},
        ], grid={"x": 0, "y": 4 + 6 * H, "w": W, "h": H}, unit="ms"),
        # Per-tenant SLO burn: the fraction of each
        # tenant's recent requests breaching its TTFT SLO — the same
        # number serve.status() shows and breach timeline dumps key off.
        _panel(49, "Tenant SLO burn rate", [
            {"expr": "tenant_slo_burn_frac",
             "legend": "{{deployment}}/{{tenant}}"},
        ], grid={"x": W, "y": 4 + 6 * H, "w": W, "h": H},
            unit="percentunit"),
        # Row 6: memory observability: per-node object-store
        # usage vs capacity/pinned, HBM used vs limit, worker RSS, and the
        # spill-rate-by-node view that pairs with the leak watcher.
        _panel(50, "Object store used / pinned / capacity", [
            {"expr": "ray_tpu_object_store_used_bytes", "legend": "{{node_id}} used"},
            {"expr": "ray_tpu_object_store_pinned_bytes", "legend": "{{node_id}} pinned"},
            {"expr": "ray_tpu_object_store_capacity_bytes", "legend": "{{node_id}} capacity"},
        ], grid={"x": 0, "y": 4 + 4 * H, "w": W, "h": H}, unit="bytes"),
        _panel(51, "HBM used / limit by node", [
            {"expr": "ray_tpu_hbm_used_bytes", "legend": "{{node_id}} used"},
            {"expr": "ray_tpu_hbm_peak_bytes", "legend": "{{node_id}} peak"},
            {"expr": "ray_tpu_hbm_limit_bytes", "legend": "{{node_id}} limit"},
        ], grid={"x": W, "y": 4 + 4 * H, "w": W, "h": H}, unit="bytes"),
        _panel(52, "Worker RSS / spill rate by node", [
            {"expr": "ray_tpu_worker_rss_bytes", "legend": "{{node_id}} rss"},
            {"expr": "rate(ray_tpu_spill_bytes_total[5m])",
             "legend": "{{node_id}} spill Bps"},
        ], grid={"x": 2 * W, "y": 4 + 4 * H, "w": W, "h": H}, unit="bytes"),
    ]
    return {
        "title": title,
        "uid": "ray-tpu-default",
        "tags": ["ray_tpu", "generated"],
        "timezone": "browser",
        "editable": True,
        "schemaVersion": 39,
        "refresh": "10s",
        "time": {"from": "now-1h", "to": "now"},
        "templating": {"list": [{
            "name": "datasource", "type": "datasource", "query": "prometheus",
            "label": "Data source",
        }]},
        "panels": panels,
    }


def main() -> None:
    print(json.dumps(generate_dashboard(), indent=2))


if __name__ == "__main__":
    main()
