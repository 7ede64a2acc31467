"""State API: list/summarize cluster entities.

Equivalent of the reference's ``python/ray/util/state/api.py:110``
(``StateApiClient``, list_actors:784, summarize_tasks:1368) minus the
dashboard hop: queries go straight to the GCS, which is the single source
of truth for nodes/actors/tasks/placement groups in this runtime.

The port of ``ray_tpu/util/state.py``, on the port's GCS, raylets and
Serve; a profile is the worker's ``torch.profiler`` capture.
"""

from __future__ import annotations

from ..core.worker import global_worker


def _gcs(method: str, payload: dict | None = None) -> dict:
    return global_worker()._gcs_call(method, payload or {})


def list_nodes() -> list[dict]:
    return _gcs("GetAllNodes")["nodes"]


def list_actors() -> list[dict]:
    return _gcs("ListActors")["actors"]


def list_tasks(limit: int = 1000) -> list[dict]:
    return _gcs("ListTaskEvents", {"limit": limit})["tasks"]


def list_placement_groups() -> list[dict]:
    return _gcs("ListPlacementGroups")["placement_groups"]


def list_spans(trace_id: str | None = None, limit: int = 1000) -> list[dict]:
    """Trace spans retained by the GCS span store (observability/):
    task submit/lease/spawn/execute hops plus the serve request path
    (http → router → replica batch → llm prefill/decode), connected by
    ``trace_id``/``parent_id``."""
    return _gcs("ListSpans", {"trace_id": trace_id, "limit": limit})["spans"]


def list_traces(limit: int = 100) -> list[dict]:
    """Per-trace summaries (root span, span count, duration)."""
    return _gcs("ListTraces", {"limit": limit})["traces"]


def loop_stats() -> list[dict]:
    """Per-loop stall attribution for every compiled loop THIS process
    compiled (loops are driver-owned objects — there is no cluster-wide
    loop registry): one row per live loop with per-stage
    wait_up/compute/wait_down splits and the bottleneck stage. Stats
    come from node-local snapshot files the resident stages flush on the
    span cadence (no RPC to the parked stage actors)."""
    from ..dag.loop import live_loop_stats

    return live_loop_stats()


def serve_fleet() -> dict:
    """Always-warm fleet view per serve deployment: running vs standby
    replica counts, the scale-to-zero latch, folded replica residency
    (idle age, host-resident weight copies), and the last standby
    promotion with its path and timing — pulled from the controller's
    ``get_app_status`` so ``cli serve status`` and tests see one truth."""
    from ..serve import api as serve_api

    out: dict = {}
    try:
        status = serve_api.status()
    except Exception:
        return out
    for app, deps in (status or {}).items():
        for name, dep in (deps or {}).items():
            out[f"{app}#{name}"] = {
                "running": dep.get("running_replicas"),
                "standby": dep.get("standby_replicas"),
                "target": dep.get("target_replicas"),
                "scaled_to_zero": dep.get("scaled_to_zero"),
                "fleet": dep.get("fleet") or {},
                "last_promote": dep.get("last_promote"),
            }
    return out


def find_request_timeline(request_id: str, limit: int = 200) -> dict | None:
    """The most recent ``llm.request_timeline`` breach dump for one
    request id: scans this process's local span buffer first (standalone
    engines), then recent traces in the GCS span store. Returns the span
    dict (attrs carry the event list) or None."""
    from ..observability import tracing

    def _match(spans):
        hits = [s for s in spans
                if s.get("name") == "llm.request_timeline"
                and (s.get("attrs") or {}).get("request_id") == request_id]
        return max(hits, key=lambda s: s.get("end", 0.0)) if hits else None

    hit = _match(tracing.local_spans())
    if hit is not None:
        return hit
    try:
        for row in list_traces(limit=limit):
            hit = _match(list_spans(trace_id=row["trace_id"]))
            if hit is not None:
                return hit
    except Exception:
        return None
    return None


def _fanout_raylets(method: str, payload: dict, result_key: str) -> list[dict]:
    """Call a raylet RPC on every alive node concurrently; tag each row
    with its node_id. Nodes that fail to answer are skipped."""
    import asyncio

    from ..core.rpc import RpcClient

    nodes = [n for n in list_nodes() if n["state"] == "ALIVE"]
    worker = global_worker()

    async def _one(node):
        client = RpcClient(node["address"])
        try:
            reply = await client.call(method, payload, timeout=10.0)
            rows = reply.get(result_key, [])
            for r in rows:
                r["node_id"] = node["node_id"]
            return rows
        except Exception:
            return []
        finally:
            await client.close()

    async def _all():
        return await asyncio.gather(*(_one(n) for n in nodes))

    return [row for rows in worker.io.run_sync(_all()) for row in rows]


def list_workers() -> list[dict]:
    """Workers across all alive nodes (raylet worker-pool fan-out)."""
    return _fanout_raylets("ListWorkers", {}, "workers")


def list_objects(limit: int = 1000) -> list[dict]:
    """Objects in each node's plasma store, enriched with the owner-side
    reference view (ref type + creation callsite + age from the workers'
    memory summaries). Warns — never silently truncates — when any node's
    listing hit ``limit``."""
    import asyncio
    import warnings

    from ..core.rpc import RpcClient

    nodes = [n for n in list_nodes() if n["state"] == "ALIVE"]
    worker = global_worker()

    async def _one(node):
        client = RpcClient(node["address"])
        try:
            reply = await client.call("ListObjects", {"limit": limit}, timeout=10.0)
            for r in reply.get("objects", []):
                r["node_id"] = node["node_id"]
            return reply
        except Exception:
            return {"objects": []}
        finally:
            await client.close()

    async def _all():
        return await asyncio.gather(*(_one(n) for n in nodes))

    replies = worker.io.run_sync(_all())
    rows = [row for reply in replies for row in reply.get("objects", [])]
    truncated = [r for r in replies if r.get("truncated")]
    if truncated:
        warnings.warn(
            f"list_objects(limit={limit}) truncated: "
            f"{sum(r.get('total', 0) for r in truncated)} objects exist on "
            f"{len(truncated)} node(s); raise limit for the full view",
            stacklevel=2)
    # Merge in the reference-debugging fields reported by owners.
    by_oid: dict[str, dict] = {}
    try:
        for w in memory_summary().get("workers", []):
            for e in w.get("entries", []):
                by_oid.setdefault(e.get("object_id", ""), e)
    except Exception:
        pass
    for row in rows:
        ref = by_oid.get(row.get("object_id", ""))
        if ref:
            row.setdefault("size", ref.get("size", 0))
            row["ref_type"] = ref.get("ref_type", "")
            row["callsite"] = ref.get("callsite", "")
            row["age_s"] = round(ref.get("age_s", 0.0), 1)
    return rows


def memory_summary() -> dict:
    """Cluster memory view (reference ``ray memory`` /
    ``memory_summary()``): per-worker reference tables with object sizes,
    ref types (LOCAL_REFERENCE / USED_BY_PENDING_TASK / ...), creation
    callsites, and ages, aggregated by the GCS from the workers' periodic
    reports on the task-event flush path."""
    return _gcs("MemorySummary")["summary"]


def capture_profile(node_id: str | None = None, duration: float = 2.0,
                    worker_id: str | None = None) -> dict:
    """Trigger an on-demand ``torch.profiler`` trace capture on a worker of
    ``node_id`` (prefix match; default: this node) and return the artifact
    info (``{"path", "worker_id", "node_id", "duration"}`` or
    ``{"error"}``). The artifact is also registered under
    ``list_profiles()`` / dashboard ``/api/profiles``."""
    import asyncio

    from ..core.rpc import RpcClient

    worker = global_worker()
    nodes = [n for n in list_nodes() if n["state"] == "ALIVE"]
    if node_id:
        nodes = [n for n in nodes if n["node_id"].startswith(node_id)]
        if not nodes:
            return {"error": f"no alive node matching {node_id!r}"}
    else:
        nodes = [n for n in nodes if n["node_id"] == worker.node_id] or nodes
    node = nodes[0]

    async def _call():
        client = RpcClient(node["address"])
        try:
            return await client.call(
                "CaptureProfile",
                {"duration": duration, "worker_id": worker_id or ""},
                timeout=duration + 150.0)
        finally:
            await client.close()

    return worker.io.run_sync(_call())


def list_profiles() -> list[dict]:
    """Profiler artifacts captured via ``capture_profile`` / ``cli
    profile``, most recent last."""
    return _gcs("ListProfiles")["profiles"]


def summarize_tasks() -> dict:
    """Counts by (name, state) — reference summarize_tasks:1368."""
    summary: dict[str, dict[str, int]] = {}
    for t in list_tasks(limit=100_000):
        entry = summary.setdefault(t["name"], {})
        entry[t["state"]] = entry.get(t["state"], 0) + 1
    return summary


# ------------------------------------------------------------- diagnostics
def list_errors(source: str | None = None, error_type: str | None = None,
                limit: int = 100) -> list[dict]:
    """Structured ErrorEvents retained by the GCS error-info channel:
    raising tasks, failed actor/replica starts, OOM kills, lease-wedge
    watchdog reports (reference: the driver's error-message listener over
    RAY_ERROR_INFO_CHANNEL, surfaced as a state API)."""
    return _gcs("ListErrors", {
        "source": source, "type": error_type, "limit": limit,
    })["errors"]


def cluster_diagnostics(error_limit: int = 50) -> dict:
    """One aggregated doctor view: the GCS control-plane snapshot, every
    alive raylet's debug state (lease queue with ages, worker pool,
    store/spill/OOM counters), and the most recent ErrorEvents."""
    import asyncio

    from ..core.rpc import RpcClient

    nodes = [n for n in list_nodes() if n["state"] == "ALIVE"]
    worker = global_worker()

    async def _one(node):
        client = RpcClient(node["address"])
        try:
            reply = await client.call("GetDebugState", {}, timeout=10.0)
            snap = reply.get("debug_state") or {}
            snap.setdefault("node_id", node["node_id"])
            return snap
        except Exception as e:
            return {"node_id": node["node_id"], "unreachable": str(e)}
        finally:
            await client.close()

    async def _all():
        return await asyncio.gather(*(_one(n) for n in nodes))

    from ..chaos.runner import active_plan

    return {
        "gcs": _gcs("GetDebugState").get("debug_state", {}),
        "nodes": list(worker.io.run_sync(_all())),
        "errors": list_errors(limit=error_limit),
        # Registered FaultPlan, if chaos is running — operators must be
        # able to tell injected pain from real pain.
        "active_fault_plan": active_plan(),
    }
