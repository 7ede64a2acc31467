"""GCS — the cluster-wide control plane.

Equivalent of the reference's ``GcsServer`` (``src/ray/gcs/gcs_server/
gcs_server.h:89``) composed of the same managers:

  * NodeManager        — registration, resource views, death broadcast
  * ActorManager       — actor registration/creation/restart FSM
                         (``gcs_actor_manager.h:324``, RestartActor .cc:565)
  * JobManager         — job table
  * InternalKV         — cluster KV (function table, named things)
  * Publisher          — long-poll pub/sub (``src/ray/pubsub/publisher.h:300``)
  * HealthCheckManager — periodic raylet pings (``gcs_health_check_manager.h:61``)

Storage defaults to in-memory (the reference's ``InMemoryStoreClient``);
with ``gcs_storage_backend=file`` the durable tables snapshot to disk
(``gcs_storage.py``) and a restarted GCS recovers them — the raylets
re-register on heartbeat, standing in for the reference's Redis-backed
fault tolerance (``redis_store_client.h:107``).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any

from .config import get_config
from .ids import ActorID, NodeID
from .rpc import RetryableRpcClient, RpcClient, RpcServer, spawn
from ..chaos import clock as chaos_clock

logger = logging.getLogger(__name__)

# Actor FSM states (reference rpc::ActorTableData::ActorState).
DEPENDENCIES_UNREADY = "DEPENDENCIES_UNREADY"
PENDING_CREATION = "PENDING_CREATION"
ALIVE = "ALIVE"
RESTARTING = "RESTARTING"
DEAD = "DEAD"


class Publisher:
    """Per-channel sequenced message log with long-poll subscribers.

    Fan-out is BATCHED (reference ``pubsub/publisher.h`` buffered
    per-subscriber mailboxes): a publish appends to the channel log and
    schedules ONE deferred wake covering every publish that lands within
    ``gcs_pubsub_batch_window_ms`` — so 1k actor-state churns per flush
    cost one ``notify_all`` instead of 1k, and each woken subscriber
    drains everything past its cursor in one bounded reply
    (``gcs_pubsub_max_batch_msgs`` per channel). Cursor scans are O(new
    messages): sequences are contiguous per channel, so the resume point
    is index arithmetic, not a filter over the whole buffer."""

    def __init__(self, max_buffer: int = 10000):
        self._channels: dict[str, list[tuple[int, Any]]] = {}
        self._seqs: dict[str, int] = {}
        self._cond = asyncio.Condition()
        self._max_buffer = max_buffer
        self._notify_scheduled = False
        # Fan-out evidence (GCS debug_state): wake batching ratio.
        self.publishes_total = 0
        self.notify_batches_total = 0

    async def publish(self, channel: str, message: Any) -> None:
        # Single-loop store: the append is atomic on the event loop; only
        # the wake needs the condition's lock (taken in _notify_waiters).
        seq = self._seqs.get(channel, 0) + 1
        self._seqs[channel] = seq
        buf = self._channels.setdefault(channel, [])
        buf.append((seq, message))
        self.publishes_total += 1
        if len(buf) > self._max_buffer:
            del buf[: len(buf) // 2]
        window_s = get_config().gcs_pubsub_batch_window_ms / 1000.0
        if window_s <= 0:
            await self._notify_waiters()
        elif not self._notify_scheduled:
            self._notify_scheduled = True
            loop = asyncio.get_running_loop()
            loop.call_later(
                window_s,
                lambda: loop.create_task(self._notify_waiters()))

    async def _notify_waiters(self) -> None:
        self._notify_scheduled = False
        self.notify_batches_total += 1
        async with self._cond:
            self._cond.notify_all()

    def current_seq(self, channel: str) -> int:
        return self._seqs.get(channel, 0)

    def _pending(self, cursors: dict[str, int],
                 max_msgs: int) -> dict[str, list]:
        out: dict[str, list] = {}
        for channel, cursor in cursors.items():
            buf = self._channels.get(channel)
            if not buf:
                continue
            # Sequences are contiguous within the buffer: resume index is
            # arithmetic off the head's seq (O(1)), not a full scan.
            start = max(0, cursor - buf[0][0] + 1) if cursor >= buf[0][0] else 0
            if start < len(buf):
                out[channel] = buf[start:start + max_msgs]
        return out

    async def poll(self, cursors: dict[str, int], timeout: float) -> dict[str, list]:
        """Long-poll: block until any channel has messages past its cursor."""
        deadline = time.monotonic() + timeout
        max_msgs = max(1, get_config().gcs_pubsub_max_batch_msgs)
        async with self._cond:
            while True:
                out = self._pending(cursors, max_msgs)
                if out:
                    return out
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {}
                try:
                    await asyncio.wait_for(self._cond.wait(), remaining)
                except asyncio.TimeoutError:
                    return {}


class GcsServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0, storage=None,
                 session_dir: str | None = None):
        self._server = RpcServer(host, port, tag="gcs")
        self._server.register_service(self)
        self.publisher = Publisher()
        self._session_dir = session_dir
        # Fault tolerance (redis_store_client.h equivalent): durable tables
        # snapshot through `storage`; a restarted GCS restores them and
        # raylets re-register on their next heartbeat.
        from .gcs_storage import MemoryStorage

        self._storage = storage or MemoryStorage()
        self._last_snapshot: bytes = b""
        self._persist_task: asyncio.Task | None = None
        # Every background coroutine (actor creation, PG scheduling) is
        # tracked so crash()/stop() can cancel them — a "dead" GCS must not
        # keep leasing workers on the shared test event loop (split-brain).
        self._bg_tasks: set[asyncio.Task] = set()
        # node_id(hex) -> {address, resources{total,available,labels}, state,
        #                  last_heartbeat}
        self._nodes: dict[str, dict] = {}
        self._raylet_clients: dict[str, RpcClient] = {}
        # Durable tables ride the sharded store client (one lock per key
        # shard — the reference's store_client/ split) so writes from
        # off-loop ingest threads and the event loop never convoy on one
        # table lock and stay linearizable per key.
        from .store_client import ShardedKv

        shards = get_config().gcs_store_shards
        # actor_id(hex) -> record
        self._actors: ShardedKv = ShardedKv(shards)
        self._named_actors: dict[str, str] = {}  # name -> actor_id hex
        self._jobs: dict[str, dict] = {}
        self._next_job = 1
        self._kv: ShardedKv = ShardedKv(shards)
        self._health_task: asyncio.Task | None = None
        self._placement_groups: dict[str, dict] = {}
        # Observability: task-event ring (gcs_task_manager.h) + per-worker
        # metric snapshots (stats/metric.h aggregation point).
        from .task_events import GcsTaskEventStore
        from ..observability.spans import GcsSpanStore
        from ..util.metrics import Histogram

        # Lease-stage latency histograms, fed at event ingest (submit→lease,
        # queue wait, worker spawn, lease→run). Private (register=False):
        # the GCS often shares a process with a driver whose metrics flusher
        # would otherwise re-report this registry back to us — these are
        # merged into GetMetrics directly via _framework_metrics.
        self._lease_stage_hist = Histogram(
            "ray_tpu_lease_stage_ms",
            "Task lease pipeline stage durations (submit to lease, lease "
            "queue wait, worker spawn/setup, lease to run)",
            tag_keys=("stage", "node_id"), register=False)
        self.task_events = GcsTaskEventStore(
            max_tasks=get_config().task_events_buffer_size,
            on_stage=lambda stage, ms, node: self._lease_stage_hist.observe(
                ms, {"stage": stage, "node_id": (node or "")[:12]}),
        )
        # Trace spans flushed on the task-event path (status SPAN).
        self.span_store = GcsSpanStore(
            max_spans=get_config().span_events_buffer_size)
        # Per-worker memory summaries flushed on the same path (status
        # MEMORY) + the trend histories the leak watcher scans.
        from ..observability.memory import GcsMemoryStore

        self.memory_store = GcsMemoryStore()
        self._memory_watch_task: asyncio.Task | None = None
        # On-demand profiler artifacts registered by raylets (cli profile).
        self._profiles: list[dict] = []
        self._metrics: dict[str, tuple[float, list[dict]]] = {}  # worker -> (ts, snapshot)
        # Error-info table: retained ErrorEvents behind the pub/sub channel
        # (reference ErrorInfoHandler / RAY_ERROR_INFO_CHANNEL).
        self._errors: list[dict] = []
        self._debug_dump_task: asyncio.Task | None = None

    # ------------------------------------------------------------------ util
    def _spawn(self, coro) -> asyncio.Task:
        task = spawn(coro)
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)
        return task

    def _cancel_bg(self) -> None:
        if self._health_task:
            self._health_task.cancel()
        if self._persist_task:
            self._persist_task.cancel()
        if self._debug_dump_task:
            self._debug_dump_task.cancel()
        if self._memory_watch_task:
            self._memory_watch_task.cancel()
        for task in list(self._bg_tasks):
            task.cancel()

    async def start(self) -> None:
        self._restore()
        await self._server.start()
        self._health_task = spawn(self._health_check_loop())
        self._persist_task = spawn(self._persist_loop())
        self._memory_watch_task = spawn(self._memory_watch_loop())
        if self._session_dir:
            self._debug_dump_task = spawn(self._debug_dump_loop())

    async def stop(self) -> None:
        self._cancel_bg()
        self._flush()
        await self._server.stop()

    async def crash(self) -> None:
        """Die WITHOUT a final flush — simulates abrupt GCS process death
        for fault-tolerance tests (only snapshots the persist loop already
        wrote survive)."""
        self._cancel_bg()
        await self._server.stop(grace=0.0)

    @property
    def port(self) -> int:
        return int(self.address.rsplit(":", 1)[1])

    # -------------------------------------------------------- fault tolerance
    def _tables(self) -> dict:
        return {
            "kv": self._kv.to_dict(),
            "jobs": self._jobs,
            "next_job": self._next_job,
            "actors": self._actors.to_dict(),
            "named_actors": self._named_actors,
            "placement_groups": self._placement_groups,
        }

    def _flush(self) -> None:
        """Snapshot the durable tables if they changed. Change detection by
        comparing the packed blob — cheaper than instrumenting every
        mutation site and can never miss one."""
        if not self._storage.persistent:
            return
        from .gcs_storage import pack_tables

        try:
            blob = pack_tables(self._tables())
            if blob != self._last_snapshot:
                self._storage.save_blob(blob)
                self._last_snapshot = blob
        except Exception:
            logger.exception("GCS table snapshot failed")

    def _restore(self) -> None:
        tables = self._storage.load()
        if not tables:
            return
        from .store_client import ShardedKv

        shards = get_config().gcs_store_shards
        self._kv = ShardedKv(shards, tables.get("kv", {}))
        self._jobs = tables.get("jobs", {})
        self._next_job = tables.get("next_job", 1)
        self._named_actors = tables.get("named_actors", {})
        self._placement_groups = tables.get("placement_groups", {})
        # Restored ALIVE actors keep their addresses — the processes are
        # still running and clients reconnect transparently. Actors that
        # were mid-creation or mid-restart lost their coroutine with the
        # old GCS; their specs are durable, so creation is re-driven
        # (reference gcs_actor_manager reconstruction on restart).
        self._actors = ShardedKv(shards, tables.get("actors", {}))
        for record in self._actors.values():
            if record["state"] in (PENDING_CREATION, RESTARTING):
                self._spawn(self._create_actor(record))
        for record in self._placement_groups.values():
            if record["state"] == "PENDING":
                self._spawn(self._schedule_pg_loop(record))
        logger.info(
            "GCS restored %d kv keys, %d actors, %d jobs, %d placement groups",
            len(self._kv), len(self._actors), len(self._jobs),
            len(self._placement_groups),
        )

    async def _persist_loop(self) -> None:
        while True:
            await asyncio.sleep(0.2)
            self._flush()

    @property
    def address(self) -> str:
        return self._server.address

    def _raylet(self, node_id_hex: str) -> RpcClient | None:
        node = self._nodes.get(node_id_hex)
        if node is None or node["state"] != "ALIVE":
            return None
        client = self._raylet_clients.get(node_id_hex)
        if client is None:
            client = RetryableRpcClient(node["address"])
            self._raylet_clients[node_id_hex] = client
        return client

    # ----------------------------------------------------------- node manager
    async def handle_RegisterNode(self, p: dict) -> dict:
        node_id = p["node_id"].hex() if isinstance(p["node_id"], bytes) else p["node_id"]
        self._nodes[node_id] = {
            "node_id": node_id,
            "address": p["address"],
            "object_store_path": p.get("object_store_path", ""),
            "object_store_capacity": p.get("object_store_capacity", 0),
            "resources": p["resources"],
            "state": "ALIVE",
            "last_heartbeat": time.time(),
        }
        await self.publisher.publish("node", {"node_id": node_id, "state": "ALIVE"})
        logger.info("Node %s registered at %s", node_id[:8], p["address"])
        # New capacity invalidates INFEASIBLE verdicts: re-run scheduling
        # for groups that timed out waiting (the autoscaler may have
        # launched this node precisely for them).
        for record in self._placement_groups.values():
            if record["state"] == "INFEASIBLE":
                record["state"] = "PENDING"
                self._spawn(self._schedule_pg_loop(record))
        return {"node_id": node_id}

    async def handle_Heartbeat(self, p: dict) -> dict:
        node = self._nodes.get(p["node_id"])
        if node is None:
            return {"unknown": True}
        node["last_heartbeat"] = time.time()
        if p.get("draining") and not node.get("draining"):
            # Heartbeat-carried drain flag: belt-and-braces sync in case
            # the explicit ReportNodeDraining RPC was lost.
            await self._note_node_draining(
                p["node_id"], p.get("drain_reason", "raylet heartbeat"),
                notice_clock=p.get("drain_notice_clock"))
        if "resources" in p and p["resources"]:
            node["resources"] = p["resources"]
        node["pending_demand"] = p.get("pending_demand", [])
        if "store" in p:
            node["store"] = p["store"]
            # Feed the leak watcher's per-node pinned-bytes trend history.
            self.memory_store.report_node(
                p["node_id"], p["store"].get("pinned_bytes", 0))
        if "hbm" in p:
            node["hbm"] = p["hbm"]
        if "worker_rss_bytes" in p:
            node["worker_rss_bytes"] = p["worker_rss_bytes"]
        # Bundle reconciliation (reference: GCS-restart bundle cleanup):
        # the raylet cancels reservations whose group no longer exists —
        # half-committed 2PC bundles from before a GCS crash would
        # otherwise pin their resources forever.
        return {"live_pgs": list(self._placement_groups.keys())}

    async def handle_GetAllNodes(self, p: dict) -> dict:
        return {"nodes": list(self._nodes.values())}

    async def handle_PublishLogs(self, p: dict) -> dict:
        """Raylet log monitors forward worker output here; drivers long-
        poll it via PollLogs (reference: log pubsub through the GCS)."""
        await self.publisher.publish(
            "logs", {"node_id": p["node_id"], "batch": p["batch"]}
        )
        return {}

    async def handle_PollLogs(self, p: dict) -> dict:
        cursor = p.get("cursor")
        if cursor is None:
            # Baseline request: a newly connected driver starts at the
            # CURRENT end so it doesn't replay other drivers' history.
            return {"cursor": self.publisher.current_seq("logs"), "messages": []}
        out = await self.publisher.poll({"logs": cursor}, p.get("timeout", 10.0))
        msgs = out.get("logs", [])
        return {
            "cursor": msgs[-1][0] if msgs else cursor,
            "messages": [m for _, m in msgs],
        }

    async def handle_DrainNode(self, p: dict) -> dict:
        await self._mark_node_dead(p["node_id"], "drained")
        return {}

    # ------------------------------------------------------------- preemption
    async def handle_ReportNodeDraining(self, p: dict) -> dict:
        """A raylet received a preemption notice and entered draining.
        The node stays ALIVE (it still serves objects and in-flight work)
        but is flagged ``draining`` — schedulers, the autoscaler, and the
        serve controller all treat it as capacity that is about to
        vanish — and a ``node_preempted`` ErrorEvent goes out so
        consumers react to the NOTICE, not the eventual death."""
        if p["node_id"] not in self._nodes:
            return {"unknown": True}
        await self._note_node_draining(
            p["node_id"], p.get("reason", ""),
            notice_clock=p.get("notice_clock"), grace_s=p.get("grace_s"))
        return {}

    async def _note_node_draining(self, node_id: str, reason: str,
                                  notice_clock=None, grace_s=None) -> None:
        node = self._nodes.get(node_id)
        if node is None or node.get("draining") or node["state"] != "ALIVE":
            return
        node["draining"] = True
        node["drain_reason"] = reason
        node["drain_notice_clock"] = (
            float(notice_clock) if notice_clock else chaos_clock.now())
        logger.warning("node %s draining (%s)", node_id[:8], reason)
        from ..diagnostics.errors import make_event

        await self.handle_PublishError({"event": make_event(
            "node_preempted",
            f"node {node_id[:8]} received a preemption notice ({reason}); "
            "draining",
            source="gcs", node_id=node_id,
            extra={"reason": reason, "grace_s": grace_s,
                   "notice_clock": node["drain_notice_clock"]})})

    async def handle_NodePreempted(self, p: dict) -> dict:
        """The drain grace expired: the node is gone (the cloud reclaimed
        the VM). Terminal — actors there restart elsewhere."""
        await self._mark_node_dead(
            p["node_id"], f"preempted ({p.get('reason', '')})")
        return {}

    async def _health_check_loop(self) -> None:
        cfg = get_config()
        period = cfg.health_check_period_ms / 1000.0
        failures: dict[str, int] = {}
        while True:
            await chaos_clock.sleep(period)
            for node_id, node in list(self._nodes.items()):
                if node["state"] != "ALIVE":
                    continue
                client = self._raylet(node_id)
                try:
                    await client.call("HealthCheck", {}, timeout=period * 2)
                    failures[node_id] = 0
                except Exception:
                    failures[node_id] = failures.get(node_id, 0) + 1
                    if failures[node_id] >= cfg.health_check_failure_threshold:
                        await self._mark_node_dead(node_id, "health check failed")

    async def _mark_node_dead(self, node_id: str, reason: str) -> None:
        node = self._nodes.get(node_id)
        if node is None or node["state"] == "DEAD":
            return
        node["state"] = "DEAD"
        logger.warning("Node %s marked DEAD (%s)", node_id[:8], reason)
        await self.publisher.publish("node", {"node_id": node_id, "state": "DEAD"})
        self._raylet_clients.pop(node_id, None)
        # Restart / fail actors that lived there (gcs_actor_manager.cc
        # OnNodeDead).
        for actor in list(self._actors.values()):
            if actor.get("node_id") == node_id and actor["state"] in (ALIVE, PENDING_CREATION):
                await self._restart_or_kill_actor(actor, f"node {node_id[:8]} died")

    # ---------------------------------------------------------- job manager
    async def handle_AddJob(self, p: dict) -> dict:
        job_id = self._next_job
        self._next_job += 1
        self._jobs[str(job_id)] = {
            "job_id": job_id,
            "driver_address": p.get("driver_address", ""),
            "start_time": time.time(),
            "state": "RUNNING",
        }
        return {"job_id": job_id}

    async def handle_FinishJob(self, p: dict) -> dict:
        job = self._jobs.get(str(p["job_id"]))
        if job:
            job["state"] = "FINISHED"
            job["end_time"] = time.time()
        return {}

    async def handle_GetAllJobs(self, p: dict) -> dict:
        return {"jobs": list(self._jobs.values())}

    # ------------------------------------------------------------ internal KV
    async def handle_KvPut(self, p: dict) -> dict:
        key = p["key"]
        overwrite = p.get("overwrite", True)
        exists = key in self._kv
        if exists and not overwrite:
            return {"added": False}
        self._kv[key] = p["value"]
        return {"added": not exists}

    async def handle_KvGet(self, p: dict) -> dict:
        value = self._kv.get(p["key"])
        return {"value": value, "found": value is not None}

    async def handle_KvDel(self, p: dict) -> dict:
        existed = self._kv.pop(p["key"], None) is not None
        return {"deleted": existed}

    async def handle_KvKeys(self, p: dict) -> dict:
        return {"keys": self._kv.keys_with_prefix(p.get("prefix", ""))}

    # --------------------------------------------------------- observability
    async def handle_AddTaskEvents(self, p: dict) -> dict:
        from .task_events import MEMORY, SPAN

        # ONE routing pass per batch (a 100k-task bench flushes tens of
        # thousands of events per interval — the old triple list scan was
        # measurable GIL time), then one locked store ingestion; coalesced
        # events (status-transition bundles) expand inside the store.
        task_events: list[dict] = []
        spans: list[dict] = []
        for e in p.get("events") or []:
            status = e.get("status")
            if status == MEMORY:
                summary = e.get("memory")
                if summary:
                    self.memory_store.report(summary)
            elif status == SPAN:
                # Stamp recorder identity onto the span at ingest so the
                # chrome trace can group tracks per recording worker.
                s = dict(e.get("span") or {})
                s.setdefault("worker_id", e.get("worker_id", ""))
                s.setdefault("node_id", e.get("node_id", ""))
                spans.append(s)
            else:
                task_events.append(e)
        if spans:
            self.span_store.add(spans)
        dropped = p.get("dropped", 0)
        if task_events or dropped:
            # Ingest OFF the event loop: a 100k-task bench flushes tens
            # of thousands of events per interval, and chewing them
            # inline blocked every other RPC (heartbeats, leases) for the
            # duration. The store is sharded with per-shard locks, so
            # flush batches from N raylets ingest concurrently in
            # executor threads.
            await asyncio.get_running_loop().run_in_executor(
                None, self.task_events.add_events, task_events, dropped)
        return {}

    async def handle_ListTaskEvents(self, p: dict) -> dict:
        return {"tasks": self.task_events.list_tasks(p.get("limit", 1000))}

    async def handle_MemorySummary(self, p: dict) -> dict:
        """Merged per-worker memory summaries (state.memory_summary /
        cli memory / dashboard /api/memory)."""
        return {"summary": self.memory_store.summary()}

    async def handle_RegisterProfile(self, p: dict) -> dict:
        """A raylet registers a finished torch.profiler capture artifact."""
        entry = dict(p.get("profile") or {})
        entry.setdefault("ts", time.time())
        self._profiles.append(entry)
        del self._profiles[: max(0, len(self._profiles) - 100)]
        return {}

    async def handle_ListProfiles(self, p: dict) -> dict:
        return {"profiles": list(self._profiles)}

    async def _memory_watch_loop(self) -> None:
        """Leak watcher: scan the memory store's trend histories and turn
        monotonic growth (a worker's refcount table, a raylet's pinned
        bytes) into a diagnostics ErrorEvent naming the top holders by
        callsite (ROADMAP 1c). Re-reads the config each tick so tests and
        live operators can retune thresholds without a restart."""
        from ..observability.memory import leak_event_message
        from ..diagnostics.errors import make_event

        while True:
            cfg = get_config()
            await chaos_clock.sleep(max(0.1, cfg.memory_leak_check_interval_s))
            if cfg.memory_leak_intervals <= 0:
                continue
            try:
                suspects = self.memory_store.detect_leaks(
                    intervals=cfg.memory_leak_intervals,
                    min_growth_bytes=cfg.memory_leak_min_growth_bytes,
                    min_growth_refs=cfg.memory_leak_min_growth_refs)
                for s in suspects:
                    logger.warning("memory leak watcher: %s", leak_event_message(s))
                    await self.handle_PublishError({"event": make_event(
                        "memory_leak", leak_event_message(s), source="gcs",
                        node_id=s.get("node_id", ""),
                        worker_id=s.get("worker_id", ""),
                        extra={"suspect": s})})
            except Exception:
                logger.exception("memory leak watcher scan failed")

    async def handle_ListSpans(self, p: dict) -> dict:
        return {"spans": self.span_store.list_spans(
            p.get("trace_id"), p.get("limit", 1000))}

    async def handle_ListTraces(self, p: dict) -> dict:
        return {"traces": self.span_store.list_traces(p.get("limit", 100))}

    async def handle_Timeline(self, p: dict) -> dict:
        # Task slices + trace spans in one chrome trace: spans appear as
        # nested per-trace flows alongside the per-node task tracks.
        return {"trace": self.task_events.chrome_trace()
                + self.span_store.chrome_trace()}

    # ----------------------------------------------------------- error info
    async def handle_PublishError(self, p: dict) -> dict:
        """Record + broadcast an ErrorEvent (reference
        ``publish_error_to_driver`` → RAY_ERROR_INFO_CHANNEL). The event is
        retained in a bounded table for ``ListErrors`` AND published on the
        long-poll channel for live driver subscribers."""
        from ..diagnostics.errors import ERROR_INFO_CHANNEL

        event = dict(p.get("event") or {})
        event.setdefault("timestamp", time.time())
        self._errors.append(event)
        max_events = get_config().error_info_buffer_size
        if len(self._errors) > max_events:
            del self._errors[: len(self._errors) - max_events]
        await self.publisher.publish(ERROR_INFO_CHANNEL, event)
        return {}

    async def handle_ListErrors(self, p: dict) -> dict:
        """Filtered view of retained ErrorEvents. ``limit=0`` returns no
        events — used by drivers to fetch just the channel cursor before
        subscribing (no history replay)."""
        from ..diagnostics.errors import ERROR_INFO_CHANNEL

        source, etype = p.get("source"), p.get("type")
        limit = p.get("limit", 100)
        out = [
            e for e in self._errors
            if (not source or e.get("source") == source)
            and (not etype or e.get("type") == etype)
        ]
        return {
            "errors": out[-limit:] if limit else [],
            "cursor": self.publisher.current_seq(ERROR_INFO_CHANNEL),
        }

    def _debug_state_snapshot(self) -> dict:
        """Control-plane FSM counts (the GCS half of debug_state.txt)."""
        def by_state(records, key: str = "state") -> dict[str, int]:
            out: dict[str, int] = {}
            for r in records:
                s = r.get(key, "?")
                out[s] = out.get(s, 0) + 1
            return out

        return {
            "num_nodes": len(self._nodes),
            "nodes_by_state": by_state(self._nodes.values()),
            "actors_by_state": by_state(self._actors.values()),
            "named_actors": len(self._named_actors),
            "placement_groups_by_state": by_state(self._placement_groups.values()),
            "jobs_by_state": by_state(self._jobs.values()),
            "kv_keys": len(self._kv),
            "tasks_by_state": self.task_events.count_by_state(),
            "errors_buffered": len(self._errors),
            "spans_buffered": self.span_store.size(),
            "memory_reports": self.memory_store.size(),
            "memory_leaks_flagged_total": self.memory_store.leaks_flagged_total,
            "profiles_registered": len(self._profiles),
            "pubsub_publishes_total": self.publisher.publishes_total,
            "pubsub_notify_batches_total": self.publisher.notify_batches_total,
        }

    async def handle_GetDebugState(self, p: dict) -> dict:
        return {"debug_state": self._debug_state_snapshot()}

    async def _debug_dump_loop(self) -> None:
        """Periodic ``debug_state_gcs.txt`` in the session dir (reference:
        every component dumps its DebugString on an interval)."""
        import os

        from ..diagnostics.debug_state import write_debug_state

        last = 0.0
        while True:
            await asyncio.sleep(0.5)
            interval = get_config().debug_state_dump_interval_s
            now = time.monotonic()
            if interval <= 0 or now - last < interval:
                continue
            last = now
            try:
                path = os.path.join(self._session_dir, "debug_state_gcs.txt")
                snapshot = self._debug_state_snapshot()
                await asyncio.get_running_loop().run_in_executor(
                    None, write_debug_state, path, "GCS", snapshot)
            except Exception:
                logger.exception("GCS debug-state dump failed")

    async def handle_ListPlacementGroups(self, p: dict) -> dict:
        return {
            "placement_groups": [
                {"pg_id": r["pg_id"], "state": r["state"], "strategy": r["strategy"],
                 "bundles": r["bundles"], "name": r.get("name", "")}
                for r in self._placement_groups.values()
            ]
        }

    async def handle_ReportMetrics(self, p: dict) -> dict:
        self._metrics[p["worker_id"]] = (time.time(), p.get("metrics") or [])
        return {}

    async def handle_GetMetrics(self, p: dict) -> dict:
        """Aggregate across workers: counters/histogram sums add, gauges
        add (per-worker gauges are usually disjoint by tags). Snapshots
        from workers silent for >30s (dead) are dropped."""
        now = time.time()
        merged: dict[tuple, dict] = {}
        for worker_id, (ts, snapshot) in list(self._metrics.items()):
            if now - ts > 30.0:
                del self._metrics[worker_id]
                continue
            for m in snapshot:
                key = (m["name"], tuple(sorted((m.get("tags") or {}).items())))
                cur = merged.get(key)
                if cur is None:
                    merged[key] = dict(m)
                elif m.get("type") == "histogram":
                    cur["value"] = cur.get("value", 0.0) + m.get("value", 0.0)
                    cur["count"] = cur.get("count", 0) + m.get("count", 0)
                    if cur.get("boundaries") == m.get("boundaries"):
                        cur["buckets"] = [
                            a + b for a, b in zip(cur.get("buckets", []), m.get("buckets", []))
                        ]
                    else:  # incompatible shapes: bucket detail unavailable
                        cur.pop("buckets", None)
                else:
                    cur["value"] = cur.get("value", 0.0) + m.get("value", 0.0)
        return {"metrics": list(merged.values()) + self._framework_metrics()}

    def _framework_metrics(self) -> list[dict]:
        """Cluster-state gauges (``ray_tpu_*``) synthesized from GCS tables
        on every scrape — nodes/actors/tasks/PGs by state, per-resource
        totals and usage, pending demand. These back the generated Grafana
        dashboard (``ray_tpu/grafana.py``; reference
        ``dashboard/modules/metrics/grafana_dashboard_factory.py``)."""
        out: list[dict] = []

        def gauge(name: str, value: float, **tags) -> None:
            out.append({"name": name, "type": "gauge", "value": value, "tags": tags})

        by_state: dict[str, int] = {}
        for n in self._nodes.values():
            by_state[n.get("state", "?")] = by_state.get(n.get("state", "?"), 0) + 1
        for state, count in by_state.items():
            gauge("ray_tpu_nodes", count, state=state)

        totals: dict[str, float] = {}
        avail: dict[str, float] = {}
        demand: dict[str, int] = {}
        for n in self._nodes.values():
            if n.get("state") != "ALIVE":
                continue
            res = n.get("resources") or {}
            for k, v in (res.get("total") or {}).items():
                totals[k] = totals.get(k, 0.0) + float(v)
            for k, v in (res.get("available") or {}).items():
                avail[k] = avail.get(k, 0.0) + float(v)
            for d in n.get("pending_demand") or []:
                shape = ",".join(
                    f"{k}:{v:g}" for k, v in sorted((d.get("shape") or {}).items()))
                demand[shape] = demand.get(shape, 0) + d.get("count", 0)
        for k, v in totals.items():
            gauge("ray_tpu_resource_total", v, resource=k)
            gauge("ray_tpu_resource_used", v - avail.get(k, 0.0), resource=k)
        if not demand:
            demand[""] = 0  # always expose the series, even when idle
        for shape, count in demand.items():
            gauge("ray_tpu_pending_demand", count, shape=shape)

        worker_hbm = self.memory_store.hbm_by_node()
        for node_id, n in self._nodes.items():
            if n.get("state") != "ALIVE":
                continue
            nid = node_id[:12]
            store = n.get("store") or {}
            gauge("ray_tpu_object_store_used_bytes", store.get("used", 0), node_id=nid)
            gauge("ray_tpu_object_store_capacity_bytes",
                  store.get("capacity", n.get("object_store_capacity", 0)), node_id=nid)
            gauge("ray_tpu_object_store_pinned_bytes", store.get("pinned_bytes", 0), node_id=nid)
            gauge("ray_tpu_object_store_used_peak_bytes",
                  store.get("used_peak", store.get("used", 0)), node_id=nid)
            gauge("ray_tpu_object_store_fallback_allocations_total",
                  store.get("fallback_allocations_total", 0), node_id=nid)
            # Spill/restore counters: bytes AND object counts (canonical
            # ray_tpu_spill_* names; the legacy *_bytes_total spellings from
            # the first metrics PR stay for existing dashboards).
            gauge("ray_tpu_spill_bytes_total", store.get("spilled_bytes_total", 0), node_id=nid)
            gauge("ray_tpu_restore_bytes_total", store.get("restored_bytes_total", 0), node_id=nid)
            gauge("ray_tpu_spill_objects_total", store.get("spilled_objects_total", 0), node_id=nid)
            gauge("ray_tpu_restore_objects_total", store.get("restored_objects_total", 0), node_id=nid)
            gauge("ray_tpu_spilled_bytes_total", store.get("spilled_bytes_total", 0), node_id=nid)
            gauge("ray_tpu_restored_bytes_total", store.get("restored_bytes_total", 0), node_id=nid)
            # HBM accounting: the raylet's own heartbeat view merged (max)
            # with what the node's workers report in memory summaries — the
            # device lock is exclusive per process, and max never double
            # counts a driver sharing the raylet's process.
            hbm = dict(n.get("hbm") or {})
            whbm = worker_hbm.get(node_id) or {}
            for k in ("used", "limit", "peak"):
                hbm[k] = max(int(hbm.get(k, 0)), int(whbm.get(k, 0)))
            gauge("ray_tpu_hbm_used_bytes", hbm.get("used", 0), node_id=nid)
            gauge("ray_tpu_hbm_limit_bytes", hbm.get("limit", 0), node_id=nid)
            gauge("ray_tpu_hbm_peak_bytes", hbm.get("peak", 0), node_id=nid)
            gauge("ray_tpu_worker_rss_bytes", n.get("worker_rss_bytes", 0), node_id=nid)

        by_state = {}
        for a in self._actors.values():
            by_state[a.get("state", "?")] = by_state.get(a.get("state", "?"), 0) + 1
        for state, count in by_state.items():
            gauge("ray_tpu_actors", count, state=state)

        for state, count in self.task_events.count_by_state().items():
            gauge("ray_tpu_tasks", count, state=state)

        by_state = {}
        for r in self._placement_groups.values():
            by_state[r.get("state", "?")] = by_state.get(r.get("state", "?"), 0) + 1
        for state, count in by_state.items():
            gauge("ray_tpu_placement_groups", count, state=state)
        out.extend(self._lease_stage_hist.snapshot())
        return out

    # --------------------------------------------------------------- pub/sub
    async def handle_Publish(self, p: dict) -> dict:
        await self.publisher.publish(p["channel"], p["message"])
        return {}

    async def handle_SubscribePoll(self, p: dict) -> dict:
        cfg = get_config()
        timeout = min(p.get("timeout", cfg.gcs_pubsub_poll_timeout_s), cfg.gcs_pubsub_poll_timeout_s)
        out = await self.publisher.poll(p["cursors"], timeout)
        return {"messages": out}

    # ---------------------------------------------------------- actor manager
    async def handle_RegisterActor(self, p: dict) -> dict:
        """Register + asynchronously create an actor (gcs_actor_manager.cc:389,475)."""
        spec = p["spec"]
        actor_id = spec["actor_id"].hex() if isinstance(spec["actor_id"], bytes) else spec["actor_id"]
        name = p.get("name", "")
        if name:
            if name in self._named_actors:
                return {"error": f"Actor name '{name}' already taken"}
            self._named_actors[name] = actor_id
        record = {
            "actor_id": actor_id,
            "name": name,
            "spec": spec,
            "state": PENDING_CREATION,
            "address": "",
            "node_id": "",
            "worker_id": "",
            "num_restarts": 0,
            "max_restarts": spec.get("max_restarts", 0),
            "detached": p.get("detached", False),
            "death_cause": "",
        }
        self._actors[actor_id] = record
        self._spawn(self._create_actor(record))
        return {"actor_id": actor_id}

    async def _create_actor(self, record: dict) -> None:
        """Lease a worker and push the creation task (GcsActorScheduler).

        Invariant: a granted dedicated lease is ALWAYS either promoted to a
        live actor or returned to its raylet (killing the worker) — failed
        creations must not strand leased resources."""
        spec = record["spec"]
        resources = spec.get("resources") or {"CPU": 1.0}
        strategy = spec.get("scheduling_strategy") or {}

        def _stamp_creation(status: str, worker_id: str = "",
                            node_id: str = "") -> None:
            # Submitter-side terminal status for the creation task: the
            # executor records one too, but its buffer dies unflushed if
            # the worker is killed right after (or during) creation —
            # every settled creation must look settled in list_tasks().
            self.task_events.add_events([{
                "task_id": spec["task_id"], "status": status,
                "ts": time.time(), "name": spec.get("name", ""),
                "kind": spec.get("kind", 1),
                "worker_id": worker_id, "node_id": node_id,
            }])

        for attempt in range(60):
            if record["state"] == DEAD:  # killed while pending
                _stamp_creation("FAILED")
                return
            pg_id = spec.get("placement_group_id") or b""
            wait_infeasible = False
            if pg_id:
                # PG-bundled actor: the bundle RESERVED its resources, so
                # availability-based selection would see a full cluster and
                # never place it — go straight to the bundle's node (the
                # raylet grants the lease from the bundle reservation).
                pg_hex = pg_id.hex() if isinstance(pg_id, bytes) else pg_id
                pg_rec = self._placement_groups.get(pg_hex)
                locs = (pg_rec or {}).get("bundle_locations") or []
                idx = spec.get("placement_group_bundle_index", -1)
                node_id = (locs[idx] if 0 <= idx < len(locs)
                           else (locs[0] if locs else None))
            else:
                node_id = self._select_node(resources, strategy)
                if node_id is None:
                    node_id = self._infeasible_host(strategy)
                    wait_infeasible = node_id is not None
            if node_id is None:
                await asyncio.sleep(0.5)
                continue
            client = self._raylet(node_id)
            if client is None:
                continue
            try:
                lease = await client.call(
                    "RequestWorkerLease",
                    {"spec": spec, "dedicated": True,
                     "wait_infeasible": wait_infeasible},
                    timeout=get_config().worker_register_timeout_s + 10.0,
                )
            except Exception as e:
                logger.warning("Actor lease on node %s failed: %s", node_id[:8], e)
                await asyncio.sleep(0.2)
                continue
            if lease.get("spillback"):
                continue  # re-select with fresh view
            if not lease.get("granted"):
                # Only a resource WAIT suggests capacity pinned by garbage
                # (un-collected actor-handle cycles) — infeasible requests
                # and worker-start failures would just churn gc.collect()
                # cluster-wide for nothing.
                if "waiting for resources" in lease.get("reason", ""):
                    await self._maybe_global_gc("actor_pending")
                await asyncio.sleep(0.2)
                continue
            worker_addr = lease["worker_address"]
            worker_id = lease.get("worker_id", "")
            try:
                # Confirm the grant reply arrived (AckLease): un-acked
                # leases are reclaimed by the raylet's orphan watchdog.
                await client.call("AckLease", {"worker_id": worker_id},
                                  timeout=10.0)
            except Exception:
                pass

            async def _return_lease(kill: bool) -> None:
                try:
                    await client.call("ReturnWorker", {"worker_id": worker_id, "kill": kill}, timeout=10.0)
                except Exception as e:
                    logger.warning(
                        "actor %s: returning dedicated lease %s failed (%s)",
                        record["actor_id"][:8], worker_id[:8], e)

            logger.info("Actor %s: pushing creation task to %s", record["actor_id"][:8], worker_addr)
            try:
                worker = RpcClient(worker_addr)
                reply = await worker.call(
                    "PushTask", {"spec": spec}, timeout=get_config().worker_register_timeout_s * 2
                )
                await worker.close()
                logger.info("Actor %s: creation reply %s", record["actor_id"][:8], "err" if reply.get("error") else "ok")
                _stamp_creation("FAILED" if reply.get("error") else "FINISHED",
                                worker_id, node_id)
                if reply.get("error"):
                    await _return_lease(kill=True)
                    record["state"] = DEAD
                    record["death_cause"] = f"creation task failed: {reply['error']}"
                    if record.get("name"):
                        self._named_actors.pop(record["name"], None)
                    await self._publish_actor(record)
                    return
            except Exception as e:
                record["death_cause"] = f"creation push failed: {e}"
                await _return_lease(kill=True)
                await asyncio.sleep(0.2)
                continue
            if record["state"] == DEAD:  # ray.kill raced with creation
                await _return_lease(kill=True)
                return  # (terminal status already stamped above)
            record["state"] = ALIVE
            record["address"] = worker_addr
            record["node_id"] = node_id
            record["worker_id"] = worker_id
            await self._publish_actor(record)
            return
        record["state"] = DEAD
        record["death_cause"] = record.get("death_cause") or "no node could schedule the actor"
        _stamp_creation("FAILED")
        await self._publish_actor(record)

    def _infeasible_host(self, strategy: dict | None) -> str | None:
        """A live raylet to queue an actor lease no node can take. Its
        infeasible wait reports the shape as pending demand in its
        heartbeats (what an autoscaler launches nodes for) and spills the
        lease back once a node that fits registers; without it such an
        actor was never seen as demand and died after its attempts. Not
        for node-affinity or label strategies, which name their nodes."""
        strategy = strategy or {}
        if strategy.get("type") == "node_affinity" or strategy.get("labels"):
            return None
        alive = sorted(nid for nid, n in self._nodes.items()
                       if n.get("state") == "ALIVE" and not n.get("draining"))
        return alive[0] if alive else None

    def _select_node(self, resources: dict, strategy: dict | None = None) -> str | None:
        from .scheduling import select_node_for_resources

        node_id = select_node_for_resources(self._nodes, resources,
                                            strategy or {})
        if node_id is not None:
            # Optimistic bookkeeping (reference GcsActorScheduler): deduct
            # the selection from the cached availability view NOW, so a
            # 1k-actor creation storm spreads across raylets instead of
            # every coroutine picking the same node off the same stale
            # heartbeat snapshot and convoying in one admission queue.
            # The next heartbeat overwrites the view with ground truth.
            avail = (self._nodes[node_id].get("resources") or {}).get(
                "available") or {}
            for k, v in (resources or {}).items():
                if k in avail:
                    avail[k] = avail[k] - float(v)
        return node_id

    async def _publish_actor(self, record: dict) -> None:
        await self.publisher.publish(
            "actor",
            {
                "actor_id": record["actor_id"],
                "state": record["state"],
                "address": record["address"],
                "num_restarts": record["num_restarts"],
                "death_cause": record["death_cause"],
            },
        )

    async def handle_GetActorInfo(self, p: dict) -> dict:
        actor_id = p["actor_id"]
        record = self._actors.get(actor_id)
        if record is None:
            return {"found": False}
        return {
            "found": True,
            "state": record["state"],
            "address": record["address"],
            "node_id": record.get("node_id", ""),
            "num_restarts": record["num_restarts"],
            "death_cause": record["death_cause"],
        }

    async def handle_GetActorByName(self, p: dict) -> dict:
        actor_id = self._named_actors.get(p["name"])
        if actor_id is None:
            return {"found": False}
        info = await self.handle_GetActorInfo({"actor_id": actor_id})
        info["actor_id"] = actor_id
        info["spec"] = self._actors[actor_id]["spec"]
        return info

    async def handle_ListActors(self, p: dict) -> dict:
        return {
            "actors": [
                {k: v for k, v in rec.items() if k != "spec"}
                for rec in self._actors.values()
            ]
        }

    async def handle_ReportActorDeath(self, p: dict) -> dict:
        """Raylet/worker reports an actor's process died (OnWorkerDead)."""
        record = self._actors.get(p["actor_id"])
        if record is None or record["state"] == DEAD:
            return {}
        if record["state"] in (RESTARTING, PENDING_CREATION):
            # A restart/creation is already in flight for this actor —
            # this report describes the SAME death that triggered it (the
            # preempted node's drain kill races its own worker-monitor
            # report). Spawning a second _create_actor here double-created
            # the actor: two dedicated leases, one leaked forever.
            # Failures of the in-flight creation surface through its own
            # push path, never through this report.
            return {}
        if p.get("worker_id") and record.get("worker_id") \
                and p["worker_id"] != record["worker_id"]:
            # Stale report about a PREVIOUS incarnation's worker arriving
            # after the restarted actor went ALIVE: must not kill the
            # live incarnation.
            return {}
        await self._restart_or_kill_actor(record, p.get("reason", "worker died"))
        return {}

    async def handle_KillActor(self, p: dict) -> dict:
        record = self._actors.get(p["actor_id"])
        if record is None:
            return {"found": False}
        record["max_restarts"] = 0  # no_restart
        node = self._raylet(record["node_id"]) if record["node_id"] else None
        if record["state"] == ALIVE and record["address"]:
            try:
                w = RpcClient(record["address"])
                await w.call("Exit", {}, timeout=2.0)
                await w.close()
            except Exception:
                pass
        if node is not None and record.get("worker_id"):
            # Belt and braces through the RAYLET: the Exit RPC above is
            # best-effort against the worker's own loop — under a storm
            # it can time out and the dedicated worker (plus its CPU
            # lease) leaked forever. ReturnWorker(kill) is idempotent if
            # the Exit already landed.
            try:
                await node.call(
                    "ReturnWorker",
                    {"worker_id": record["worker_id"], "kill": True},
                    timeout=5.0)
            except Exception:
                pass
        record["state"] = DEAD
        record["death_cause"] = "killed via ray.kill"
        if record.get("name"):
            self._named_actors.pop(record["name"], None)
        await self._publish_actor(record)
        return {"found": True}

    async def _restart_or_kill_actor(self, record: dict, reason: str) -> None:
        """The restart FSM (gcs_actor_manager.cc:565 RestartActor)."""
        max_restarts = record.get("max_restarts", 0)
        if max_restarts == -1 or record["num_restarts"] < max_restarts:
            record["num_restarts"] += 1
            record["state"] = RESTARTING
            record["address"] = ""
            await self._publish_actor(record)
            self._spawn(self._create_actor(record))
        else:
            record["state"] = DEAD
            record["death_cause"] = reason
            if record.get("name"):
                self._named_actors.pop(record["name"], None)
            await self._publish_actor(record)

    # ------------------------------------------------------ placement groups
    async def handle_CreatePlacementGroup(self, p: dict) -> dict:
        pg_id = p["pg_id"].hex() if isinstance(p["pg_id"], bytes) else p["pg_id"]
        record = {
            "pg_id": pg_id,
            "bundles": p["bundles"],
            "strategy": p.get("strategy", "PACK"),
            "state": "PENDING",
            "bundle_locations": [],
            "name": p.get("name", ""),
        }
        self._placement_groups[pg_id] = record
        self._spawn(self._schedule_pg_loop(record))
        return {"pg_id": pg_id, "state": record["state"]}

    async def _schedule_pg_loop(self, record: dict) -> None:
        """Keep a PENDING group scheduling until it is placed or removed.

        A group whose bundles exceed every node's TOTAL resources is
        terminally INFEASIBLE; one that merely doesn't fit the currently
        AVAILABLE resources stays PENDING and is retried as resources free
        up (reference: GcsPlacementGroupManager pending queue,
        ``gcs_placement_group_scheduler.h:117-119`` 2PC)."""
        from .scheduling import schedule_placement_group

        infeasible_since: float | None = None
        while record["state"] == "PENDING":
            if self._nodes:
                feasible = schedule_placement_group(
                    self._nodes, record["bundles"], record["strategy"], use_total=True
                )
                if feasible is None:
                    # Only terminally INFEASIBLE if the totals check keeps
                    # failing for a grace window — nodes may still be
                    # registering (late raylets must not doom the group).
                    now = time.time()
                    if infeasible_since is None:
                        infeasible_since = now
                    elif now - infeasible_since > 10.0:
                        record["state"] = "INFEASIBLE"
                        return
                else:
                    infeasible_since = None
                    placement = schedule_placement_group(
                        self._nodes, record["bundles"], record["strategy"]
                    )
                    if placement is not None and await self._try_reserve(record, placement):
                        return
                    # Feasible on totals but unplaceable on available
                    # resources: capacity may be pinned by garbage (e.g.
                    # actor handles stuck in exception→frame reference
                    # cycles in some driver). Broadcast a global GC so every
                    # worker runs gc.collect() (reference:
                    # ``ray._private.internal_api.global_gc``,
                    # ``core_worker.cc`` TriggerGlobalGC on PG pending).
                    await self._maybe_global_gc("pg_pending")
            await asyncio.sleep(0.25)

    async def _maybe_global_gc(self, reason: str) -> None:
        """Publish a rate-limited global-GC broadcast (at most every 5s)."""
        now = time.time()
        if now - getattr(self, "_last_global_gc", 0.0) < get_config().global_gc_interval_s:
            return
        self._last_global_gc = now
        await self.publisher.publish("global_gc", {"reason": reason})

    async def handle_PollGlobalGc(self, p: dict) -> dict:
        """Worker long-poll for global-GC broadcasts. ``cursor=None`` means
        "start at the current end" (no replay of old triggers)."""
        cursor = p.get("cursor")
        current = self.publisher.current_seq("global_gc")
        if cursor is None or cursor > current:
            # None = "start at the end". A cursor PAST the end means this
            # GCS restarted (fresh Publisher, seqs reset): clamp, or the
            # worker would filter every future broadcast forever.
            return {"cursor": current, "triggered": False}
        out = await self.publisher.poll({"global_gc": cursor}, p.get("timeout", 10.0))
        msgs = out.get("global_gc", [])
        if msgs:
            return {"cursor": msgs[-1][0], "triggered": True}
        return {"cursor": cursor, "triggered": False}

    async def _try_reserve(self, record: dict, placement: list[str]) -> bool:
        """2PC: reserve every bundle, then commit; cancel all on any failure."""
        pg_id = record["pg_id"]
        reserved: list[tuple[int, str]] = []
        ok = True
        for idx, node_id in enumerate(placement):
            client = self._raylet(node_id)
            try:
                r = await client.call(
                    "ReserveBundle",
                    {"pg_id": pg_id, "bundle_index": idx, "resources": record["bundles"][idx]},
                    timeout=5.0,
                )
                if not r.get("ok"):
                    ok = False
                    break
                reserved.append((idx, node_id))
            except Exception:
                ok = False
                break
        # RemovePlacementGroup may have raced with the reservations: roll
        # back instead of committing, or the raylet-side reservations leak.
        if not ok or record["state"] != "PENDING":
            for idx, node_id in reserved:
                client = self._raylet(node_id)
                try:
                    await client.call("CancelBundle", {"pg_id": pg_id, "bundle_index": idx}, timeout=5.0)
                except Exception:
                    pass
            return record["state"] != "PENDING"  # stop the loop if removed
        for idx, node_id in reserved:
            client = self._raylet(node_id)
            await client.call("CommitBundle", {"pg_id": pg_id, "bundle_index": idx}, timeout=5.0)
        record["bundle_locations"] = [n for _, n in sorted(reserved)]
        if record["state"] != "PENDING":
            # removed mid-commit: release everything we just committed
            for idx, node_id in enumerate(record["bundle_locations"]):
                client = self._raylet(node_id)
                try:
                    await client.call("ReturnBundle", {"pg_id": pg_id, "bundle_index": idx}, timeout=5.0)
                except Exception:
                    pass
            return True
        record["state"] = "CREATED"
        return True

    async def handle_GetPlacementGroup(self, p: dict) -> dict:
        record = self._placement_groups.get(p["pg_id"])
        return {"found": record is not None, "pg": record}

    async def handle_RemovePlacementGroup(self, p: dict) -> dict:
        record = self._placement_groups.pop(p["pg_id"], None)
        if record and record["state"] == "PENDING":
            record["state"] = "REMOVED"  # stops the scheduling loop
        if record and record["state"] == "CREATED":
            for idx, node_id in enumerate(record["bundle_locations"]):
                client = self._raylet(node_id)
                if client:
                    try:
                        await client.call("ReturnBundle", {"pg_id": record["pg_id"], "bundle_index": idx}, timeout=5.0)
                    except Exception:
                        pass
        return {"removed": record is not None}
