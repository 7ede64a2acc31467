"""Raylet: the per-node agent.

Equivalent of the reference's ``src/ray/raylet/``: ``NodeManager``
(``node_manager.h:118``) + ``WorkerPool`` (``worker_pool.h:524``) +
``LocalTaskManager``/``ClusterTaskManager`` (``scheduling/``) + the local
object store (our native shm store standing in for the in-raylet plasma
runner) + ``LocalObjectManager`` duties (object transfer; spill is
delegated to eviction in round 1).

Protocol surface (RPC methods):
  RequestWorkerLease / ReturnWorker      — worker lease protocol
                                           (node_manager.cc:1910)
  RegisterWorker                         — worker startup handshake
  PlasmaCreate/Seal/GetInfo/Contains/
  AddRef/Release/Delete/Wait             — object store service
  FetchObjectChunk                       — chunked object transfer between
                                           nodes (object_manager.h:117)
  ReserveBundle/CommitBundle/
  CancelBundle/ReturnBundle              — placement-group 2PC
  HealthCheck                            — GCS health pings
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import os
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field

from .config import get_config
from .ids import NodeID, WorkerID
from .resources import NodeResources, ResourceSet
from .rpc import RetryableRpcClient, RpcClient, RpcServer, get_chaos, spawn
from ..chaos import clock as chaos_clock
from ..native.store import ShmStore, StoreFullError

# The port's own session dir: a port cluster never shares files with the
# JAX package's (``/tmp/ray_tpu``).
DEFAULT_SESSION_DIR = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")

logger = logging.getLogger(__name__)


class ObjectMissingOnHolder(Exception):
    """A node listed as holding an object reported it absent (evicted)."""


class PidHandle:
    """Popen-compatible handle for a worker forked by the zygote (not our
    child, so ``waitpid`` is unavailable; the zygote auto-reaps). Exposes
    the subset of the Popen surface the raylet uses: poll/wait/terminate/
    kill/pid/returncode. Identity is (pid, /proc start time) so a recycled
    pid is never mistaken for the live worker (or SIGKILLed at teardown)."""

    def __init__(self, pid: int):
        self.pid = pid
        self.returncode: int | None = None
        self._starttime = self._read_starttime(pid)

    @staticmethod
    def _read_starttime(pid: int) -> str | None:
        try:
            with open(f"/proc/{pid}/stat") as f:
                return f.read().rsplit(")", 1)[-1].split()[19]  # field 22
        except (OSError, IndexError):
            return None

    def poll(self) -> int | None:
        if self.returncode is not None:
            return self.returncode
        current = self._read_starttime(self.pid)
        if current is None or (self._starttime is not None
                               and current != self._starttime):
            self.returncode = -1  # gone, or the pid was recycled
            return self.returncode
        return None

    def wait(self, timeout: float | None = None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(f"worker pid {self.pid}", timeout)
            time.sleep(0.02)
        return self.returncode

    def _signal(self, sig) -> None:
        if self.poll() is not None:
            return  # dead or recycled pid: never signal a stranger
        try:
            os.kill(self.pid, sig)
        except OSError:
            pass

    def terminate(self) -> None:
        import signal

        self._signal(signal.SIGTERM)

    def kill(self) -> None:
        import signal

        self._signal(signal.SIGKILL)


@dataclass
class ZygoteHandle:
    """One runtime-env-keyed forkserver (worker_zygote.py): the process,
    its boot state, and the lock serializing fork-protocol framing."""

    renv: dict | None = None
    proc: subprocess.Popen | None = None
    booting: bool = False
    lock: threading.Lock = field(default_factory=threading.Lock)


# Spawn-latency evidence for the zygote pool (mode "pooled" = forked from
# a warm zygote image; "cold" = direct Popen paying interpreter boot +
# imports). Module-level: many in-process raylets (the Cluster harness)
# share one registry entry instead of each registering a duplicate.
_SPAWN_HIST: "object | None" = None


def _spawn_hist():
    global _SPAWN_HIST
    if _SPAWN_HIST is None:
        from ..util.metrics import Histogram

        _SPAWN_HIST = Histogram(
            "ray_tpu_worker_spawn_ms",
            "Worker spawn-to-register latency by spawn mode "
            "(cold Popen vs zygote-pool fork)",
            tag_keys=("mode",))
    return _SPAWN_HIST


@dataclass
class WorkerHandle:
    worker_id: str
    address: str = ""
    pid: int = 0
    proc: subprocess.Popen | None = None
    state: str = "starting"  # starting | idle | leased | dedicated | dead
    actor_id: str = ""
    # How this process came to be: "pooled" = forked from a warm zygote
    # image (~ms), "cold" = direct Popen (interpreter boot + imports).
    spawn_mode: str = "cold"
    # monotonic stamp at spawn, cleared once the register latency has
    # been observed into ray_tpu_worker_spawn_ms.
    spawn_started_at: float = 0.0
    # Hash of the runtime env this worker was started with ("" = default);
    # leases only match workers with the same env (worker_pool.h:524
    # runtime-env-hash matching).
    env_hash: str = ""
    lease_resources: ResourceSet = field(default_factory=ResourceSet)
    # Bundle this lease draws from, if the task runs in a placement group.
    bundle_key: tuple | None = None
    registered: asyncio.Future | None = None
    last_idle_time: float = 0.0
    # When the current lease was granted + whether its task is retriable —
    # the memory monitor's OOM policy kills the newest retriable lease
    # (reference worker_killing_policy.cc retriable-LIFO).
    lease_time: float = 0.0
    retriable: bool = False
    # Lease-grant acknowledgement: the owner acks right after it receives
    # the grant reply. A lease still un-acked past lease_orphan_timeout_s
    # means the reply was lost (the owner will retry elsewhere) and the
    # reservation would strand forever — the watchdog reclaims it.
    # Granted-at runs on the chaos clock so virtual time replays it.
    lease_acked: bool = True
    lease_granted_at: float = 0.0
    # pushes_total sampled at the watchdog's first orphan probe (a second
    # unchanged sample confirms the owner really never used the lease).
    orphan_probe: int | None = None
    # Worker parks a resident compiled-loop executor (dag/loop.py): the
    # owner declared it via PinLoopWorker. A parked loop is indistinguishable
    # from a stranded grant to the orphan watchdog (no pushes, never
    # finishes, probe may be unreachable under chaos) — pinned leases are
    # exempt from orphan reclaim until the owner unpins at loop teardown.
    loop_pinned: bool = False


class Raylet:
    def __init__(
        self,
        gcs_address: str,
        host: str = "127.0.0.1",
        port: int = 0,
        num_cpus: float | None = None,
        resources: dict | None = None,
        labels: dict | None = None,
        object_store_capacity: int | None = None,
        session_dir: str | None = None,
    ):
        self.node_id = NodeID.from_random()
        self.gcs_address = gcs_address
        self._server = RpcServer(host, port, tag="raylet")
        self._server.register_service(self)
        self._gcs = RetryableRpcClient(gcs_address)

        cfg = get_config()
        total: dict = dict(resources or {})
        total.setdefault("CPU", num_cpus if num_cpus is not None else (os.cpu_count() or 1))
        from ..gpu import detect_gpu_resources

        for k, v in detect_gpu_resources().items():
            total.setdefault(k, v)
        if object_store_capacity is None:
            object_store_capacity = cfg.object_store_minimum_memory_bytes
        total.setdefault("object_store_memory", float(object_store_capacity))
        self.resources = NodeResources(total, labels)

        session_dir = session_dir or DEFAULT_SESSION_DIR
        os.makedirs(session_dir, exist_ok=True)
        self.store_path = os.path.join(
            "/dev/shm", f"raytpu_torch_store_{self.node_id.hex()[:12]}"
        )
        self.store = ShmStore(self.store_path, object_store_capacity)
        self.object_store_capacity = object_store_capacity

        self._workers: dict[str, WorkerHandle] = {}
        self._idle: list[str] = []
        self._lease_waiters: list[asyncio.Future] = []
        # Resource-admission queue: (priority, seq)-ordered waiters; the
        # releaser hands reservations to the head directly, so a flood of
        # new task leases can never starve a parked actor creation
        # (fixes the scheduler-fairness starvation; reference:
        # cluster_task_manager.cc queue ordering).
        self._admission_queue: list[dict] = []
        self._admission_seq = 0
        self._pg_bundles: dict[tuple[str, int], dict] = {}  # (pg_id, idx) -> {resources, committed}
        self._tasks: list[asyncio.Task] = []
        self._node_table: dict[str, dict] = {}
        # Node-table refresh sharing: concurrent refreshers ride ONE
        # in-flight GetAllNodes, and bounded-staleness callers (the
        # infeasible-lease wait loop) accept a recent cache outright.
        self._node_table_ts = 0.0
        self._node_table_refresh: asyncio.Future | None = None
        # Lease admission fast-path: resource shapes recur (a 100k-task
        # bench is 100k×{"CPU": 1}) — cache the fixed-point ResourceSet
        # per shape instead of rebuilding it for every request.
        self._request_shape_cache: dict[tuple, ResourceSet] = {}
        self._remote_store_clients: dict[str, RpcClient] = {}
        self._fetching: dict[bytes, asyncio.Future] = {}
        self._session_dir = session_dir
        self._shutdown = False
        # object_id -> {size, state} for the state API (ListObjects)
        self._object_meta: dict[bytes, dict] = {}

        # --- spill manager (LocalObjectManager, local_object_manager.h:110):
        # primary copies are pinned in the store; under memory pressure the
        # oldest unreferenced pinned objects are written to disk and deleted
        # from shm, then restored on the next Get/Fetch.
        self._spill_dir = os.path.join(session_dir, f"spill-{self.node_id.hex()[:12]}")
        self._spilled: dict[bytes, tuple[int, int]] = {}  # oid -> (data_size, meta_size)
        self._spill_pending: dict[bytes, bytes] = {}  # disk write still in flight
        self._pinned: dict[bytes, int] = {}  # oid -> total size, insertion-ordered
        self._last_oom_kill = 0.0
        self._spilled_bytes_total = 0
        self._restored_bytes_total = 0
        # Memory observability: spill/restore object counts, creations that
        # only succeeded after a synchronous spill (the reference's
        # "fallback allocation" analogue), and the high-water store mark.
        self._spilled_objects_total = 0
        self._restored_objects_total = 0
        self._fallback_allocations_total = 0
        self._store_used_peak = 0
        # Overridable for tests: returns fraction of node memory in use.
        self._memory_usage_fn = _node_memory_usage_fraction
        # Outstanding pin_read store refs per reader (worker_id), released
        # in bulk if the reader dies mid-read.
        self._read_refs: dict[str, dict[bytes, int]] = {}
        # Resource shapes of lease requests currently waiting for capacity,
        # reported in heartbeats as autoscaler demand (reference: resource
        # load in raylet heartbeats feeding autoscaler/v2).
        self._pending_lease_demand: dict[tuple, int] = {}
        # Unsealed creations per creator worker, force-deleted if the creator
        # dies between PlasmaCreate and PlasmaSeal (else the creator ref
        # leaks the arena bytes forever).
        self._creating: dict[bytes, str] = {}
        # GPU shares behind a device-release fence, per bundle key (None =
        # node-pool lease): bundle teardown withholds these from its
        # release; the fence re-grants them when the holder is dead.
        self._fence_pending: dict[tuple | None, float] = {}
        # Runtime-env-keyed forkservers (worker_zygote.py): env hash ->
        # zygote. Key "" (default env) is warmed at start; other keys
        # boot on first use and are LRU-bounded via _pool_keys.
        self._zygotes: dict[str, ZygoteHandle] = {}
        # Zygote-pool hot keys: env hash -> {"renv", "last_used"} in LRU
        # order (insertion order, re-inserted on touch). The maintenance
        # loop keeps zygote_pool_size idle workers per hot key; over
        # zygote_pool_max_keys the coldest key is evicted (zygote killed,
        # idle pooled workers of that env killed).
        self._pool_keys: dict[str, dict] = {}
        # Spawn-mode counters (debug_state + the pool smoke tests).
        self._spawn_stats = {"cold": 0, "pooled": 0}
        # --- object manager: push + prioritized pull admission ---------
        # In-progress inbound pushes: oid -> {offset, received, total,
        # data_size, meta_size} (receiver side of PushObject).
        self._receiving: dict[bytes, dict] = {}
        # Pull admission queue: heap-ordered (class, seq) waiters; classes
        # get(0) > wait(1) > task_arg(2) (reference pull_manager.h:51).
        self._pull_inflight = 0
        self._pull_waiters: list[dict] = []
        self._pull_seq = 0
        # Transfer counters (observability + the broadcast fan-out test).
        self.transfer_stats = {"chunks_served": 0, "pushes_served": 0,
                               "pulls_started": 0}
        # Preemption draining (resilience subsystem): after a GCE-style
        # preemption notice the node admits NO new leases, flushes its
        # task events, and — once the grace window expires — its workers
        # are killed and the GCS marks it dead. Timestamps ride the chaos
        # clock so VirtualClock runs measure the drain window virtually.
        self._draining = False
        self._draining_since = 0.0
        self._drain_reason = ""
        # GCE metadata preemption watcher (resilience/metadata_watcher),
        # started in start() behind config preempt_metadata_watch.
        self._metadata_watcher = None
        # Diagnostics counters (debug_state + the lease-wedge watchdog).
        self._wedge_events_total = 0
        self._oom_kills_total = 0
        self._orphan_leases_total = 0
        self._started_at = time.monotonic()
        # Lease-stage task events + spans (LEASED at grant, queue-wait and
        # spawn timings), flushed to the GCS on the worker flush cadence.
        from .task_events import TaskEventBuffer

        self._task_events = TaskEventBuffer(
            f"raylet-{self.node_id.hex()[:8]}", self.node_id.hex())

    # ------------------------------------------------------------- lifecycle
    async def start(self) -> None:
        await self._server.start()
        reply = await self._gcs.call(
            "RegisterNode",
            {
                "node_id": self.node_id.hex(),
                "address": self.address,
                "object_store_path": self.store_path,
                "object_store_capacity": self.object_store_capacity,
                "resources": self.resources.to_dict(),
            },
        )
        if get_config().enable_worker_zygote:
            self._kick_zygote("")  # warm the default-env forkserver off-path
        self._tasks.append(spawn(self._heartbeat_loop()))
        self._tasks.append(spawn(self._worker_monitor_loop()))
        self._tasks.append(spawn(self._memory_monitor_loop()))
        self._tasks.append(spawn(self._debug_dump_loop()))
        self._tasks.append(spawn(self._lease_watchdog_loop()))
        self._tasks.append(spawn(self._task_event_flush_loop()))
        if get_config().log_to_driver:
            self._tasks.append(spawn(self._log_monitor_loop()))
        cfg = get_config()
        if cfg.preempt_metadata_watch:
            # GCE spot reclaim notice, straight from the node's own
            # metadata server into the PreemptionNotice drain path —
            # the watcher thread hops back onto the raylet loop.
            from ..resilience.metadata_watcher import (
                GceMetadataPreemptionWatcher)

            loop = asyncio.get_running_loop()
            self._metadata_watcher = GceMetadataPreemptionWatcher(
                lambda reason: loop.call_soon_threadsafe(
                    self.begin_draining, reason),
                url=cfg.preempt_metadata_url,
                poll_s=cfg.preempt_metadata_poll_s,
            ).start()
        for _ in range(cfg.num_prestart_workers):
            self._start_worker()

    @property
    def address(self) -> str:
        return self._server.address

    async def stop(self, graceful: bool = True) -> None:
        self._shutdown = True
        if self._metadata_watcher is not None:
            self._metadata_watcher._stop.set()  # no join: its thread may
            self._metadata_watcher = None       # be mid-poll; it's daemon
        for t in self._tasks:
            t.cancel()
        for w in self._workers.values():
            if w.proc is not None and w.proc.poll() is None:
                if graceful:
                    w.proc.terminate()
                else:
                    w.proc.kill()
        if graceful:
            await asyncio.sleep(0)
            deadline = time.monotonic() + 5.0
            for w in self._workers.values():
                if w.proc is not None:
                    try:
                        w.proc.wait(timeout=max(0.1, deadline - time.monotonic()))
                    except Exception:
                        w.proc.kill()
        # Always reap after the kill escalation: a worker that survives
        # stop() keeps its device memory and starves whatever claims the
        # card next (serve-after-train handoff).
        for w in self._workers.values():
            if w.proc is None:
                continue
            if w.proc.poll() is None and not graceful:
                w.proc.kill()
            try:
                w.proc.wait(timeout=2)
            except Exception:
                pass
        for zh in self._zygotes.values():
            if zh.proc is not None:
                try:
                    zh.proc.kill()
                    zh.proc.wait(timeout=2)
                except Exception:
                    pass
                zh.proc = None
        self._zygotes.clear()
        await self._server.stop(grace=0.5 if graceful else 0.0)
        self.store.close()

    async def kill(self) -> None:
        """Abrupt node death (no drain, SIGKILL workers) — the GCS discovers
        it via failed health checks. Test-harness API (reference
        ``cluster_utils.py`` remove_node non-graceful path)."""
        await self.stop(graceful=False)

    def _store_stats(self) -> dict:
        """Store/spill accounting shared by heartbeats and debug_state
        (the node half of the memory observability layer)."""
        used = self.store.used()
        self._store_used_peak = max(self._store_used_peak, used)
        return {
            "used": used,
            "used_peak": self._store_used_peak,
            "capacity": self.object_store_capacity,
            "objects": self.store.num_objects(),
            "pinned_objects": len(self._pinned),
            "pinned_bytes": sum(self._pinned.values()),
            "spilled_objects": len(self._spilled),
            "spilled_bytes_total": self._spilled_bytes_total,
            "restored_bytes_total": self._restored_bytes_total,
            "spilled_objects_total": self._spilled_objects_total,
            "restored_objects_total": self._restored_objects_total,
            "fallback_allocations_total": self._fallback_allocations_total,
        }

    def _worker_rss(self) -> dict[str, int]:
        """RSS per tracked worker/driver process on this node."""
        from ..observability.memory import process_rss_bytes

        out: dict[str, int] = {}
        for w in self._workers.values():
            if w.pid and w.state != "dead":
                rss = process_rss_bytes(w.pid)
                if rss:
                    out[w.worker_id] = rss
        return out

    async def _heartbeat_loop(self) -> None:
        from ..observability.memory import hbm_stats

        cfg = get_config()
        while True:
            await asyncio.sleep(cfg.health_check_period_ms / 1000.0)
            # Chaos injection point: the `preempt_slice` FaultPlan kind
            # delivers a GCE-style preemption notice at this node's Nth
            # heartbeat tick (deterministic per targeted node).
            if not self._draining and get_chaos().take_preempt_slice(
                    self.node_id.hex()):
                self.begin_draining("chaos: injected preemption notice")
            try:
                reply = await self._gcs.call(
                    "Heartbeat",
                    {
                        "node_id": self.node_id.hex(),
                        "draining": self._draining,
                        "drain_reason": self._drain_reason,
                        "drain_notice_clock": self._draining_since,
                        "resources": self.resources.to_dict(),
                        "pending_demand": [
                            {"shape": dict(shape), "count": count}
                            for shape, count in self._pending_lease_demand.items()
                        ],
                        # Store/spill/HBM/RSS gauges for the metrics
                        # pipeline (ray_tpu_object_store_* / ray_tpu_hbm_*).
                        "store": self._store_stats(),
                        "hbm": hbm_stats(),
                        "worker_rss_bytes": sum(self._worker_rss().values()),
                    },
                    timeout=5.0,
                )
                live_pgs = reply.get("live_pgs")
                if live_pgs is not None:
                    live = set(live_pgs)
                    now = time.monotonic()
                    for key, b in list(self._pg_bundles.items()):
                        # Age guard: a bundle reserved AFTER the GCS
                        # composed its live list would look orphaned for
                        # one beat — never reclaim fresh reservations.
                        if key[0] in live or now - b.get("reserved_at", 0.0) < 10.0:
                            continue
                        logger.info("reclaiming orphaned bundle %s", key)
                        self._drop_bundle(key)
                if reply.get("unknown"):
                    # The GCS restarted and lost the node table: re-register
                    # (gcs_client reconnection path in the reference).
                    logger.info("GCS does not know us — re-registering node %s",
                                self.node_id.hex()[:8])
                    await self._gcs.call(
                        "RegisterNode",
                        {
                            "node_id": self.node_id.hex(),
                            "address": self.address,
                            "object_store_path": self.store_path,
                            "object_store_capacity": self.object_store_capacity,
                            "resources": self.resources.to_dict(),
                        },
                        timeout=10.0,
                    )
                await self._refresh_node_table()
            except Exception:
                pass

    async def _worker_monitor_loop(self) -> None:
        """Detect worker process exits (reference: raylet detects via
        socket close; we poll pids). Actor-death reports that fail (e.g.
        the GCS is down) are queued and retried — a death observed during
        a GCS outage must still reach the restarted GCS, or the restored
        record stays ALIVE forever."""
        pending_deaths: list[dict] = []
        cfg = get_config()
        while True:
            await asyncio.sleep(0.2)
            # Zygote-pool maintenance (reference worker_pool prestart,
            # extended to runtime-env keys): keep a target of pre-forked
            # idle workers per hot env key so actor creation and task
            # bursts bind a ready, already-registered process instead of
            # paying spawn+register inline. The default env is always
            # hot; non-default keys are LRU-tracked in _pool_keys.
            if not self._shutdown and not self._draining:
                self._maintain_worker_pools(cfg)
            for w in list(self._workers.values()):
                # Drivers register without a proc handle but always live on
                # this host: poll their pid so a driver that exits with
                # unreleased pin_read refs (or mid-create objects) is reaped
                # like any worker — leaked read refs make objects
                # unspillable forever.
                if w.proc is None and w.state == "driver" and w.pid:
                    try:
                        os.kill(w.pid, 0)
                    except ProcessLookupError:
                        self._on_worker_dead(w)
                    except OSError:
                        pass  # EPERM etc: process exists
                    continue
                if w.proc is not None and w.proc.poll() is not None and w.state != "dead":
                    prev_state = w.state
                    self._on_worker_dead(w)
                    if prev_state == "dedicated" and w.actor_id:
                        pending_deaths.append({
                            "actor_id": w.actor_id,
                            # Incarnation identity: the GCS drops reports
                            # about a worker that is no longer the
                            # actor's current one (stale death after a
                            # restart already replaced it).
                            "worker_id": w.worker_id,
                            "reason": f"worker process exited with code {w.proc.returncode}",
                        })
            still_pending = []
            for report in pending_deaths:
                try:
                    await self._gcs.call("ReportActorDeath", report, timeout=5.0)
                except Exception:
                    still_pending.append(report)
            pending_deaths = still_pending
            # GC abandoned partial pushes: an unsealed receive allocation
            # with no progress (holder died, object never re-pulled) would
            # otherwise pin arena bytes forever — unsealed objects are not
            # spillable or evictable.
            now = time.monotonic()
            for oid, state in list(self._receiving.items()):
                if now - state["last_progress"] > cfg.object_receive_gc_grace_s:
                    self._receiving.pop(oid, None)
                    try:
                        self.store.delete(oid, force=True)
                    except Exception:
                        pass
                    self._object_meta.pop(oid, None)
                    logger.warning("reclaimed abandoned partial push of %s",
                                   oid.hex()[:12])

    def _pool_counts(self, env_hash: str) -> tuple[int, int]:
        """(idle, starting) workers of one env key."""
        idle = sum(
            1 for wid in self._idle
            if (w := self._workers.get(wid)) and w.env_hash == env_hash)
        starting = sum(
            1 for w in self._workers.values()
            if w.state == "starting" and w.env_hash == env_hash)
        return idle, starting

    def _maintain_worker_pools(self, cfg) -> None:
        """One maintenance tick: top idle pools up toward their targets.
        Refill rate is bounded per key (zygote_pool_refill_batch) and
        globally by the spawn-concurrency caps; never runs while
        draining (begin_draining stops the tick upstream) so a
        preempted node doesn't refill workers it is about to kill."""
        pool_size = cfg.zygote_pool_size if cfg.enable_worker_zygote else 0
        targets: list[tuple[str, dict | None, int]] = [
            ("", None, max(cfg.num_prestart_workers, pool_size))]
        for key, info in list(self._pool_keys.items()):
            targets.append((key, info.get("renv"), pool_size))
        for env_hash, renv, target in targets:
            if target <= 0:
                continue
            idle, starting = self._pool_counts(env_hash)
            cap = (max(cfg.maximum_startup_concurrency,
                       cfg.zygote_max_fork_concurrency)
                   if self._zygote_live(env_hash)
                   else cfg.maximum_startup_concurrency)
            want = min(target - idle - starting,
                       max(1, cfg.zygote_pool_refill_batch),
                       cap - starting)
            for _ in range(max(0, want)):
                try:
                    self._start_worker(renv)
                except Exception:
                    break
        self._shrink_idle_pools(cfg, {k: t for k, _r, t in targets})

    def _shrink_idle_pools(self, cfg, targets: dict[str, int]) -> None:
        """Idle worker killing (reference worker_pool
        ``idle_worker_killing_time_threshold_ms``): once a key's idle
        count exceeds its pool target, the LRU excess is reaped after
        the idle threshold — a burst that ballooned the pool must not
        leave hundreds of resident interpreters competing for CPU/RAM
        forever; re-spawning later is a ~ms zygote fork. 0 disables."""
        threshold_s = cfg.idle_worker_killing_time_threshold_ms / 1000.0
        if threshold_s <= 0:
            return
        now = time.monotonic()
        by_key: dict[str, list[WorkerHandle]] = {}
        for wid in self._idle:  # append-ordered: oldest idle first
            w = self._workers.get(wid)
            if w is not None:
                by_key.setdefault(w.env_hash, []).append(w)
        for key, idle_list in by_key.items():
            excess = len(idle_list) - targets.get(key, 0)
            for w in idle_list:
                if excess <= 0:
                    break
                if now - w.last_idle_time < threshold_s:
                    continue
                if w.proc is not None:
                    w.proc.terminate()
                self._on_worker_dead(w)
                excess -= 1

    def _release_lease(self, w: WorkerHandle) -> bool:
        """Release a worker's lease reservation. Returns True if a GPU
        device fence was started — the worker is being killed and must NOT
        go back to the idle pool (its process still holds the card's
        memory; the GPU portion of the lease is re-granted only once the
        process is confirmed dead, when the driver has freed it). Without
        the fence, the next GPU lease starts a worker that competes with
        the dying holder's allocations while it drains."""
        if w.lease_resources.is_empty():
            return False
        lease, bundle_key = w.lease_resources, w.bundle_key
        w.lease_resources = ResourceSet()
        w.bundle_key = None
        gpu = lease.to_dict().get("GPU", 0.0)
        if gpu > 0 and w.proc is not None and w.proc.poll() is None and _in_loop():
            gpu_part = ResourceSet({"GPU": gpu})
            self._release_into(lease.subtract(gpu_part, allow_negative=True), bundle_key)
            self._fence_pending[bundle_key] = (
                self._fence_pending.get(bundle_key, 0.0) + gpu)
            try:
                w.proc.terminate()
            except Exception:
                pass
            spawn(self._fenced_gpu_release(w, gpu_part, bundle_key))
            return True
        self._release_into(lease, bundle_key)
        return False

    def _release_into(self, res: ResourceSet, bundle_key: tuple | None) -> None:
        if res.is_empty():
            return
        if bundle_key is not None:
            b = self._pg_bundles.get(bundle_key)
            if b is not None:
                b["used"] = b["used"].subtract(res, allow_negative=True)
        else:
            self.resources.release(res)

    async def _fenced_gpu_release(self, w: WorkerHandle, gpu_part: ResourceSet,
                                  bundle_key: tuple | None) -> None:
        """Re-grant the GPU resource only after the previous holder's
        process is gone (SIGTERM already sent; escalate to SIGKILL at half
        the fence timeout). The driver frees a process's device memory
        when it exits, so death == device released."""
        import functools

        loop = asyncio.get_running_loop()
        timeout = get_config().gpu_release_fence_timeout_s
        # Timed Popen.wait INSIDE the executor thread — an untimed wait
        # abandoned by wait_for would pin the shared executor thread
        # forever on an unkillable (D-state) worker.
        try:
            await loop.run_in_executor(
                None, functools.partial(w.proc.wait, timeout / 2))
        except Exception:
            try:
                w.proc.kill()
            except Exception:
                pass
            try:
                await loop.run_in_executor(
                    None, functools.partial(w.proc.wait, timeout / 2))
            except Exception:
                pass  # unkillable (D-state?): re-grant anyway after the fence
        left = self._fence_pending.get(bundle_key, 0.0) - gpu_part.get("GPU")
        if left > 0:
            self._fence_pending[bundle_key] = left
        else:
            self._fence_pending.pop(bundle_key, None)
        if bundle_key is not None and bundle_key not in self._pg_bundles:
            # The bundle was dropped mid-fence; _drop_bundle withheld our
            # share from its release, so hand it to the node pool directly.
            self.resources.release(gpu_part)
        else:
            self._release_into(gpu_part, bundle_key)
        self._wake_lease_waiters()

    def _on_worker_dead(self, w: WorkerHandle) -> None:
        w.state = "dead"
        if w.worker_id in self._idle:
            self._idle.remove(w.worker_id)
        self._release_lease(w)
        self._workers.pop(w.worker_id, None)
        for oid, count in self._read_refs.pop(w.worker_id, {}).items():
            for _ in range(count):
                self.store.release(oid)
        for oid, creator in list(self._creating.items()):
            if creator == w.worker_id:
                self.store.delete(oid, force=True)
                self._creating.pop(oid, None)
                self._object_meta.pop(oid, None)

    # ------------------------------------------------------------ worker pool
    @staticmethod
    def _env_hash(runtime_env: dict | None) -> str:
        renv = runtime_env or {}
        env_vars = renv.get("env_vars") or {}
        working_dir = renv.get("working_dir") or ""
        py_modules = renv.get("py_modules") or []
        pip = renv.get("pip") or renv.get("uv") or []
        # Interpreter-level plugins key the hash too: a conda/py_executable/
        # container task must NEVER match an idle default-interpreter worker
        # — that silently ran it on the wrong interpreter (and skipped the
        # plugin's setup-error surface entirely).
        interp = {k: renv.get(k)
                  for k in ("py_executable", "conda", "container", "image_uri")
                  if renv.get(k)}
        if (not env_vars and not working_dir and not py_modules and not pip
                and not interp):
            return ""
        import hashlib
        import json

        modules_digest = ""
        if py_modules:
            # Content-addressed, like the reference's uploaded py_modules
            # URIs: editing a module must produce a DIFFERENT env so stale
            # idle workers (old sys.path, old imports) never match.
            from .runtime_env import _hash_paths

            modules_digest = _hash_paths(list(py_modules))
        blob = json.dumps({"env_vars": env_vars, "working_dir": working_dir,
                           "py_modules": modules_digest, "pip": pip,
                           "interp": interp},
                          sort_keys=True, default=str)
        return hashlib.sha1(blob.encode()).hexdigest()[:16]

    # ------------------------------------------------------ worker zygote
    def _default_worker_env(self) -> dict:
        """The environment default-env workers run with (also the default
        zygote's own env, so its pre-imported image matches its children)."""
        env = dict(os.environ)
        env["PYTHONUNBUFFERED"] = "1"
        env["CUDA_VISIBLE_DEVICES"] = ""
        return env

    def _worker_env(self, runtime_env: dict | None) -> tuple[dict, str | None]:
        """(env, working_dir) a worker with ``runtime_env`` runs under —
        shared by direct spawns and env-keyed zygote boots so the zygote's
        pre-imported image is byte-equivalent to a cold spawn's."""
        env = dict(os.environ)
        # Worker stdout goes to a file the log monitor tails; without this
        # it would be 8KB block-buffered and prints from long-lived workers
        # would never reach the driver.
        env["PYTHONUNBUFFERED"] = "1"
        from .runtime_env import apply_runtime_env

        explicit_vars = (runtime_env or {}).get("env_vars") or {}
        if "CUDA_VISIBLE_DEVICES" not in explicit_vars:
            # Workers don't see the cards by default. FORCE it empty (don't
            # setdefault): a driver that runs on a card passes its own
            # CUDA_VISIBLE_DEVICES through, and a CPU task would then take
            # the card unnoticed. A GPU worker opts in by unsetting it via
            # runtime_env env_vars.
            env["CUDA_VISIBLE_DEVICES"] = ""
        # working_dir: tasks run with this cwd and import modules from it
        # (reference runtime_env working_dir, minus the remote upload —
        # single-host path semantics).
        working_dir = apply_runtime_env(env, runtime_env)
        if working_dir is not None and not os.path.isdir(working_dir):
            # Popen(cwd=missing) would raise AFTER the lease reserved
            # resources; run without the cwd instead — the task's import
            # error is visible, a leaked reservation is not.
            logger.warning("runtime_env working_dir %s does not exist; ignoring", working_dir)
            working_dir = None
        return env, working_dir

    @staticmethod
    def _zygote_eligible(runtime_env: dict | None) -> bool:
        """True when workers of this env may fork from an env-keyed
        zygote. Interpreter-level plugins can NEVER fork (a fork keeps
        this interpreter; conda/py_executable pick another binary and
        container wraps the whole command) — those envs always pay the
        cold spawn, the PR 1 enforcement path. Neither may a worker that
        sees a card (a GPU lease unsets CUDA_VISIBLE_DEVICES): CUDA does
        not survive a fork, so such a worker always starts cold."""
        renv = runtime_env or {}
        if (renv.get("env_vars") or {}).get("CUDA_VISIBLE_DEVICES", "") != "":
            return False
        return not any(renv.get(k) for k in
                       ("py_executable", "conda", "container", "image_uri"))

    def _boot_zygote(self, key: str) -> None:
        """Spawn the zygote for env ``key`` and wait for its post-import
        handshake. BLOCKING (interpreter boot + imports + runtime_env
        preparation) — runs in an executor thread, never on the event
        loop; ``zh.proc`` is published only once the handshake arrives,
        so spawns before that fall back to direct Popen."""
        import json

        zh = self._zygotes.get(key)
        if zh is None:
            return
        try:
            env, working_dir = self._worker_env(zh.renv)
            z = subprocess.Popen(
                [
                    sys.executable, "-m", "ray_tpu_torch.core.worker_zygote",
                    "--raylet-address", self.address,
                    "--gcs-address", self.gcs_address,
                    "--node-id", self.node_id.hex(),
                    "--store-path", self.store_path,
                    "--store-capacity", str(self.object_store_capacity),
                ],
                env=env,
                cwd=working_dir,
                stdin=subprocess.PIPE,
                stdout=subprocess.PIPE,
                stderr=open(os.path.join(
                    self._session_dir,
                    f"zygote-{self.node_id.hex()[:12]}"
                    f"{'-' + key[:8] if key else ''}.err"), "ab"),
            )
            ready = json.loads(z.stdout.readline())
            if not ready.get("ready"):
                raise RuntimeError(f"unexpected zygote handshake {ready!r}")
            zh.proc = z
        except Exception as e:
            logger.warning("worker zygote (env %s) unavailable (%s); "
                           "using direct spawn", key or "default", e)
        finally:
            zh.booting = False

    def _kick_zygote(self, key: str, runtime_env: dict | None = None) -> None:
        """(Re)boot the zygote for env ``key`` off the event loop if it
        isn't running."""
        zh = self._zygotes.get(key)
        if zh is None:
            zh = self._zygotes[key] = ZygoteHandle(renv=runtime_env)
        if zh.booting:
            return
        if zh.proc is not None and zh.proc.poll() is None:
            return
        zh.proc = None
        zh.booting = True
        if _in_loop():
            asyncio.get_running_loop().run_in_executor(
                None, self._boot_zygote, key)
        else:
            self._boot_zygote(key)

    def _spawn_via_zygote(self, key: str, worker_id: str, log_path: str,
                          runtime_env: dict | None = None) -> int | None:
        import json
        import select

        zh = self._zygotes.get(key)
        if zh is None or zh.proc is None or zh.proc.poll() is not None:
            self._kick_zygote(key, runtime_env)  # warms up in the background
            return None  # this spawn goes direct
        req = {"worker_id": worker_id, "log": log_path,
               "env": {"RAY_TPU_TORCH_WORKER_ID": worker_id}}
        z = zh.proc
        try:
            # The protocol lock serializes request/reply framing: pool
            # refills running in executor threads must not interleave
            # writes with a lease-path fork on the raylet loop.
            with zh.lock:
                z.stdin.write((json.dumps(req) + "\n").encode())
                z.stdin.flush()
                # Bounded wait: a wedged zygote must not stall the caller
                # (fork replies normally arrive in single-digit ms).
                ready, _, _ = select.select([z.stdout], [], [], 5.0)
                if not ready:
                    raise TimeoutError("zygote fork reply timed out")
                reply = json.loads(z.stdout.readline())
            return int(reply["pid"])
        except Exception as e:
            logger.warning("zygote fork failed (%s); using direct spawn", e)
            try:
                z.kill()
            except Exception:
                pass
            zh.proc = None
            return None

    def _touch_pool_key(self, env_hash: str, runtime_env: dict | None) -> None:
        """LRU-touch a non-default env key in the zygote pool: the
        maintenance loop keeps zygote_pool_size idle workers per hot key;
        over zygote_pool_max_keys the coldest key is evicted."""
        cfg = get_config()
        if (not env_hash or cfg.zygote_pool_size <= 0
                or not cfg.enable_worker_zygote
                or not self._zygote_eligible(runtime_env)):
            return
        self._pool_keys.pop(env_hash, None)
        self._pool_keys[env_hash] = {"renv": runtime_env,
                                     "last_used": time.monotonic()}
        while len(self._pool_keys) > max(1, cfg.zygote_pool_max_keys):
            self._evict_pool_key(next(iter(self._pool_keys)))

    def _evict_pool_key(self, env_hash: str) -> None:
        """Evict one env key from the pool: its zygote dies and its idle
        pooled workers are killed — a pooled worker is only ever handed
        to a lease with the SAME env hash, so mismatched residue is pure
        memory cost."""
        self._pool_keys.pop(env_hash, None)
        zh = self._zygotes.pop(env_hash, None)
        if zh is not None and zh.proc is not None:
            try:
                zh.proc.kill()
            except Exception:
                pass
        for wid in list(self._idle):
            w = self._workers.get(wid)
            if w is not None and w.env_hash == env_hash:
                if w.proc is not None:
                    w.proc.terminate()
                self._on_worker_dead(w)
        logger.info("zygote pool evicted env key %s", env_hash[:8])

    def _start_worker(self, runtime_env: dict | None = None) -> WorkerHandle:
        worker_id = WorkerID.from_random().hex()
        log_path = os.path.join(self._session_dir, f"worker-{worker_id[:12]}.out")
        env_hash = self._env_hash(runtime_env)
        if get_config().enable_worker_zygote and self._zygote_eligible(runtime_env):
            # Fork from the env-keyed warm zygote image (~ms) instead of
            # paying interpreter boot + imports per process. First use of
            # an env key boots its zygote in the background and this
            # spawn falls through to the direct (cold) path. (LRU touch
            # happens on the LEASE path, not here — pool refills must not
            # keep their own key artificially hot.)
            pid = self._spawn_via_zygote(env_hash, worker_id, log_path,
                                         runtime_env)
            if pid is not None:
                handle = WorkerHandle(worker_id=worker_id, pid=pid,
                                      proc=PidHandle(pid), env_hash=env_hash,
                                      spawn_mode="pooled",
                                      spawn_started_at=time.monotonic())
                handle.registered = (
                    asyncio.get_running_loop().create_future() if _in_loop() else None)
                self._workers[worker_id] = handle
                return handle
        env, working_dir = self._worker_env(runtime_env)
        env["RAY_TPU_TORCH_WORKER_ID"] = worker_id
        from .runtime_env import resolve_python_executable, wrap_worker_command

        # Interpreter-level plugins: py_executable / conda pick the
        # worker's python; container wraps the whole command in
        # podman/docker. Failures raise BEFORE the Popen so the lease
        # reply carries the plugin's error, not a crash-looping worker.
        py = resolve_python_executable(runtime_env) or sys.executable
        cmd = wrap_worker_command(
            [
                py,
                "-m",
                "ray_tpu_torch.core.worker_main",
                "--raylet-address",
                self.address,
                "--gcs-address",
                self.gcs_address,
                "--node-id",
                self.node_id.hex(),
                "--worker-id",
                worker_id,
                "--store-path",
                self.store_path,
                "--store-capacity",
                str(self.object_store_capacity),
            ],
            runtime_env,
        )
        proc = subprocess.Popen(
            cmd,
            env=env,
            cwd=working_dir,
            stdout=open(log_path, "wb"),
            stderr=subprocess.STDOUT,
        )
        handle = WorkerHandle(worker_id=worker_id, pid=proc.pid, proc=proc,
                              env_hash=env_hash, spawn_mode="cold",
                              spawn_started_at=time.monotonic())
        handle.registered = asyncio.get_running_loop().create_future() if _in_loop() else None
        self._workers[worker_id] = handle
        return handle

    async def handle_RegisterWorker(self, p: dict) -> dict:
        w = self._workers.get(p["worker_id"])
        if w is None:
            # Worker started externally (e.g. driver core worker) — track it.
            w = WorkerHandle(worker_id=p["worker_id"])
            self._workers[p["worker_id"]] = w
        w.address = p["address"]
        w.pid = p.get("pid", w.pid)
        if p.get("is_driver"):
            w.state = "driver"
            return {"node_id": self.node_id.hex()}
        if w.state == "starting":
            w.state = "idle"
            w.last_idle_time = time.monotonic()
            self._idle.append(w.worker_id)
            if w.spawn_started_at:
                # Spawn-to-register latency, the zygote pool's evidence
                # trail (cold Popen vs warm-image fork).
                _spawn_hist().observe(
                    (time.monotonic() - w.spawn_started_at) * 1000.0,
                    {"mode": w.spawn_mode})
                self._spawn_stats[w.spawn_mode] = (
                    self._spawn_stats.get(w.spawn_mode, 0) + 1)
                w.spawn_started_at = 0.0
        if w.registered is not None and not w.registered.done():
            w.registered.set_result(True)
        self._wake_lease_waiters()
        return {"node_id": self.node_id.hex()}

    def _zygote_live(self, env_hash: str) -> bool:
        zh = self._zygotes.get(env_hash)
        return (zh is not None and zh.proc is not None
                and zh.proc.poll() is None)

    async def _get_idle_worker(self, timeout: float, runtime_env: dict | None = None) -> WorkerHandle | None:
        """Pop an idle registered worker whose env matches, starting one if
        needed (reference: worker_pool runtime-env-hash matching)."""
        want = self._env_hash(runtime_env)
        self._touch_pool_key(want, runtime_env)
        deadline = time.monotonic() + timeout
        while True:
            for wid in list(self._idle):
                w = self._workers.get(wid)
                if w is None:
                    self._idle.remove(wid)
                    continue
                if w.proc is not None and w.proc.poll() is not None:
                    # Died while idle (e.g. OOM-killed between return and
                    # re-lease) — reap now rather than leasing a corpse.
                    self._on_worker_dead(w)
                    continue
                if w.state == "idle" and w.env_hash == want:
                    self._idle.remove(wid)
                    return w
            starting = sum(
                1 for w in self._workers.values()
                if w.state == "starting" and w.env_hash == want
            )
            cfg = get_config()
            # A live zygote makes spawns ~ms forks with no import storm:
            # allow a wider in-flight bound so a creation storm drains at
            # fork speed instead of queueing behind the cold-spawn cap.
            startup_cap = (max(cfg.maximum_startup_concurrency,
                               cfg.zygote_max_fork_concurrency)
                           if self._zygote_live(want)
                           else cfg.maximum_startup_concurrency)
            if starting < startup_cap:
                self._start_worker(runtime_env)
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._lease_waiters.append(fut)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            try:
                await asyncio.wait_for(fut, remaining)
            except asyncio.TimeoutError:
                return None

    def _wake_lease_waiters(self) -> None:
        # Hand freed resources to parked admission waiters FIRST (in
        # priority+FIFO order), then wake idle-worker/bundle waiters.
        self._dispatch_admission()
        waiters, self._lease_waiters = self._lease_waiters, []
        for fut in waiters:
            if not fut.done():
                fut.set_result(True)

    def _dispatch_admission(self) -> None:
        """Grant queued resource reservations in (priority, seq) order.
        Strict head-of-line: a request never overtakes an earlier one it
        could outrace — that race was the actor-creation starvation."""
        while self._admission_queue:
            entry = self._admission_queue[0]
            if entry["fut"].done():  # timed out / cancelled waiter
                self._admission_queue.pop(0)
                continue
            if not self.resources.can_fit(entry["request"]):
                break
            self.resources.acquire(entry["request"])
            self._admission_queue.pop(0)
            entry["fut"].set_result(True)

    async def _acquire_resources_queued(self, request: ResourceSet, priority: int, deadline: float) -> bool:
        """Reserve ``request`` against the node pool, waiting FIFO within
        priority class (0 = actor creation, 1 = normal tasks). Returns False
        on deadline. On True the reservation is held by the caller."""
        if not self._admission_queue and self.resources.can_fit(request):
            self.resources.acquire(request)
            return True
        self._admission_seq += 1
        entry = {
            "prio": priority,
            "seq": self._admission_seq,
            "request": request,
            "fut": asyncio.get_running_loop().create_future(),
            # Lease-wedge watchdog input — on the chaos clock so virtual
            # time replays the wedge thresholds deterministically.
            "enqueued_at": chaos_clock.now(),
        }
        # Insert in (priority, seq) order: earlier same-priority requests
        # stay ahead; higher-priority (lower number) requests go first.
        at = len(self._admission_queue)
        for i, e in enumerate(self._admission_queue):
            if (entry["prio"], entry["seq"]) < (e["prio"], e["seq"]):
                at = i
                break
        self._admission_queue.insert(at, entry)
        self._dispatch_admission()  # we may be admissible right now
        with self._track_demand(request):
            while not entry["fut"].done():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    try:
                        self._admission_queue.remove(entry)
                    except ValueError:
                        pass
                    # Lost race: granted between the deadline check and
                    # removal — keep the reservation and proceed.
                    return entry["fut"].done()
                try:
                    # Periodic re-dispatch guards against a missed wake.
                    await asyncio.wait_for(asyncio.shield(entry["fut"]), min(remaining, 0.5))
                except asyncio.TimeoutError:
                    self._dispatch_admission()
        return True

    @contextlib.contextmanager
    def _track_demand(self, request: ResourceSet):
        """Count this request's shape in `_pending_lease_demand` for the
        scope of a wait (heartbeats report it as autoscaler demand)."""
        shape = tuple(sorted(request.to_dict().items()))
        self._pending_lease_demand[shape] = self._pending_lease_demand.get(shape, 0) + 1
        try:
            yield
        finally:
            left = self._pending_lease_demand.get(shape, 1) - 1
            if left > 0:
                self._pending_lease_demand[shape] = left
            else:
                self._pending_lease_demand.pop(shape, None)

    # ---------------------------------------------------------- lease service
    async def _task_event_flush_loop(self) -> None:
        """Flush raylet-recorded task events/spans (LEASED, lease/spawn
        spans) to the GCS — the raylet's half of the worker flusher."""
        interval = get_config().task_events_flush_interval_ms / 1000.0
        while True:
            await asyncio.sleep(interval)
            events, dropped = self._task_events.drain()
            if not events and not dropped:
                continue
            try:
                await self._gcs.call(
                    "AddTaskEvents", {"events": events, "dropped": dropped},
                    timeout=10.0)
            except Exception:
                pass

    def _record_lease_grant(self, spec: dict, t_arrive: float,
                            queue_wait_ms: float, spawn_ms: float) -> None:
        """Record the LEASED transition (with the raylet-measured stage
        timings) and, when the spec is traced, the lease + worker-spawn
        spans — all fire-and-forget into the local event buffer."""
        task_id = spec.get("task_id") or b""
        if not task_id:
            return
        self._task_events.record(
            task_id, spec.get("name", ""), "LEASED", kind=spec.get("kind", 0),
            extra={"queue_wait_ms": round(queue_wait_ms, 3),
                   "spawn_ms": round(spawn_ms, 3),
                   "trace_id": spec.get("trace_id", "")})
        trace_id = spec.get("trace_id") or ""
        if not trace_id:
            return
        from ..observability import tracing

        now = time.time()
        start = now - (time.monotonic() - t_arrive)
        lease_span = tracing.make_span(
            f"lease {spec.get('name', '')}", "lease", start, now, trace_id,
            spec.get("span_id", ""),
            attrs={"queue_wait_ms": round(queue_wait_ms, 3),
                   "node_id": self.node_id.hex()})
        self._task_events.record_span(lease_span)
        if spawn_ms > 1.0:
            self._task_events.record_span(tracing.make_span(
                "worker spawn/setup", "lease", now - spawn_ms / 1000.0, now,
                trace_id, lease_span["span_id"],
                attrs={"node_id": self.node_id.hex()}))

    async def handle_RequestWorkerLease(self, p: dict) -> dict:
        """ClusterTaskManager::QueueAndScheduleTask equivalent
        (cluster_task_manager.cc:48): grant locally, or spill to a better
        node, or queue until resources free up."""
        spec = p["spec"]
        t_arrive = time.monotonic()
        request = self._lease_request_set(spec)
        grant_only_local = bool(p.get("grant_only_local") or p.get("dedicated"))

        # Draining (preemption notice): this node admits NOTHING new —
        # whatever it granted now would die inside the grace window.
        # Spill to a non-draining peer when one fits; otherwise refuse.
        if self._draining:
            if not grant_only_local:
                await self._refresh_node_table(max_age_s=0.45)
                node = (self._pick_remote_node(request, require_available=True)
                        or self._pick_remote_node(request))
                if node is not None:
                    return {"spillback": True, "node_address": node["address"],
                            "node_id": node["node_id"]}
            return {"granted": False,
                    "reason": "node draining (preemption notice)"}

        # Placement-group tasks run on the node holding their bundle and
        # draw resources from the bundle's reservation, not the node pool
        # (reference: bundle_scheduling_policy.cc, bundle resources are real).
        pg_id = spec.get("placement_group_id") or b""
        if pg_id:
            pg_hex = pg_id.hex() if isinstance(pg_id, bytes) else pg_id
            idx = spec.get("placement_group_bundle_index", -1)
            if not self._has_local_bundle(pg_hex, idx):
                target = await self._pg_bundle_node(pg_hex, idx)
                if target is None:
                    return {"granted": False, "reason": f"placement group {pg_hex} not created"}
                if target != self.node_id.hex():
                    node = self._node_table.get(target)
                    if node is None:
                        await self._refresh_node_table()
                        node = self._node_table.get(target)
                    if node is None:
                        return {"granted": False, "reason": "bundle node lost"}
                    return {"spillback": True, "node_address": node["address"], "node_id": target}
            return await self._grant_in_bundle(p, spec, pg_hex, idx)

        # Spread strategy: round-robin the lease over all feasible nodes
        # BEFORE considering local fit (policy/spread_scheduling_policy.cc);
        # otherwise lease pipelining would pack every task onto one node.
        strategy = spec.get("scheduling_strategy") or {}
        if strategy.get("type") == "spread" and not grant_only_local and not p.get("spilled"):
            from .scheduling import select_node_for_resources

            await self._refresh_node_table()
            pick = select_node_for_resources(
                self._node_table, self._lease_resources(spec), strategy
            )
            if pick is not None and pick != self.node_id.hex():
                node = self._node_table.get(pick)
                if node is not None:
                    return {"spillback": True, "node_address": node["address"], "node_id": pick}

        if not request.subset_of(self.resources.total):
            # A dedicated lease the GCS queued here because no node fits
            # (``wait_infeasible``) waits below like any other, so its
            # shape is reported as demand.
            if grant_only_local and not p.get("wait_infeasible"):
                return {"granted": False, "reason": "infeasible on this node"}
            # Infeasible locally: wait (bounded) for a feasible peer — the
            # node table may be stale, a node may be joining, or the
            # autoscaler may launch one for the demand we report here.
            deadline = time.monotonic() + get_config().worker_register_timeout_s
            with self._track_demand(request):
                while True:
                    # Infeasible waiters SHARE one cached refresh per poll
                    # beat instead of each paying a GCS round trip.
                    await self._refresh_node_table(max_age_s=0.45)
                    node = self._pick_remote_node(request)
                    if node is not None:
                        return {"spillback": True, "node_address": node["address"], "node_id": node["node_id"]}
                    if time.monotonic() > deadline:
                        return {"granted": False, "reason": "infeasible everywhere"}
                    await asyncio.sleep(0.5)

        # Spillback decision before queuing (hybrid policy): if we cannot fit
        # now but another node can, send the lease there.
        if not self.resources.can_fit(request) and not grant_only_local:
            node = self._pick_remote_node(request, require_available=True)
            if node is not None and node["node_id"] != self.node_id.hex():
                return {"spillback": True, "node_address": node["address"], "node_id": node["node_id"]}

        # Reserve resources through the admission queue: actor creations
        # (dedicated leases) rank ahead of normal tasks, FIFO within class,
        # and the releaser grants directly to the head — no wake-and-race.
        deadline = time.monotonic() + get_config().worker_register_timeout_s
        priority = 0 if (p.get("dedicated") or spec.get("kind", 0) == 1) else 1
        if not await self._acquire_resources_queued(request, priority, deadline):
            return {"granted": False, "reason": "timed out waiting for resources"}
        queue_wait_ms = (time.monotonic() - t_arrive) * 1000.0

        t_spawn = time.monotonic()
        try:
            worker = await self._get_idle_worker(
                get_config().worker_register_timeout_s, spec.get("runtime_env")
            )
        except Exception as e:
            self.resources.release(request)  # never leak the reservation
            return {"granted": False, "reason": f"worker start failed: {e}"}
        if worker is None:
            self.resources.release(request)
            return {"granted": False, "reason": "no worker available"}
        worker.lease_resources = request
        worker.state = "dedicated" if p.get("dedicated") else "leased"
        worker.lease_time = time.monotonic()
        worker.retriable = bool(spec.get("max_retries", 0)) and not p.get("dedicated")
        worker.lease_acked = False
        worker.lease_granted_at = chaos_clock.now()
        worker.orphan_probe = None
        if p.get("dedicated"):
            actor_id = spec.get("actor_id", b"")
            worker.actor_id = actor_id.hex() if isinstance(actor_id, bytes) else actor_id
        self._record_lease_grant(spec, t_arrive, queue_wait_ms,
                                 (time.monotonic() - t_spawn) * 1000.0)
        self._maybe_chaos_kill_lease(worker)
        extras = self._try_extra_grants(p, spec, request)
        self._wake_lease_waiters()
        reply = {
            "granted": True,
            "worker_id": worker.worker_id,
            "worker_address": worker.address,
            "node_id": self.node_id.hex(),
        }
        if extras:
            reply["extra_grants"] = extras
        return reply

    def _try_extra_grants(self, p: dict, spec: dict,
                          request: ResourceSet) -> list[dict]:
        """Best-effort additional grants for a multiplexed lease request
        (``num_workers`` > 1: the owner's queue is deep). Only workers
        that are idle RIGHT NOW with a matching env, and resources that
        fit without queuing, are granted — anything slower would delay
        the primary reply — and nothing is granted past parked admission
        waiters (they reserved their place in line first). LEASED task
        events are NOT recorded here: the owner stamps LEASED at dispatch
        for every task it pushes onto a multiplexed lease, exactly as it
        does for reused leases, so per-task records stay identical to the
        one-lease-per-RPC path."""
        want = min(int(p.get("num_workers") or 1), 64) - 1
        extras: list[dict] = []
        if want <= 0 or p.get("dedicated"):
            return extras
        env_hash = self._env_hash(spec.get("runtime_env"))
        while len(extras) < want:
            if self._admission_queue or not self.resources.can_fit(request):
                break
            w = None
            for wid in list(self._idle):
                cand = self._workers.get(wid)
                if cand is None:
                    self._idle.remove(wid)
                    continue
                if cand.proc is not None and cand.proc.poll() is not None:
                    self._on_worker_dead(cand)
                    continue
                if cand.state == "idle" and cand.env_hash == env_hash:
                    self._idle.remove(wid)
                    w = cand
                    break
            if w is None:
                # No idle worker: warm the pool for the NEXT request, but
                # never block this reply on a spawn.
                starting = sum(1 for x in self._workers.values()
                               if x.state == "starting" and x.env_hash == env_hash)
                if starting < get_config().maximum_startup_concurrency:
                    try:
                        self._start_worker(spec.get("runtime_env"))
                    except Exception:
                        pass
                break
            self.resources.acquire(request)
            w.lease_resources = request
            w.state = "leased"
            w.lease_time = time.monotonic()
            w.retriable = bool(spec.get("max_retries", 0))
            w.lease_acked = False
            w.lease_granted_at = chaos_clock.now()
            w.orphan_probe = None
            self._maybe_chaos_kill_lease(w)
            extras.append({"worker_id": w.worker_id,
                           "worker_address": w.address})
        return extras

    def _maybe_chaos_kill_lease(self, worker: WorkerHandle) -> None:
        """Chaos injection point: SIGKILL the worker of the lease just
        granted (kill-on-Nth-lease FaultPlan rule) — the owner's task push
        fails and the retry / actor-restart machinery takes over."""
        if worker.proc is None:
            return
        if not get_chaos().take_kill_on_lease(self.node_id.hex()):
            return
        logger.warning("chaos: killing worker %s (pid %d) of the lease just "
                       "granted", worker.worker_id[:12], worker.pid)
        try:
            worker.proc.kill()
        except Exception:
            pass

    async def _grant_in_bundle(self, p: dict, spec: dict, pg_hex: str, idx: int) -> dict:
        """Lease a worker whose resources are charged against a committed
        bundle's reservation (so bundles cannot be oversubscribed)."""
        res = dict(spec.get("resources") or {})
        if not res:
            res = {"CPU": 1.0}
        request = ResourceSet(res)
        t_arrive = time.monotonic()
        deadline = time.monotonic() + get_config().worker_register_timeout_s
        key = None
        while True:
            key = self._pick_bundle(pg_hex, idx, request)
            if key is not None:
                b = self._pg_bundles[key]
                b["used"] = b["used"].add(request)
                break
            if time.monotonic() > deadline:
                return {"granted": False, "reason": f"bundle {pg_hex}[{idx}] has no spare capacity for {res}"}
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._lease_waiters.append(fut)
            try:
                await asyncio.wait_for(fut, 0.5)
            except asyncio.TimeoutError:
                pass
        queue_wait_ms = (time.monotonic() - t_arrive) * 1000.0
        t_spawn = time.monotonic()
        try:
            worker = await self._get_idle_worker(
                get_config().worker_register_timeout_s, spec.get("runtime_env")
            )
        except Exception as e:
            worker = None
            reason = f"worker start failed: {e}"
        else:
            reason = "no worker available"
        if worker is None:
            b = self._pg_bundles.get(key)
            if b is not None:
                b["used"] = b["used"].subtract(request, allow_negative=True)
            return {"granted": False, "reason": reason}
        self._record_lease_grant(spec, t_arrive, queue_wait_ms,
                                 (time.monotonic() - t_spawn) * 1000.0)
        worker.lease_resources = request
        worker.bundle_key = key
        worker.state = "dedicated" if p.get("dedicated") else "leased"
        worker.lease_time = time.monotonic()
        worker.retriable = bool(spec.get("max_retries", 0)) and not p.get("dedicated")
        worker.lease_acked = False
        worker.lease_granted_at = chaos_clock.now()
        worker.orphan_probe = None
        if p.get("dedicated"):
            actor_id = spec.get("actor_id", b"")
            worker.actor_id = actor_id.hex() if isinstance(actor_id, bytes) else actor_id
        self._maybe_chaos_kill_lease(worker)
        self._wake_lease_waiters()
        return {
            "granted": True,
            "worker_id": worker.worker_id,
            "worker_address": worker.address,
            "node_id": self.node_id.hex(),
        }

    def _pick_bundle(self, pg_hex: str, idx: int, request: ResourceSet) -> tuple | None:
        """Find a committed local bundle with spare capacity for `request`."""
        for key, b in self._pg_bundles.items():
            if key[0] != pg_hex or not b.get("committed"):
                continue
            if idx >= 0 and key[1] != idx:
                continue
            spare = b["resources"].subtract(b["used"], allow_negative=True)
            if request.subset_of(spare):
                return key
        return None

    def _has_local_bundle(self, pg_hex: str, idx: int) -> bool:
        if idx >= 0:
            b = self._pg_bundles.get((pg_hex, idx))
            return bool(b and b.get("committed"))
        return any(
            k[0] == pg_hex and b.get("committed") for k, b in self._pg_bundles.items()
        )

    async def _pg_bundle_node(self, pg_hex: str, idx: int) -> str | None:
        try:
            reply = await self._gcs.call("GetPlacementGroup", {"pg_id": pg_hex}, timeout=5.0)
        except Exception:
            return None
        pg = reply.get("pg") or {}
        locations = pg.get("bundle_locations") or []
        if not locations:
            return None
        if idx >= 0:
            return locations[idx] if idx < len(locations) else None
        return locations[0]

    def _lease_resources(self, spec: dict) -> dict:
        res = dict(spec.get("resources") or {})
        if not res and spec.get("kind", 0) == 0:
            res = {"CPU": 1.0}
        return res

    def _lease_request_set(self, spec: dict) -> ResourceSet:
        """Cached fixed-point ResourceSet for a lease request's shape.
        Safe to share: ResourceSet algebra never mutates in place (every
        acquire/release builds a new set), so N requests and N worker
        ``lease_resources`` fields may all alias one object."""
        res = self._lease_resources(spec)
        key = tuple(sorted(res.items()))
        cached = self._request_shape_cache.get(key)
        if cached is None:
            if len(self._request_shape_cache) > 256:
                self._request_shape_cache.clear()
            cached = self._request_shape_cache[key] = ResourceSet(res)
        return cached

    async def _refresh_node_table(self, max_age_s: float = 0.0) -> None:
        """GetAllNodes into the local cache. Concurrent refreshers share
        ONE in-flight RPC, and ``max_age_s`` > 0 accepts a recent-enough
        cache outright — N parked infeasible-lease waiters used to each
        fire their own GCS round trip every 0.5 s poll beat."""
        if max_age_s > 0 and time.monotonic() - self._node_table_ts < max_age_s:
            return
        if self._node_table_refresh is not None:
            await asyncio.shield(self._node_table_refresh)
            return
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._node_table_refresh = fut
        try:
            nodes = await self._gcs.call("GetAllNodes", {}, timeout=5.0)
            self._node_table = {n["node_id"]: n for n in nodes["nodes"]}
            self._node_table_ts = time.monotonic()
        except Exception:
            pass
        finally:
            self._node_table_refresh = None
            if not fut.done():
                fut.set_result(None)

    def _pick_remote_node(self, request: ResourceSet, require_available: bool = False) -> dict | None:
        best = None
        for node_id, node in self._node_table.items():
            if node_id == self.node_id.hex() or node.get("state") != "ALIVE" \
                    or node.get("draining"):
                continue
            nr = NodeResources.from_dict(node["resources"])
            if require_available and not nr.can_fit(request):
                continue
            if not request.subset_of(nr.total):
                continue
            if best is None or nr.utilization() < best[1]:
                best = (node, nr.utilization())
        return best[0] if best else None

    async def handle_PinLoopWorker(self, p: dict) -> dict:
        """Mark/unmark the worker hosting ``actor_id`` as parking a
        resident compiled-loop executor (exempt from orphan-lease
        reclaim — see WorkerHandle.loop_pinned)."""
        actor_id = p.get("actor_id") or ""
        pinned = bool(p.get("pinned", True))
        for w in self._workers.values():
            if actor_id and w.actor_id == actor_id and w.state != "dead":
                w.loop_pinned = pinned
                return {"ok": True, "worker_id": w.worker_id}
        return {"ok": False}

    async def handle_AckLease(self, p: dict) -> dict:
        """Owner (or the GCS, for dedicated leases) confirms it received
        the grant reply. Un-acked leases past ``lease_orphan_timeout_s``
        are reclaimed by the watchdog — a grant whose reply was lost in
        transit otherwise strands its reservation forever (the ROADMAP-1c
        lease-timeout cascade)."""
        ids = list(p.get("worker_ids") or ())
        if p.get("worker_id"):
            ids.append(p["worker_id"])
        for wid in ids:
            w = self._workers.get(wid)
            if w is not None:
                w.lease_acked = True
        return {}

    async def handle_ReturnWorker(self, p: dict) -> dict:
        w = self._workers.get(p["worker_id"])
        if w is None or w.state == "dead":
            return {}
        if self._release_lease(w):
            # GPU device fence: the worker was killed and must not rejoin
            # the idle pool; the GPU re-grant happens when it is dead.
            self._on_worker_dead(w)
            self._wake_lease_waiters()
            return {}
        if w.proc is not None and w.proc.poll() is not None:
            self._on_worker_dead(w)
            self._wake_lease_waiters()
            return {}
        if p.get("kill"):
            if w.proc is not None:
                w.proc.terminate()
            self._on_worker_dead(w)
        else:
            w.state = "idle"
            w.actor_id = ""
            w.last_idle_time = time.monotonic()
            self._idle.append(w.worker_id)
        self._wake_lease_waiters()
        return {}

    async def handle_HealthCheck(self, p: dict) -> dict:
        return {"node_id": self.node_id.hex()}

    # ------------------------------------------------------------- preemption
    async def handle_PreemptionNotice(self, p: dict) -> dict:
        """GCE-style preemption notice delivered over RPC (the instance
        manager / test harness path; the chaos engine delivers the same
        notice in-process via ``take_preempt_slice``)."""
        started = self.begin_draining(
            p.get("reason") or "preemption notice",
            grace_s=p.get("grace_s"))
        return {"draining": True, "started": started,
                "node_id": self.node_id.hex()}

    def begin_draining(self, reason: str, grace_s: float | None = None) -> bool:
        """Enter the draining state: no new leases are admitted (requests
        spill to non-draining peers), buffered task events are flushed,
        the GCS is told to flag the node and publish ``node_preempted``,
        and after the grace window the workers are killed and the node is
        reported dead. Must run on the raylet loop."""
        if self._draining or self._shutdown:
            return False
        self._draining = True
        self._draining_since = chaos_clock.now()
        self._drain_reason = reason
        logger.warning("node %s draining (%s): refusing new leases, dying in "
                       "%.1fs grace", self.node_id.hex()[:8], reason,
                       get_config().preempt_grace_s if grace_s is None
                       else float(grace_s))
        self._tasks.append(spawn(self._drain_to_death(grace_s)))
        return True

    async def _drain_to_death(self, grace_s: float | None) -> None:
        grace = (get_config().preempt_grace_s if grace_s is None
                 else float(grace_s))
        # Flush buffered task events NOW — after the VM reclaim nothing
        # ships them, and the whole point of the drain is that no
        # observability is lost to the preemption.
        events, dropped = self._task_events.drain()
        try:
            if events or dropped:
                await self._gcs.call(
                    "AddTaskEvents", {"events": events, "dropped": dropped},
                    timeout=10.0)
        except Exception:
            pass
        try:
            await self._gcs.call("ReportNodeDraining", {
                "node_id": self.node_id.hex(),
                "reason": self._drain_reason,
                "grace_s": grace,
                "notice_clock": self._draining_since,
            }, timeout=10.0)
        except Exception:
            pass
        await chaos_clock.sleep(grace)
        if self._shutdown:
            return
        logger.warning("preemption grace expired on node %s: reclaiming "
                       "(killing %d workers)", self.node_id.hex()[:8],
                       len(self._workers))
        for w in list(self._workers.values()):
            if w.proc is not None and w.proc.poll() is None:
                try:
                    w.proc.kill()
                except Exception:
                    pass
        try:
            await self._gcs.call("NodePreempted", {
                "node_id": self.node_id.hex(),
                "reason": self._drain_reason,
            }, timeout=10.0)
        except Exception:
            pass

    # ----------------------------------------------------------- spill manager
    def _create_with_spill(self, oid: bytes, data_size: int, meta_size: int) -> int:
        """Allocate, spilling pinned primaries to disk if LRU eviction of
        secondary copies wasn't enough (local_object_manager.cc
        SpillObjectsOfSize)."""
        try:
            offset = self.store.create(oid, data_size, meta_size)
        except StoreFullError:
            self._spill_objects(data_size + meta_size)
            offset = self.store.create(oid, data_size, meta_size)
            self._fallback_allocations_total += 1
        self._store_used_peak = max(self._store_used_peak, self.store.used())
        return offset

    def _spill_objects(self, nbytes: int) -> int:
        """Move the oldest unreferenced pinned objects out of shm until
        ~`nbytes` are free. Space is reclaimed synchronously (callers need
        it now); the disk write itself is offloaded to an executor thread so
        the event loop — heartbeats, leases — never stalls on file I/O
        (reference: spill runs in dedicated IO workers). Until the write
        completes the blob is served from ``_spill_pending``."""
        freed = 0
        for oid in list(self._pinned):
            if freed >= nbytes:
                break
            if self.store.contains(oid) != 2 or self.store.ref_count(oid) > 0:
                continue  # mid-read or unsealed: not spillable right now
            info = self.store.get_info(oid)
            if info is None:
                self._pinned.pop(oid, None)
                continue
            offset, data_size, meta_size = info
            blob = bytes(self.store.read(offset, data_size + meta_size))
            self.store.unpin(oid)
            self.store.delete(oid, force=False)
            self._pinned.pop(oid, None)
            self._spilled[oid] = (data_size, meta_size)
            self._spill_pending[oid] = blob
            if _in_loop():
                spawn(self._write_spill_file(oid, blob))
            else:
                try:
                    self._write_file(self._spill_path(oid), blob)
                    self._spill_pending.pop(oid, None)
                except OSError as e:
                    # Disk write failed (full disk / chaos injection): the
                    # blob stays in _spill_pending, so the object remains
                    # restorable from memory — degraded, never lost.
                    logger.warning("spill write of %s failed: %s "
                                   "(kept in memory)", oid.hex()[:12], e)
            self._spilled_bytes_total += data_size + meta_size
            self._spilled_objects_total += 1
            meta = self._object_meta.get(oid)
            if meta is not None:
                meta["spilled"] = True
            freed += data_size + meta_size
        return freed

    def _spill_path(self, oid: bytes) -> str:
        return os.path.join(self._spill_dir, oid.hex())

    def _write_file(self, path: str, blob: bytes) -> None:
        if get_chaos().maybe_fail_spill():
            raise OSError("chaos-injected spill write failure")
        os.makedirs(self._spill_dir, exist_ok=True)
        with open(path, "wb") as f:
            f.write(blob)

    async def _write_spill_file(self, oid: bytes, blob: bytes) -> None:
        path = self._spill_path(oid)
        try:
            await asyncio.get_running_loop().run_in_executor(
                None, self._write_file, path, blob)
        except OSError as e:
            # Failed disk write: keep the blob in _spill_pending — restore
            # serves it from memory, and a later spill pass may re-spill it.
            logger.warning("spill write of %s failed: %s (kept in memory)",
                           oid.hex()[:12], e)
            return
        # Identity check: a restore + re-spill while we were writing installs
        # a new pending blob (and its own write task) — leave those alone.
        if self._spill_pending.get(oid) is blob:
            self._spill_pending.pop(oid, None)
        if oid not in self._spilled:
            # Deleted or restored while the write was in flight.
            try:
                os.unlink(path)
            except OSError:
                pass

    async def _restore_spilled(self, oid: bytes) -> bool:
        """Bring a spilled object back into shm (restore-on-Get,
        local_object_manager.cc AsyncRestoreSpilledObject)."""
        sizes = self._spilled.get(oid)
        if sizes is None:
            return False
        data_size, meta_size = sizes
        blob = self._spill_pending.get(oid)
        if blob is None:
            path = self._spill_path(oid)
            loop = asyncio.get_running_loop()
            try:
                blob = await loop.run_in_executor(None, lambda: open(path, "rb").read())
            except OSError:
                return False
        if oid not in self._spilled:
            return True  # a concurrent handler restored it during the read
        offset = self._create_with_spill(oid, data_size, meta_size)
        self.store.write(offset, blob)
        self.store.seal(oid)
        self.store.pin(oid)
        self.store.release(oid)
        self._pinned[oid] = data_size + meta_size
        self._spilled.pop(oid, None)
        self._spill_pending.pop(oid, None)
        self._restored_bytes_total += data_size + meta_size
        self._restored_objects_total += 1
        meta = self._object_meta.get(oid)
        if meta is not None:
            meta["spilled"] = False
        try:
            os.unlink(self._spill_path(oid))
        except OSError:
            pass
        return True

    async def _log_monitor_loop(self) -> None:
        """Tail this node's worker log files and forward new lines to the
        GCS log channel (reference ``log_monitor.py``: per-node agent
        tailing worker logs for the driver)."""
        import glob

        offsets: dict[str, int] = {}
        period = get_config().log_monitor_poll_ms / 1000.0
        while True:
            await asyncio.sleep(period)
            batch = []
            staged: dict[str, int] = {}  # offsets commit only after publish
            for path in glob.glob(os.path.join(self._session_dir, "worker-*.out")):
                try:
                    size = os.path.getsize(path)
                except OSError:
                    continue
                start = offsets.get(path, 0)
                if size <= start:
                    continue
                try:
                    with open(path, "rb") as f:
                        f.seek(start)
                        chunk = f.read(min(size - start, 256 * 1024))
                except OSError:
                    continue
                # forward whole lines only; carry partial tails to next tick
                cut = chunk.rfind(b"\n") + 1
                if cut == 0:
                    if len(chunk) < 256 * 1024:
                        continue
                    cut = len(chunk)  # giant single line: forward truncated
                worker_tag = os.path.basename(path)[len("worker-"):-len(".out")]
                lines = chunk[:cut].decode("utf-8", errors="replace").splitlines()
                batch.append({"worker": worker_tag, "lines": lines})
                staged[path] = start + cut
            if batch:
                try:
                    await self._gcs.call(
                        "PublishLogs",
                        {"node_id": self.node_id.hex(), "batch": batch},
                        timeout=5.0,
                    )
                except Exception:
                    continue  # don't commit offsets: re-read and retry next tick
                offsets.update(staged)

    async def _memory_monitor_loop(self) -> None:
        """Two duties of the reference's memory safety net: proactive spill
        above ``object_spilling_threshold`` (local_object_manager.cc) and the
        node memory watcher that OOM-kills the newest retriable lease
        (memory_monitor.h:52, worker_killing_policy.cc)."""
        cfg = get_config()
        if not cfg.memory_monitor_refresh_ms:
            return
        period = cfg.memory_monitor_refresh_ms / 1000.0
        while True:
            await chaos_clock.sleep(period)
            try:
                threshold = int(self.object_store_capacity * cfg.object_spilling_threshold)
                if self.store.used() > threshold:
                    self._spill_objects(self.store.used() - threshold)
                usage = self._memory_usage_fn()
                # Cooldown: give the kernel time to reap the last victim and
                # publish the freed memory before killing again (reference
                # memory monitor min-interval between kills).
                if usage > cfg.memory_usage_threshold and (
                    time.monotonic() - self._last_oom_kill > max(1.0, 4 * period)
                ):
                    if self._oom_kill_one(usage):
                        self._last_oom_kill = time.monotonic()
            except Exception:
                logger.exception("memory monitor iteration failed")

    def _oom_kill_one(self, usage: float) -> bool:
        victims = [
            w for w in self._workers.values()
            if w.state in ("leased", "dedicated") and w.proc is not None and w.retriable
        ]
        if not victims:
            return False
        victim = max(victims, key=lambda w: w.lease_time)
        logger.warning(
            "Node memory usage %.0f%% above threshold: killing newest retriable "
            "lease (worker %s, pid %d) — the owner will retry it",
            usage * 100, victim.worker_id[:12], victim.pid,
        )
        try:
            victim.proc.kill()
        except Exception:
            pass
        self._oom_kills_total += 1
        from ..diagnostics.errors import make_event

        spawn(self._publish_error_event(make_event(
            "oom_kill",
            f"node memory usage {usage * 100:.0f}% above threshold: killed "
            f"newest retriable lease (worker {victim.worker_id[:12]}, "
            f"pid {victim.pid})",
            source="raylet", node_id=self.node_id.hex(),
            worker_id=victim.worker_id, actor_id=victim.actor_id)))
        return True

    # ------------------------------------------------------- plasma service
    async def handle_PlasmaCreate(self, p: dict) -> dict:
        from ..native.store import ObjectExistsError

        oid = p["id"]
        try:
            offset = self._create_with_spill(oid, p["data_size"], p.get("meta_size", 0))
        except StoreFullError as e:
            return {"error": "store_full", "detail": str(e)}
        except ObjectExistsError:
            # Deterministic return IDs: a retried task recreates the same
            # object. Sealed (in shm or on disk) → idempotent success.
            # Unsealed with a dead creator → reclaim and recreate.
            if self.store.contains(oid) == 2 or oid in self._spilled:
                return {"exists": True}
            # `_workers` covers raylet-spawned workers AND drivers (both
            # register; dead drivers are reaped by the pid monitor), so a
            # live creator of either kind is recognized here.
            creator = self._creating.get(oid)
            if creator is not None and creator in self._workers:
                return {"error": "create_conflict",
                        "detail": f"{oid.hex()} is being created by a live worker"}
            self.store.delete(oid, force=True)
            try:
                offset = self._create_with_spill(oid, p["data_size"], p.get("meta_size", 0))
            except StoreFullError as e:
                return {"error": "store_full", "detail": str(e)}
        if p.get("creator"):
            self._creating[oid] = p["creator"]
        self._object_meta[oid] = {"size": p["data_size"] + p.get("meta_size", 0)}
        return {"offset": offset}

    async def handle_PlasmaSeal(self, p: dict) -> dict:
        """Seal + pin: objects sealed through the RPC service are primary
        copies (created on this node by their owner) and must survive until
        deleted — spilled under pressure, never silently evicted."""
        oid = p["id"]
        self.store.seal(oid)
        self.store.pin(oid)
        self.store.release(oid)
        self._creating.pop(oid, None)
        meta = self._object_meta.get(oid)
        self._pinned[oid] = meta["size"] if meta else 0
        fut = self._fetching.pop(oid, None)
        if fut is not None and not fut.done():
            fut.set_result(True)
        return {}

    async def handle_PlasmaGetInfo(self, p: dict) -> dict:
        """Return (offset, sizes) for a sealed local object; if absent and an
        owner address is supplied, pull it from a remote node first
        (PullManager, pull_manager.h:51)."""
        oid: bytes = p["id"]
        timeout = p.get("timeout", 0)
        deadline = time.monotonic() + (timeout if timeout else 0)
        while True:
            info = self.store.get_info(oid)
            if info is None and oid in self._spilled:
                try:
                    await self._restore_spilled(oid)
                except StoreFullError:
                    pass  # shm full of read-pinned objects: poll until free
                info = self.store.get_info(oid)
            if info is not None:
                if p.get("pin_read"):
                    # Hold a store ref for the reader so the object cannot be
                    # spilled/evicted while its views are alive; the reader
                    # sends PlasmaRelease when the value is GC'd.
                    self.store.add_ref(oid)
                    reader = p.get("reader") or ""
                    refs = self._read_refs.setdefault(reader, {})
                    refs[oid] = refs.get(oid, 0) + 1
                return {"found": True, "offset": info[0], "data_size": info[1], "meta_size": info[2]}
            if p.get("owner_address"):
                pulled = await self._maybe_pull(
                    oid, p["owner_address"], p.get("pull_class", "get"))
                if pulled:
                    continue
            if timeout == 0 or time.monotonic() > deadline:
                return {"found": False}
            await asyncio.sleep(0.02)

    _PULL_CLASS = {"get": 0, "wait": 1, "task_arg": 2}

    async def _admit_pull(self, pull_class: str) -> None:
        """Pull admission control: bounded concurrent inbound transfers,
        ordered get > wait > task-arg within the queue (reference
        pull_manager.h:51 — a user blocked in ray.get outranks a
        prefetching task-arg pull)."""
        cfg = get_config()
        if (not self._pull_waiters
                and self._pull_inflight < cfg.pull_manager_max_concurrent):
            self._pull_inflight += 1
            return
        self._pull_seq += 1
        entry = {
            "key": (self._PULL_CLASS.get(pull_class, 2), self._pull_seq),
            "fut": asyncio.get_running_loop().create_future(),
        }
        self._pull_waiters.append(entry)
        self._pull_waiters.sort(key=lambda e: e["key"])
        await entry["fut"]

    def _release_pull(self) -> None:
        self._pull_inflight -= 1
        while (self._pull_waiters
               and self._pull_inflight < get_config().pull_manager_max_concurrent):
            entry = self._pull_waiters.pop(0)
            if entry["fut"].done():
                continue
            self._pull_inflight += 1
            entry["fut"].set_result(True)

    async def _maybe_pull(self, oid: bytes, owner_address: str,
                          pull_class: str = "get") -> bool:
        """Locate via the owner (OwnershipBasedObjectDirectory) and
        transfer from a holder node: ask the holder to PUSH (holder-driven
        pipelined chunks, push_manager.h:30), falling back to puller-driven
        chunk fetches. A completed copy is reported back to the owner so
        LATER pullers of the same object fan out across receivers instead
        of all draining the primary (broadcast tree)."""
        fut = self._fetching.get(oid)
        if fut is not None:
            try:
                await asyncio.wait_for(asyncio.shield(fut), 30.0)
            except asyncio.TimeoutError:
                return False
            return True
        fut = asyncio.get_running_loop().create_future()
        self._fetching[oid] = fut
        await self._admit_pull(pull_class)
        self.transfer_stats["pulls_started"] += 1
        try:
            owner = RpcClient(owner_address)
            status = await owner.call(
                "GetObjectLocations", {"id": oid},
                timeout=get_config().object_directory_rpc_timeout_s)
            locations = [n for n in status.get("locations", []) if n != self.node_id.hex()]
            # Fan-out: prefer SECONDARY holders (earlier receivers) over
            # the primary, rotating among them by a node-local stamp — a
            # broadcast then drains receivers tree-style instead of every
            # puller queueing on the one primary.
            primary = status.get("primary", "")
            secondaries = [n for n in locations if n != primary]
            if len(secondaries) > 1:
                k = int(self.node_id.hex()[:4], 16) % len(secondaries)
                secondaries = secondaries[k:] + secondaries[:k]
            locations = secondaries + ([primary] if primary in locations else [])
            ok = False
            for node_id in locations:
                node = self._node_table.get(node_id)
                if node is None or node.get("state") != "ALIVE":
                    await self._refresh_node_table()
                    node = self._node_table.get(node_id)
                    if node is None or node.get("state") != "ALIVE":
                        continue
                try:
                    await self._transfer_from_node(oid, node["address"])
                    ok = True
                    break
                except ObjectMissingOnHolder as e:
                    logger.warning("Holder %s no longer has %s: %s",
                                   node_id[:8], oid.hex()[:12], e)
                    # ONLY on holder-reported absence (evicted secondary):
                    # deregister so later pullers skip the stale entry.
                    # Generic transfer failures (e.g. THIS node's store is
                    # full) must not wipe live copies from the directory.
                    try:
                        await owner.call(
                            "RemoveObjectLocation",
                            {"id": oid, "node_id": node_id},
                            timeout=get_config().object_directory_rpc_timeout_s)
                    except Exception:
                        pass
                except Exception as e:
                    logger.warning("Transfer of %s from %s failed: %s",
                                   oid.hex()[:12], node_id[:8], e)
            if ok:
                try:
                    await owner.call(
                        "AddObjectLocation",
                        {"id": oid, "node_id": self.node_id.hex()},
                        timeout=get_config().object_directory_rpc_timeout_s)
                except Exception:
                    pass  # directory update is best-effort
            await owner.close()
            return ok
        finally:
            self._release_pull()
            done_fut = self._fetching.pop(oid, None)
            if done_fut is not None and not done_fut.done():
                done_fut.set_result(self.store.contains(oid) == 2)

    def _store_client(self, node_address: str) -> RpcClient:
        client = self._remote_store_clients.get(node_address)
        if client is None:
            client = RpcClient(node_address)
            self._remote_store_clients[node_address] = client
        return client

    async def _transfer_from_node(self, oid: bytes, node_address: str) -> None:
        """Preferred path: the holder pushes chunks at its own pace (one
        request, pipelined transfers); legacy per-chunk pull as fallback."""
        client = self._store_client(node_address)
        try:
            reply = await client.call(
                "PushObject", {"id": oid, "to": self.address}, timeout=30.0)
        except Exception:
            reply = {}
        if reply.get("pushing"):
            fut = self._fetching.get(oid)
            if fut is not None:
                # Resolved by the seal of the last pushed chunk. Bail on a
                # STALLED push quickly (holder died / failed silently) —
                # parking 120s here would pin an admission slot and starve
                # get-class pulls behind a few bad holders. The
                # no-progress grace also covers the window BEFORE the
                # first chunk (a busy holder may need seconds to start).
                started = time.monotonic()
                deadline = started + get_config().object_push_complete_timeout_s
                while time.monotonic() < deadline:
                    try:
                        await asyncio.wait_for(asyncio.shield(fut), 2.0)
                        break
                    except asyncio.TimeoutError:
                        state = self._receiving.get(oid)
                        last = state["last_progress"] if state else started
                        if (time.monotonic() - last
                                > get_config().object_push_stall_timeout_s):
                            break  # no chunk in the window: holder is gone
                if self.store.contains(oid) == 2:
                    return
                raise KeyError(f"push of {oid.hex()} did not complete")
        if not reply.get("found", True):
            raise ObjectMissingOnHolder(f"{oid.hex()} not on {node_address}")
        if self._receiving.pop(oid, None) is not None:
            # A failed partial push left an unsealed allocation; reclaim it
            # before the puller-driven fallback recreates the object.
            self.store.delete(oid, force=True)
        await self._fetch_from_node(oid, node_address)

    # --------------------------------------------------- push manager (holder)
    async def handle_PushObject(self, p: dict) -> dict:
        """A puller asks THIS node (a holder) to push ``id`` to it. Chunks
        go out holder-driven with a bounded in-flight window — no
        per-chunk round-trip stall (reference push_manager.h:30)."""
        oid = p["id"]
        info = self.store.get_info(oid)
        if info is None and oid in self._spilled:
            try:
                await self._restore_spilled(oid)
            except StoreFullError:
                return {"found": False}
            info = self.store.get_info(oid)
        if info is None:
            return {"found": False}
        self.transfer_stats["pushes_served"] += 1
        # Pin BEFORE the spawned task runs: between this handler returning
        # and _push_to starting, a spill triggered by another handler could
        # evict the object and leave _push_to reading a stale offset.
        self.store.add_ref(oid)
        spawn(self._push_to(oid, info, p["to"]))
        return {"found": True, "pushing": True}

    async def _push_to(self, oid: bytes, info: tuple, dest_address: str) -> None:
        """Stream chunks to ``dest``; the caller already holds a store ref
        (released here) so the pages can't move mid-push."""
        cfg = get_config()
        store_offset, data_size, meta_size = info
        total = data_size + meta_size
        try:
            client = self._store_client(dest_address)

            def _check(reply: dict) -> None:
                if not reply.get("ok"):
                    # Receiver is rejecting chunks (store full, create
                    # failed): abort the stream instead of shipping the
                    # rest of a multi-GB object into a void.
                    raise RuntimeError(
                        f"receiver rejected chunk: {reply.get('error')}")

            window: list = []
            pos = 0
            while pos < total:
                size = min(cfg.object_manager_chunk_size, total - pos)
                data = bytes(self.store.read(store_offset + pos, size))
                window.append(spawn(client.call("PushObjectChunk", {
                    "id": oid, "offset": pos, "data": data,
                    "data_size": data_size, "meta_size": meta_size,
                }, timeout=cfg.object_transfer_rpc_timeout_s)))
                self.transfer_stats["chunks_served"] += 1
                pos += size
                if len(window) >= cfg.push_manager_chunks_in_flight:
                    _check(await window.pop(0))
            for w in window:
                _check(await w)
        except Exception as e:
            logger.warning("push of %s to %s failed: %s",
                           oid.hex()[:12], dest_address, e)
        finally:
            self.store.release(oid)

    # ------------------------------------------------ push manager (receiver)
    async def handle_PushObjectChunk(self, p: dict) -> dict:
        oid = p["id"]
        if self.store.contains(oid) == 2 or oid in self._spilled:
            return {"ok": True}  # already have it (duplicate push)
        state = self._receiving.get(oid)
        if state is None:
            try:
                offset = self._create_with_spill(
                    oid, p["data_size"], p["meta_size"])
            except StoreFullError:
                return {"ok": False, "error": "store_full"}
            except Exception:
                return {"ok": False, "error": "create_failed"}
            state = self._receiving[oid] = {
                "offset": offset,
                "total": p["data_size"] + p["meta_size"],
                # Completion = UNIQUE offsets covering total: a retry push
                # (new holder after a dead one) re-sends offsets already
                # written — counting raw bytes would seal with holes.
                "chunks": {},
                "last_progress": time.monotonic(),
            }
            self._object_meta[oid] = {"size": state["total"]}
        self.store.write(state["offset"] + p["offset"], p["data"])
        state["chunks"][p["offset"]] = len(p["data"])
        state["last_progress"] = time.monotonic()
        if sum(state["chunks"].values()) >= state["total"]:
            self._receiving.pop(oid, None)
            self.store.seal(oid)
            self.store.release(oid)
            fut = self._fetching.get(oid)
            if fut is not None and not fut.done():
                fut.set_result(True)
        return {"ok": True}

    async def _fetch_from_node(self, oid: bytes, node_address: str) -> None:
        cfg = get_config()
        client = self._store_client(node_address)
        first = await client.call(
            "FetchObjectChunk", {"id": oid, "offset": 0, "size": cfg.object_manager_chunk_size},
            timeout=cfg.object_transfer_rpc_timeout_s,
        )
        if not first.get("found"):
            raise ObjectMissingOnHolder(f"{oid.hex()} not on {node_address}")
        data_size, meta_size = first["data_size"], first["meta_size"]
        total = data_size + meta_size
        offset = self._create_with_spill(oid, data_size, meta_size)
        self._object_meta[oid] = {"size": total}
        chunk = first["data"]
        self.store.write(offset, chunk)
        pos = len(chunk)
        while pos < total:
            r = await client.call(
                "FetchObjectChunk",
                {"id": oid, "offset": pos, "size": cfg.object_manager_chunk_size},
                timeout=cfg.object_transfer_rpc_timeout_s,
            )
            data = r["data"]
            self.store.write(offset + pos, data)
            pos += len(data)
        self.store.seal(oid)
        self.store.release(oid)

    async def handle_FetchObjectChunk(self, p: dict) -> dict:
        info = self.store.get_info(p["id"])
        if info is None and p["id"] in self._spilled:
            try:
                await self._restore_spilled(p["id"])
            except StoreFullError:
                return {"found": False}  # puller retries other replicas / later
            info = self.store.get_info(p["id"])
        if info is None:
            return {"found": False}
        store_offset, data_size, meta_size = info
        total = data_size + meta_size
        start = p["offset"]
        size = min(p["size"], total - start)
        data = bytes(self.store.read(store_offset + start, size))
        return {"found": True, "data": data, "data_size": data_size, "meta_size": meta_size}

    async def handle_PlasmaContains(self, p: dict) -> dict:
        return {"state": self.store.contains(p["id"])}

    async def handle_PlasmaAddRef(self, p: dict) -> dict:
        self.store.add_ref(p["id"])
        return {}

    async def handle_PlasmaRelease(self, p: dict) -> dict:
        reader = p.get("reader")
        if reader is None:
            self.store.release(p["id"])
            return {}
        # Reader-accounted release: only drop a ref this reader actually
        # holds, so duplicate sends (RPC retry) or releases arriving after
        # _on_worker_dead already reaped the reader can't drop refs owned
        # by other readers.
        refs = self._read_refs.get(reader)
        if refs is not None and refs.get(p["id"], 0) > 0:
            self.store.release(p["id"])
            left = refs[p["id"]] - 1
            if left > 0:
                refs[p["id"]] = left
            else:
                refs.pop(p["id"], None)
            if not refs:
                self._read_refs.pop(reader, None)
        return {}

    async def handle_PlasmaDelete(self, p: dict) -> dict:
        oid = p["id"]
        deleted = self.store.delete(oid, p.get("force", False))
        if deleted:
            self._pinned.pop(oid, None)
        elif self.store.contains(oid) and not p.get("force"):
            # Still read-referenced: deferred delete — unpin so the last
            # PlasmaRelease makes it LRU-evictable instead of leaking it.
            self.store.unpin(oid)
            self._pinned.pop(oid, None)
            deleted = True
        if self._spilled.pop(oid, None) is not None:
            self._spill_pending.pop(oid, None)
            try:
                os.unlink(self._spill_path(oid))
            except OSError:
                pass
            deleted = True
        if deleted:
            self._object_meta.pop(oid, None)
        return {"deleted": deleted}

    # --------------------------------------------------- placement-group 2PC
    async def handle_ReserveBundle(self, p: dict) -> dict:
        key = (p["pg_id"], p["bundle_index"])
        if key in self._pg_bundles:
            # Idempotent: a restarted GCS re-drives 2PC for PENDING groups;
            # double-acquiring here would leak the bundle's resources.
            return {"ok": True}
        request = ResourceSet(p["resources"])
        if not self.resources.can_fit(request):
            return {"ok": False}
        self.resources.acquire(request)
        self._pg_bundles[key] = {
            "resources": request,
            "used": ResourceSet(),
            "committed": False,
            "reserved_at": time.monotonic(),
        }
        return {"ok": True}

    async def handle_CommitBundle(self, p: dict) -> dict:
        b = self._pg_bundles.get((p["pg_id"], p["bundle_index"]))
        if b is not None:
            b["committed"] = True
        return {"ok": b is not None}

    def _drop_bundle(self, key: tuple) -> None:
        """Release one bundle reservation back to the node pool and admit
        parked leases (shared by 2PC cancel and heartbeat reconciliation).
        GPU shares still behind a device-release fence (a bundle-leased
        worker being killed, its process not yet confirmed dead) are
        WITHHELD here — the fence releases them straight to the node pool
        when the holder dies, so PG teardown can't re-grant a held chip."""
        b = self._pg_bundles.pop(key, None)
        if b is not None:
            res = b["resources"]
            fenced = self._fence_pending.get(key, 0.0)
            if fenced > 0:
                res = res.subtract(ResourceSet({"GPU": min(
                    fenced, res.get("GPU"))}), allow_negative=True)
            self.resources.release(res)
            self._wake_lease_waiters()

    async def handle_CancelBundle(self, p: dict) -> dict:
        self._drop_bundle((p["pg_id"], p["bundle_index"]))
        return {}

    async def handle_ReturnBundle(self, p: dict) -> dict:
        return await self.handle_CancelBundle(p)

    async def handle_ReleaseReader(self, p: dict) -> dict:
        """Drop ALL read refs held by a reader (clean shutdown path: a
        driver flushes its pins in one call instead of per-object releases
        racing its io-loop teardown)."""
        for oid, count in self._read_refs.pop(p.get("reader") or "", {}).items():
            for _ in range(count):
                self.store.release(oid)
        return {}

    # ----------------------------------------------------------------- debug
    async def handle_ListWorkers(self, p: dict) -> dict:
        return {
            "workers": [
                {"worker_id": w.worker_id, "state": w.state, "pid": w.pid,
                 "address": w.address, "actor_id": w.actor_id,
                 "lease": w.lease_resources.to_dict()}
                for w in self._workers.values()
            ]
        }

    async def handle_ListObjects(self, p: dict) -> dict:
        limit = p.get("limit", 1000)
        out = []
        total = len(self._object_meta)
        for oid, meta in list(self._object_meta.items())[:limit]:
            if oid in self._spilled:
                state_name = "SPILLED"
            else:
                state = self.store.contains(oid)
                state_name = {0: "ABSENT", 1: "CREATED", 2: "SEALED"}.get(state, "?")
            out.append({"object_id": oid.hex(), "size": meta["size"],
                        "state": state_name, "pinned": oid in self._pinned})
        # Truncation is reported, never silent: the state API warns when a
        # listing hit its limit.
        return {"objects": out, "total": total, "truncated": total > limit}

    async def handle_CaptureProfile(self, p: dict) -> dict:
        """Trigger an on-demand torch.profiler capture on one of this node's
        workers (cli profile --node ...). Prefers a busy (leased/dedicated)
        worker — the one actually touching the accelerator — then idle,
        then the driver. The finished artifact is registered with the GCS
        so it shows up under /api/profiles."""
        target_id = p.get("worker_id") or ""
        candidates = [w for w in self._workers.values()
                      if w.address and w.state not in ("dead", "starting")]
        if target_id:
            candidates = [w for w in candidates if w.worker_id == target_id]
        rank = {"dedicated": 0, "leased": 1, "idle": 2, "driver": 3}
        candidates.sort(key=lambda w: rank.get(w.state, 4))
        if not candidates:
            return {"error": "no reachable worker on node "
                             f"{self.node_id.hex()[:8]}"
                             + (f" matching worker_id {target_id}" if target_id else "")}
        target = candidates[0]
        duration = float(p.get("duration", 2.0))
        outdir = os.path.join(self._session_dir, "profiles")
        client = RpcClient(target.address)
        try:
            reply = await client.call(
                "CaptureProfile",
                {"duration": duration, "output_dir": outdir},
                timeout=duration + 120.0)
        except Exception as e:
            return {"error": f"worker {target.worker_id[:12]} capture failed: {e}"}
        finally:
            await client.close()
        if reply.get("path"):
            profile = {
                "path": reply["path"],
                "node_id": self.node_id.hex(),
                "worker_id": target.worker_id,
                "worker_state": target.state,
                "duration": reply.get("duration", duration),
            }
            try:
                await self._gcs.call("RegisterProfile", {"profile": profile},
                                     timeout=5.0)
            except Exception:
                pass
            reply.setdefault("node_id", self.node_id.hex())
        return reply

    async def handle_DebugState(self, p: dict) -> dict:
        return {
            "node_id": self.node_id.hex(),
            "resources": self.resources.to_dict(),
            "num_workers": len(self._workers),
            "idle": len(self._idle),
            "store_used": self.store.used(),
            "store_objects": self.store.num_objects(),
            "spilled_objects": len(self._spilled),
            "spilled_bytes_total": self._spilled_bytes_total,
            "restored_bytes_total": self._restored_bytes_total,
        }

    # ----------------------------------------------------------- diagnostics
    def _debug_state_snapshot(self) -> dict:
        """Full raylet internals for debug_state.txt / GetDebugState /
        wedge reports: the lease admission queue with per-entry ages (the
        round-5 cascade was invisible precisely because this view did not
        exist), worker-pool states, bundle ledger, store/spill/OOM
        counters (reference node_manager.cc DebugString)."""
        now = time.monotonic()
        qnow = chaos_clock.now()
        lease_queue = [
            {
                "shape": e["request"].to_dict(),
                "priority": e["prio"],
                "seq": e["seq"],
                "age_s": round(qnow - e.get("enqueued_at", qnow), 3),
                "granted": e["fut"].done(),
            }
            for e in self._admission_queue
        ]
        workers_by_state: dict[str, int] = {}
        for w in self._workers.values():
            workers_by_state[w.state] = workers_by_state.get(w.state, 0) + 1
        return {
            "node_id": self.node_id.hex(),
            "address": self.address,
            "uptime_s": round(now - self._started_at, 1),
            "resources": self.resources.to_dict(),
            "lease_queue_depth": len(self._admission_queue),
            "lease_queue": lease_queue,
            "lease_waiters": len(self._lease_waiters),
            "pending_demand": [
                {"shape": dict(shape), "count": count}
                for shape, count in self._pending_lease_demand.items()
            ],
            "workers_by_state": workers_by_state,
            "num_workers": len(self._workers),
            "idle_workers": len(self._idle),
            "pg_bundles": [
                {"pg_id": key[0], "bundle_index": key[1],
                 "committed": b.get("committed", False),
                 "resources": b["resources"].to_dict(),
                 "used": b["used"].to_dict()}
                for key, b in self._pg_bundles.items()
            ],
            "fence_pending": {str(k): v for k, v in self._fence_pending.items()},
            "store": {
                **self._store_stats(),
                "receiving": len(self._receiving),
                "pull_inflight": self._pull_inflight,
                "pull_waiters": len(self._pull_waiters),
            },
            "hbm": _hbm_snapshot(),
            "worker_rss_bytes": {
                wid[:12]: rss for wid, rss in self._worker_rss().items()},
            "transfer_stats": dict(self.transfer_stats),
            "worker_spawns": dict(self._spawn_stats),
            "zygote_pool": {
                (key or "default"): dict(zip(("idle", "starting"),
                                             self._pool_counts(key)))
                for key in ["", *self._pool_keys]
            },
            "zygote_keys": [k for k in self._pool_keys],
            "draining": self._draining,
            "drain_reason": self._drain_reason,
            "oom_kills_total": self._oom_kills_total,
            "wedge_events_total": self._wedge_events_total,
            "orphan_leases_total": self._orphan_leases_total,
            "loop_pinned_workers": sum(
                1 for w in self._workers.values() if w.loop_pinned),
        }

    async def handle_GetDebugState(self, p: dict) -> dict:
        return {"debug_state": self._debug_state_snapshot()}

    async def _publish_error_event(self, event: dict) -> None:
        """Best-effort ErrorEvent publish to the GCS error-info channel."""
        try:
            await self._gcs.call("PublishError", {"event": event}, timeout=5.0)
        except Exception:
            pass

    async def _debug_dump_loop(self) -> None:
        """Write ``debug_state_<node>.txt`` into the session dir on an
        interval (reference: raylet debug_state.txt dumps). Polls the
        config each tick so tests (and live operators) can retune the
        cadence without restarting the raylet."""
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
                path = os.path.join(
                    self._session_dir,
                    f"debug_state_{self.node_id.hex()[:12]}.txt")
                snapshot = self._debug_state_snapshot()
                await asyncio.get_running_loop().run_in_executor(
                    None, write_debug_state, path, "raylet", snapshot)
            except Exception:
                logger.exception("debug-state dump failed")

    async def _lease_watchdog_loop(self) -> None:
        """Lease-wedge watchdog: a queued admission entry older than the
        threshold whose request WOULD fit the free pool means the queue is
        wedged — head-of-line blocked behind an unsatisfiable entry, or a
        missed wake. Fire an ErrorEvent carrying the full queue snapshot
        (the exact instrumentation the round-5 mid-suite lease-timeout
        cascade lacked), then nudge the dispatcher as a self-heal."""
        from ..diagnostics.errors import make_event

        while True:
            cfg = get_config()
            await chaos_clock.sleep(max(0.1, cfg.lease_wedge_check_interval_s))
            try:
                await self._scan_orphan_leases(cfg)
            except Exception:
                logger.exception("orphan-lease scan failed")
            threshold = cfg.lease_wedge_threshold_s
            if threshold <= 0 or not self._admission_queue:
                continue
            try:
                now = chaos_clock.now()
                fired = False
                for entry in list(self._admission_queue):
                    age = now - entry.get("enqueued_at", now)
                    if (age < threshold or entry.get("wedge_reported")
                            or entry["fut"].done()):
                        continue
                    if not self.resources.can_fit(entry["request"]):
                        continue  # genuinely waiting for capacity: not a wedge
                    entry["wedge_reported"] = True
                    self._wedge_events_total += 1
                    fired = True
                    shape = entry["request"].to_dict()
                    logger.error(
                        "lease-wedge watchdog: lease %s (prio %d) pending %.1fs "
                        "while matching resources are free; queue depth %d",
                        shape, entry["prio"], age, len(self._admission_queue))
                    spawn(self._publish_error_event(make_event(
                        "lease_wedge",
                        f"lease {shape} pending {age:.1f}s on node "
                        f"{self.node_id.hex()[:8]} while matching resources are "
                        f"free (queue depth {len(self._admission_queue)})",
                        source="raylet", node_id=self.node_id.hex(),
                        extra={"debug_state": self._debug_state_snapshot()})))
                if fired:
                    # Self-heal a missed wake; a truly blocked head keeps the
                    # queue intact and the report stands.
                    self._dispatch_admission()
            except Exception:
                # The watchdog must outlive any one bad scan (e.g. the
                # store closing mid-snapshot during teardown).
                logger.exception("lease-wedge watchdog scan failed")

    async def _scan_orphan_leases(self, cfg) -> None:
        """Reclaim granted leases whose owner never acknowledged them.

        The grant reply can be lost in transit (chaos, or a real network
        fault): the owner times out and retries elsewhere while this
        raylet keeps the reservation and the leased worker forever. That
        strand was the root cause of the ROADMAP-1c mid-suite
        lease-timeout cascade — each lost reply shrank the node's usable
        CPU pool until every later lease timed out. Before reclaiming,
        the worker itself is probed: a worker that is executing (or whose
        push count moves between two probes) proves the owner DID receive
        the grant — only its AckLease was lost — and the lease is kept.
        """
        timeout = cfg.lease_orphan_timeout_s
        if timeout <= 0:
            return
        now = chaos_clock.now()
        for w in list(self._workers.values()):
            if w.state not in ("leased", "dedicated") or w.lease_acked:
                continue
            if w.loop_pinned:
                # The owner declared a parked compiled-loop executor on
                # this worker: it legitimately never finishes, never
                # pushes, and may be unprobeable mid-chaos — reclaiming
                # it would kill a live pipeline. Unpinned at teardown.
                continue
            if not w.lease_granted_at or now - w.lease_granted_at < timeout:
                continue
            probe = None
            if w.address:
                try:
                    client = RpcClient(w.address)
                    probe = await client.call("LeaseProbe", {}, timeout=5.0)
                    await client.close()
                except Exception:
                    probe = None  # unreachable/dead: reclaim below
            if probe is not None:
                if probe.get("executing"):
                    w.lease_acked = True  # grant reached the owner after all
                    continue
                if w.orphan_probe is None:
                    # First look: sample the push counter; confirm on the
                    # next scan so a push in flight right now isn't raced.
                    w.orphan_probe = probe.get("pushes_total", 0)
                    continue
                if probe.get("pushes_total", 0) != w.orphan_probe:
                    w.lease_acked = True
                    continue
            self._reclaim_orphan_lease(w, now - w.lease_granted_at, cfg)

    def _reclaim_orphan_lease(self, w: WorkerHandle, age: float, cfg) -> None:
        from ..diagnostics.errors import make_event

        self._orphan_leases_total += 1
        logger.error(
            "orphan-lease reclaim: worker %s lease un-acked for %.1fs (grant "
            "reply lost?); releasing %s",
            w.worker_id[:12], age, w.lease_resources.to_dict())
        # Classification must be robust to stale queue state (a previous
        # workload's un-acked strands aging out mid-scan, the cross-file
        # watchdog flake): the "blocked behind an orphaned lease" wedge
        # is claimed ONLY for a live head entry that could not fit the
        # free pool before this reclaim but CAN after it — the orphan
        # provably held its resources. A head that already fits is the
        # canonical missed-wake wedge and belongs to the watchdog loop's
        # own scan (whose report names the free resources); an
        # unsatisfiable head is infeasible, not orphan-blocked.
        head = next((e for e in self._admission_queue
                     if not e["fut"].done()), None)
        head_fits_before = (head is not None
                            and self.resources.can_fit(head["request"]))
        spawn(self._publish_error_event(make_event(
            "lease_orphan",
            f"reclaimed un-acked lease on worker {w.worker_id[:12]} after "
            f"{age:.1f}s — the grant reply likely never reached the owner",
            source="raylet", node_id=self.node_id.hex(),
            worker_id=w.worker_id, actor_id=w.actor_id)))
        if self._release_lease(w):
            self._on_worker_dead(w)  # GPU device fence: worker being killed
        else:
            w.state = "idle"
            w.actor_id = ""
            w.lease_acked = True
            w.orphan_probe = None
            w.last_idle_time = time.monotonic()
            self._idle.append(w.worker_id)
        if head is not None and cfg.lease_wedge_threshold_s > 0:
            head_age = chaos_clock.now() - head.get("enqueued_at", 0.0)
            if (head_age >= cfg.lease_wedge_threshold_s
                    and not head.get("wedge_reported")
                    and not head_fits_before
                    and self.resources.can_fit(head["request"])):
                head["wedge_reported"] = True
                self._wedge_events_total += 1
                spawn(self._publish_error_event(make_event(
                    "lease_wedge",
                    f"lease {head['request'].to_dict()} pending "
                    f"{head_age:.1f}s on node {self.node_id.hex()[:8]} "
                    f"blocked behind an orphaned lease grant (worker "
                    f"{w.worker_id[:12]}, queue depth "
                    f"{len(self._admission_queue)})",
                    source="raylet", node_id=self.node_id.hex(),
                    extra={"debug_state": self._debug_state_snapshot()})))
        self._wake_lease_waiters()


def _hbm_snapshot() -> dict:
    from ..observability.memory import hbm_stats

    return hbm_stats()


def _node_memory_usage_fraction() -> float:
    """Fraction of node memory in use, from /proc/meminfo (reference
    memory_monitor.cc GetLinuxMemoryBytes; cgroup limits not consulted)."""
    try:
        fields = {}
        with open("/proc/meminfo") as f:
            for line in f:
                name, _, rest = line.partition(":")
                fields[name] = int(rest.split()[0])  # kB
        total = fields.get("MemTotal", 0)
        avail = fields.get("MemAvailable", total)
        if total <= 0:
            return 0.0
        return 1.0 - avail / total
    except OSError:
        return 0.0


def _in_loop() -> bool:
    try:
        asyncio.get_running_loop()
        return True
    except RuntimeError:
        return False
