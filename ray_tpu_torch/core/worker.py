"""CoreWorker: embedded in every driver and worker process.

Equivalent of the reference's ``CoreWorker`` (``src/ray/core_worker/
core_worker.cc``: SubmitTask:2475, Put:1522, Get:1823, ExecuteTask:3229,
HandlePushTask:3810) plus the transport layer (``transport/
normal_task_submitter.cc``, ``actor_task_submitter.cc``).

Data path:
  * small values   → owner's in-process memory store, shipped inline in RPC
                     replies (reference: <100KB direct-call inlining)
  * large values   → node-local native shm store; other nodes pull chunks
                     via their raylet (ownership-based location lookup)

Round-1 simplifications vs the reference protocol (tracked for round 2):
borrower counts are not reported back to owners (owners pin args only for
the duration of the task), and worker-side ``ray.put`` owns objects at the
worker (as in the reference).
"""

from __future__ import annotations

import functools
import hashlib
import inspect
import logging
import os
import socket
import threading
import time
import traceback
from typing import Any, Callable, Sequence

from .._vendor import cloudpickle

from . import serialization
from .config import get_config
from .generator import ObjectRefGenerator, StreamState
from .ids import ActorID, JobID, ObjectID, TaskID, WorkerID
from .memory_store import MemoryStore
from .object_ref import ObjectRef, install_refcount_hooks
from .refcount import ReferenceCounter
from .rpc import EventLoopThread, RetryableRpcClient, RpcClient, RpcServer
from .status import (
    ActorDiedError,
    GetTimeoutError,
    ObjectLostError,
    RayTaskError,
    RayTpuError,
    RpcError,
    TaskCancelledError,
    WorkerCrashedError,
)
from .task_spec import TASK_KIND_ACTOR_CREATION, TASK_KIND_ACTOR_TASK, TASK_KIND_NORMAL, TaskSpec
from ..native.store import ShmClient

logger = logging.getLogger(__name__)

MODE_DRIVER = "driver"
MODE_WORKER = "worker"


class FunctionMissingError(RayTpuError):
    """The GCS has no record of the function (lost export)."""


class FunctionManager:
    """Pickled functions/classes in the GCS KV, keyed by content hash
    (reference ``python/ray/_private/function_manager.py``)."""

    def __init__(self, worker: "CoreWorker"):
        import weakref

        self._worker = worker
        self._exported: set[bytes] = set()
        self._cache: dict[bytes, Any] = {}
        # Submit-hot-path memo: ``export`` must cloudpickle the function on
        # EVERY call just to compute its content hash — 100k no-op submits
        # would pay 100k pickles. Keyed weakly on the live object (a
        # collected function frees its slot, so a recycled id can never
        # alias), one pickle per function definition — the reference's
        # export-once semantics.
        self._memo: "weakref.WeakKeyDictionary[Any, bytes]" = weakref.WeakKeyDictionary()
        self._lock = threading.Lock()

    def export_cached(self, fn: Any, tag: str) -> bytes:
        try:
            fid = self._memo.get(fn)
        except TypeError:  # unhashable/unweakrefable callable
            return self.export((fn, tag))
        if fid is not None:
            return fid
        fid = self.export((fn, tag))
        try:
            self._memo[fn] = fid
        except TypeError:
            pass
        return fid

    def export(self, fn: Any) -> bytes:
        payload = cloudpickle.dumps(fn)
        fid = hashlib.sha1(payload).digest()[:20]
        with self._lock:
            if fid in self._exported:
                return fid
        self._worker._gcs_call("KvPut", {"key": "fn:" + fid.hex(), "value": payload, "overwrite": False})
        with self._lock:
            self._exported.add(fid)
            self._cache[fid] = fn
        return fid

    def get(self, fid: bytes) -> Any:
        with self._lock:
            if fid in self._cache:
                return self._cache[fid]
        reply = self._worker._gcs_call("KvGet", {"key": "fn:" + fid.hex()})
        if not reply.get("found"):
            raise FunctionMissingError(f"Function {fid.hex()} not found in GCS")
        fn = cloudpickle.loads(reply["value"])
        with self._lock:
            self._cache[fid] = fn
        return fn

    def cached(self, fid: bytes):
        with self._lock:
            return self._cache.get(fid)


class TaskManager:
    """Owner-side task table: pending specs, retries, lineage
    (reference ``task_manager.h:212``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: dict[bytes, dict] = {}
        self._lineage: dict[bytes, TaskSpec] = {}  # return object id -> spec
        self._lineage_bytes = 0
        self._lineage_cost: dict[bytes, int] = {}  # oid -> charged bytes

    @staticmethod
    def _spec_bytes(spec: TaskSpec) -> int:
        """Real lineage footprint of a pinned spec (reference
        task_manager.h:219 caps actual bytes): inline arg payloads
        dominate — a large captured closure must charge what it weighs."""
        total = 256  # fixed fields
        for arg in spec.args:
            total += len(arg.get("blob") or b"") + len(arg.get("meta") or b"") + 64
        return total

    def add_pending(self, spec: TaskSpec, return_ids: list[ObjectID]) -> None:
        with self._lock:
            self._pending[spec.task_id] = {
                "spec": spec,
                "retries_left": spec.max_retries,
                "return_ids": return_ids,
                "submitted_at": time.time(),  # owner-side task span start
            }

    def get_pending(self, task_id: bytes) -> dict | None:
        with self._lock:
            return self._pending.get(task_id)

    def complete(self, task_id: bytes) -> None:
        with self._lock:
            entry = self._pending.pop(task_id, None)
            if entry is not None:
                # Pin lineage so lost objects can be reconstructed
                # (task_manager.h:219 lineage pinning, capped by REAL bytes).
                spec = entry["spec"]
                if spec.max_retries != 0 and self._lineage_bytes < get_config().lineage_max_bytes:
                    cost = self._spec_bytes(spec)
                    for oid in entry["return_ids"]:
                        key = oid.binary()
                        if key in self._lineage:
                            continue  # reconstruction re-completes: no re-charge
                        self._lineage[key] = spec
                        self._lineage_cost[key] = cost
                        self._lineage_bytes += cost

    def consume_retry(self, task_id: bytes) -> bool:
        """Returns True if the task may be retried (decrements budget)."""
        with self._lock:
            entry = self._pending.get(task_id)
            if entry is None:
                return False
            if entry["retries_left"] == 0:
                return False
            if entry["retries_left"] > 0:
                entry["retries_left"] -= 1
            return True

    def fail(self, task_id: bytes) -> dict | None:
        with self._lock:
            return self._pending.pop(task_id, None)

    def lineage_for(self, object_id: ObjectID) -> TaskSpec | None:
        with self._lock:
            return self._lineage.get(object_id.binary())

    def evict_lineage(self, object_id: ObjectID) -> None:
        with self._lock:
            key = object_id.binary()
            if self._lineage.pop(key, None) is not None:
                self._lineage_bytes -= self._lineage_cost.pop(key, 0)

    def num_pending(self) -> int:
        with self._lock:
            return len(self._pending)


class _ActorState:
    """Client-side view of one actor (ActorTaskSubmitter entry)."""

    def __init__(self, actor_id: bytes):
        self.actor_id = actor_id
        self.address = ""
        self.state = "PENDING_CREATION"
        # Pipelined RegisterActor in flight (unnamed actors): resolution
        # tolerates a GCS "not found" until this lands — a 1k-actor storm
        # must not pay one serial GCS round trip per registration.
        self.register_future = None
        # Set by the actor-channel watcher whenever the GCS publishes a
        # state transition for this actor: resolution parks on it instead
        # of re-polling GetActorInfo on a fixed cadence.
        self.changed = None
        self.seq_no = 0
        # Bumped on each detected death: sequence numbers are scoped to one
        # actor incarnation (the restarted executor expects seq 0).
        self.incarnation = 0
        self.client: RpcClient | None = None
        self.death_cause = ""
        # True only when THIS process created the actor with
        # max_concurrency=1 and no concurrency groups: calls execute
        # strictly serially, so a burst may ride one PushActorTasks RPC
        # without changing overlap semantics. None = unknown (handle
        # received from elsewhere) — never batch those.
        self.serialized: bool | None = None
        self.lock = threading.Lock()


class CoreWorker:
    def __init__(
        self,
        mode: str,
        gcs_address: str,
        raylet_address: str,
        node_id: str,
        store_path: str,
        store_capacity: int,
        job_id: JobID | None = None,
        worker_id: str | None = None,
    ):
        self.mode = mode
        self.node_id = node_id
        self.worker_id = worker_id or WorkerID.from_random().hex()
        self.job_id = job_id or JobID.from_int(1)
        self.io = EventLoopThread(f"raytpu-io-{mode}")
        self.gcs_address = gcs_address
        self.gcs = RetryableRpcClient(gcs_address)
        self.raylet = RetryableRpcClient(raylet_address)
        self.raylet_address = raylet_address
        self.memory_store = MemoryStore()
        self.refcounter = ReferenceCounter(on_object_freed=self._on_object_freed)
        self.task_manager = TaskManager()
        self.functions = FunctionManager(self)
        self.shm = ShmClient(store_path, store_capacity) if store_path else None
        self.store_path = store_path

        # Owner-side task submission state.
        self._task_counter = 0
        self._put_counter = 0
        self._counter_lock = threading.Lock()
        if mode == MODE_DRIVER:
            self.current_task_id = TaskID.for_driver_task(self.job_id)
        else:
            # Outside any task (a thread that outlives the task that
            # started it, as a Tune trial's fit does) a worker submits
            # under a parent of its own: task, actor and put ids derive
            # from (parent, counter), and the nil parent that every worker
            # shared gave two workers' first actors the same id.
            self.current_task_id = TaskID.for_normal_task(
                self.job_id, TaskID.nil(), int.from_bytes(hashlib.sha1(
                    self.worker_id.encode()).digest()[:8], "little"))
        self._task_queues: dict[tuple, list] = {}
        # ray_tpu.cancel bookkeeping: cancelled task ids (never retried),
        # dispatched-task -> executing worker address, and (executor side)
        # task -> thread ident for the async-interrupt path.
        self._cancelled_tasks: set[bytes] = set()
        self._dispatched_to: dict[bytes, str] = {}
        # executor side: task -> thread ident (guarded by _exec_lock so a
        # CancelTask async-interrupt can never target a thread that moved
        # on to another task), plus cancels that arrived before execution
        self._exec_threads: dict[bytes, int] = {}
        self._exec_lock = threading.Lock()
        # insertion-ordered dict so the oldest markers (cancels whose
        # task never arrived here) are evicted first once the set is
        # over its size bound — it cannot accumulate forever
        self._cancelled_inbound: dict[bytes, None] = {}
        self._pipelines: dict[tuple, int] = {}
        # Per-shape-key lease-acquisition gate (io-loop only): while one
        # pipeline's multiplexed RequestWorkerLease is in flight, sibling
        # pipelines park here and take grants from its reply instead of
        # issuing their own RPC.
        self._lease_gates: dict[tuple, dict] = {}
        self._spread_salt = 0
        self._queue_lock = threading.Lock()
        self._actors: dict[bytes, _ActorState] = {}
        self._actor_watch_started = False
        # Actor-call submit fast path: specs queue here and the io loop is
        # woken ONCE per burst — run_coroutine_threadsafe's self-pipe
        # write per call is ~0.4 ms of pure syscall, the single biggest
        # cost of a tight actor-call loop before PR 6.
        from collections import deque as _deque

        self._actor_submit_q: "_deque" = _deque()
        self._actor_submit_active = False
        self._actor_submit_lock = threading.Lock()
        self._node_table: dict[str, dict] = {}
        # Actor-handle GC: non-detached, unnamed actors die when the last
        # handle in the owning process is dropped (reference actor.py
        # __ray_terminate__ on handle GC).
        self._actor_handle_counts: dict[bytes, int] = {}
        self._owned_actors: set[bytes] = set()
        # Borrowing protocol state: per-owner ordered RPC clients, and
        # temporary holds on owned objects we returned to a caller that has
        # not yet registered as a borrower (expiring failsafe).
        self._borrow_clients: dict[str, RetryableRpcClient] = {}
        self._borrow_clients_lock = threading.Lock()
        self._borrow_holds: dict[bytes, list[float]] = {}
        self._borrow_holds_lock = threading.Lock()
        # Owner-side streaming-generator state, keyed by task id
        # (reference task_manager.h:212 ObjectRefStream map).
        self._streams: dict[bytes, StreamState] = {}
        # Driver-side view of the GCS error-info channel (diagnostics):
        # most recent ErrorEvents seen by the auto-subscriber.
        from collections import deque

        self._recent_errors: deque = deque(maxlen=256)

        # Executor-side state (worker mode).
        self.actor_instance: Any = None
        self.actor_id: bytes = b""
        # Task pushes received over this worker's lifetime: the raylet's
        # orphan-lease watchdog probes it (LeaseProbe) before reclaiming a
        # lease whose AckLease never arrived.
        self._pushes_total = 0
        # Per-caller sequencing (reference: per-handle sequence numbers,
        # actor_task_submitter.cc; callers are identified by owner address).
        self._actor_next_seq: dict[str, int] = {}
        self._actor_ooo_buffer: dict[tuple[str, int], Any] = {}
        self._actor_sem: threading.Semaphore | None = None
        self._actor_max_concurrency = 1
        self._actor_group_sems: dict[str, threading.Semaphore] = {}
        self._exec_local = threading.local()

        # Task execution threads: the loop's default executor caps at
        # cpu_count+4 which starves long-poll-style actor methods (Serve
        # listen_for_change); give every worker a deep pool.
        from concurrent.futures import ThreadPoolExecutor

        self.io.loop.set_default_executor(ThreadPoolExecutor(
            max_workers=get_config().worker_executor_threads,
            thread_name_prefix="raytpu-exec"))

        # RPC server for owner + executor duties. Bind to the node's
        # routable interface (the host our raylet registered with the GCS)
        # so the advertised worker address — and everything derived from
        # it, e.g. cross-node DAG channel servers — is reachable from
        # other hosts, not just loopback.
        node_host = self.raylet_address.rpartition(":")[0]
        if node_host in ("", "localhost"):
            node_host = "127.0.0.1"
        self.server = RpcServer(node_host, 0)
        self.server.register_service(self)
        # Task-event buffer: status timestamps flushed to the GCS on an
        # interval (task_event_buffer.h:224; powers list_tasks + timeline).
        from .task_events import TaskEventBuffer

        self.task_events = TaskEventBuffer(self.worker_id, self.node_id)

        self.io.run_sync(self.server.start())
        self.address = self.server.address
        self.io.run_coro(self._borrow_hold_sweeper())
        self.io.run_coro(self._task_event_flusher())
        self.io.run_coro(self._global_gc_poller())

        install_refcount_hooks(self._hook_add_local, self._hook_remove_local)

    # ------------------------------------------------------------- lifecycle
    def connect(self) -> None:
        self._raylet_call(
            "RegisterWorker",
            {
                "worker_id": self.worker_id,
                "address": self.address,
                "pid": os.getpid(),
                "is_driver": self.mode == MODE_DRIVER,
            },
        )
        if self.mode == MODE_DRIVER and get_config().log_to_driver:
            self.io.run_coro(self._stream_logs_to_driver())
        if self.mode == MODE_DRIVER:
            # Auto-subscribe to the error-info channel: worker/raylet/serve
            # failures surface in the driver's log, not just worker files
            # (reference: listen_error_messages in worker.py).
            self.io.run_coro(self._error_info_poller())

    async def _error_info_poller(self) -> None:
        """Driver-side error-info subscriber: long-poll the GCS channel,
        cache events for inspection, and log each one — a replica or
        remote-worker failure becomes visible at the driver without
        grepping per-worker log files."""
        import asyncio

        from ..diagnostics.errors import ERROR_INFO_CHANNEL

        cursor = None  # start at the current end: no history replay
        while True:
            try:
                if cursor is None:
                    reply = await self.gcs.call("ListErrors", {"limit": 0}, timeout=10.0)
                    cursor = reply.get("cursor", 0)
                reply = await self.gcs.call(
                    "SubscribePoll",
                    {"cursors": {ERROR_INFO_CHANNEL: cursor}, "timeout": 30.0},
                    timeout=45.0,
                )
            except Exception:
                await asyncio.sleep(1.0)
                continue
            msgs = (reply.get("messages") or {}).get(ERROR_INFO_CHANNEL, [])
            if not msgs:
                # Empty long-poll: re-check the channel cursor — a restarted
                # GCS resets Publisher sequences, and a cursor PAST the new
                # end would filter every future event forever (same clamp as
                # PollGlobalGc).
                try:
                    base = await self.gcs.call("ListErrors", {"limit": 0}, timeout=10.0)
                    cursor = min(cursor, base.get("cursor", cursor))
                except Exception:
                    pass
                continue
            for seq, event in msgs:
                cursor = max(cursor, seq)
                self._recent_errors.append(event)
                logger.warning(
                    "ErrorEvent [%s/%s] node=%s: %s",
                    event.get("source", "?"), event.get("type", "?"),
                    (event.get("node_id") or "")[:8], event.get("message", ""))

    async def _stream_logs_to_driver(self) -> None:
        """Long-poll the GCS log channel and echo worker output with a
        ``(worker=..., node=...)`` prefix (reference: driver-side
        print_logs over the log pubsub)."""
        import asyncio
        import sys

        cursor = None  # None = "start at the current end" (no history replay)
        while True:
            try:
                reply = await self.gcs.call(
                    "PollLogs", {"cursor": cursor, "timeout": 10.0}, timeout=20.0
                )
            except Exception:
                await asyncio.sleep(1.0)
                continue
            cursor = reply.get("cursor", cursor)
            for msg in reply.get("messages", []):
                node = msg["node_id"][:8]
                for entry in msg["batch"]:
                    prefix = f"({entry['worker'][:8]}, node={node}) "
                    for line in entry["lines"]:
                        print(prefix + line, file=sys.stderr)

    def shutdown(self) -> None:
        install_refcount_hooks(lambda r: None, lambda r: None)
        # final event flush so short-lived drivers/workers leave a trace
        try:
            events, dropped = self.task_events.drain()
            if events or dropped:
                self._gcs_call("AddTaskEvents", {"events": events, "dropped": dropped}, timeout=5.0)
        except Exception:
            pass
        # Flush read-ref pins in one call BEFORE stopping the io loop:
        # per-object PlasmaRelease from GC'd buffers would race teardown
        # and leak pins on the raylet (objects become unspillable).
        try:
            self._raylet_call("ReleaseReader", {"reader": self.worker_id}, timeout=5.0)
        except Exception:
            pass

        async def _close_all():
            await self.server.stop()
            for state in self._actors.values():
                if state.client is not None:
                    await state.client.close()
            for client in self._borrow_clients.values():
                await client.close()
            await self.gcs.close()
            await self.raylet.close()

        try:
            self.io.run_sync(_close_all(), timeout=5)
        except Exception:
            pass
        self.io.stop()
        if self.shm:
            self.shm.close()

    def _gcs_call(self, method: str, payload: dict, timeout: float | None = 30.0) -> dict:
        return self.io.run_sync(self.gcs.call(method, payload, timeout))

    def _raylet_call(self, method: str, payload: dict, timeout: float | None = 30.0) -> dict:
        return self.io.run_sync(self.raylet.call(method, payload, timeout))

    def pin_loop_worker(self, actor_id: str, pinned: bool,
                        node_id: str | None = None) -> bool:
        """Tell the raylet hosting ``actor_id`` that its worker parks a
        resident compiled-loop executor (``dag/loop.py``): pinned leases
        are exempt from the orphan-lease watchdog's reclaim (a parked
        loop looks exactly like a stranded grant — no pushes, no
        finished task — and reclaiming it would kill a live pipeline)."""
        async def _go() -> bool:
            addr = (await self._raylet_address_for(node_id)
                    if node_id else self.raylet_address)
            if addr is None:
                return False
            client = RpcClient(addr)
            try:
                reply = await client.call(
                    "PinLoopWorker",
                    {"actor_id": actor_id, "pinned": bool(pinned)},
                    timeout=10.0)
                return bool(reply.get("ok"))
            finally:
                await client.close()

        try:
            return self.io.run_sync(_go())
        except Exception:
            return False  # pinning is protective, never fatal

    # -------------------------------------------------------------- refcount
    def _hook_add_local(self, ref: ObjectRef) -> None:
        oid = ref.id()
        self.refcounter.add_local_ref(oid)
        self.refcounter.set_callsite(oid, ref.callsite)
        owner = ref.owner_address
        if owner and owner != self.address and self.refcounter.note_borrowed(oid, owner):
            # First local ref to a borrowed object: register with its owner
            # so the owner keeps it alive (reference_count.h:66 borrowing).
            self.io.run_coro(self._send_borrow(owner, "AddBorrower", oid))

    def _hook_remove_local(self, ref: ObjectRef) -> None:
        self.refcounter.remove_local_ref(ref.id())

    def _owner_client(self, owner_address: str) -> RetryableRpcClient:
        """One ordered connection per owner (shared by the borrowing
        protocol and generator-item reports, so neither can race)."""
        with self._borrow_clients_lock:
            client = self._borrow_clients.get(owner_address)
            if client is None:
                client = self._borrow_clients[owner_address] = RetryableRpcClient(owner_address)
            return client

    async def _send_borrow(self, owner_address: str, method: str, oid: ObjectID) -> None:
        try:
            client = self._owner_client(owner_address)
            await client.call(method, {"id": oid.binary(), "borrower": self.worker_id}, timeout=30.0)
        except Exception:
            pass  # owner died: its state is gone anyway

    def _on_object_freed(self, oid: ObjectID, ref) -> None:
        """All references dropped. Owned objects: delete every copy
        (reference_count.cc → plasma Delete broadcast). Borrowed objects:
        report the release back to the owner."""
        if not ref.owned:
            if ref.borrow_registered and ref.owner_address:
                self.io.run_coro(self._send_borrow(ref.owner_address, "RemoveBorrower", oid))
            return
        self.memory_store.delete(oid)
        self.task_manager.evict_lineage(oid)
        locations = set(ref.locations)

        async def _free():
            for node_id in locations:
                addr = await self._raylet_address_for(node_id)
                if addr is None:
                    continue
                try:
                    client = RpcClient(addr)
                    await client.call("PlasmaDelete", {"id": oid.binary()}, timeout=5.0)
                    await client.close()
                except Exception:
                    pass

        if locations:
            self.io.run_coro(_free())

    async def _raylet_address_for(self, node_id) -> str | None:
        node_hex = node_id if isinstance(node_id, str) else node_id.hex()
        if node_hex == self.node_id:
            return self.raylet_address
        node = self._node_table.get(node_hex)
        if node is None:
            reply = await self.gcs.call("GetAllNodes", {}, timeout=10.0)
            self._node_table = {n["node_id"]: n for n in reply["nodes"]}
            node = self._node_table.get(node_hex)
        return node["address"] if node else None

    # ------------------------------------------------------------------- put
    def put(self, value: Any, *, _owner_ref: ObjectRef | None = None) -> ObjectRef:
        with self._counter_lock:
            self._put_counter += 1
            oid = ObjectID.for_put(self.current_task_id, self._put_counter)
        s = serialization.serialize_value(value)
        self._store_owned_value(oid, s.metadata, s, s.contained)
        return ObjectRef(oid, self.address)

    def _store_owned_value(self, oid: ObjectID, metadata: bytes, blob, contained: list) -> None:
        cfg = get_config()
        contained_ids = [r.id() for r in contained]
        self.refcounter.add_owned_object(oid, contained_ids)
        nbytes = blob.nbytes if isinstance(blob, serialization.Serialized) else len(blob)
        self.refcounter.set_size(oid, nbytes)
        if nbytes <= cfg.max_inline_object_size:
            if isinstance(blob, serialization.Serialized):
                blob = blob.to_blob()
            self.memory_store.put(oid, metadata, blob)
        else:
            self._plasma_put(oid, metadata, blob)
            self.memory_store.put_plasma_marker(oid, self.node_id.encode())
            self.refcounter.add_location(oid, self.node_id)

    def _plasma_put(self, oid: ObjectID, metadata: bytes, blob) -> None:
        """``blob`` may be bytes OR a ``serialization.Serialized`` — the
        latter frames its buffers DIRECTLY into the mmapped arena (the
        plasma-client zero-copy create path, reference ``plasma/store.h``
        client mmap + ``fling.cc`` fd passing): one copy end to end
        instead of pickle-concat + frame + mmap write."""
        parts = isinstance(blob, serialization.Serialized)
        data_size = blob.nbytes if parts else len(blob)
        reply = self._raylet_call(
            "PlasmaCreate",
            {"id": oid.binary(), "data_size": data_size, "meta_size": len(metadata),
             "creator": self.worker_id},
        )
        if reply.get("exists"):
            return  # already sealed (e.g. a retried task's deterministic return)
        if reply.get("error"):
            from .status import ObjectStoreFullError

            raise ObjectStoreFullError(reply.get("detail", "object store full"))
        offset = reply["offset"]
        if parts:
            blob.write_into(self.shm.read(offset, data_size))
        else:
            self.shm.write(offset, blob)
        if metadata:
            self.shm.write(offset + data_size, metadata)
        self._raylet_call("PlasmaSeal", {"id": oid.binary()})

    # ------------------------------------------------------------------- get
    def get(self, refs: Sequence[ObjectRef], timeout: float | None = None) -> list:
        deadline = None if timeout is None else time.monotonic() + timeout
        return [self._get_one(ref, deadline) for ref in refs]

    def _remaining(self, deadline: float | None) -> float | None:
        if deadline is None:
            return None
        return max(0.0, deadline - time.monotonic())

    def _get_one(self, ref: ObjectRef, deadline: float | None,
                 pull_class: str = "get"):
        oid = ref.id()
        owned = self.refcounter.is_owned(oid)
        while True:
            entry = self.memory_store.get_if_exists(oid)
            if entry is not None and not entry.in_plasma:
                return self._deserialize(entry.metadata, entry.blob, oid)
            if entry is not None and entry.in_plasma:
                return self._get_from_plasma(ref, deadline, pull_class)
            if owned:
                remaining = self._remaining(deadline)
                ready, _ = self.memory_store.wait_ready([oid], 1, remaining)
                if not ready:
                    raise GetTimeoutError(f"Timed out getting {oid.hex()}")
                continue
            # Borrowed ref: ask the owner.
            status = self._owner_status(ref, deadline)
            if status.get("inline"):
                return self._deserialize(status["metadata"], status["blob"], oid)
            if status.get("in_plasma"):
                return self._get_from_plasma(ref, deadline, pull_class)
            raise ObjectLostError(oid, status.get("error", "owner could not locate object"))

    def _owner_status(self, ref: ObjectRef, deadline: float | None) -> dict:
        remaining = self._remaining(deadline)
        try:
            owner = RpcClient(ref.owner_address)

            async def _call():
                try:
                    return await owner.call(
                        "GetObjectStatus",
                        {"id": ref.binary(), "wait": True, "timeout": remaining if remaining is not None else 3600.0},
                        timeout=None if remaining is None else remaining + 5.0,
                    )
                finally:
                    await owner.close()

            reply = self.io.run_sync(_call())
            return reply
        except RpcError as e:
            from .status import OwnerDiedError

            raise OwnerDiedError(ref.id(), f"owner {ref.owner_address} unreachable: {e}")

    # Per-attempt PlasmaGetInfo wait: a lost object must surface as
    # not-found well before the caller's deadline, or lineage
    # reconstruction never gets time to run (the raylet used to long-poll
    # the ENTIRE get() budget before admitting the object was gone).
    _PLASMA_PROBE_S = 5.0

    def _get_from_plasma(self, ref: ObjectRef, deadline: float | None,
                         pull_class: str = "get"):
        oid = ref.id()
        t0 = time.monotonic()  # no-deadline gets still give up after 1 h
        while True:
            remaining = self._remaining(deadline)
            probe = (self._PLASMA_PROBE_S if remaining is None
                     else max(0.0, min(remaining, self._PLASMA_PROBE_S)))
            reply = self._raylet_call(
                "PlasmaGetInfo",
                {
                    "id": oid.binary(),
                    "owner_address": ref.owner_address or self.address,
                    "timeout": probe,
                    # The raylet holds a store ref for us until we release, so
                    # the object can't be spilled/evicted while views are alive.
                    "pin_read": True,
                    "reader": self.worker_id,
                    # Pull admission class (raylet orders get > wait > task_arg).
                    "pull_class": pull_class,
                },
                timeout=probe + 10.0,
            )
            if reply.get("found"):
                break
            # Lost from every reachable node: try lineage reconstruction
            # (object_recovery_manager.h:90,106), then keep probing — a
            # copy may still appear (in-flight push, restarting holder)
            # until the caller's deadline truly expires.
            if self._try_reconstruct(oid, deadline):
                continue
            remaining = self._remaining(deadline)
            if (remaining is not None and remaining <= 0) or (
                    remaining is None and time.monotonic() - t0 > 3600.0):
                raise ObjectLostError(
                    oid, "not found on any node and not reconstructable")
        data = self.shm.read(reply["offset"], reply["data_size"])
        meta = bytes(self.shm.read(reply["offset"] + reply["data_size"], reply["meta_size"]))
        # Zero-copy deserialization aliases the arena; release the read ref
        # only when the last derived view (e.g. a reconstructed numpy array)
        # is GC'd, never before (plasma Buffer lifetime semantics).
        buf = serialization.PlasmaBuffer(data, self._make_read_releaser(oid))
        del data
        return self._deserialize(meta, buf, oid)

    def _make_read_releaser(self, oid: ObjectID):
        binary = oid.binary()
        reader = self.worker_id
        io, raylet = self.io, self.raylet

        def _release():
            coro = raylet.call("PlasmaRelease", {"id": binary, "reader": reader}, 10.0)
            try:
                io.run_coro(coro)
            except Exception:
                # Shutdown: the raylet reaps reader refs with the worker.
                # Close the never-scheduled coroutine so teardown doesn't
                # warn "coroutine was never awaited".
                coro.close()

        return _release

    def _try_reconstruct(self, oid: ObjectID, deadline: float | None) -> bool:
        spec = self.task_manager.lineage_for(oid)
        if spec is None:
            return False
        logger.warning("Reconstructing %s by resubmitting task %s", oid.hex()[:12], spec.name)
        return_ids = [ObjectID.for_task_return(TaskID(spec.task_id), i + 1) for i in range(spec.num_returns)]
        for rid in return_ids:
            self.memory_store.delete(rid)
        self.task_manager.add_pending(spec, return_ids)
        self._enqueue_task(spec)
        remaining = self._remaining(deadline)
        ready, _ = self.memory_store.wait_ready([oid], 1, remaining if remaining is not None else 300.0)
        return bool(ready)

    def _deserialize(self, metadata: bytes, blob, oid: ObjectID):
        value = serialization.deserialize(metadata, blob)
        if isinstance(value, RayTaskError):
            raise value.as_instanceof_cause()
        return value

    # ------------------------------------------------------------------ wait
    def wait(self, refs: Sequence[ObjectRef], num_returns: int, timeout: float | None):
        """Event-driven wait (reference ``core_worker.cc`` Wait): one asyncio
        waiter per ref resolves on memory-store arrival (owned refs) or on an
        owner long-poll (borrowed refs) — no polling loop."""
        refs = list(refs)
        fut = self.io.run_coro(self._wait_async(refs, num_returns, timeout))
        ready_idx = fut.result()
        ready = [refs[i] for i in sorted(ready_idx)][:num_returns]
        not_ready = [r for r in refs if r not in ready]
        return ready, not_ready

    async def _wait_async(self, refs: list[ObjectRef], num_returns: int, timeout: float | None) -> list[int]:
        import asyncio

        loop = asyncio.get_running_loop()
        ready: list[int] = []
        pending: dict[asyncio.Task, int] = {}
        cleanups = []
        for i, ref in enumerate(refs):
            if self.memory_store.contains(ref.id()):
                ready.append(i)
            elif self.refcounter.is_owned(ref.id()) or not ref.owner_address or ref.owner_address == self.address:
                fut: asyncio.Future = loop.create_future()

                def _on_ready(_oid, fut=fut):
                    loop.call_soon_threadsafe(lambda: fut.done() or fut.set_result(True))

                if self.memory_store.add_callback(ref.id(), _on_ready):
                    cleanups.append((ref.id(), _on_ready))
                    pending[asyncio.ensure_future(self._await_future(fut))] = i
                else:
                    ready.append(i)
            else:
                pending[asyncio.ensure_future(self._wait_borrowed(ref, timeout))] = i
        try:
            deadline = None if timeout is None else time.monotonic() + timeout
            while len(ready) < num_returns and pending:
                remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
                done, _ = await asyncio.wait(
                    pending.keys(), timeout=remaining, return_when=asyncio.FIRST_COMPLETED
                )
                if not done:
                    break  # timeout
                for task in done:
                    ready.append(pending.pop(task))
            return ready
        finally:
            for task in pending:
                task.cancel()
            for oid, cb in cleanups:
                self.memory_store.remove_callback(oid, cb)

    @staticmethod
    async def _await_future(fut) -> None:
        await fut

    async def _wait_borrowed(self, ref: ObjectRef, timeout: float | None) -> None:
        """Long-poll the owner until a borrowed ref is ready. Owner death
        counts as ready (the subsequent get raises OwnerDiedError)."""
        owner = RpcClient(ref.owner_address)
        try:
            while True:
                try:
                    status = await owner.call(
                        "GetObjectStatus",
                        {"id": ref.binary(), "wait": True, "timeout": 30.0 if timeout is None else min(timeout, 3600.0)},
                        timeout=None,
                    )
                except RpcError:
                    return
                if status.get("inline") or status.get("in_plasma"):
                    return
        finally:
            await owner.close()

    # --------------------------------------------------------- task submission
    def next_task_id(self) -> TaskID:
        with self._counter_lock:
            self._task_counter += 1
            return TaskID.for_normal_task(self.job_id, self.current_task_id, self._task_counter)

    def _attach_trace(self, spec: TaskSpec) -> None:
        """Give the spec a trace context: continue the submitting thread's
        active trace (the task's span becomes a child of it) or root a
        fresh one, so every task is traceable end to end."""
        from ..observability import tracing

        if not get_config().enable_tracing:
            return
        ctx = tracing.current()
        if ctx is None:
            spec.trace_id = tracing.new_trace_id()
        else:
            spec.trace_id = ctx.trace_id
            spec.parent_span_id = ctx.span_id
        spec.span_id = tracing.new_span_id()

    def _record_submit(self, spec: TaskSpec) -> None:
        extra = {"trace_id": spec.trace_id} if spec.trace_id else None
        self.task_events.record(spec.task_id, spec.name, "SUBMITTED",
                                kind=spec.kind, extra=extra)

    def _record_task_span(self, spec: TaskSpec, status: str) -> None:
        """Owner-side umbrella span for one task: submit → settled."""
        if not spec.trace_id:
            return
        from ..observability import tracing

        entry = self.task_manager.get_pending(spec.task_id)
        start = (entry or {}).get("submitted_at") or time.time()
        tracing.record_span(tracing.make_span(
            f"task {spec.name}", "task", start, time.time(), spec.trace_id,
            spec.parent_span_id, spec.span_id,
            attrs={"task_id": spec.task_id.hex(), "status": status}))

    @staticmethod
    def _accelerator_runtime_env(resources: dict | None, runtime_env: dict | None) -> dict:
        """Workers are pinned to CUDA_VISIBLE_DEVICES="" by the raylet unless
        the runtime_env explicitly overrides it. A task/actor that REQUESTS
        a GPU obviously wants the card: inject the opt-out so users don't
        silently train/infer on CPU while holding a GPU lease."""
        if not resources or not resources.get("GPU"):
            return runtime_env or {}
        renv = dict(runtime_env or {})
        env_vars = dict(renv.get("env_vars") or {})
        if "CUDA_VISIBLE_DEVICES" not in env_vars:
            env_vars["CUDA_VISIBLE_DEVICES"] = None  # unset -> the host's cards
            renv["env_vars"] = env_vars
        return renv

    def submit_task(
        self,
        fn: Callable,
        args: tuple,
        kwargs: dict,
        *,
        name: str | None = None,
        num_returns: int | str = 1,
        resources: dict | None = None,
        max_retries: int | None = None,
        scheduling_strategy: dict | None = None,
        placement_group_id: bytes = b"",
        placement_group_bundle_index: int = -1,
        runtime_env: dict | None = None,
        generator_backpressure: int = 0,
    ) -> list[ObjectRef] | ObjectRefGenerator:
        cfg = get_config()
        streaming = num_returns == "streaming"
        n_returns = -1 if streaming else num_returns
        fid = self.functions.export_cached(fn, "task")
        task_id = self.next_task_id()
        spec = TaskSpec(
            task_id=task_id.binary(),
            job_id=self.job_id.binary(),
            name=name or getattr(fn, "__name__", "task"),
            function_id=fid,
            kind=TASK_KIND_NORMAL,
            args=self._serialize_args(args, kwargs),
            num_returns=n_returns,
            generator_backpressure=generator_backpressure,
            resources=resources or {},
            max_retries=cfg.task_max_retries if max_retries is None else max_retries,
            owner_address=self.address,
            parent_task_id=self.current_task_id.binary(),
            scheduling_strategy=scheduling_strategy or {},
            placement_group_id=placement_group_id,
            placement_group_bundle_index=placement_group_bundle_index,
            runtime_env=self._accelerator_runtime_env(resources, runtime_env),
        )
        self._attach_trace(spec)
        if streaming:
            return self._submit_streaming(spec)
        return_ids = [ObjectID.for_task_return(task_id, i + 1) for i in range(num_returns)]
        for rid in return_ids:
            self.refcounter.add_owned_object(rid)
        self.task_manager.add_pending(spec, return_ids)
        self._record_submit(spec)
        self._enqueue_task(spec)
        return [ObjectRef(rid, self.address) for rid in return_ids]

    def _submit_streaming(self, spec: TaskSpec) -> ObjectRefGenerator:
        stream = StreamState(spec.task_id)
        self._streams[spec.task_id] = stream
        self.task_manager.add_pending(spec, [])
        self._record_submit(spec)
        if spec.kind == TASK_KIND_ACTOR_TASK:
            self.io.run_coro(self._submit_actor_task_async(spec))
        else:
            self._enqueue_task(spec)
        return ObjectRefGenerator(self, stream, self.address)

    def _serialize_args(self, args: tuple, kwargs: dict) -> list:
        cfg = get_config()
        wire_args = []
        for kind, item in [("a", a) for a in args] + [("k", (k, v)) for k, v in kwargs.items()]:
            key = None
            if kind == "k":
                key, item = item
            if isinstance(item, ObjectRef):
                self.refcounter.add_submitted_ref(item.id())
                entry = {"t": "r", "id": item.binary(), "owner": item.owner_address or self.address}
            else:
                metadata, blob, contained = serialization.serialize(item)
                if len(blob) <= cfg.max_inline_object_size and not contained:
                    entry = {"t": "v", "meta": metadata, "blob": blob}
                else:
                    # Promote large inline args to owned objects; the
                    # submitted-ref count keeps them alive until completion.
                    ref = self.put(item)
                    self.refcounter.add_submitted_ref(ref.id())
                    entry = {"t": "r", "id": ref.binary(), "owner": self.address}
            if key is not None:
                entry["key"] = key
            wire_args.append(entry)
        return wire_args

    def _release_submitted_refs(self, spec: TaskSpec) -> None:
        for arg in spec.args:
            if arg.get("t") == "r":
                self.refcounter.remove_submitted_ref(ObjectID(arg["id"]))

    def _shape_key(self, spec: TaskSpec) -> tuple:
        strategy = spec.scheduling_strategy or {}
        # Spread tasks get one lease each (salted key): sharing a lease
        # pipeline would pack them all onto the first leased worker.
        salt = 0
        if strategy.get("type") == "spread":
            with self._counter_lock:
                self._spread_salt += 1
                salt = self._spread_salt
        # The FULL runtime env keys the pipeline: leases hold workers built
        # for one env, and a task with different py_modules/pip/working_dir
        # pushed onto a reused lease would import the wrong world.
        renv = spec.runtime_env or {}
        renv_key = ""
        if renv:
            import json

            renv_key = json.dumps(renv, sort_keys=True, default=str)
            if renv.get("py_modules"):
                # Content digest, not just paths: an edited module must key
                # a fresh pipeline, or a warm lease (idle-grace reuse)
                # would push the task onto a worker with the stale code.
                from .runtime_env import _hash_paths

                renv_key += ":" + _hash_paths(list(renv["py_modules"]))
        return (
            tuple(sorted(spec.required_resources().items())),
            spec.placement_group_id,
            spec.placement_group_bundle_index,
            tuple(sorted(strategy.items())) if strategy else (),
            renv_key,
            # Retriable and non-retriable tasks never share a lease: the
            # raylet's OOM policy kills leases whose probe spec was
            # retriable, which must hold for every task pushed on them.
            bool(spec.max_retries),
            salt,
        )

    def cancel(self, ref, *, force: bool = False) -> None:
        """Cancel the task producing ``ref`` (reference ``ray.cancel``,
        ``_private/worker.py:3086``). Queued tasks are dropped; a RUNNING
        task gets TaskCancelledError raised asynchronously in its executor
        thread (takes effect at the next Python bytecode — a task blocked
        in a C call is only reachable with ``force``); ``force=True``
        kills the executing worker process. Cancelled tasks never retry;
        already-finished tasks are untouched (best-effort semantics)."""
        oid = ref.id() if hasattr(ref, "id") else ref
        task_id = oid.task_id().binary()
        if oid.is_put():
            raise ValueError("ray_tpu.cancel only applies to task returns, "
                             "not ray_tpu.put objects")
        if self.task_manager.get_pending(task_id) is None:
            return  # already finished (or never ours): best-effort no-op,
                    # and no marker left behind to leak
        self._cancelled_tasks.add(task_id)
        # queued (pre-dispatch): drop + fail in place
        with self._queue_lock:
            dropped = None
            for key, queue in self._task_queues.items():
                for spec in queue:
                    if spec.task_id == task_id:
                        dropped = spec
                        queue.remove(spec)
                        break
                if dropped is not None:
                    break
        if dropped is not None:
            self._fail_task(dropped, TaskCancelledError(task_id.hex()[:12]))
            return
        # dispatched: interrupt (or kill) the executing worker
        addr = self._dispatched_to.get(task_id)
        if addr is None:
            return  # finished, unknown, or actor task — no-op
        async def _send():
            client = RpcClient(addr)
            try:
                await client.call("CancelTask",
                                  {"task_id": task_id, "force": force},
                                  timeout=10.0)
            except Exception as e:
                logger.debug("CancelTask to %s failed: %s", addr, e)
            finally:
                await client.close()
        self.io.run_coro(_send())

    def _enqueue_task(self, spec: TaskSpec) -> None:
        if spec.task_id in self._cancelled_tasks:
            # cancelled tasks never (re)enter the queue — a retry after a
            # force-kill must fail, not resubmit
            self._fail_task(spec, TaskCancelledError(spec.task_id.hex()[:12]))
            return
        key = self._shape_key(spec)
        with self._queue_lock:
            self._task_queues.setdefault(key, []).append(spec)
            active = self._pipelines.get(key, 0)
            queued = len(self._task_queues[key])
            cfg = get_config()
            if active < min(queued, cfg.max_pending_lease_requests_per_scheduling_category):
                self._pipelines[key] = active + 1
                self.io.run_coro(self._lease_pipeline(key))

    def _lease_want(self, key: tuple, extra_waiters: int) -> int:
        """How many workers one RequestWorkerLease should ask for: enough
        for the pipelines parked on this key plus the queue's depth, up to
        ``lease_grant_batch_size``. Spread keys are salted per task (one
        spec per key) — never multiplex those."""
        cap = get_config().lease_grant_batch_size
        if cap <= 1 or key[-1]:
            return 1
        with self._queue_lock:
            queued = len(self._task_queues.get(key) or ())
        return max(1, min(cap, max(1 + extra_waiters, queued)))

    # How long a pipeline parks on a sibling's in-flight lease RPC before
    # de-coalescing and issuing its own: config lease_coalesce_degrade_ms.
    # Fast-path replies land in milliseconds, so coalescing keeps its win
    # there; a leader stuck on a dropped reply or a slow worker spawn must
    # NOT hold every other pipeline hostage for its full RPC timeout —
    # under faults the owner degrades to the old one-RPC-per-pipeline
    # concurrency. The deadline runs on the chaos clock, so a VirtualClock
    # chaos replay fires the degrade deterministically (frozen clock =
    # never; an explicit advance() = exactly then).

    @staticmethod
    async def _await_gate_with_degrade(fut: "asyncio.Future"):
        """Await a lease-gate future up to the coalesce-degrade window,
        measured on the chaos clock. Raises asyncio.TimeoutError when the
        window elapses (virtual or wall) before the leader resolves."""
        import asyncio

        from ..chaos import clock as chaos_clock

        wait_s = get_config().lease_coalesce_degrade_ms / 1000.0
        clk = chaos_clock.get_clock()
        deadline = clk.now() + wait_s
        # Wall clock: one wait_for covers the window. Virtual clock:
        # poll in small real slices so explicit advance() calls (and
        # rate-scaled time) are observed without wall-time coupling.
        slice_s = wait_s if isinstance(clk, chaos_clock.WallClock) else 0.02
        while True:
            remaining = deadline - clk.now()
            if remaining <= 0:
                raise asyncio.TimeoutError
            try:
                return await asyncio.wait_for(
                    asyncio.shield(fut), min(slice_s, max(remaining, 0.001))
                    if slice_s != wait_s else remaining)
            except asyncio.TimeoutError:
                continue

    async def _acquire_lease_shared(self, key: tuple, spec: TaskSpec):
        """Coalesce same-shape lease acquisition across this owner's
        pipelines: one leader RPC requests workers for everyone parked on
        the key; followers receive grants from the leader's reply instead
        of each paying ``_acquire_lease``'s serial round trip. Returns
        ``(leases, reason)`` like ``_acquire_lease`` — the caller owns
        every returned lease (extras beyond the first come from
        multiplexed grants the waiters didn't absorb)."""
        import asyncio

        if get_config().lease_grant_batch_size <= 1 or key[-1]:
            # Multiplexing off (or a salted spread key, one spec per key):
            # the legacy fully-concurrent one-RPC-per-pipeline protocol.
            return await self._acquire_lease(spec)
        while True:
            gate = self._lease_gates.get(key)
            if gate is not None:
                fut: asyncio.Future = asyncio.get_running_loop().create_future()
                gate["waiters"].append(fut)
                try:
                    outcome, value = await self._await_gate_with_degrade(fut)
                except asyncio.TimeoutError:
                    if fut in gate["waiters"]:
                        gate["waiters"].remove(fut)
                    if fut.done():  # resolved in the race window
                        outcome, value = fut.result()
                    else:
                        fut.cancel()
                        return await self._acquire_lease(
                            spec, num_workers=self._lease_want(key, 0))
                if outcome == "lease":
                    return [value], ""
                if outcome == "denied":
                    return None, value
                continue  # grants ran out before our turn: try again
            gate = {"waiters": []}
            self._lease_gates[key] = gate
            try:
                leases, reason = await self._acquire_lease(
                    spec, num_workers=self._lease_want(key, 0))
            finally:
                self._lease_gates.pop(key, None)
            waiters = gate["waiters"]
            if leases is None:
                for f in waiters:
                    if not f.done():
                        f.set_result(("denied", reason))
                return None, reason
            keep, extras = [leases[0]], leases[1:]
            for f in waiters:
                if f.done():
                    continue
                if extras:
                    f.set_result(("lease", extras.pop(0)))
                else:
                    f.set_result(("retry", None))
            keep.extend(extras)
            return keep, ""

    async def _return_lease(self, lease) -> None:
        """Give an unused multiplexed grant back to its raylet."""
        _addr, worker_id, client, owns = lease
        try:
            await client.call("ReturnWorker", {"worker_id": worker_id},
                              timeout=10.0)
        except Exception:
            pass
        if owns:
            await client.close()

    async def _lease_pipeline(self, key: tuple, preacquired=None) -> None:
        """One lease worker: acquire a lease, drain the queue, return it
        (NormalTaskSubmitter::RequestNewWorkerIfNeeded, :291).
        ``preacquired`` carries a multiplexed grant handed over by a
        sibling pipeline — the first iteration skips acquisition.

        Invariant: once a spec is popped from the queue it is ALWAYS resolved
        — completed, re-enqueued for retry, or failed — on every exit path,
        including cancellation and unexpected exceptions."""
        try:
            while True:
                if preacquired is not None:
                    leases, preacquired = [preacquired], None
                else:
                    with self._queue_lock:
                        if not self._task_queues.get(key):
                            return
                        probe_spec = self._task_queues[key][0]
                    leases, reason = await self._acquire_lease_shared(key, probe_spec)
                    if leases is None:
                        with self._queue_lock:
                            queue = self._task_queues.get(key) or []
                            specs, self._task_queues[key] = list(queue), []
                        reason = reason or "cluster infeasible or timeout"
                        for spec in specs:
                            self._fail_task(spec, RayTpuError(
                                f"Failed to lease a worker ({reason})"))
                        return
                # Extra multiplexed grants: hand each to a fresh pipeline
                # (bounded by the per-key cap); grants the cap or an
                # emptied queue leave unused go straight back.
                for lease in leases[1:]:
                    spawned = False
                    with self._queue_lock:
                        cap = get_config().max_pending_lease_requests_per_scheduling_category
                        if (self._task_queues.get(key)
                                and self._pipelines.get(key, 0) < cap):
                            self._pipelines[key] = self._pipelines.get(key, 0) + 1
                            spawned = True
                    if spawned:
                        self.io.run_coro(self._lease_pipeline(key, preacquired=lease))
                    else:
                        await self._return_lease(lease)
                worker_addr, worker_id, raylet_client, owns_client = leases[0]
                worker = RpcClient(worker_addr)
                # Spread tasks salt the key per task (key[-1] != 0): their
                # queue can never refill, so skip the grace.
                grace_s = 0.0 if key[-1] else get_config().lease_idle_grace_ms / 1000.0
                push_batch_cap = get_config().task_push_batch_size
                # ADAPTIVE batch size: batching amortizes per-RPC overhead
                # for cheap tasks but SERIALIZES execution within the batch
                # — two 1s tasks in one batch take 2s on one worker while
                # other leased workers idle. Start at 1 and ramp up only
                # while observed per-task time stays well under the RPC
                # overhead scale; any slow batch resets to 1
                # (_next_push_batch).
                cur_batch = 1

                pipeline_cap = get_config().max_pending_lease_requests_per_scheduling_category

                try:
                    while True:
                        with self._queue_lock:
                            queue = self._task_queues.get(key)
                            specs = _pop_push_batch(
                                queue, cur_batch, pipeline_cap) if queue else []
                        if not specs:
                            # Drained: hold the lease for a short grace so
                            # an immediate next submit reuses it (sync
                            # loops would otherwise pay a full lease
                            # acquire+return round trip per task).
                            if grace_s > 0:
                                deadline = time.monotonic() + grace_s
                                while not specs and time.monotonic() < deadline:
                                    await asyncio_sleep(0.002)
                                    with self._queue_lock:
                                        queue = self._task_queues.get(key)
                                        if queue:
                                            specs = _pop_push_batch(
                                                queue, cur_batch, pipeline_cap)
                            if not specs:
                                break
                        try:
                            push_t0 = time.monotonic()
                            worker_alive = await self._push_and_complete_batch(
                                specs, worker, worker_id)
                            per_task = (time.monotonic() - push_t0) / len(specs)
                            cur_batch = _next_push_batch(
                                cur_batch, per_task, push_batch_cap)
                        except BaseException as e:
                            # Never lose a popped spec: cancellation and
                            # unexpected errors fail them visibly.
                            for spec in specs:
                                self._fail_task(spec, RayTpuError(f"task submission aborted: {type(e).__name__}: {e}"))
                            raise
                        if not worker_alive:
                            # Worker died mid-push: drop this lease and loop
                            # back to _acquire_lease — retried specs must not
                            # be pushed to the same corpse.
                            break
                finally:
                    await worker.close()
                    try:
                        await raylet_client.call("ReturnWorker", {"worker_id": worker_id}, timeout=10.0)
                    except Exception:
                        pass
                    if owns_client:
                        await raylet_client.close()
        finally:
            with self._queue_lock:
                self._pipelines[key] = max(0, self._pipelines.get(key, 1) - 1)
                if self._task_queues.get(key):
                    self._pipelines[key] += 1
                    self.io.run_coro(self._lease_pipeline(key))
                elif self._pipelines.get(key, 0) == 0:
                    # Drop drained keys — spread tasks salt the key per
                    # task, so stale entries would accumulate forever.
                    self._pipelines.pop(key, None)
                    self._task_queues.pop(key, None)

    async def _acquire_lease(self, spec: TaskSpec, num_workers: int = 1):
        """Follow the lease/spillback protocol. A dead spillback target (its
        raylet unreachable) sends us back to the local raylet for a fresh
        placement — nodes can die between the spill decision and the hop —
        until an overall deadline expires.

        Returns ``(leases, reason)``: ``leases`` is a list of
        ``(worker_address, worker_id, raylet_client, owns_client)`` tuples
        — the first is the caller's; extras come from multiplexed grants
        (``num_workers`` > 1) and, when granted by a spillback raylet,
        each carry their own client — or ``None`` with the denial reason.
        The reason is RETURNED, never stashed on the instance: concurrent
        acquires for other scheduling keys must not see each other's
        denials (the old ``_last_lease_denial`` attribute raced exactly
        that way)."""
        import asyncio

        cfg = get_config()
        deadline = time.monotonic() + cfg.worker_register_timeout_s * 2
        # Lost-reply budget: a lease RPC that times out (dropped request
        # or reply — chaos or a real transient) is retried with a fresh
        # deadline window instead of failing every queued task; the
        # stranded grant, if any, is reclaimed raylet-side as an un-acked
        # orphan lease (ROADMAP 1c).
        timeout_retries = 3
        # Bounds waiting on a LOST reply; a slow-but-alive raylet keeps
        # streaming toward this cap legitimately (worker cold start).
        lease_rpc_timeout = (cfg.worker_register_timeout_s
                             + min(10.0, cfg.worker_register_timeout_s))
        raylet = self.raylet
        raylet_addr = self.raylet_address
        try:
            while time.monotonic() < deadline:
                for _hop in range(4):
                    payload = {"spec": spec.to_wire(), "spilled": _hop > 0}
                    # `spilled` marks follow-up hops so policies that
                    # redirect (spread) don't ping-pong the lease
                    if num_workers > 1:
                        payload["num_workers"] = num_workers
                    try:
                        reply = await raylet.call(
                            "RequestWorkerLease", payload,
                            timeout=lease_rpc_timeout,
                        )
                    except RpcError as e:
                        if raylet is self.raylet:
                            if "timed out" in str(e) and timeout_retries > 0:
                                timeout_retries -= 1
                                deadline = max(
                                    deadline,
                                    time.monotonic()
                                    + cfg.worker_register_timeout_s)
                                break
                            return None, "local raylet unreachable"
                        break  # spill target died: restart from local
                    if reply.get("granted"):
                        local = raylet is self.raylet
                        grants = [(reply["worker_address"], reply["worker_id"],
                                   raylet, not local)]
                        for g in reply.get("extra_grants") or ():
                            client = (self.raylet if local
                                      else RetryableRpcClient(raylet_addr))
                            grants.append((g["worker_address"], g["worker_id"],
                                           client, not local))
                        try:
                            # Confirm receipt of EVERY grant in one RPC:
                            # the raylet reclaims leases that are never
                            # acked (the reply may die on the wire —
                            # ROADMAP 1c).
                            await raylet.call(
                                "AckLease",
                                {"worker_id": reply["worker_id"],
                                 "worker_ids": [g[1] for g in grants[1:]]},
                                timeout=10.0)
                        except RpcError:
                            pass  # raylet reclaims; the lease still works
                        raylet = self.raylet  # returned clients kept by caller
                        return grants, ""
                    if reply.get("spillback"):
                        if raylet is not self.raylet:
                            await raylet.close()
                        raylet_addr = reply["node_address"]
                        raylet = RetryableRpcClient(raylet_addr)
                        continue
                    # definitive denial (infeasible / timeout / worker
                    # start failure): return the raylet's reason so the
                    # task error names the actual cause (e.g. a
                    # runtime_env plugin setup failure)
                    return None, reply.get("reason", "")
                if raylet is not self.raylet:
                    await raylet.close()
                    raylet = self.raylet
                    raylet_addr = self.raylet_address
                await asyncio.sleep(0.5)
            return None, ""
        finally:
            if raylet is not self.raylet:
                await raylet.close()

    async def _push_and_complete(self, spec: TaskSpec, worker: RpcClient, worker_id: str) -> bool:
        """Returns False when the worker died (the caller must drop the lease)."""
        # LEASED at dispatch: tasks pushed onto a reused lease never pass
        # through the raylet's grant path, so the owner stamps the lease
        # stage here (the GCS keeps the earliest LEASED ts per task).
        self.task_events.record(spec.task_id, spec.name, "LEASED",
                                kind=spec.kind, extra={"worker_id": worker_id})
        self._dispatched_to[spec.task_id] = worker.address
        if spec.task_id in self._cancelled_tasks:
            # Cancel raced the pop->dispatch window: the marker was set
            # after the queue scan missed this spec but before the
            # dispatch address was published — honoring it here (AFTER
            # publishing the address) closes the silent no-op window.
            self._dispatched_to.pop(spec.task_id, None)
            self._fail_task(spec, TaskCancelledError(spec.task_id.hex()[:12]))
            return True
        try:
            reply = await worker.call("PushTask", {"spec": spec.to_wire()}, timeout=None)
        except RpcError as e:
            # Worker died mid-task (PushNormalTask failure path →
            # FailOrRetryPendingTask, task_manager.h:491).
            self._dispatched_to.pop(spec.task_id, None)
            if spec.task_id in self._cancelled_tasks:
                # force-cancel kills the worker: that death IS the cancel
                self._fail_task(spec, TaskCancelledError(spec.task_id.hex()[:12]))
            elif self.task_manager.consume_retry(spec.task_id):
                logger.warning("Retrying task %s after worker failure: %s", spec.name, e)
                self._enqueue_task(spec)
            else:
                self._fail_task(spec, WorkerCrashedError(f"Worker died executing {spec.name}: {e}"))
            return False
        self._dispatched_to.pop(spec.task_id, None)
        if not await self._maybe_reexport(spec, reply):
            self._handle_task_reply(spec, reply)
        return True

    async def _push_and_complete_batch(self, specs: list, worker: RpcClient,
                                       worker_id: str) -> bool:
        """Push a batch of normal-task specs in ONE RPC (handle_PushTasks);
        single specs keep the one-task path. Returns False when the worker
        died — every spec of the batch is then retried or failed (the
        all-or-nothing RPC can't say which ran; same semantics as the
        single-task death path)."""
        if len(specs) == 1:
            return await self._push_and_complete(specs[0], worker, worker_id)
        for spec in specs:
            self.task_events.record(spec.task_id, spec.name, "LEASED",
                                    kind=spec.kind, extra={"worker_id": worker_id})
            self._dispatched_to[spec.task_id] = worker.address
        live = []
        for spec in specs:
            # Same cancel-raced-the-dispatch window as the single-task
            # path: honor markers set during the pop->dispatch gap.
            if spec.task_id in self._cancelled_tasks:
                self._dispatched_to.pop(spec.task_id, None)
                self._fail_task(spec, TaskCancelledError(spec.task_id.hex()[:12]))
            else:
                live.append(spec)
        specs = live
        if not specs:
            return True
        try:
            reply = await worker.call(
                "PushTasks", {"specs": [s.to_wire() for s in specs]}, timeout=None)
        except RpcError as e:
            for spec in specs:
                self._dispatched_to.pop(spec.task_id, None)
                if spec.task_id in self._cancelled_tasks:
                    self._fail_task(spec, TaskCancelledError(spec.task_id.hex()[:12]))
                elif self.task_manager.consume_retry(spec.task_id):
                    logger.warning("Retrying task %s after worker failure: %s", spec.name, e)
                    self._enqueue_task(spec)
                else:
                    self._fail_task(spec, WorkerCrashedError(
                        f"Worker died executing {spec.name}: {e}"))
            return False
        for spec, r in zip(specs, reply["replies"]):
            self._dispatched_to.pop(spec.task_id, None)
            if not await self._maybe_reexport(spec, r):
                self._handle_task_reply(spec, r)
        return True

    def _store_return_item(self, rid: ObjectID, ret: dict) -> None:
        """Store one executor-reported return (inline value or plasma
        marker) and register nested-ref containment/borrowing."""
        # The return value embeds nested refs: record containment (they
        # live while the return object lives here) and register as a
        # borrower with their owners (reference: nested-ref borrowing).
        contained = ret.get("contained") or []
        if contained:
            child_ids = []
            for c in contained:
                cid = ObjectID(c["id"])
                child_ids.append(cid)
                owner = c.get("owner", "")
                if owner and owner != self.address and self.refcounter.note_borrowed(cid, owner):
                    self.io.run_coro(self._send_borrow(owner, "AddBorrower", cid))
            self.refcounter.add_containment(rid, child_ids)
        if ret["t"] == "v":
            self.memory_store.put(rid, ret["meta"], ret["blob"])
            self.refcounter.set_size(rid, len(ret["blob"]))
        else:  # in plasma on executor's node
            node_id = ret["node_id"]
            self.refcounter.add_location(rid, node_id)
            self.memory_store.put_plasma_marker(rid, node_id.encode() if isinstance(node_id, str) else node_id)
            self.refcounter.set_size(rid, ret.get("size", 0))

    async def _maybe_reexport(self, spec: TaskSpec, reply: dict) -> bool:
        """Handle a worker's "function not in GCS" reply: the GCS lost the
        export (a crash inside the snapshot window). We still hold the
        function — re-export and resubmit (does NOT consume a user retry;
        nothing ran). Runs ON the io loop, so the KV write is awaited, not
        run_sync'd (that would deadlock the loop on itself)."""
        if not reply.get("function_missing"):
            return False
        fn = self.functions.cached(spec.function_id)
        if fn is None:
            self._fail_task(spec, RayTpuError(
                f"Function for task {spec.name} lost from the GCS and not "
                "cached by the owner"))
            return True
        logger.warning("Re-exporting function for task %s after GCS loss", spec.name)
        payload = cloudpickle.dumps(fn)
        await self.gcs.call(
            "KvPut",
            {"key": "fn:" + spec.function_id.hex(), "value": payload,
             "overwrite": True},
            timeout=30.0,
        )
        self._enqueue_task(spec)
        return True

    def _handle_task_reply(self, spec: TaskSpec, reply: dict) -> None:
        self._cancelled_tasks.discard(spec.task_id)
        self._record_task_span(spec, "ok")
        task_id = TaskID(spec.task_id)
        if spec.num_returns == -1:
            # Streaming task finished: items arrived via ReportGeneratorItem;
            # the reply only carries the final count (races with the last
            # report are fine — both paths are idempotent). The error fallback
            # covers a lost error report (owner briefly unreachable).
            stream = self._streams.get(spec.task_id)
            if stream is not None:
                err_wire = reply.get("stream_error")
                if err_wire:
                    err = serialization.deserialize(err_wire["meta"], err_wire["blob"])
                    if isinstance(err, RayTaskError):
                        err = err.as_instanceof_cause()
                    stream.fail(err)
                else:
                    stream.finish(reply.get("streamed", 0))
            self.task_manager.complete(spec.task_id)
            self._release_submitted_refs(spec)
            self._record_terminal(spec, reply)
            return
        for i, ret in enumerate(reply.get("returns", [])):
            rid = ObjectID.for_task_return(task_id, i + 1)
            self._store_return_item(rid, ret)
        self.task_manager.complete(spec.task_id)
        self._release_submitted_refs(spec)
        self._record_terminal(spec, reply)

    def _record_terminal(self, spec: TaskSpec, reply: dict) -> None:
        """Owner-side terminal status: the executor records FINISHED too,
        but its buffer dies unflushed when the worker is killed right
        after executing (chaos kill-on-lease, OOM kill) — the owner has
        the reply in hand, so the GCS must never show a settled task as
        non-terminal."""
        status = "FAILED" if reply.get("stream_error") else "FINISHED"
        self.task_events.record(spec.task_id, spec.name, status,
                                kind=spec.kind)

    def _fail_task(self, spec: TaskSpec, error: Exception) -> None:
        self._cancelled_tasks.discard(spec.task_id)
        self._record_task_span(spec, "error")
        self.task_events.record(spec.task_id, spec.name, "FAILED", kind=spec.kind,
                                extra={"error": str(error)[:200]})
        task_id = TaskID(spec.task_id)
        if spec.num_returns == -1:
            stream = self._streams.get(spec.task_id)
            if stream is not None:
                stream.fail(error)
            self.task_manager.fail(spec.task_id)
            self._release_submitted_refs(spec)
            return
        metadata, blob, _ = serialization.serialize_error(
            RayTaskError(spec.name, str(error), error)
        )
        for i in range(spec.num_returns):
            rid = ObjectID.for_task_return(task_id, i + 1)
            self.memory_store.put(rid, metadata, blob)
        self.task_manager.fail(spec.task_id)
        self._release_submitted_refs(spec)

    # ------------------------------------------------------------- actor API
    def create_actor(
        self,
        cls: type,
        args: tuple,
        kwargs: dict,
        *,
        name: str = "",
        num_cpus: float | None = None,
        resources: dict | None = None,
        max_restarts: int = 0,
        max_concurrency: int = 1,
        concurrency_groups: dict | None = None,
        detached: bool = False,
        scheduling_strategy: dict | None = None,
        placement_group_id: bytes = b"",
        placement_group_bundle_index: int = -1,
        runtime_env: dict | None = None,
    ) -> bytes:
        with self._counter_lock:
            self._task_counter += 1
            counter = self._task_counter
        actor_id = ActorID.of(self.job_id, self.current_task_id, counter)
        fid = self.functions.export_cached(cls, "actor")
        task_id = TaskID.for_actor_creation_task(actor_id)
        res = dict(resources or {})
        if num_cpus is not None:
            res["CPU"] = num_cpus
        res.setdefault("CPU", 1.0)
        spec = TaskSpec(
            task_id=task_id.binary(),
            job_id=self.job_id.binary(),
            name=f"{cls.__name__}.__init__",
            function_id=fid,
            kind=TASK_KIND_ACTOR_CREATION,
            args=self._serialize_args(args, kwargs),
            resources=res,
            owner_address=self.address,
            actor_id=actor_id.binary(),
            max_restarts=max_restarts,
            max_concurrency=max_concurrency,
            concurrency_groups=dict(concurrency_groups or {}),
            scheduling_strategy=scheduling_strategy or {},
            placement_group_id=placement_group_id,
            placement_group_bundle_index=placement_group_bundle_index,
            runtime_env=self._accelerator_runtime_env(res, runtime_env),
        )
        self._attach_trace(spec)
        payload = {"spec": spec.to_wire(), "name": name, "detached": detached}
        state = _ActorState(actor_id.binary())
        state.serialized = (max_concurrency <= 1
                            and not spec.concurrency_groups)
        self._actors[actor_id.binary()] = state
        if name or detached:
            # Named/detached registration stays synchronous: the
            # name-taken error must surface from .remote() itself.
            reply = self._gcs_call("RegisterActor", payload)
            if reply.get("error"):
                self._actors.pop(actor_id.binary(), None)
                raise RayTpuError(reply["error"])
        else:
            # PIPELINED registration: unnamed actors cannot fail
            # RegisterActor (only name conflicts error), so a creation
            # storm fires the RPCs back-to-back instead of paying one
            # serial GCS round trip each — resolution and kill both wait
            # on register_future before trusting a GCS "not found".
            state.register_future = self.io.run_coro(
                self.gcs.call("RegisterActor", payload, 30.0))
        return actor_id.binary()

    def _actor_state(self, actor_id: bytes) -> _ActorState:
        state = self._actors.get(actor_id)
        if state is None:
            state = self._actors[actor_id] = _ActorState(actor_id)
        return state

    def submit_actor_task(
        self,
        actor_id: bytes,
        method_name: str,
        args: tuple,
        kwargs: dict,
        *,
        num_returns: int | str = 1,
        generator_backpressure: int = 0,
        concurrency_group: str = "",
    ) -> list[ObjectRef] | ObjectRefGenerator:
        state = self._actor_state(actor_id)
        streaming = num_returns == "streaming"
        with self._counter_lock:
            self._task_counter += 1
            counter = self._task_counter
        task_id = TaskID.for_actor_task(self.job_id, self.current_task_id, counter, ActorID(actor_id))
        with state.lock:
            seq_no = state.seq_no
            state.seq_no += 1
            incarnation = state.incarnation
        spec = TaskSpec(
            task_id=task_id.binary(),
            job_id=self.job_id.binary(),
            name=method_name,
            function_id=b"",
            kind=TASK_KIND_ACTOR_TASK,
            args=self._serialize_args(args, kwargs),
            num_returns=-1 if streaming else num_returns,
            generator_backpressure=generator_backpressure,
            owner_address=self.address,
            actor_id=actor_id,
            actor_method=method_name,
            seq_no=seq_no,
            concurrency_group=concurrency_group,
        )
        spec._incarnation = incarnation
        self._attach_trace(spec)
        if streaming:
            return self._submit_streaming(spec)
        return_ids = [ObjectID.for_task_return(task_id, i + 1) for i in range(num_returns)]
        for rid in return_ids:
            self.refcounter.add_owned_object(rid)
        self.task_manager.add_pending(spec, return_ids)
        self._record_submit(spec)
        wake = False
        with self._actor_submit_lock:
            self._actor_submit_q.append(spec)
            if not self._actor_submit_active:
                self._actor_submit_active = True
                wake = True
        if wake:
            self.io.run_coro(self._drain_actor_submits())
        return [ObjectRef(rid, self.address) for rid in return_ids]

    async def _drain_actor_submits(self) -> None:
        """Dispatch queued actor-task specs on the io loop, in submission
        order (seq numbers were assigned in ``submit_actor_task``, and the
        executor's per-caller buffer reorders stragglers anyway). Exits
        only after observing an empty queue under the lock, so a producer
        that appends after the last pop always sees ``active`` and wakes a
        new drainer.

        Specs addressed to the same SERIALIZED actor that are queued in
        the same sweep coalesce into one ``PushActorTasks`` RPC (executed
        strictly in seq order executor-side): a burst of K calls pays one
        wire round trip and one worker wakeup instead of K — the
        actor-call sibling of the normal-task push batch."""
        import asyncio

        batch_cap = get_config().task_push_batch_size
        while True:
            with self._actor_submit_lock:
                if not self._actor_submit_q:
                    self._actor_submit_active = False
                    return
                sweep = list(self._actor_submit_q)
                self._actor_submit_q.clear()
            groups: dict[bytes, list] = {}
            order: list[bytes] = []
            for spec in sweep:
                if spec.actor_id not in groups:
                    groups[spec.actor_id] = []
                    order.append(spec.actor_id)
                groups[spec.actor_id].append(spec)
            for aid in order:
                specs = groups[aid]
                batchable = (len(specs) > 1
                             and self._actors.get(aid) is not None
                             and self._actors[aid].serialized)
                if not batchable:
                    for spec in specs:
                        asyncio.ensure_future(self._submit_actor_task_async(spec))
                    continue
                for i in range(0, len(specs), batch_cap):
                    asyncio.ensure_future(
                        self._submit_actor_batch_async(specs[i:i + batch_cap]))
            # Let the dispatched sends make progress mid-burst.
            await asyncio.sleep(0)

    async def _submit_actor_batch_async(self, specs: list, attempts: int = 3) -> None:
        """Batched sibling of ``_submit_actor_task_async``: one
        PushActorTasks RPC for K in-seq-order calls to one serialized
        actor; per-spec replies settle exactly like the single path."""
        if len(specs) == 1:
            await self._submit_actor_task_async(specs[0])
            return
        state = self._actor_state(specs[0].actor_id)
        try:
            address = await self._resolve_actor(state)
        except ActorDiedError as e:
            for spec in specs:
                self._fail_task(spec, e)
            return
        with state.lock:
            for spec in specs:
                if getattr(spec, "_incarnation", state.incarnation) != state.incarnation:
                    spec.seq_no = state.seq_no
                    state.seq_no += 1
                    spec._incarnation = state.incarnation
        try:
            if state.client is None or state.client.address != address:
                state.client = RpcClient(address)
            reply = await state.client.call(
                "PushActorTasks", {"specs": [s.to_wire() for s in specs]},
                timeout=None)
            for spec, r in zip(specs, reply["replies"]):
                if r.get("error"):
                    self._fail_task(spec, RayTpuError(r["error"]))
                else:
                    self._handle_task_reply(spec, r)
        except RpcError as e:
            with state.lock:
                if state.address == address:  # first observer of this death
                    state.incarnation += 1
                    state.seq_no = 0
                    state.address = ""
                    state.client = None
            if getattr(e, "undelivered", False) and attempts > 0:
                await self._submit_actor_batch_async(specs, attempts - 1)
                return
            for spec in specs:
                self._fail_task(
                    spec, ActorDiedError(spec.actor_id.hex(),
                                         f"actor died while executing {spec.name}: {e}"))

    async def _submit_actor_task_async(self, spec: TaskSpec, attempts: int = 3) -> None:
        state = self._actor_state(spec.actor_id)
        try:
            address = await self._resolve_actor(state)
        except ActorDiedError as e:
            self._fail_task(spec, e)
            return
        # Sequence numbers are scoped to one actor incarnation: a spec
        # assigned before a restart gets a fresh seq for the new executor
        # (whose per-caller ordering buffer starts at 0 again).
        with state.lock:
            if getattr(spec, "_incarnation", state.incarnation) != state.incarnation:
                spec.seq_no = state.seq_no
                state.seq_no += 1
                spec._incarnation = state.incarnation
        try:
            if state.client is None or state.client.address != address:
                state.client = RpcClient(address)
            reply = await state.client.call("PushTask", {"spec": spec.to_wire()}, timeout=None)
            if reply.get("error"):
                self._fail_task(spec, RayTpuError(reply["error"]))
            else:
                self._handle_task_reply(spec, reply)
        except RpcError as e:
            with state.lock:
                if state.address == address:  # first observer of this death
                    state.incarnation += 1
                    state.seq_no = 0
                    state.address = ""
                    state.client = None
            # Never-delivered sends (connect failed — e.g. the cached
            # address points at a pre-restart incarnation) are side-effect
            # free: re-resolve and retry. Failures after delivery follow
            # reference semantics (actor_task_submitter.cc): the task FAILS
            # — the method may have executed and had side effects.
            if getattr(e, "undelivered", False) and attempts > 0:
                await self._submit_actor_task_async(spec, attempts - 1)
                return
            self._fail_task(
                spec, ActorDiedError(spec.actor_id.hex(), f"actor died while executing {spec.name}: {e}")
            )

    def _ensure_actor_watcher(self) -> None:
        """Start the actor-channel subscriber once (on first resolve):
        one long-poll on the GCS "actor" pub/sub channel replaces N
        pending actors x 10 GetActorInfo polls per second — during a
        creation storm the polling alone was a GCS-loop DoS, and the
        channel's batched fan-out delivers every transition in one wake."""
        if self._actor_watch_started:
            return
        self._actor_watch_started = True
        self.io.run_coro(self._actor_state_poller())

    async def _actor_state_poller(self) -> None:
        import asyncio

        cursor = 0  # replay is cheap (skips untracked actors) and has no
        # staleness hole for actors that settled before we subscribed
        while True:
            try:
                reply = await self.gcs.call(
                    "SubscribePoll",
                    {"cursors": {"actor": cursor}, "timeout": 30.0},
                    timeout=45.0)
            except Exception:
                await asyncio.sleep(1.0)
                continue
            msgs = (reply.get("messages") or {}).get("actor", [])
            for seq, msg in msgs:
                cursor = max(cursor, seq)
                try:
                    aid = bytes.fromhex(msg.get("actor_id", ""))
                except ValueError:
                    continue
                state = self._actors.get(aid)
                if state is None:
                    continue
                # Just signal: _resolve_actor re-reads authoritative
                # state via GetActorInfo, so every transition semantic
                # (ALIVE address, DEAD cause, RESTARTING) stays in one
                # place and a lost message only costs the safety re-poll.
                ev = state.changed
                if ev is not None:
                    ev.set()

    async def _resolve_actor(self, state: _ActorState) -> str:
        """Resolve the actor's current address: one authoritative
        GetActorInfo per state transition, parked on the actor-channel
        watcher between transitions (plus a 5s safety re-poll)."""
        import asyncio

        if state.address:
            return state.address
        self._ensure_actor_watcher()
        deadline = time.monotonic() + get_config().actor_resolve_timeout_s
        while time.monotonic() < deadline:
            if state.address:
                return state.address
            ev = state.changed
            if ev is None:
                ev = state.changed = asyncio.Event()
            ev.clear()
            reply = await self.gcs.call("GetActorInfo", {"actor_id": state.actor_id.hex()}, timeout=10.0)
            if not reply.get("found"):
                if state.register_future is not None \
                        and not state.register_future.done():
                    # Pipelined RegisterActor still in flight: "not
                    # found" just means our registration hasn't landed.
                    await asyncio_sleep(0.02)
                    continue
                raise ActorDiedError(state.actor_id.hex(), "actor not registered")
            if reply["state"] == "ALIVE" and reply["address"]:
                state.address = reply["address"]
                state.state = "ALIVE"
                return state.address
            if reply["state"] == "DEAD":
                state.state = "DEAD"
                raise ActorDiedError(state.actor_id.hex(), reply.get("death_cause", ""))
            remaining = deadline - time.monotonic()
            try:
                await asyncio.wait_for(ev.wait(), min(max(remaining, 0.01), 5.0))
            except asyncio.TimeoutError:
                pass
        raise ActorDiedError(state.actor_id.hex(), "timed out resolving actor address")

    def kill_actor(self, actor_id: bytes) -> None:
        self._await_registered(actor_id)
        self._gcs_call("KillActor", {"actor_id": actor_id.hex()})

    def _await_registered(self, actor_id: bytes, timeout: float = 30.0) -> None:
        """Ensure a pipelined RegisterActor has landed before a kill: a
        KillActor racing ahead of its registration would no-op and leak
        the actor once the register arrives."""
        state = self._actors.get(actor_id)
        fut = getattr(state, "register_future", None) if state else None
        if fut is not None:
            try:
                fut.result(timeout)
            except Exception:
                pass
            state.register_future = None

    def register_actor_handle(self, actor_id: bytes, owned: bool) -> None:
        with self._counter_lock:
            self._actor_handle_counts[actor_id] = self._actor_handle_counts.get(actor_id, 0) + 1
            if owned:
                self._owned_actors.add(actor_id)

    def deregister_actor_handle(self, actor_id: bytes) -> None:
        with self._counter_lock:
            count = self._actor_handle_counts.get(actor_id, 1) - 1
            self._actor_handle_counts[actor_id] = count
            should_kill = count <= 0 and actor_id in self._owned_actors
            if should_kill:
                self._owned_actors.discard(actor_id)
        if should_kill:
            try:
                state = self._actors.get(actor_id)
                reg = getattr(state, "register_future", None) if state else None

                async def _kill():
                    import asyncio

                    if reg is not None and not reg.done():
                        # A GC-kill racing ahead of the pipelined
                        # registration would no-op and leak the actor.
                        await asyncio.wrap_future(reg)
                    await self.gcs.call(
                        "KillActor", {"actor_id": actor_id.hex()}, 10.0)

                self.io.run_coro(_kill())
            except Exception:
                pass

    def get_actor_by_name(self, name: str) -> tuple[bytes, dict] | None:
        reply = self._gcs_call("GetActorByName", {"name": name})
        if not reply.get("found"):
            return None
        return bytes.fromhex(reply["actor_id"]), reply

    # --------------------------------------------------------- owner RPC svc
    async def handle_GetObjectStatus(self, p: dict) -> dict:
        oid = ObjectID(p["id"])
        wait = p.get("wait", False)
        timeout = p.get("timeout", 0.0)

        def _check() -> dict | None:
            entry = self.memory_store.get_if_exists(oid)
            if entry is None:
                return None
            if entry.in_plasma:
                return {"in_plasma": True, "locations": [l if isinstance(l, str) else l.hex() for l in self.refcounter.get_locations(oid)] or ([entry.node_id.decode()] if entry.node_id else [])}
            return {"inline": True, "metadata": entry.metadata, "blob": entry.blob}

        status = _check()
        if status is not None or not wait:
            return status or {"error": "unknown object"}
        # Event-driven long-poll: park an asyncio future on the store rather
        # than burning an executor thread per waiting borrower.
        import asyncio

        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()

        def _on_ready(_oid):
            loop.call_soon_threadsafe(lambda: fut.done() or fut.set_result(True))

        if self.memory_store.add_callback(oid, _on_ready):
            try:
                await asyncio.wait_for(fut, timeout)
            except asyncio.TimeoutError:
                pass
            finally:
                self.memory_store.remove_callback(oid, _on_ready)
        return _check() or {"error": "timeout"}

    async def handle_AddObjectLocation(self, p: dict) -> dict:
        """A raylet that completed a transfer reports its new copy; later
        pullers then fan out across receivers instead of all draining the
        primary (the owner IS the object directory —
        ownership_based_object_directory.h)."""
        node_id = p["node_id"]
        self.refcounter.add_location(
            ObjectID(p["id"]),
            node_id if isinstance(node_id, str) else node_id.hex())
        return {}

    async def handle_RemoveObjectLocation(self, p: dict) -> dict:
        """A puller found a listed copy missing (evicted/dead holder):
        drop the stale directory entry (locations are added as hex
        strings by AddObjectLocation and as bytes by the return path —
        discard both forms)."""
        oid = ObjectID(p["id"])
        node_id = p["node_id"]
        hexed = node_id if isinstance(node_id, str) else node_id.hex()
        self.refcounter.remove_location(oid, hexed)
        self.refcounter.remove_location(oid, bytes.fromhex(hexed))
        return {}

    async def handle_GetObjectLocations(self, p: dict) -> dict:
        oid = ObjectID(p["id"])
        locations = [l if isinstance(l, str) else l.hex() for l in self.refcounter.get_locations(oid)]
        entry = self.memory_store.get_if_exists(oid)
        primary = ""
        if entry is not None and entry.in_plasma and entry.node_id:
            primary = entry.node_id.decode()
            if primary not in locations:
                locations.append(primary)  # the primary copy always counts
        return {"locations": locations, "primary": primary}

    async def handle_Ping(self, p: dict) -> dict:
        return {"worker_id": self.worker_id}

    # --------------------------------------------------- borrowing protocol
    async def handle_AddBorrower(self, p: dict) -> dict:
        oid = ObjectID(p["id"])
        self.refcounter.add_borrower(oid)
        # The borrower has registered: release one temporary return-hold.
        with self._borrow_holds_lock:
            holds = self._borrow_holds.get(oid.binary())
            had_hold = bool(holds)
            if holds:
                holds.pop()
                if not holds:
                    self._borrow_holds.pop(oid.binary(), None)
        if had_hold:
            self.refcounter.remove_borrower(oid)
        return {}

    async def handle_RemoveBorrower(self, p: dict) -> dict:
        self.refcounter.remove_borrower(ObjectID(p["id"]))
        return {}

    # ------------------------------------------------- streaming generators
    def release_stream(self, task_id: bytes) -> None:
        """Consumer is done with (or abandoned) a stream: drop the owner-side
        state and the stored-but-never-consumed items. The producer learns
        via its next report (``cancel``) and stops generating."""
        stream = self._streams.pop(task_id, None)
        if stream is None:
            return
        with stream.cond:
            consumed, num_items = stream.consumed, stream.num_items
        if not stream.finished:
            stream.fail(RayTpuError("streaming generator abandoned by consumer"))
        tid = TaskID(task_id)
        for i in range(consumed, num_items):
            # Unconsumed items never got a consumer-side ObjectRef, so the
            # refcounter will not free them — drop the store entries AND the
            # owned-object refcounter bookkeeping here (plasma copies fall
            # to LRU eviction).
            rid = ObjectID.for_task_return(tid, i + 1)
            self.memory_store.delete(rid)
            self.refcounter.drop(rid)

    async def handle_ReportGeneratorItem(self, p: dict) -> dict:
        """Executor reports one yielded item (or stream end/error) for a
        streaming task this worker owns (reference
        ``HandleReportGeneratorItemReturns``, task_manager.h:212)."""
        task_id = p["task_id"]
        stream = self._streams.get(task_id)
        if stream is None:
            # Unknown stream: the consumer abandoned it (or this owner
            # restarted) — tell the producer to stop generating.
            return {"consumed": p.get("index", 0) + 1, "cancel": True}
        if p.get("done"):
            if "error" in p:
                err = serialization.deserialize(p["error"]["meta"], p["error"]["blob"])
                if isinstance(err, RayTaskError):
                    err = err.as_instanceof_cause()
                stream.fail(err)
            else:
                stream.finish(p.get("total", 0))
            return {"consumed": stream.consumed}
        index = p["index"]
        rid = ObjectID.for_task_return(TaskID(task_id), index + 1)
        self.refcounter.add_owned_object(rid)
        self._store_return_item(rid, p["item"])
        stream.report_item(index)
        if self._streams.get(task_id) is not stream:
            # Raced with release_stream(): the consumer abandoned the stream
            # after we fetched it but before we stored this item, so the
            # release's drop loop (bounded by its num_items snapshot) missed
            # it. Clean up here — delete/drop are idempotent — and cancel.
            self.memory_store.delete(rid)
            self.refcounter.drop(rid)
            return {"consumed": index + 1, "cancel": True}
        return {"consumed": stream.consumed}

    async def handle_WaitGeneratorConsumed(self, p: dict) -> dict:
        """Executor-side backpressure long-poll: resolve once the consumer
        has taken ``until`` items, the stream ends, or a timeout passes.
        Parks an asyncio future on the stream — no thread per waiter."""
        import asyncio

        stream = self._streams.get(p["task_id"])
        if stream is None:
            return {"consumed": p.get("until", 0), "cancel": True}
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        if stream.add_async_waiter(p["until"], loop, fut):
            try:
                await asyncio.wait_for(fut, min(p.get("timeout", 10.0), 60.0))
            except asyncio.TimeoutError:
                pass
        with stream.cond:
            return {"consumed": stream.consumed, "cancel": stream.error is not None}

    # -------------------------------------------------- memory observability
    def memory_summary(self, limit: int | None = None) -> dict:
        """This process's reference table, `ray memory`-style: every live
        entry with size, classified ref type, creation callsite, and age,
        plus actor handles and local CUDA memory stats (observability/memory)."""
        from ..observability.memory import ACTOR_HANDLE, hbm_stats, process_rss_bytes

        cfg = get_config()
        entries, num_refs, total_bytes = self.refcounter.summary(
            limit if limit is not None else cfg.memory_summary_max_entries)
        with self._counter_lock:
            handles = {aid: n for aid, n in self._actor_handle_counts.items() if n > 0}
        for aid, count in handles.items():
            entries.append({
                "object_id": aid.hex(), "size": 0, "ref_type": ACTOR_HANDLE,
                "callsite": "", "age_s": 0.0, "local": count,
                "submitted": 0, "borrowers": 0, "contained_in": 0,
                "owned": aid in self._owned_actors,
            })
        return {
            "worker_id": self.worker_id,
            "node_id": self.node_id,
            "mode": self.mode,
            "pid": os.getpid(),
            "ts": time.time(),
            "num_refs": num_refs,
            "actor_handles": len(handles),
            "total_bytes": total_bytes,
            "rss_bytes": process_rss_bytes(),
            "hbm": hbm_stats(),
            "entries": entries,
        }

    async def handle_MemorySummary(self, p: dict) -> dict:
        """Live (un-buffered) summary for direct fan-out queries."""
        return {"summary": self.memory_summary(p.get("limit"))}

    async def handle_CaptureProfile(self, p: dict) -> dict:
        """On-demand ``torch.profiler`` trace capture (reference: `ray timeline`
        + the dashboard profiler button): profiles a sleep in an executor
        thread (host ops, and the card's kernels where this process has
        initialized CUDA) and returns the artifact directory (a Chrome
        trace, ``trace.json``, loadable in Perfetto)."""
        import asyncio
        import tempfile

        cfg = get_config()
        duration = min(float(p.get("duration", 2.0)), cfg.profile_max_duration_s)
        outdir = p.get("output_dir") or tempfile.gettempdir()
        path = os.path.join(
            outdir, f"raytpu_profile_{self.worker_id[:8]}_{int(time.time())}")
        with self._exec_lock:
            if getattr(self, "_profiling", False):
                return {"error": "a profile capture is already in progress"}
            self._profiling = True

        def _capture() -> None:
            import torch
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(path, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_initialized():
                activities.append(ProfilerActivity.CUDA)
            with profile(activities=activities) as prof:
                time.sleep(duration)
            prof.export_chrome_trace(os.path.join(path, "trace.json"))

        try:
            await asyncio.get_running_loop().run_in_executor(None, _capture)
        except Exception as e:
            return {"error": f"{type(e).__name__}: {e}"}
        finally:
            with self._exec_lock:
                self._profiling = False
        return {"path": path, "worker_id": self.worker_id,
                "node_id": self.node_id, "duration": duration}

    async def _task_event_flusher(self) -> None:
        import asyncio

        interval = get_config().task_events_flush_interval_ms / 1000.0
        last_memory_report = 0.0
        while True:
            await asyncio.sleep(interval)
            # Piggyback the periodic memory summary on the flush cadence
            # (re-reads the config so tests can retune it live).
            mem_interval = get_config().memory_report_interval_ms / 1000.0
            now = time.monotonic()
            if mem_interval > 0 and now - last_memory_report >= mem_interval:
                last_memory_report = now
                try:
                    self.task_events.record_memory(self.memory_summary())
                except Exception:
                    pass
            events, dropped = self.task_events.drain()
            if not events and not dropped:
                continue
            try:
                await self.gcs.call(
                    "AddTaskEvents", {"events": events, "dropped": dropped}, timeout=10.0
                )
            except Exception:
                pass

    async def _global_gc_poller(self) -> None:
        """Run ``gc.collect()`` when the GCS broadcasts a global GC —
        scheduling is starved by resources that garbage may be pinning
        (reference ``ray._private.internal_api.global_gc`` / core_worker
        TriggerGlobalGC). Typical culprit: actor handles captured in
        exception→traceback→frame reference cycles."""
        import asyncio
        import gc

        cursor = None
        while True:
            try:
                reply = await self.gcs.call(
                    "PollGlobalGc", {"cursor": cursor, "timeout": 30.0}, timeout=40.0
                )
            except Exception:
                await asyncio.sleep(1.0)
                continue
            cursor = reply.get("cursor", cursor)
            if reply.get("triggered"):
                # NEVER collect on the io loop thread: finalizers (e.g.
                # CompiledDAG.__del__ → teardown) may run_sync back onto
                # this very loop — a guaranteed self-deadlock.
                await asyncio.get_running_loop().run_in_executor(None, gc.collect)

    async def _borrow_hold_sweeper(self) -> None:
        """Failsafe: drop return-holds whose caller never registered (it
        died before processing the reply)."""
        import asyncio

        while True:
            await asyncio.sleep(get_config().borrow_sweep_interval_s)
            now = time.monotonic()
            expired: list[bytes] = []
            with self._borrow_holds_lock:
                for key, holds in list(self._borrow_holds.items()):
                    while holds and holds[0] <= now:
                        holds.pop(0)
                        expired.append(key)
                    if not holds:
                        self._borrow_holds.pop(key, None)
            for key in expired:
                self.refcounter.remove_borrower(ObjectID(key))

    # ------------------------------------------------------------ executor
    async def handle_CancelTask(self, p: dict) -> dict:
        """Owner asks this EXECUTOR to cancel a running task. Non-force:
        raise TaskCancelledError asynchronously in the executing thread
        (CPython PyThreadState_SetAsyncExc — lands at the next bytecode).
        Force: the whole worker process exits; the owner's push RPC fails,
        and the cancelled marker turns that death into TaskCancelledError
        instead of a retry."""
        import ctypes

        task_id = p["task_id"]
        if p.get("force"):
            import asyncio

            import os as _os
            import signal as _signal

            # give the reply a moment to flush, then die hard
            asyncio.get_running_loop().call_later(
                0.05, lambda: _os.kill(_os.getpid(), _signal.SIGKILL))
            return {"found": True, "killing": True}
        with self._exec_lock:
            ident = self._exec_threads.get(task_id)
            if ident is None:
                # dispatched but not yet executing: mark so _execute_task
                # refuses to run the body when it gets the thread. Bound
                # the set: markers for tasks that never execute here
                # (e.g. re-routed after a lease change) are evicted
                # oldest-first past the cap instead of leaking.
                self._cancelled_inbound[task_id] = None
                while len(self._cancelled_inbound) > 4096:
                    self._cancelled_inbound.pop(
                        next(iter(self._cancelled_inbound)))
                return {"found": False, "pending": True}
            # under the lock the thread cannot pop its entry, so the
            # async exception targets the right task
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(ident), ctypes.py_object(TaskCancelledError))
        return {"found": True}

    async def handle_LeaseProbe(self, p: dict) -> dict:
        """Raylet probe before an orphan-lease reclaim: is this worker
        actually serving its lease (executing, hosting an actor, or still
        receiving pushes)?"""
        with self._exec_lock:
            executing = bool(self._exec_threads)
        return {
            "executing": executing or self.actor_instance is not None,
            "pushes_total": self._pushes_total,
        }

    async def handle_PushTask(self, p: dict) -> dict:
        import asyncio

        self._pushes_total += 1
        spec = TaskSpec.from_wire(p["spec"])
        logger.debug("PushTask recv: %s kind=%s seq=%s", spec.name, spec.kind, spec.seq_no)
        loop = asyncio.get_running_loop()
        if spec.kind == TASK_KIND_ACTOR_TASK:
            return await self._execute_actor_task(spec, loop)
        return await loop.run_in_executor(None, self._execute_task, spec)

    async def handle_PushActorTasks(self, p: dict) -> dict:
        """Batched PushTask for ACTOR tasks: K in-order calls from one
        caller to this (serialized) actor in one RPC. Each spec still
        passes through the per-caller sequencing buffer and the actor
        semaphore — execution semantics are identical to K single pushes
        on the same ordered connection; only the wire round trips and
        process wakeups collapse."""
        import asyncio

        self._pushes_total += 1
        specs = [TaskSpec.from_wire(w) for w in p["specs"]]
        loop = asyncio.get_running_loop()
        return {"replies": [await self._execute_actor_task(spec, loop)
                            for spec in specs]}

    async def handle_PushTasks(self, p: dict) -> dict:
        """Batched PushTask for normal tasks: K specs in one RPC, executed
        sequentially in ONE executor-thread hop, K replies in one response.
        The per-task cost of the batch-submit path is otherwise dominated
        by per-hop RPC + thread-handoff overhead, not execution."""
        import asyncio

        self._pushes_total += 1
        specs = [TaskSpec.from_wire(w) for w in p["specs"]]
        loop = asyncio.get_running_loop()

        def run_all():
            return [self._execute_task(s) for s in specs]

        return {"replies": await loop.run_in_executor(None, run_all)}

    async def _execute_actor_task(self, spec: TaskSpec, loop) -> dict:
        # Per-caller submission-order delivery with an out-of-order arrival
        # buffer (transport/actor_scheduling_queue.cc). Tasks are RELEASED
        # to the executor in sequence order, but the next seq is unblocked
        # as soon as this one starts — the actor's max_concurrency
        # semaphore (not the ordering buffer) bounds concurrent execution,
        # so max_concurrency=1 still serializes while concurrent actors
        # overlap (reference: threaded/async scheduling queues).
        caller = spec.owner_address
        while spec.seq_no > self._actor_next_seq.get(caller, 0):
            fut = loop.create_future()
            self._actor_ooo_buffer[(caller, spec.seq_no)] = fut
            await fut
        if self._actor_max_concurrency <= 1 and not self._actor_group_sems:
            # Serialized actor: strict execution order — complete before
            # releasing the next sequence number. (An actor WITH
            # concurrency groups is inherently concurrent: grouped calls
            # must not serialize behind the default pool.)
            result = await loop.run_in_executor(None, self._execute_task, spec)
            self._release_next_actor_seq(caller, spec.seq_no)
            return result
        # Concurrent actor: release the next seq as soon as this task is
        # handed to the executor; the max_concurrency semaphore bounds
        # parallelism.
        exec_fut = loop.run_in_executor(None, self._execute_task, spec)
        self._release_next_actor_seq(caller, spec.seq_no)
        return await exec_fut

    def _release_next_actor_seq(self, caller: str, seq_no: int) -> None:
        self._actor_next_seq[caller] = max(self._actor_next_seq.get(caller, 0), seq_no + 1)
        nxt = self._actor_ooo_buffer.pop((caller, self._actor_next_seq[caller]), None)
        if nxt is not None and not nxt.done():
            nxt.set_result(True)

    def _execute_task(self, spec: TaskSpec) -> dict:
        """ExecuteTask (core_worker.cc:3229) + Cython execute_task
        (_raylet.pyx:1726) equivalent."""
        prev_task_id = self.current_task_id
        self.current_task_id = TaskID(spec.task_id)
        self.task_events.record(spec.task_id, spec.name, "RUNNING", kind=spec.kind)
        with self._exec_lock:
            if spec.task_id in self._cancelled_inbound:
                # cancel arrived before execution (batched push / pool
                # backlog): never run the body
                self._cancelled_inbound.pop(spec.task_id, None)
                self.current_task_id = prev_task_id
                metadata, blob, _ = serialization.serialize_error(
                    RayTaskError(spec.name, "task cancelled",
                                 TaskCancelledError(spec.task_id.hex()[:12])))
                if spec.num_returns == -1:
                    # Streaming task: reply in stream form so the owner
                    # raises TaskCancelledError at the consumer instead
                    # of finishing a clean empty stream.
                    return {"returns": [], "streamed": 0,
                            "stream_error": {"meta": metadata, "blob": blob}}
                return {"returns": [
                    {"t": "v", "meta": metadata, "blob": blob, "contained": []}
                    for _ in range(max(spec.num_returns, 1))]}
            self._exec_threads[spec.task_id] = threading.get_ident()
        # Install the spec's trace context for the duration of execution:
        # spans recorded by user code (and nested submits, engine requests,
        # serve batches) chain under this task's execute span.
        from ..observability import tracing

        _exec_ctx = _trace_prev = None
        _exec_start = time.time()
        if spec.trace_id:
            _exec_ctx = tracing.TraceContext(
                spec.trace_id, tracing.new_span_id(), spec.span_id)
            _trace_prev = tracing.set_current(_exec_ctx)
        try:
            args, kwargs = self._deserialize_args(spec)
            if spec.kind == TASK_KIND_ACTOR_CREATION:
                cls, _tag = self.functions.get(spec.function_id)
                self.actor_instance = cls(*args, **kwargs)
                self.actor_id = spec.actor_id
                self._actor_next_seq = {}
                # Actor-wide concurrency limit: sequencing is per-caller, but
                # calls from DIFFERENT callers must still respect
                # max_concurrency (default 1 = serialized actor).
                self._actor_max_concurrency = max(1, spec.max_concurrency)
                self._actor_sem = threading.Semaphore(self._actor_max_concurrency)
                # Named per-method pools (reference
                # concurrency_group_manager.cc): each group gets its own
                # semaphore; grouped calls never contend with the default
                # pool or with other groups.
                self._actor_group_sems = {
                    g: threading.Semaphore(max(1, int(n)))
                    for g, n in (spec.concurrency_groups or {}).items()}
                # Terminal status for the creation task: without this every
                # successful actor creation stays RUNNING in list_tasks()
                # forever (and trips any "all tasks settled" invariant).
                self.task_events.record(spec.task_id, spec.name, "FINISHED",
                                        kind=spec.kind)
                return {"returns": []}
            if spec.kind == TASK_KIND_ACTOR_TASK:
                if self.actor_instance is None:
                    return {"error": "actor instance not initialized"}
                if spec.actor_method == "__ray_call__":
                    # Internal escape hatch (reference: actor __ray_call__):
                    # run a shipped function with the instance as first arg.
                    # Compiled DAGs use it to install their executor loop.
                    fn, args = args[0], args[1:]
                    method = functools.partial(fn, self.actor_instance)
                else:
                    method = getattr(self.actor_instance, spec.actor_method)
                group = spec.concurrency_group
                if not group:
                    # per-method default declared with @method(
                    # concurrency_group=...) — resolved here, executor
                    # side, where the class definition lives
                    fn = getattr(method, "__func__", method)
                    group = getattr(fn, "__ray_concurrency_group__", "")
                sem = self._actor_group_sems.get(group) or self._actor_sem
                if sem is not None:
                    with sem:
                        # run-to-completion INSIDE the semaphore: an async
                        # method returns its coroutine instantly, so the
                        # asyncio.run must also be covered or
                        # max_concurrency=1 would not serialize async actors
                        result = _run_to_completion(method(*args, **kwargs))
                else:
                    result = _run_to_completion(method(*args, **kwargs))
            else:
                try:
                    fn, _tag = self.functions.get(spec.function_id)
                except FunctionMissingError:
                    # GCS lost the export (crash inside the snapshot
                    # window): ask the owner to re-export + resubmit.
                    return {"function_missing": True}
                result = _run_to_completion(fn(*args, **kwargs))
            if spec.num_returns == -1:
                # Streaming generator: iterate + report items; the reply
                # carries only the final count (events recorded inside).
                return self._stream_generator_results(spec, result)
            reply = {"returns": self._serialize_returns(spec, result)}
            self.task_events.record(spec.task_id, spec.name, "FINISHED", kind=spec.kind)
            return reply
        except Exception as e:
            tb = traceback.format_exc()
            self.task_events.record(spec.task_id, spec.name, "FAILED", kind=spec.kind,
                                    extra={"error": f"{type(e).__name__}: {e}"})
            self._publish_task_error(spec, e, tb)
            if spec.kind == TASK_KIND_ACTOR_CREATION:
                return {"error": f"{type(e).__name__}: {e}\n{tb}"}
            metadata, blob, _ = serialization.serialize_error(RayTaskError(spec.name, tb, e))
            if spec.num_returns == -1:
                # Failure before the generator started (bad args, arity,
                # missing function): surface it on the stream — the normal
                # per-index error path never ran.
                try:
                    self.io.run_sync(self._owner_client(spec.owner_address).call(
                        "ReportGeneratorItem",
                        {"task_id": spec.task_id, "done": True, "total": 0,
                         "error": {"meta": metadata, "blob": blob}},
                        timeout=30.0,
                    ))
                except Exception:
                    pass
                return {"returns": [], "streamed": 0,
                        "stream_error": {"meta": metadata, "blob": blob}}
            return {"returns": [{"t": "v", "meta": metadata, "blob": blob} for _ in range(spec.num_returns)]}
        finally:
            if _exec_ctx is not None:
                tracing.record_span(tracing.make_span(
                    f"execute {spec.name}", "task", _exec_start, time.time(),
                    spec.trace_id, spec.span_id, _exec_ctx.span_id,
                    attrs={"task_id": spec.task_id.hex(),
                           "worker_id": self.worker_id}))
                tracing.set_current(_trace_prev)
            with self._exec_lock:
                self._exec_threads.pop(spec.task_id, None)
            self.current_task_id = prev_task_id

    def _publish_task_error(self, spec: TaskSpec, error: Exception, tb: str) -> None:
        """Executor-side publish_error_to_driver: a raising task's full
        traceback reaches the GCS error-info channel (→ the driver's log
        and ``state.list_errors()``), not just the serialized return value.
        Fire-and-forget — diagnostics never blocks or fails execution."""
        if isinstance(error, TaskCancelledError):
            return  # a requested cancel is not an error condition
        try:
            from ..diagnostics.errors import make_event

            etype = ("actor_creation_failure"
                     if spec.kind == TASK_KIND_ACTOR_CREATION else "task_failure")
            actor_id = spec.actor_id or b""
            event = make_event(
                etype,
                f"{spec.name}: {type(error).__name__}: {error}",
                source="worker",
                traceback=tb,
                node_id=self.node_id,
                worker_id=self.worker_id,
                actor_id=actor_id.hex() if isinstance(actor_id, bytes) else actor_id,
                job_id=str(self.job_id.int_value()),
            )
            self.io.run_coro(self.gcs.call("PublishError", {"event": event}, 10.0))
        except Exception:
            pass

    def _deserialize_args(self, spec: TaskSpec) -> tuple[tuple, dict]:
        args: list = []
        kwargs: dict = {}
        ref_args: list[tuple[int | str, ObjectRef]] = []
        for entry in spec.args:
            if entry["t"] == "v":
                value = serialization.deserialize(entry["meta"], entry["blob"])
            else:
                ref = ObjectRef(ObjectID(entry["id"]), entry["owner"], _add_local_ref=False)
                value = self._get_one(ref, deadline=None, pull_class="task_arg")
            if "key" in entry:
                kwargs[entry["key"]] = value
            else:
                args.append(value)
        return tuple(args), kwargs

    def _serialize_returns(self, spec: TaskSpec, result: Any) -> list:
        cfg = get_config()
        if spec.num_returns == 1:
            results = [result]
        else:
            results = list(result)
            if len(results) != spec.num_returns:
                raise ValueError(f"Task {spec.name} returned {len(results)} values, expected {spec.num_returns}")
        task_id = TaskID(spec.task_id)
        return [self._serialize_return_value(task_id, i, v) for i, v in enumerate(results)]

    def _serialize_return_value(self, task_id: TaskID, index: int, value: Any) -> dict:
        """Serialize one task return: inline entry for small values, shm
        store + plasma marker for large ones."""
        cfg = get_config()
        s = serialization.serialize_value(value)
        metadata = s.metadata
        wire_contained = self._hold_returned_refs(s.contained)
        if s.nbytes <= cfg.max_inline_object_size:
            entry = {"t": "v", "meta": metadata, "blob": s.to_blob()}
        else:
            rid = ObjectID.for_task_return(task_id, index + 1)
            self._plasma_put(rid, metadata, s)
            entry = {"t": "p", "node_id": self.node_id, "size": s.nbytes}
        if wire_contained:
            entry["contained"] = wire_contained
        return entry

    def _stream_generator_results(self, spec: TaskSpec, gen: Any) -> dict:
        """Execute a streaming task's generator, reporting every yielded
        item to the owner as it is produced (reference: streaming-generator
        executor protocol, _raylet.pyx execute_streaming_generator).

        Runs in the executor thread AFTER the task function returned its
        generator. Item object IDs are deterministic task-return IDs, so a
        retried execution re-reports idempotently."""
        task_id = TaskID(spec.task_id)
        client = self._owner_client(spec.owner_address)
        count = 0
        consumed = 0
        bp = spec.generator_backpressure
        cancelled = False
        try:
            it = _iter_generator(gen)
            for value in it:
                entry = self._serialize_return_value(task_id, count, value)
                reply = self.io.run_sync(client.call(
                    "ReportGeneratorItem",
                    {"task_id": spec.task_id, "index": count, "item": entry},
                    timeout=get_config().generator_report_timeout_s,
                ))
                consumed = reply.get("consumed", consumed)
                count += 1
                if reply.get("cancel"):
                    # Consumer abandoned the stream: stop producing.
                    cancelled = True
                    it.close()
                    break
                # Backpressure: pause once `bp` reported items sit unconsumed
                # (reference _generator_backpressure_num_objects).
                while bp > 0 and count - consumed >= bp:
                    r2 = self.io.run_sync(client.call(
                        "WaitGeneratorConsumed",
                        {"task_id": spec.task_id, "until": count - bp + 1,
                         "timeout": get_config().generator_wait_consumed_poll_s},
                        timeout=get_config().generator_wait_consumed_poll_s + 30.0,
                    ))
                    consumed = r2.get("consumed", consumed)
                    if r2.get("cancel"):
                        cancelled = True
                        it.close()
                        break
                if cancelled:
                    break
        except Exception as e:
            tb = traceback.format_exc()
            self.task_events.record(spec.task_id, spec.name, "FAILED", kind=spec.kind,
                                    extra={"error": f"{type(e).__name__}: {e}"})
            metadata, blob, _ = serialization.serialize_error(RayTaskError(spec.name, tb, e))
            try:
                self.io.run_sync(client.call(
                    "ReportGeneratorItem",
                    {"task_id": spec.task_id, "done": True, "total": count,
                     "error": {"meta": metadata, "blob": blob}},
                    timeout=30.0,
                ))
            except Exception:
                pass  # owner gone: nothing to report to
            return {"returns": [], "streamed": count,
                    "stream_error": {"meta": metadata, "blob": blob}}
        if not cancelled:
            try:
                self.io.run_sync(client.call(
                    "ReportGeneratorItem",
                    {"task_id": spec.task_id, "done": True, "total": count},
                    timeout=30.0,
                ))
            except Exception:
                pass
        self.task_events.record(spec.task_id, spec.name, "FINISHED", kind=spec.kind)
        return {"returns": [], "streamed": count}

    def _hold_returned_refs(self, contained: list) -> list[dict]:
        """A return value embeds ObjectRefs: take a temporary borrower hold
        on each ref we own so it survives until the caller registers as a
        borrower (released in handle_AddBorrower, or by the expiry sweep if
        the caller died). Returns the wire descriptors."""
        wire = []
        now = time.monotonic()
        for r in contained:
            oid = r.id()
            owner = r.owner_address or self.address
            if self.refcounter.is_owned(oid):
                owner = self.address
                self.refcounter.add_borrower(oid)
                with self._borrow_holds_lock:
                    self._borrow_holds.setdefault(oid.binary(), []).append(
                        now + get_config().borrow_hold_ttl_s)
            wire.append({"id": oid.binary(), "owner": owner})
        return wire

    async def handle_Exit(self, p: dict) -> dict:
        import asyncio

        asyncio.get_running_loop().call_later(0.05, os._exit, 0)
        return {}


def asyncio_sleep(t: float):
    import asyncio

    return asyncio.sleep(t)


def _pop_push_batch(queue: list, cur_batch: int, pipeline_cap: int) -> list:
    """Pop the next push batch off a lease pipeline's queue. Load-bearing
    invariants (unit-tested in test_core_throughput.py):

    * Batched pushes defer every reply to the end of the batch, so a spec
      with an ObjectRef arg must ship ALONE: its dependency may be an
      earlier task of the same batch, whose result only reaches the owner
      with the reply — batching them would deadlock the chain.
    * A SHORT queue (no more specs than pipelines allowed) is parallel
      opportunity, not batching material: other lease pipelines can run
      those specs on other workers concurrently — only batch genuine
      backlog.
    """
    limit = cur_batch if len(queue) > pipeline_cap else 1
    specs: list = []
    while queue and len(specs) < limit:
        has_ref = any(e.get("t") == "r" for e in queue[0].args)
        if has_ref and specs:
            break
        specs.append(queue.pop(0))
        if has_ref:
            break
    return specs


def _next_push_batch(cur_batch: int, per_task_s: float, cap: int) -> int:
    """Adaptive push-batch ramp: grow (×4 up to ``cap``) only while the
    observed per-task time stays well under the RPC-overhead scale; ANY
    slow batch resets to 1 — a batch serializes execution on one worker,
    so batching slow tasks wastes every other leased worker."""
    if per_task_s < 0.005:
        return min(cap, cur_batch * 4)
    return 1


def _iter_generator(gen):
    """Drive a sync or async generator from the executor thread, yielding
    items synchronously (async generators get a private event loop)."""
    if hasattr(gen, "__anext__"):
        import asyncio

        loop = asyncio.new_event_loop()
        try:
            while True:
                try:
                    yield loop.run_until_complete(gen.__anext__())
                except StopAsyncIteration:
                    break
        finally:
            loop.close()
    elif hasattr(gen, "__next__") or hasattr(gen, "__iter__"):
        yield from gen
    else:
        raise TypeError(
            f"Task declared num_returns='streaming' must return a generator, got {type(gen).__name__}"
        )


def _run_to_completion(result):
    """async actor/task functions run on their own loop in this executor
    thread (reference: fiber scheduling queues, transport/fiber.h)."""
    if inspect.iscoroutine(result):
        import asyncio

        return asyncio.run(result)
    return result


# ---------------------------------------------------------------- global API
_global_worker: CoreWorker | None = None
_global_lock = threading.Lock()


def global_worker() -> CoreWorker:
    if _global_worker is None:
        raise RayTpuError("ray_tpu.init() has not been called")
    return _global_worker


def set_global_worker(worker: CoreWorker | None) -> None:
    global _global_worker
    _global_worker = worker
