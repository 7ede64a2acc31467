"""Ray Client: remote drivers over ``ray://host:port``.

Equivalent of the reference's client mode
(``python/ray/util/client/__init__.py:200``): a thin proxy server runs
next to the cluster; remote Python processes connect with
``ray_tpu_torch.init(address="ray://host:port")`` and use the NORMAL
API — ``@remote``, ``put/get/wait``, actors — while every operation
executes in the proxy's driver on the cluster. The client worker
duck-types the ``CoreWorker`` surface the public API calls, so no
separate client API exists (the reference generates the same illusion
with a gRPC proxy).

The port of ``ray_tpu/util/client.py``. Its ``ClientServer`` listens on
loopback unless the caller names an interface, as the port's other
servers do.
"""

from __future__ import annotations

import threading
import uuid
from typing import Any

from .._vendor import cloudpickle
from ..core.ids import JobID, ObjectID, TaskID
from ..core.object_ref import ObjectRef, install_refcount_hooks
from ..core.rpc import EventLoopThread, RetryableRpcClient, RpcServer
from ..core.status import RayTpuError

CLIENT_PREFIX = "ray://"


class ClientServer:
    """Cluster-side proxy: executes client requests as this process's
    driver (it must run in a connected driver process — e.g. the head
    bootstrap or any ``ray_tpu_torch.init()``'d process). ``host``
    defaults to loopback: pass ``"0.0.0.0"`` to serve other hosts."""

    def __init__(self, host: str = "127.0.0.1", port: int = 10001):
        from ..core.config import get_config
        from ..core.worker import global_worker

        self._worker = global_worker()
        self._io = EventLoopThread("raytpu-torch-client-server")
        self._server = RpcServer(host, port)
        self._server.register_service(self)
        # Per-client object registries: client ref id -> real ObjectRef
        # (dropping a client drops its refs).
        self._refs: dict[str, dict[str, ObjectRef]] = {}
        # Actors each client session OWNS (non-detached, unnamed): killed
        # on disconnect, like handle-GC in a local driver.
        self._client_actors: dict[str, list[bytes]] = {}
        # Session metadata: last_seen (heartbeat reaping), the client's
        # GCS job id (per-client job isolation for observability), and
        # open streaming generators.
        self._sessions: dict[str, dict] = {}
        self._lock = threading.Lock()
        self._timeout = get_config().client_session_timeout_s
        self._stopping = False
        self._io.run_sync(self._server.start())
        self.address = self._server.address
        self._reaper = threading.Thread(
            target=self._reap_loop, name="raytpu-torch-client-reaper", daemon=True)
        self._reaper.start()

    def stop(self) -> None:
        self._stopping = True
        try:
            self._io.run_sync(self._server.stop())
        except Exception:
            pass
        self._io.stop()

    def _reap_loop(self) -> None:
        """Crash cleanup: a client that vanishes without disconnecting
        (killed process, severed network) stops pinging; its session-owned
        actors/refs/streams are reclaimed after the timeout — the
        reference's client reconnect-grace expiry."""
        import time as _time

        while not self._stopping:
            _time.sleep(min(5.0, self._timeout / 3))
            now = _time.monotonic()
            with self._lock:
                dead = [cid for cid, s in self._sessions.items()
                        if now - s["last_seen"] > self._timeout]
            for cid in dead:
                self._cleanup_session(cid, reason="session timeout")

    def _cleanup_session(self, client_id: str, *, reason: str) -> None:
        import logging

        with self._lock:
            self._refs.pop(client_id, None)
            actors = self._client_actors.pop(client_id, [])
            session = self._sessions.pop(client_id, None)
        if session is not None:
            logging.getLogger(__name__).info(
                "client session %s cleaned up (%s): %d actors, %d streams",
                client_id[:12], reason, len(actors),
                len(session.get("streams", {})))
        for state in (session or {}).get("streams", {}).values():
            try:
                state["gen"].close()
            except Exception:
                pass
        for actor_id in actors:
            # Session-owned actors die with the session (the handle-GC
            # semantics a local driver would have given them).
            try:
                self._worker.kill_actor(actor_id)
            except Exception:
                pass
        if session and session.get("job_id") is not None:
            try:
                self._worker._gcs_call("FinishJob", {"job_id": session["job_id"]})
            except Exception:
                pass

    # ------------------------------------------------------------- helpers
    def _client(self, p: dict) -> dict:
        """Touch the session and return its ref registry. Unknown (never
        seen or already-reaped) sessions are REJECTED rather than
        resurrected: a client partitioned past the timeout must fail fast
        with 'session expired', not keep running against destroyed state."""
        import time as _time

        with self._lock:
            session = self._sessions.get(p["client_id"])
            if session is None:
                raise RayTpuError(
                    "client session expired or unknown — reconnect with "
                    "ray_tpu_torch.init(address='ray://...')")
            session["last_seen"] = _time.monotonic()
            return self._refs.setdefault(p["client_id"], {})

    def _resolve(self, p: dict, wire_args: list) -> tuple[tuple, dict]:
        refs = self._client(p)
        args, kwargs = [], {}

        def fix(v):
            if isinstance(v, dict) and v.get("__client_ref__"):
                return refs[v["id"]]
            return v

        for entry in wire_args:
            value = fix(cloudpickle.loads(entry["blob"]))
            if "key" in entry:
                kwargs[entry["key"]] = value
            else:
                args.append(value)
        return tuple(args), kwargs

    def _track(self, p: dict, ref: ObjectRef) -> str:
        rid = uuid.uuid4().hex
        self._client(p)[rid] = ref
        return rid

    # ------------------------------------------------------------ handlers
    async def handle_ClientHello(self, p: dict) -> dict:
        """Session start (the ONLY call that may create a session):
        register a per-client JOB in the GCS (the reference attaches each
        ray:// driver as its own job — job-level observability and
        lifetime isolation), return the ping interval."""
        import time as _time

        from ..core.config import get_config

        reply = self._worker._gcs_call(
            "AddJob", {"driver_address": f"ray-client:{p['client_id'][:12]}"})
        with self._lock:
            self._sessions[p["client_id"]] = {
                "last_seen": _time.monotonic(),
                "job_id": reply.get("job_id"),
                "streams": {},
            }
        return {"job_id": reply.get("job_id"),
                "ping_interval_s": get_config().client_ping_interval_s}

    async def handle_ClientPing(self, p: dict) -> dict:
        self._client(p)  # touches last_seen
        return {}

    def _register_stream(self, p: dict, gen) -> str:
        import asyncio

        sid = uuid.uuid4().hex
        self._client(p)
        with self._lock:
            # next: the index the client may request next; last: cached
            # reply for index next-1 so a RETRIED StreamNext (transport
            # drop after the server consumed the item) replays instead of
            # silently skipping an item. serial: per-stream asyncio lock
            # — a duplicate request racing the still-in-flight original
            # must not pass the cursor check twice and double-consume.
            self._sessions[p["client_id"]]["streams"][sid] = {
                "gen": gen, "next": 0, "last": None,
                "serial": asyncio.Lock()}
        return sid

    async def handle_ClientStreamNext(self, p: dict) -> dict:
        """Idempotent by item index: the client sends the index it wants;
        a duplicate request (RPC retry) replays the cached reply."""
        import asyncio

        self._client(p)
        with self._lock:
            state = self._sessions.get(p["client_id"], {}).get(
                "streams", {}).get(p["stream"])
        if state is None:
            return {"error": cloudpickle.dumps(
                RayTpuError(f"unknown stream {p['stream']!r}"))}
        # Serialize per stream: the cursor/replay check must re-run after
        # any in-flight duplicate finishes, else both pass idx == next
        # and the generator is consumed twice (one item silently lost).
        async with state["serial"]:
            return await self._stream_next_locked(p, state)

    async def _stream_next_locked(self, p: dict, state: dict) -> dict:
        import asyncio

        idx = p.get("index", state["next"])
        if idx == state["next"] - 1 and state["last"] is not None:
            return state["last"]  # retry replay
        if idx != state["next"]:
            return {"error": cloudpickle.dumps(RayTpuError(
                f"stream cursor mismatch: asked {idx}, next {state['next']}"))}

        gen = state["gen"]
        loop = asyncio.get_running_loop()
        # Loop-native wait for availability: no executor thread parks for
        # the whole (possibly unbounded) producer wait — with many idle
        # token streams that would starve every other client RPC.
        fut = loop.create_future()
        if gen._stream.add_item_waiter(gen._cursor, loop, fut):
            try:
                await asyncio.wait_for(fut, p.get("timeout"))
            except asyncio.TimeoutError:
                from ..core.status import GetTimeoutError

                return {"error": cloudpickle.dumps(GetTimeoutError(
                    f"timed out waiting for stream item {idx}"))}

        _END = object()  # StopIteration cannot cross an asyncio Future

        def step():
            try:
                # item (or end) is available: returns without blocking
                return gen._next_sync(30.0)
            except StopIteration:
                return _END

        try:
            ref = await loop.run_in_executor(None, step)
        except Exception as e:
            inner = getattr(e, "_inner", e)
            reply = {"error": cloudpickle.dumps(inner)}
        else:
            reply = {"done": True} if ref is _END else {"ref": self._track(p, ref)}
        with self._lock:
            state["last"] = reply
            state["next"] += 1
        return reply

    async def handle_ClientStreamClose(self, p: dict) -> dict:
        self._client(p)
        with self._lock:
            state = self._sessions.get(p["client_id"], {}).get(
                "streams", {}).pop(p["stream"], None)
        if state is not None:
            state["gen"].close()
        return {}

    async def handle_ClientPut(self, p: dict) -> dict:
        import asyncio

        value = cloudpickle.loads(p["blob"])
        ref = await asyncio.get_running_loop().run_in_executor(
            None, self._worker.put, value)
        return {"ref": self._track(p, ref)}

    async def handle_ClientGet(self, p: dict) -> dict:
        import asyncio

        refs = self._client(p)
        try:
            targets = [refs[r] for r in p["refs"]]
        except KeyError as e:
            return {"error": cloudpickle.dumps(RayTpuError(f"unknown client ref {e}"))}
        loop = asyncio.get_running_loop()
        try:
            values = await loop.run_in_executor(
                None, lambda: self._worker.get(targets, p.get("timeout")))
        except Exception as e:
            # The as_instanceof_cause wrapper class is process-local: ship
            # the inner RayTaskError; the client re-wraps.
            inner = getattr(e, "_inner", e)
            return {"error": cloudpickle.dumps(inner)}
        return {"blob": cloudpickle.dumps(values)}

    async def handle_ClientWait(self, p: dict) -> dict:
        import asyncio

        refs = self._client(p)
        targets = [refs[r] for r in p["refs"]]
        loop = asyncio.get_running_loop()
        ready, not_ready = await loop.run_in_executor(
            None, lambda: self._worker.wait(
                targets, p["num_returns"], p.get("timeout")))
        ready_ids = [p["refs"][targets.index(r)] for r in ready]
        return {"ready": ready_ids,
                "not_ready": [r for r in p["refs"] if r not in ready_ids]}

    async def handle_ClientSubmitTask(self, p: dict) -> dict:
        import asyncio

        fn = cloudpickle.loads(p["fn"])
        args, kwargs = self._resolve(p, p["args"])
        opts = p.get("options") or {}
        loop = asyncio.get_running_loop()
        refs = await loop.run_in_executor(
            None, lambda: self._worker.submit_task(fn, args, kwargs, **opts))
        if not isinstance(refs, list):  # ObjectRefGenerator (streaming)
            return {"stream": self._register_stream(p, refs)}
        return {"refs": [self._track(p, r) for r in refs]}

    async def handle_ClientCreateActor(self, p: dict) -> dict:
        import asyncio

        cls = cloudpickle.loads(p["cls"])
        args, kwargs = self._resolve(p, p["args"])
        opts = p.get("options") or {}
        loop = asyncio.get_running_loop()
        try:
            actor_id = await loop.run_in_executor(
                None, lambda: self._worker.create_actor(cls, args, kwargs, **opts))
        except Exception as e:
            return {"error": cloudpickle.dumps(e)}
        if not opts.get("detached") and not opts.get("name"):
            with self._lock:
                self._client_actors.setdefault(p["client_id"], []).append(actor_id)
        return {"actor_id": actor_id.hex()}

    async def handle_ClientActorCall(self, p: dict) -> dict:
        import asyncio

        args, kwargs = self._resolve(p, p["args"])
        loop = asyncio.get_running_loop()
        refs = await loop.run_in_executor(
            None, lambda: self._worker.submit_actor_task(
                bytes.fromhex(p["actor_id"]), p["method"], args, kwargs,
                num_returns=p.get("num_returns", 1),
                generator_backpressure=p.get("generator_backpressure", 0),
                concurrency_group=p.get("concurrency_group", "")))
        if not isinstance(refs, list):  # ObjectRefGenerator (streaming)
            return {"stream": self._register_stream(p, refs)}
        return {"refs": [self._track(p, r) for r in refs]}

    async def handle_ClientCancel(self, p: dict) -> dict:
        refs = self._client(p)
        ref = refs.get(p["ref"])
        if ref is None:
            return {"error": cloudpickle.dumps(
                RayTpuError(f"unknown client ref {p['ref']!r}"))}
        try:
            self._worker.cancel(ref, force=bool(p.get("force")))
        except Exception as e:
            return {"error": cloudpickle.dumps(e)}
        return {}

    async def handle_ClientKillActor(self, p: dict) -> dict:
        self._worker.kill_actor(bytes.fromhex(p["actor_id"]))
        return {}

    async def handle_ClientGetActorByName(self, p: dict) -> dict:
        found = self._worker.get_actor_by_name(p["name"])
        if found is None:
            return {"found": False}
        return {"found": True, "actor_id": found[0].hex()}

    async def handle_ClientGcsCall(self, p: dict) -> dict:
        # read-only control-plane passthrough (cluster_resources, nodes...)
        if p["method"] not in ("GetAllNodes", "Timeline"):
            return {"error": cloudpickle.dumps(
                RayTpuError(f"GCS method {p['method']!r} not allowed over ray://"))}
        return self._worker._gcs_call(p["method"], p.get("payload") or {})

    async def handle_ClientDisconnect(self, p: dict) -> dict:
        self._cleanup_session(p["client_id"], reason="disconnect")
        return {}


class ClientObjectRefGenerator:
    """Client-side view of a server-held ``ObjectRefGenerator``: iterating
    yields ObjectRefs (fetched one server round trip per item), matching
    the local streaming surface; ``close()`` cancels the producer."""

    def __init__(self, worker: "ClientWorker", stream_id: str):
        self._worker = worker
        self._stream_id = stream_id
        self._index = 0
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self):
        return self._next_sync(timeout=None)

    def _next_sync(self, timeout: float | None):
        if self._closed:
            raise StopIteration
        reply = self._worker._call(
            "ClientStreamNext",
            {"stream": self._stream_id, "index": self._index, "timeout": timeout},
            timeout=None if timeout is None else timeout + 30.0)
        self._index += 1
        if reply.get("done"):
            self._closed = True
            raise StopIteration
        return self._worker._make_ref(reply["ref"])

    def __aiter__(self):
        return self

    async def __anext__(self):
        import asyncio

        _END = object()  # StopIteration cannot cross an asyncio Future

        def step():
            try:
                return self._next_sync(None)
            except StopIteration:
                return _END

        ref = await asyncio.get_running_loop().run_in_executor(None, step)
        if ref is _END:
            raise StopAsyncIteration
        return ref

    def completed(self) -> bool:
        return self._closed

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._worker._call("ClientStreamClose",
                               {"stream": self._stream_id}, timeout=10.0)
        except Exception:
            pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class ClientWorker:
    """Client-side stand-in for ``CoreWorker``: implements the method
    surface the public API uses, forwarding everything to the proxy."""

    def __init__(self, address: str):
        host_port = address[len(CLIENT_PREFIX):]
        self.client_id = uuid.uuid4().hex
        self.io = EventLoopThread("raytpu-torch-client")
        self.rpc = RetryableRpcClient(host_port)
        self.node_id = "client"
        self.worker_id = f"client-{self.client_id[:12]}"
        self.job_id = JobID.from_int(0)
        self.actor_id = b""
        self.mode = "client"
        self._ref_lock = threading.Lock()
        self._local_refs: dict[bytes, str] = {}  # ObjectID binary -> server rid
        self._stop_ping = threading.Event()
        self._ping_thread: threading.Thread | None = None
        install_refcount_hooks(lambda r: None, lambda r: None)

    def _start_ping(self, interval: float) -> None:
        """Heartbeat so the proxy can tell a live-but-idle client from a
        crashed one (session reaping on the server side)."""
        def loop():
            while not self._stop_ping.wait(interval):
                try:
                    self._call("ClientPing", {}, timeout=15.0)
                except Exception:
                    pass  # transient; the retryable RPC client reconnects

        self._ping_thread = threading.Thread(
            target=loop, name="raytpu-torch-client-ping", daemon=True)
        self._ping_thread.start()

    # ------------------------------------------------------------ plumbing
    def _call(self, method: str, payload: dict, timeout: float | None = 300.0) -> dict:
        from ..core.status import RayTaskError

        payload = {**payload, "client_id": self.client_id}
        reply = self.io.run_sync(self.rpc.call(method, payload, timeout))
        if reply.get("error"):
            err = cloudpickle.loads(reply["error"])
            if isinstance(err, RayTaskError):
                raise err.as_instanceof_cause()
            raise err
        return reply

    def _make_ref(self, rid: str) -> ObjectRef:
        # Client-side ObjectRefs carry a synthetic id; the server rid maps
        # back to the real ref.
        oid = ObjectID(bytes.fromhex(rid) + b"\x00" * (28 - len(rid) // 2))
        with self._ref_lock:
            self._local_refs[oid.binary()] = rid
        return ObjectRef(oid, owner_address="", _add_local_ref=False)

    def _rid(self, ref: ObjectRef) -> str:
        with self._ref_lock:
            rid = self._local_refs.get(ref.binary())
        if rid is None:
            raise RayTpuError("ObjectRef does not belong to this client session")
        return rid

    def _wire_args(self, args: tuple, kwargs: dict) -> list:
        out = []
        for kind, item in [(None, a) for a in args] + list(kwargs.items()):
            if isinstance(item, ObjectRef):
                blob = cloudpickle.dumps({"__client_ref__": True, "id": self._rid(item)})
            else:
                blob = cloudpickle.dumps(item)
            entry = {"blob": blob}
            if kind is not None:
                entry["key"] = kind
            out.append(entry)
        return out

    # ------------------------------------------------------------- surface
    def put(self, value: Any) -> ObjectRef:
        reply = self._call("ClientPut", {"blob": cloudpickle.dumps(value)})
        return self._make_ref(reply["ref"])

    def get(self, refs, timeout: float | None = None):
        reply = self._call("ClientGet", {
            "refs": [self._rid(r) for r in refs], "timeout": timeout,
        }, timeout=None if timeout is None else timeout + 30.0)
        return cloudpickle.loads(reply["blob"])

    def wait(self, refs, num_returns: int, timeout: float | None):
        rids = [self._rid(r) for r in refs]
        reply = self._call("ClientWait", {
            "refs": rids, "num_returns": num_returns, "timeout": timeout,
        }, timeout=None if timeout is None else timeout + 30.0)
        by_rid = dict(zip(rids, refs))
        return ([by_rid[r] for r in reply["ready"]],
                [by_rid[r] for r in reply["not_ready"]])

    def submit_task(self, fn, args, kwargs, **options):
        reply = self._call("ClientSubmitTask", {
            "fn": cloudpickle.dumps(fn),
            "args": self._wire_args(args, kwargs),
            "options": options,
        })
        if "stream" in reply:
            return ClientObjectRefGenerator(self, reply["stream"])
        return [self._make_ref(r) for r in reply["refs"]]

    def create_actor(self, cls, args, kwargs, **options) -> bytes:
        reply = self._call("ClientCreateActor", {
            "cls": cloudpickle.dumps(cls),
            "args": self._wire_args(args, kwargs),
            "options": options,
        })
        return bytes.fromhex(reply["actor_id"])

    def submit_actor_task(self, actor_id: bytes, method: str, args, kwargs,
                          *, num_returns=1, generator_backpressure: int = 0,
                          concurrency_group: str = ""):
        reply = self._call("ClientActorCall", {
            "actor_id": actor_id.hex(), "method": method,
            "args": self._wire_args(args, kwargs), "num_returns": num_returns,
            "generator_backpressure": generator_backpressure,
            "concurrency_group": concurrency_group,
        })
        if "stream" in reply:
            return ClientObjectRefGenerator(self, reply["stream"])
        return [self._make_ref(r) for r in reply["refs"]]

    def cancel(self, ref, *, force: bool = False) -> None:
        self._call("ClientCancel", {"ref": self._rid(ref), "force": force})

    def kill_actor(self, actor_id: bytes) -> None:
        self._call("ClientKillActor", {"actor_id": actor_id.hex()})

    def get_actor_by_name(self, name: str):
        reply = self._call("ClientGetActorByName", {"name": name})
        if not reply.get("found"):
            return None
        return bytes.fromhex(reply["actor_id"]), reply

    def register_actor_handle(self, actor_id: bytes, owned: bool) -> None:
        pass  # client handles never own cluster actors

    def deregister_actor_handle(self, actor_id: bytes) -> None:
        pass

    def _gcs_call(self, method: str, payload: dict, timeout: float | None = 30.0) -> dict:
        return self._call("ClientGcsCall", {"method": method, "payload": payload})

    def shutdown(self) -> None:
        self._stop_ping.set()
        if self._ping_thread is not None:
            self._ping_thread.join(timeout=2.0)
        try:
            self._call("ClientDisconnect", {}, timeout=5.0)
        except Exception:
            pass
        try:
            self.io.run_sync(self.rpc.close(), timeout=5)
        except Exception:
            pass
        self.io.stop()

    @property
    def current_task_id(self):
        return TaskID.nil()


def connect(address: str) -> ClientWorker:
    """``ray_tpu_torch.init(address="ray://...")`` entry point."""
    worker = ClientWorker(address)
    # handshake: fails fast on a bad address, registers the per-client
    # job, and returns the heartbeat cadence
    reply = worker._call("ClientHello", {}, timeout=15.0)
    if reply.get("job_id") is not None:
        worker.job_id = JobID.from_int(reply["job_id"])
    worker._start_ping(float(reply.get("ping_interval_s") or 5.0))
    return worker
