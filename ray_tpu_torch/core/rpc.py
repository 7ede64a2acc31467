"""RPC layer: asyncio TCP transport with msgpack framing.

TPU-native equivalent of the reference's ``src/ray/rpc/`` (gRPC server/client
wrappers). The control plane does not need gRPC/protobuf machinery on TPU
VMs; a length-prefixed msgpack protocol over asyncio TCP gives the same
request/response semantics with far less code:

    frame   := [u32 little-endian length][msgpack body]
    request := {"id": u64, "method": str, "payload": {...}}
    reply   := {"id": u64, "ok": bool, "payload": {...} | "error": str}

``RetryableRpcClient`` mirrors ``retryable_grpc_client.h`` (exponential
backoff, bounded retries, fail-fast on server-declared death).
``RpcChaos`` mirrors ``rpc_chaos.h:23-37``: deterministic failure injection
per method, configured via the ``testing_rpc_failure`` config entry /
``RAY_TPU_testing_rpc_failure`` env var.
"""

from __future__ import annotations

import asyncio
import logging
import random
import struct
import threading
from typing import Any, Awaitable, Callable

from .._vendor import msgpack

from .config import get_config
from .status import RpcError

logger = logging.getLogger(__name__)

_LEN = struct.Struct("<I")
MAX_FRAME = 1 << 31

# Strong roots for fire-and-forget asyncio tasks. The event loop holds only
# weak references to tasks; a task blocked on an RPC future forms a
# reference cycle (task -> coroutine frame -> client -> pending future ->
# task) with no external root, so the cyclic GC can destroy it mid-await,
# throwing GeneratorExit into the coroutine. Every background task must be
# anchored here until done.
_BACKGROUND_TASKS: set = set()


def spawn(coro) -> "asyncio.Task":
    """ensure_future with a strong reference for the task's lifetime."""
    task = asyncio.ensure_future(coro)
    _BACKGROUND_TASKS.add(task)
    task.add_done_callback(_BACKGROUND_TASKS.discard)
    return task


def _pack(obj: Any) -> bytes:
    body = msgpack.packb(obj, use_bin_type=True)
    return _LEN.pack(len(body)) + body


async def _read_frame(reader: asyncio.StreamReader) -> Any:
    header = await reader.readexactly(_LEN.size)
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise RpcError(f"Frame too large: {length}")
    body = await reader.readexactly(length)
    return msgpack.unpackb(body, raw=False)


_injections_counter = None


def record_chaos_injection(kind: str, method: str) -> None:
    """Count one injected fault in ``ray_tpu_chaos_injections_total``
    (lazily created so chaos-free processes never start the metrics
    flusher). Never raises: chaos accounting must not become a fault."""
    global _injections_counter
    try:
        if _injections_counter is None:
            from ..util.metrics import Counter

            _injections_counter = Counter(
                "ray_tpu_chaos_injections_total",
                "Injected chaos faults by kind and RPC method",
                tag_keys=("kind", "method"))
        _injections_counter.inc(tags={"kind": kind, "method": method or ""})
    except Exception:
        pass


class RpcChaos:
    """Request/response fault injection (rpc_chaos.h:23-37), extended with
    delay injection, a deterministic every-Nth mode, and seeded
    probabilistic modes.

    Spec grammar (``testing_rpc_failure`` config / env var), one rule per
    ``;``-separated item::

        Method=req_prob,resp_prob              # legacy positional form
        Method=req_prob,resp_prob,delay_ms     # legacy + delay
        Method=req:0.2,resp:0.1,client:0.3,nth:3,delay:50,max:10

    ``nth`` makes matched injections deterministic (every Nth call of
    that side, no RNG); ``max`` caps total injections for the rule;
    ``delay`` (ms) is applied to every matched request. ``Method`` may be
    ``*`` to match all methods. Subclasses (``chaos.plan.PlanChaos``)
    override the decision hooks to drive pre-compiled fault schedules and
    the non-RPC fault kinds (worker kills, spill errors, partitions).
    """

    def __init__(self, spec: str = "", seed: int | None = None):
        self._rules = self._parse_spec(spec)
        if seed is None:
            seed = get_config().testing_rpc_failure_seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._calls: dict[tuple[str, str], int] = {}
        # (kind, method) -> injections fired (mirrors the metric; used by
        # `cli doctor` / the chaos report without a GCS round trip).
        self.injections_total: dict[tuple[str, str], int] = {}

    @staticmethod
    def _parse_spec(spec: str) -> dict[str, dict]:
        rules: dict[str, dict] = {}
        for item in filter(None, (spec or "").split(";")):
            method, _, clauses = item.partition("=")
            rule = {"request": 0.0, "response": 0.0, "client": 0.0,
                    "nth": 0, "delay_ms": 0.0, "max": 0, "injected": 0}
            parts = [c.strip() for c in clauses.split(",") if c.strip()]
            if parts and ":" not in parts[0]:
                # Legacy positional: req_prob, resp_prob [, delay_ms]
                rule["request"] = float(parts[0])
                if len(parts) > 1:
                    rule["response"] = float(parts[1])
                if len(parts) > 2:
                    rule["delay_ms"] = float(parts[2])
            else:
                for clause in parts:
                    key, _, value = clause.partition(":")
                    if key == "req":
                        rule["request"] = float(value)
                    elif key == "resp":
                        rule["response"] = float(value)
                    elif key == "client":
                        rule["client"] = float(value)
                    elif key == "nth":
                        rule["nth"] = int(value)
                    elif key in ("delay", "delay_ms"):
                        rule["delay_ms"] = float(value)
                    elif key in ("max", "count"):
                        rule["max"] = int(value)
                    else:
                        raise ValueError(f"Unknown chaos clause {clause!r}")
            rules[method.strip()] = rule
        return rules

    def _rule_for(self, method: str) -> dict | None:
        return self._rules.get(method) or self._rules.get("*")

    def _decide(self, method: str, where: str) -> bool:
        rule = self._rule_for(method)
        if rule is None:
            return False
        prob = rule[where]
        sided = rule["request"] or rule["response"] or rule["client"]
        with self._lock:
            if rule["max"] and rule["injected"] >= rule["max"]:
                return False
            if rule["nth"]:
                # Deterministic mode: fire on every Nth call of this side.
                # With no side probabilities given, nth applies to requests.
                if sided and not prob:
                    return False
                if not sided and where != "request":
                    return False
                key = (method, where)
                n = self._calls.get(key, 0) + 1
                self._calls[key] = n
                hit = n % rule["nth"] == 0
            else:
                if not prob:
                    return False
                hit = self._rng.random() < prob
            if hit:
                rule["injected"] += 1
        if hit:
            self.record_injection(f"rpc_{where}_drop", method)
        return hit

    def record_injection(self, kind: str, method: str = "") -> None:
        with self._lock:
            key = (kind, method)
            self.injections_total[key] = self.injections_total.get(key, 0) + 1
        record_chaos_injection(kind, method)

    # -- decision hooks (all consulted from hot paths: fast no-op when no
    # matching rule exists) ------------------------------------------------
    def should_fail_request(self, method: str, tag: str = "") -> bool:
        return self._decide(method, "request")

    def should_fail_response(self, method: str, tag: str = "") -> bool:
        return self._decide(method, "response")

    def should_drop_client_send(self, method: str) -> bool:
        return self._decide(method, "client")

    def request_delay_s(self, method: str, tag: str = "") -> float:
        rule = self._rule_for(method)
        if rule is None or not rule["delay_ms"]:
            return 0.0
        self.record_injection("rpc_delay", method)
        return rule["delay_ms"] / 1000.0

    def peer_blocked(self, address: str) -> bool:
        """Node-pair partition / endpoint blackout probe (plan-driven)."""
        return False

    def take_kill_on_lease(self, node_id: str = "") -> bool:
        """Raylet asks: kill the worker of the lease just granted?"""
        return False

    def take_kill_loop_tick(self) -> bool:
        """A compiled-loop stage executor asks, once per tick: die here
        (between consuming inputs and producing output)?"""
        return False

    def take_preempt_slice(self, node_id: str = "") -> bool:
        """A raylet asks, once per heartbeat tick: does a GCE-style
        preemption notice land on this node now? (plan-driven)"""
        return False

    def maybe_fail_spill(self) -> bool:
        """Raylet asks: fail this spill-file disk write?"""
        return False

    def maybe_fail_store_create(self) -> bool:
        """Object store asks: fail this arena allocation (as store-full)?"""
        return False


_chaos: RpcChaos | None = None


def get_chaos() -> RpcChaos:
    global _chaos
    if _chaos is None:
        _chaos = RpcChaos(get_config().testing_rpc_failure)
    return _chaos


def set_chaos(chaos: RpcChaos | None) -> None:
    """Install failure injection for this process (tests)."""
    global _chaos
    _chaos = chaos


Handler = Callable[[dict], Awaitable[dict]]


class RpcServer:
    """Asyncio TCP server dispatching named methods (grpc_server.h equiv)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, tag: str = ""):
        self.host = host
        self.port = port
        # Chaos tag naming the service this server fronts ("gcs",
        # "raylet", ...) so plans can target a component, not a method.
        self.tag = tag
        self._handlers: dict[str, Handler] = {}
        self._server: asyncio.AbstractServer | None = None
        self._conns: set[asyncio.StreamWriter] = set()

    def register(self, method: str, handler: Handler) -> None:
        self._handlers[method] = handler

    def register_service(self, service: object, prefix: str = "") -> None:
        """Register every ``handle_<Name>`` coroutine as method ``<Name>``."""
        for attr in dir(service):
            if attr.startswith("handle_"):
                self.register(prefix + attr[len("handle_") :], getattr(service, attr))

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._on_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def stop(self, grace: float = 0.5) -> None:
        if self._server is not None:
            self._server.close()
            # wait_closed() (3.12) blocks until every connection handler
            # finishes; give in-flight RPCs a grace period, then abort the
            # stragglers (long-polls would otherwise hold shutdown forever).
            if grace > 0:
                try:
                    await asyncio.wait_for(self._server.wait_closed(), timeout=grace)
                except Exception:
                    pass
            for writer in list(self._conns):
                try:
                    writer.transport.abort()
                except Exception:
                    pass
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=1.0)
            except Exception:  # pragma: no cover - teardown best effort
                pass
            self._server = None

    async def _on_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._conns.add(writer)
        try:
            while True:
                msg = await _read_frame(reader)
                spawn(self._dispatch(msg, writer))
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.CancelledError):
            pass
        finally:
            self._conns.discard(writer)
            try:
                writer.close()
            except Exception:
                pass

    async def _dispatch(self, msg: dict, writer: asyncio.StreamWriter) -> None:
        method = msg.get("method", "")
        chaos = get_chaos()
        if chaos.should_fail_request(method, tag=self.tag):
            return  # drop request silently
        delay = chaos.request_delay_s(method, tag=self.tag)
        if delay > 0:
            await asyncio.sleep(delay)
        handler = self._handlers.get(method)
        if handler is None:
            reply = {"id": msg["id"], "ok": False, "error": f"No such method: {method}"}
        else:
            try:
                payload = await handler(msg.get("payload") or {})
                reply = {"id": msg["id"], "ok": True, "payload": payload}
            except Exception as e:
                logger.debug("RPC handler %s raised", method, exc_info=True)
                reply = {"id": msg["id"], "ok": False, "error": f"{type(e).__name__}: {e}"}
        if chaos.should_fail_response(method, tag=self.tag):
            return  # drop response
        try:
            writer.write(_pack(reply))
            await writer.drain()
        except (ConnectionError, RuntimeError):
            pass


class RpcClient:
    """Single-connection async client (grpc_client.h equiv)."""

    def __init__(self, address: str):
        self.address = address
        host, port = address.rsplit(":", 1)
        self._host, self._port = host, int(port)
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._pending: dict[int, asyncio.Future] = {}
        self._next_id = 0
        self._lock = asyncio.Lock()
        self._read_task: asyncio.Task | None = None

    async def _ensure_connected(self) -> None:
        if self._writer is not None and not self._writer.is_closing():
            return
        async with self._lock:
            if self._writer is not None and not self._writer.is_closing():
                return
            cfg = get_config()
            try:
                self._reader, self._writer = await asyncio.wait_for(
                    asyncio.open_connection(self._host, self._port),
                    timeout=cfg.rpc_connect_timeout_s,
                )
            except (OSError, asyncio.TimeoutError) as e:
                # Normalize so every transport failure surfaces as RpcError
                # (callers' except clauses and the retry filter rely on it).
                err = RpcError(f"Connection to {self.address} failed: {e}")
                err.undelivered = True  # request never reached the server
                raise err from e
            self._read_task = spawn(self._read_loop())

    async def _read_loop(self) -> None:
        try:
            while True:
                msg = await _read_frame(self._reader)
                fut = self._pending.pop(msg["id"], None)
                if fut is not None and not fut.done():
                    fut.set_result(msg)
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.CancelledError, RpcError) as e:
            self._fail_all(RpcError(f"Connection to {self.address} lost: {e}"))

    def _fail_all(self, error: Exception) -> None:
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass
        self._writer = None
        self._reader = None
        pending, self._pending = self._pending, {}
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(error)

    async def call(self, method: str, payload: dict | None = None, timeout: float | None = None) -> dict:
        chaos = get_chaos()
        if chaos.peer_blocked(self.address):
            # Partition / endpoint blackout: behaves exactly like an
            # unreachable host, so retry & failover paths see the real
            # failure mode (RetryableRpcClient retries these).
            err = RpcError(f"Connection to {self.address} failed: "
                           "chaos-injected partition")
            err.undelivered = True
            raise err
        if chaos.should_drop_client_send(method):
            err = RpcError(f"Connection to {self.address} failed: "
                           f"chaos-injected client drop of {method}")
            err.undelivered = True
            raise err
        await self._ensure_connected()
        self._next_id += 1
        req_id = self._next_id
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        try:
            self._writer.write(_pack({"id": req_id, "method": method, "payload": payload or {}}))
            await self._writer.drain()
        except (ConnectionError, RuntimeError) as e:
            self._pending.pop(req_id, None)
            self._fail_all(RpcError(str(e)))
            raise RpcError(f"Send to {self.address} failed: {e}") from e
        try:
            msg = await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            self._pending.pop(req_id, None)
            raise RpcError(f"RPC {method} to {self.address} timed out")
        if not msg.get("ok"):
            raise RpcError(msg.get("error", "unknown RPC error"))
        return msg.get("payload") or {}

    async def close(self) -> None:
        if self._read_task is not None:
            self._read_task.cancel()
        self._fail_all(RpcError("client closed"))


class RetryableRpcClient(RpcClient):
    """Client with exponential-backoff reconnect (retryable_grpc_client.h)."""

    async def call(self, method: str, payload: dict | None = None, timeout: float | None = None) -> dict:
        cfg = get_config()
        base = cfg.rpc_retry_base_delay_ms / 1000.0
        cap = cfg.rpc_retry_max_delay_ms / 1000.0
        delay = base
        last: Exception | None = None
        for attempt in range(cfg.rpc_max_retries + 1):
            try:
                return await super().call(method, payload, timeout)
            except RpcError as e:
                msg = str(e)
                if "No such method" in msg or msg.startswith("RPC") and "timed out" in msg:
                    raise
                # Application-level errors (handler raised) are not retryable;
                # only transport failures are.
                if "Connection" not in msg and "Send to" not in msg and "refused" not in msg.lower():
                    raise
                last = e
                if attempt == cfg.rpc_max_retries:
                    break
                if cfg.rpc_retry_jitter:
                    # Full jitter: U(0, min(cap, base*2^attempt)). Bare
                    # doubling synchronizes every client that failed at the
                    # same instant into retry waves (mass failure under
                    # chaos); sampling the whole window decorrelates them.
                    await asyncio.sleep(random.uniform(
                        0.0, min(cap, base * (2 ** attempt))))
                else:
                    await asyncio.sleep(delay)
                    delay = min(delay * 2, cap)
        raise RpcError(f"RPC {method} to {self.address} failed after retries: {last}")


class EventLoopThread:
    """A dedicated asyncio loop on a daemon thread.

    Plays the role of the CoreWorker's io_service threads
    (``core_worker_process.h``): synchronous frontend code schedules
    coroutines here and blocks on concurrent futures.
    """

    def __init__(self, name: str = "raytpu-io"):
        self.loop = asyncio.new_event_loop()
        self._inflight: set = set()
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def run_coro(self, coro):
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        # Anchor the future (and through its cancel-chaining callback, the
        # task) so fire-and-forget coroutines can't be GC'd mid-await.
        self._inflight.add(fut)
        fut.add_done_callback(self._inflight.discard)
        return fut

    def run_sync(self, coro, timeout: float | None = None):
        return self.run_coro(coro).result(timeout)

    def stop(self) -> None:
        async def _drain():
            me = asyncio.current_task()
            tasks = [t for t in asyncio.all_tasks() if t is not me]
            for t in tasks:
                t.cancel()
            # Let cancellations unwind (finally blocks) before the loop dies,
            # so no "Task was destroyed but it is pending!" floods.
            if tasks:
                await asyncio.wait(tasks, timeout=2.0)

        if self.loop.is_running():
            try:
                asyncio.run_coroutine_threadsafe(_drain(), self.loop).result(timeout=4)
            except Exception:
                pass
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._thread.join(timeout=5)
        if not self.loop.is_running():
            try:
                self.loop.close()
            except Exception:
                pass
