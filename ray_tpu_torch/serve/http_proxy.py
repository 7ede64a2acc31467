"""HTTP ingress: a minimal asyncio HTTP/1.1 server actor.

Reference: ``python/ray/serve/_private/proxy.py:754`` (per-node proxy).
The proxy owns a routing table (route prefix → app/ingress deployment,
pushed by the controller via long-poll), assigns each request through the
power-of-two router, and streams the response back. Plain asyncio — no
web framework is needed for the request/response shapes Serve handles.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
import urllib.parse
from typing import Any

from ..core import api as ray
from ..observability import tracing
from .long_poll import LongPollClient
from .replica import Request
from .router import (CONTROLLER_NAME, DeadlineExceeded, DeploymentHandle,
                     RequestShed, prefix_group_key)


def _request_deadline_budget(request: Request) -> float:
    """End-to-end deadline budget (seconds) for one request, resolved at
    the front door: the ``x-raytpu-deadline-ms`` header beats a
    ``timeout_s`` JSON body field beats the ``serve_default_deadline_s``
    config. 0 = no deadline (the request may wait forever)."""
    header = request.headers.get("x-raytpu-deadline-ms", "")
    if header:
        try:
            return max(0.0, float(header) / 1000.0)
        except ValueError:
            pass
    if request.body and request.headers.get(
            "content-type", "").startswith("application/json"):
        try:
            body = json.loads(request.body)
            t = body.get("timeout_s")
            if t is not None:
                return max(0.0, float(t))
        except Exception:
            pass
    from ..core.config import get_config

    return max(0.0, get_config().serve_default_deadline_s)


def _request_model_id(request: Request) -> str:
    """Multiplexed model id, unified at the front door: the legacy
    ``serve_multiplexed_model_id`` header, the tenancy spelling
    ``x-raytpu-model``, and an OpenAI-style JSON body ``model`` field
    all resolve to the SAME routing key — a client using any spelling
    lands on the same resident replica (and the same tenant ledger)."""
    from .multiplex import resolve_model_id

    body = None
    if request.body and request.headers.get(
            "content-type", "").startswith("application/json"):
        try:
            body = json.loads(request.body)
        except Exception:
            body = None
    return resolve_model_id(request.headers, body)


def _request_cost_estimate(request: Request) -> float:
    """Estimated token cost for WFQ (prompt length + max_tokens), parsed
    from OpenAI-style JSON bodies at the front door. The ByteTokenizer
    maps ~1 char to 1 token, so character length IS the prompt token
    estimate. Non-JSON / unparseable requests cost 1.0 (plain
    per-request fairness — the pre-cost behavior). The estimate is
    corrected at retire via the tenant's published EWMA ratio."""
    if not (request.body and request.headers.get(
            "content-type", "").startswith("application/json")):
        return 1.0
    try:
        body = json.loads(request.body)
        prompt = body.get("prompt", "")
        if isinstance(prompt, list):
            prompt = prompt[0] if prompt else ""
        if not prompt and isinstance(body.get("messages"), list):
            prompt = "\n".join(
                str(m.get("content", "")) for m in body["messages"]
                if isinstance(m, dict))
        max_tokens = int(body.get("max_tokens", 16))
        return float(max(1, len(str(prompt or "")) + max(0, max_tokens)))
    except Exception:
        return 1.0


def _request_prefix_group(request: Request) -> str:
    """Prefix-group key for affinity routing, extracted at the front
    door: an explicit ``x-raytpu-session`` header (multi-turn sessions)
    beats the hash of the prompt's leading characters (shared system
    prompts) parsed from OpenAI-style JSON bodies; non-LLM requests get
    no key and route by pure load."""
    session = request.headers.get("x-raytpu-session", "")
    if session:
        return prefix_group_key(session_id=session)
    text = ""
    if request.body and request.headers.get(
            "content-type", "").startswith("application/json"):
        try:
            body = json.loads(request.body)
            session = str(body.get("session_id") or "")
            if session:
                return prefix_group_key(session_id=session)
            prompt = body.get("prompt", "")
            if isinstance(prompt, list):
                prompt = prompt[0] if prompt else ""
            if not prompt and isinstance(body.get("messages"), list):
                prompt = "\n".join(
                    str(m.get("content", "")) for m in body["messages"]
                    if isinstance(m, dict))
            text = str(prompt or "")
        except Exception:
            return ""
    elif request.query_params.get("prompt"):
        text = str(request.query_params["prompt"])
    return prefix_group_key(text=text)


class ProxyActor:
    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        self._host = host
        self._port = port
        self._routes: list[dict] = []  # [{prefix, app, deployment}] longest-prefix-first
        self._handles: dict[tuple[str, str], DeploymentHandle] = {}
        self._ready = threading.Event()
        self._start_error: str | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        controller = ray.get_actor(CONTROLLER_NAME)
        self._long_poll = LongPollClient(controller, {"routes": self._update_routes})
        try:
            snap = ray.get(controller.get_snapshot.remote("routes"), timeout=30)
            if snap:
                self._update_routes(snap)
        except Exception:
            pass
        self._thread = threading.Thread(target=self._serve_forever, daemon=True, name="serve-http")
        self._thread.start()
        self._ready.wait(timeout=30)

    def _update_routes(self, table: Any) -> None:
        table = sorted(table or [], key=lambda e: len(e["prefix"]), reverse=True)
        self._routes = table

    def _serve_forever(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        # Deep executor: router assigns may BLOCK under backpressure; with
        # the default ~5-thread pool a handful of saturated-replica waits
        # would starve every other request's executor hops (deadlock spiral
        # until timeouts clear it).
        from concurrent.futures import ThreadPoolExecutor

        self._loop.set_default_executor(
            ThreadPoolExecutor(max_workers=64, thread_name_prefix="serve-proxy"))

        async def _start():
            server = await asyncio.start_server(self._handle_conn, self._host, self._port)
            self._port = server.sockets[0].getsockname()[1]
            self._ready.set()
            async with server:
                await server.serve_forever()

        try:
            self._loop.run_until_complete(_start())
        except Exception as e:
            # surface bind/listen failures to ready()/address() callers
            # instead of pretending the proxy is up
            self._start_error = f"{type(e).__name__}: {e}"
            self._ready.set()

    def _check_started(self) -> None:
        self._ready.wait(timeout=30)
        if self._start_error is not None:
            raise RuntimeError(f"HTTP proxy failed to start: {self._start_error}")

    def address(self) -> str:
        self._check_started()
        return f"http://{self._host}:{self._port}"

    def ready(self) -> bool:
        self._check_started()
        return True

    def apply_config(self, overrides: dict) -> dict:
        """Live-tune serve knobs (router queue bound, shed policy) in
        THIS proxy process — the router reads config per request, so a
        change takes effect on the next assignment without a proxy
        restart. Returns the previous values so a caller can restore."""
        from ..core.config import get_config

        cfg = get_config()
        prev = {}
        for k, v in (overrides or {}).items():
            if not hasattr(cfg, k):
                raise AttributeError(f"unknown config entry {k!r}")
            prev[k] = getattr(cfg, k)
            setattr(cfg, k, v)
        return prev

    def overload_stats(self) -> dict:
        """Per-deployment overload counters from this proxy's routers
        (sheds by reason, router-queue deadline expiries, circuit
        states) — merged into ``serve.status()`` by the API layer."""
        out: dict = {}
        for (app, dep), handle in list(self._handles.items()):
            router = handle._router_holder.get("router")
            if router is None:
                continue
            out.setdefault(app, {})[dep] = router.overload_snapshot()
        return out

    # ------------------------------------------------------------- http core
    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            while True:
                request = await self._read_request(reader)
                if request is None:
                    break
                streamed = await self._dispatch(request, writer)
                if not streamed:
                    break  # streaming error mid-body: close the connection
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    @staticmethod
    def _write_full(writer, status: str, body: bytes, content_type: str = "application/json",
                    trace_id: str = "", extra_headers: dict | None = None):
        extra = f"x-raytpu-trace-id: {trace_id}\r\n" if trace_id else ""
        for k, v in (extra_headers or {}).items():
            extra += f"{k}: {v}\r\n"
        writer.write((
            f"HTTP/1.1 {status}\r\nContent-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\n{extra}Connection: keep-alive\r\n\r\n"
        ).encode() + body)

    async def _read_request(self, reader: asyncio.StreamReader) -> Request | None:
        try:
            line = await reader.readline()
        except (asyncio.IncompleteReadError, ConnectionError):
            return None
        if not line or line in (b"\r\n", b"\n"):
            return None
        try:
            method, target, _version = line.decode().split()
        except ValueError:
            return None
        headers: dict[str, str] = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        length = int(headers.get("content-length", 0))
        body = await reader.readexactly(length) if length else b""
        parsed = urllib.parse.urlsplit(target)
        query = {k: v[0] for k, v in urllib.parse.parse_qs(parsed.query).items()}
        return Request(method=method, path=parsed.path, query=query, headers=headers, body=body)

    async def _dispatch(self, request: Request, writer) -> bool:
        """Route + drive one request. Every request flows through the
        replica's streaming path (reference proxy.py:754 — ASGI messages
        over a streaming generator task): the first wire message decides
        between a buffered JSON reply and a chunked/SSE streamed body.
        Returns False when the connection must close (error mid-stream)."""
        if request.path == "/-/healthz":
            self._write_full(writer, "200 OK", b'"ok"')
            await writer.drain()
            return True
        # Chaos injection point: ingress drops/delays (http_ingress
        # FaultPlan rules, or "http.ingress=..." in the env spec) — lets
        # fault tests exercise client retry behavior at the front door.
        from ..core.rpc import get_chaos

        chaos = get_chaos()
        drop, delay = False, 0.0
        if hasattr(chaos, "http_ingress_fault"):
            drop, delay = chaos.http_ingress_fault()
        else:
            drop = chaos.should_fail_request("http.ingress", tag="serve")
            delay = chaos.request_delay_s("http.ingress", tag="serve")
        if delay > 0:
            await asyncio.sleep(delay)
        if drop:
            self._write_full(
                writer, "503 Service Unavailable",
                json.dumps({"error": "chaos-injected ingress fault"}).encode())
            await writer.drain()
            return True
        route = next((r for r in self._routes if request.path.startswith(r["prefix"])), None)
        if route is None:
            self._write_full(writer, "404 Not Found",
                             json.dumps({"error": f"no route for {request.path}"}).encode())
            await writer.drain()
            return True
        key = (route["app"], route["deployment"])
        handle = self._handles.get(key)
        if handle is None:
            handle = self._handles[key] = DeploymentHandle(*key)
        # Multiplexing/tenancy: the target model id rides a request
        # header (reference serve_multiplexed_model_id, or the tenancy
        # spelling x-raytpu-model, or the JSON body's model field — one
        # routing key) and biases routing toward replicas with the
        # adapter resident; it also names the request's TENANT for
        # quotas / weighted fair queueing.
        model_id = _request_model_id(request)
        if model_id:
            handle = handle.options(multiplexed_model_id=model_id)
        # Prefix/session affinity: requests sharing a session id or a
        # prompt prefix stick to the replica whose engine already holds
        # their KV (the router spills off an overloaded one).
        group = _request_prefix_group(request)
        if group:
            handle = handle.options(prefix_group=group)
        # End-to-end deadline, stamped HERE (ingress) as an absolute wall
        # clock and threaded router → replica → engine: expiry anywhere
        # downstream fails fast instead of burning capacity.
        budget = _request_deadline_budget(request)
        deadline = time.time() + budget if budget else None
        if deadline is not None:
            handle = handle.options(deadline=deadline)
        # WFQ cost: estimated tokens (prompt length + max_tokens), so
        # router-level fair queueing charges big requests more than
        # small ones instead of a flat 1.0 per request.
        cost = _request_cost_estimate(request)
        if cost != 1.0:
            handle = handle.options(request_cost=cost)
        # Root span for the request (or a continuation of the client's
        # trace via the x-raytpu-trace header); everything downstream —
        # router queue, replica task, engine prefill/decode — chains
        # under this context. The trace id is echoed back in a response
        # header so clients can pull the tree with `cli trace <id>`.
        ctx = tracing.context_from_headers(request.headers)
        t0 = time.time()
        status = "200"

        def _shed_span(reason: str) -> None:
            # One `llm.shed` span per refused request: the trace-store
            # view of overload protection, tagged with WHY it was shed.
            tracing.record_span(tracing.make_span(
                "llm.shed", "serve", t0, time.time(),
                ctx.trace_id, ctx.parent_id, attrs={
                    "reason": reason, "app": route["app"],
                    "deployment": route["deployment"],
                    "tenant": model_id or "default"}))

        def _retry_after_hint() -> int:
            try:
                return handle._get_router().retry_after_hint()
            except Exception:
                return 1

        try:
            loop = asyncio.get_running_loop()
            stream = None
            try:
                # assign + submit off-loop (the router may block on
                # backpressure); bind the trace context across the hop.
                stream = await loop.run_in_executor(
                    None, tracing.bind(ctx, handle.remote_streaming, request))
                head = await stream.__anext__()
            except StopAsyncIteration:
                status = "500"
                self._write_full(writer, "500 Internal Server Error",
                                 json.dumps({"error": "empty response stream"}).encode(),
                                 trace_id=ctx.trace_id)
                await writer.drain()
                return True
            except RequestShed as e:
                # Overload protection refused the request: an honest,
                # FAST 503 with a Retry-After derived from the observed
                # service rate — the client backs off instead of piling
                # onto a collapsing queue.
                status = "503"
                if stream is not None:
                    stream.close()
                _shed_span(e.reason)
                self._write_full(
                    writer, "503 Service Unavailable",
                    json.dumps({"error": str(e), "reason": e.reason}).encode(),
                    trace_id=ctx.trace_id,
                    extra_headers={"Retry-After": e.retry_after})
                await writer.drain()
                return True
            except DeadlineExceeded as e:
                status = "504"
                if stream is not None:
                    stream.close()
                _shed_span("deadline")
                self._write_full(writer, "504 Gateway Timeout",
                                 json.dumps({"error": str(e)}).encode(),
                                 trace_id=ctx.trace_id)
                await writer.drain()
                return True
            except TimeoutError as e:
                status = "503"
                if stream is not None:
                    stream.close()  # release the router slot, cancel the replica
                _shed_span("saturated")
                self._write_full(
                    writer, "503 Service Unavailable",
                    json.dumps({"error": str(e)}).encode(),
                    trace_id=ctx.trace_id,
                    extra_headers={"Retry-After": _retry_after_hint()})
                await writer.drain()
                return True
            except Exception as e:
                from ..core.status import ActorDiedError

                if stream is not None:
                    stream.close()
                if isinstance(e, ActorDiedError):
                    # Replica-death retries exhausted (or death before the
                    # replacement is up): the controller is already
                    # replacing it — tell the client when to come back
                    # instead of a bare 500.
                    status = "503"
                    _shed_span("replica_death")
                    self._write_full(
                        writer, "503 Service Unavailable",
                        json.dumps({"error": f"{type(e).__name__}: {e}"}).encode(),
                        trace_id=ctx.trace_id,
                        extra_headers={"Retry-After": _retry_after_hint()})
                    await writer.drain()
                    return True
                status = "500"
                self._write_full(writer, "500 Internal Server Error",
                                 json.dumps({"error": f"{type(e).__name__}: {e}"}).encode(),
                                 trace_id=ctx.trace_id)
                await writer.drain()
                return True

            if head.get("kind") == "error":
                stream.close()  # settle the router slot
                # Replica-side sheds (engine queue bound) arrive as error
                # messages carrying their own status + Retry-After.
                head_status = head.get("status") or "500 Internal Server Error"
                status = head_status.split()[0]
                extra = None
                if head.get("retry_after") is not None:
                    extra = {"Retry-After": head["retry_after"]}
                    _shed_span(head.get("reason", "overload"))
                self._write_full(writer, head_status,
                                 json.dumps({"error": head["error"]}).encode(),
                                 trace_id=ctx.trace_id, extra_headers=extra)
                await writer.drain()
                return True
            if head.get("kind") == "full":
                stream.close()  # single-message stream: release the slot now
                result = head.get("data")
                body = result if isinstance(result, bytes) else json.dumps(result).encode()
                self._write_full(writer, "200 OK", body, trace_id=ctx.trace_id)
                await writer.drain()
                return True

            return await self._stream_body(request, writer, stream, head, ctx)
        finally:
            tracing.record_span(tracing.make_span(
                f"http {request.method} {request.path}", "serve", t0, time.time(),
                ctx.trace_id, ctx.parent_id, ctx.span_id,
                attrs={"app": route["app"], "deployment": route["deployment"],
                       "status": status}))

    async def _stream_body(self, request: Request, writer, stream, head,
                           ctx) -> bool:
        # Streaming body: chunked transfer encoding, flushed per chunk
        # (SSE works over this: content_type text/event-stream).
        writer.write((
            f"HTTP/1.1 {head.get('status', '200 OK')}\r\n"
            f"Content-Type: {head.get('content_type', 'application/octet-stream')}\r\n"
            f"x-raytpu-trace-id: {ctx.trace_id}\r\n"
            "Transfer-Encoding: chunked\r\nConnection: keep-alive\r\n"
            "Cache-Control: no-cache\r\n\r\n"
        ).encode())
        await writer.drain()
        try:
            async for msg in stream:
                if msg.get("kind") == "error":
                    # Headers already sent: close WITHOUT the chunked
                    # terminator — a spec-compliant client then sees a
                    # truncated (failed) body, not a well-formed success.
                    return False
                data = msg.get("data", b"")
                if data:
                    writer.write(b"%x\r\n" % len(data) + data + b"\r\n")
                    await writer.drain()
            writer.write(b"0\r\n\r\n")
            await writer.drain()
            return True
        except (ConnectionError, asyncio.CancelledError):
            raise  # client went away: finally-close cancels the generator
        except Exception:
            return False
        finally:
            stream.close()  # settle the router slot; cancel if unfinished
