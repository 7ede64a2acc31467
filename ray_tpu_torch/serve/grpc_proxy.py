"""gRPC ingress proxy.

Equivalent of the reference's gRPC proxy
(``python/ray/serve/_private/proxy.py:534``): a generic gRPC server that
routes ``/<app>/<method>`` unary calls onto deployment replicas through
the same power-of-two router as HTTP. Payloads are cloudpickled
request/response values (the reference routes user-defined protobufs; the
generic-bytes contract here keeps the surface protoc-free while the
transport, routing, and backpressure are the real thing).

Client usage::

    channel = grpc.insecure_channel(address)
    call = channel.unary_unary("/my_app/__call__")
    result = cloudpickle.loads(call(cloudpickle.dumps((args, kwargs))))
"""

from __future__ import annotations

import threading
from typing import Any

from .._vendor import cloudpickle

from ..core import api as ray
from .long_poll import LongPollClient
from .router import CONTROLLER_NAME, DeploymentHandle


class _GenericHandler:
    """grpc.GenericRpcHandler routing every unary method by path."""

    def __init__(self, proxy: "GrpcProxyActor"):
        self._proxy = proxy

    def service(self, handler_call_details):
        import grpc

        method = handler_call_details.method  # "/app/method"

        def unary(request: bytes, context) -> bytes:
            try:
                return self._proxy.dispatch(method, request)
            except Exception as e:
                context.abort(grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}")

        return grpc.unary_unary_rpc_method_handler(
            unary,
            request_deserializer=lambda b: b,
            response_serializer=lambda b: b,
        )


class GrpcProxyActor:
    """Per-cluster gRPC ingress (runs as a Serve-internal actor, like the
    HTTP proxy)."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        import grpc
        from concurrent import futures

        self._routes: dict[str, tuple[str, str]] = {}  # app -> (app, ingress)
        self._handles: dict[str, DeploymentHandle] = {}
        controller = ray.get_actor(CONTROLLER_NAME)
        self._long_poll = LongPollClient(controller, {"routes": self._update_routes})
        try:
            snap = ray.get(controller.get_snapshot.remote("routes"), timeout=30)
            if snap:
                self._update_routes(snap)
        except Exception:
            pass
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=32),
            options=[("grpc.so_reuseport", 0)],
        )
        self._server.add_generic_rpc_handlers((_GenericHandler(self),))
        bound = self._server.add_insecure_port(f"{host}:{port}")
        self._server.start()
        self._address = f"127.0.0.1:{bound}"

    def _update_routes(self, table: Any) -> None:
        self._routes = {e["app"]: (e["app"], e["deployment"]) for e in (table or [])}

    def address(self) -> str:
        return self._address

    def ready(self) -> bool:
        return True

    def dispatch(self, method: str, request: bytes) -> bytes:
        parts = method.strip("/").split("/")
        if len(parts) != 2:
            raise ValueError(f"gRPC method must be /app/method, got {method!r}")
        app, target_method = parts
        key = self._routes.get(app)
        if key is None:
            raise KeyError(f"no Serve application named {app!r}")
        handle = self._handles.get(app)
        if handle is None:
            handle = self._handles[app] = DeploymentHandle(*key)
        args, kwargs = cloudpickle.loads(request) if request else ((), {})
        h = handle.options(method_name="" if target_method == "__call__" else target_method)
        result = h.remote(*args, **kwargs).result(timeout=120)
        return cloudpickle.dumps(result)

    def shutdown(self) -> None:
        self._server.stop(grace=0.5)
        self._long_poll.stop()


_GRPC_PROXY_NAME = "SERVE_GRPC_PROXY"
_lock = threading.Lock()


def start_grpc(port: int = 0) -> str:
    """Start (or return) the cluster's gRPC ingress; returns its address
    (reference: serve.start(grpc_options=...))."""
    with _lock:
        try:
            proxy = ray.get_actor(_GRPC_PROXY_NAME)
        except ValueError:
            cls = ray.remote(GrpcProxyActor)
            try:
                proxy = cls.options(name=_GRPC_PROXY_NAME, lifetime="detached",
                                    num_cpus=0, max_concurrency=64).remote("0.0.0.0", port)
            except Exception:
                proxy = ray.get_actor(_GRPC_PROXY_NAME)  # lost the name race
        return ray.get(proxy.address.remote(), timeout=60)
