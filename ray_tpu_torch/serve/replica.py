"""Replica actor: hosts one copy of a deployment's user callable.

Reference: ``python/ray/serve/_private/replica.py`` (UserCallableWrapper).
The replica exposes readiness/health/queue-length probes for the
controller and ``handle_request`` for routers; ongoing-request counts feed
both the router's power-of-two choice and queue-based autoscaling.
"""

from __future__ import annotations

import threading
from typing import Any

from .._vendor import cloudpickle


class Request:
    """Minimal HTTP request view handed to ingress deployments
    (reference passes a starlette Request)."""

    def __init__(self, method: str = "GET", path: str = "/", query: dict | None = None,
                 headers: dict | None = None, body: bytes = b""):
        self.method = method
        self.path = path
        self.query_params = query or {}
        self.headers = headers or {}
        self.body = body

    def json(self):
        import json

        return json.loads(self.body or b"null")

    def __reduce__(self):
        return (Request, (self.method, self.path, self.query_params, self.headers, self.body))


# Identity of the replica hosted by THIS worker process (one replica actor
# per worker), set before the user callable is constructed so deployment
# code — e.g. the LLM deployment's TTFT histogram — can tag its metrics
# with the serve deployment it runs in (reference
# serve.get_replica_context()).
_REPLICA_CONTEXT: dict | None = None


def get_replica_context() -> dict | None:
    return _REPLICA_CONTEXT


class ReplicaActor:
    """One deployment replica. Created by the controller with the pickled
    user class so replicas never re-import application modules."""

    def __init__(self, serialized_callable: bytes, init_args: tuple, init_kwargs: dict,
                 user_config: Any = None, deployment_name: str = "", app_name: str = "",
                 replica_id: str = ""):
        from .router import resolve_handle_markers

        global _REPLICA_CONTEXT
        _REPLICA_CONTEXT = {"app": app_name, "deployment": deployment_name,
                            "replica_id": replica_id}
        self._lock = threading.Lock()
        self._ongoing = 0
        self._total = 0
        self._deployment_name = deployment_name
        self._app_name = app_name
        self._replica_id = replica_id
        try:
            func_or_class = cloudpickle.loads(serialized_callable)
            init_args = resolve_handle_markers(init_args)
            init_kwargs = resolve_handle_markers(init_kwargs)
            if isinstance(func_or_class, type):
                self._callable = func_or_class(*init_args, **init_kwargs)
            else:
                self._callable = func_or_class  # plain function deployment
            if user_config is not None:
                self.reconfigure(user_config)
        except Exception as e:
            # Publish the constructor's full traceback on the error-info
            # channel from INSIDE the replica process, then re-raise so the
            # actor-creation failure path still runs — the controller's
            # "failed to start" must never be cause-less again.
            import traceback

            from ..diagnostics.errors import publish_error_to_driver

            publish_error_to_driver(
                "replica_start_failure",
                f"replica of {app_name}#{deployment_name} failed in "
                f"__init__: {type(e).__name__}: {e}",
                source="serve_replica", traceback=traceback.format_exc(),
                extra={"app": app_name, "deployment": deployment_name})
            raise

    def ready(self) -> bool:
        return True

    def check_health(self) -> bool:
        probe = getattr(self._callable, "check_health", None)
        if probe is not None:
            probe()
        return True

    def get_queue_len(self) -> int:
        with self._lock:
            return self._ongoing

    def stats(self) -> dict:
        with self._lock:
            return {"ongoing": self._ongoing, "total": self._total}

    def latency_snapshot(self) -> list[dict]:
        """Cumulative latency histograms recorded IN this replica process
        (``serve_ttft_ms`` from an engine-hosting callable, plus any
        ``serve_queue_wait_ms`` observed locally), for the controller's
        latency-SLO autoscaler — pulled via the probe path so scaling
        never waits on the ~5 s GCS metrics flush. Callables exposing
        ``prefix_residency()`` (the LLM deployment) piggyback a
        ``serve_prefix_residency`` row — per-group KV residency counts
        the controller folds into the app status's affinity hit rates."""
        from ..util.metrics import snapshot_all

        names = ("serve_ttft_ms", "serve_queue_wait_ms")
        rows = [
            m for m in snapshot_all()
            if m["name"] in names
            and m.get("tags", {}).get("deployment", "") in (
                "", self._deployment_name)
        ]
        residency = getattr(self._callable, "prefix_residency", None)
        if residency is not None:
            try:
                rows.append({"name": "serve_prefix_residency",
                             **(residency() or {})})
            except Exception:
                pass
        # Overload counters (deadline expiries, engine queue sheds,
        # admission-watermark rejects) piggyback the same probe for the
        # controller's per-deployment status aggregation.
        overload = getattr(self._callable, "overload_stats", None)
        if overload is not None:
            try:
                rows.append({"name": "serve_overload",
                             **(overload() or {})})
            except Exception:
                pass
        # Tenancy rows (per-tenant quotas/TTFT + resident adapters) ride
        # the same probe so serve.status() shows per-tenant state without
        # waiting on the metrics flush.
        tenancy = getattr(self._callable, "tenancy_stats", None)
        if tenancy is not None:
            try:
                rows.append({"name": "serve_tenancy",
                             **(tenancy() or {})})
            except Exception:
                pass
        # Fleet rows (request-idle age + weight residency) feed the
        # controller's scale-to-zero / standby decisions.
        fleet = getattr(self._callable, "fleet_stats", None)
        if fleet is not None:
            try:
                rows.append({"name": "serve_fleet", **(fleet() or {})})
            except Exception:
                pass
        return rows

    # ------------------------------------------------------ fleet lifecycle
    def fleet_demote(self) -> dict:
        """Demote to STANDBY: weights to host RAM, compile cache kept.
        Plain callables have nothing to demote — report unsupported so
        the controller leaves them RUNNING."""
        fn = getattr(self._callable, "fleet_demote", None)
        if fn is None:
            return {"ok": False, "reason": "unsupported"}
        with self._lock:
            if self._ongoing:
                return {"ok": False, "reason": "busy"}
        return fn()

    def fleet_promote(self, weight_address: str | None = None) -> dict:
        """Promote from STANDBY back to serving. Plain callables never
        demoted, so promotion is trivially complete."""
        fn = getattr(self._callable, "fleet_promote", None)
        if fn is None:
            return {"ok": True, "path": "noop"}
        return fn(weight_address)

    def open_weight_stream(self, n_readers: int = 1) -> dict | None:
        """Open a weight broadcast from this replica (the donor side of
        a fan-out promotion). None when the callable can't serve one."""
        fn = getattr(self._callable, "open_weight_stream", None)
        if fn is None:
            return None
        return fn(n_readers)

    def reconfigure(self, user_config: Any) -> bool:
        fn = getattr(self._callable, "reconfigure", None)
        if fn is not None:
            fn(user_config)
        return True

    def _chaos_delay(self) -> None:
        """Chaos injection point: per-replica handle delays (the
        ``replica_delay`` FaultPlan kind) — a deterministic stand-in for
        a replica gone slow, used to exercise the deadline/circuit paths
        under the overload chaos plan."""
        from ..core.rpc import get_chaos

        chaos = get_chaos()
        fn = getattr(chaos, "replica_delay_s", None)
        if fn is None:
            return
        try:
            delay = fn(self._replica_id)
        except Exception:
            return
        if delay > 0:
            import time

            time.sleep(delay)

    def handle_request(self, method_name: str, args: tuple, kwargs: dict):
        from .multiplex import MULTIPLEXED_KWARG, set_multiplexed_model_id
        from .router import (DEADLINE_KWARG, MIGRATE_FROM_KWARG,
                             set_migration_source, set_request_deadline)

        set_multiplexed_model_id(kwargs.pop(MULTIPLEXED_KWARG, ""))
        set_migration_source(kwargs.pop(MIGRATE_FROM_KWARG, None))
        set_request_deadline(kwargs.pop(DEADLINE_KWARG, None))
        self._chaos_delay()
        with self._lock:
            self._ongoing += 1
            self._total += 1
        try:
            target = getattr(self._callable, method_name) if method_name else self._callable
            result = target(*args, **kwargs)
            import inspect

            if inspect.iscoroutine(result):
                import asyncio

                result = asyncio.run(result)
            return result
        finally:
            with self._lock:
                self._ongoing -= 1

    def handle_request_streaming(self, method_name: str, args: tuple, kwargs: dict):
        """Streaming request path (invoked with ``num_returns="streaming"``):
        drives the user callable and yields response **wire messages** —
        the reference proxy's ASGI-message stream over a generator task
        (``python/ray/serve/_private/proxy.py:754``):

          {"kind": "full", "data": value}          — non-streaming handler
          {"kind": "start", "content_type": ...}    — streaming handler head
          {"kind": "chunk", "data": bytes}          — one body chunk
          {"kind": "error", "error": str}           — handler raised

        A streaming handler is one whose result is a (sync/async)
        generator; it may yield a leading ``{"__serve_response__": ...}``
        dict to set status/content-type, then str/bytes/dict chunks.
        """
        import inspect
        import json as _json

        from .multiplex import MULTIPLEXED_KWARG, set_multiplexed_model_id
        from .router import (DEADLINE_KWARG, MIGRATE_FROM_KWARG,
                             set_migration_source, set_request_deadline)

        set_multiplexed_model_id(kwargs.pop(MULTIPLEXED_KWARG, ""))
        set_migration_source(kwargs.pop(MIGRATE_FROM_KWARG, None))
        set_request_deadline(kwargs.pop(DEADLINE_KWARG, None))
        self._chaos_delay()
        with self._lock:
            self._ongoing += 1
            self._total += 1
        try:
            target = getattr(self._callable, method_name) if method_name else self._callable
            result = target(*args, **kwargs)
            if inspect.iscoroutine(result):
                import asyncio

                result = asyncio.run(result)
            if not (inspect.isgenerator(result) or hasattr(result, "__anext__")):
                yield {"kind": "full", "data": result}
                return
            items = _drive(result)
            first = next(items, None)
            head = {"kind": "start", "status": "200 OK", "content_type": "application/octet-stream"}
            if isinstance(first, dict) and first.get("__serve_response__"):
                head["content_type"] = first.get("content_type", head["content_type"])
                head["status"] = first.get("status", head["status"])
                first = next(items, None)
            yield head
            import itertools

            for item in itertools.chain([] if first is None else [first], items):
                if isinstance(item, bytes):
                    data = item
                elif isinstance(item, str):
                    data = item.encode()
                else:
                    data = _json.dumps(item).encode() + b"\n"
                yield {"kind": "chunk", "data": data}
        except Exception as e:
            # Overload sheds (engine queue full, admission refused) carry
            # an http_status/retry_after so the proxy can answer an
            # honest 503 + Retry-After instead of a bare 500.
            msg = {"kind": "error", "error": f"{type(e).__name__}: {e}"}
            status = getattr(e, "http_status", None)
            if status:
                msg["status"] = status
                msg["retry_after"] = getattr(e, "retry_after", 1)
                msg["reason"] = getattr(e, "reason", "overload")
            yield msg
        finally:
            with self._lock:
                self._ongoing -= 1


def _drive(gen):
    """Yield from a sync or async generator, synchronously."""
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
    else:
        yield from gen
