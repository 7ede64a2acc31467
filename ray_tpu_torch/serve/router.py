"""Router + DeploymentHandle: request scheduling onto replicas.

Reference: ``python/ray/serve/_private/router.py:321`` and
``replica_scheduler/pow_2_scheduler.py:52`` — the router keeps a local
view of each replica's in-flight count, samples two replicas at random
and picks the less loaded one, skipping replicas at their
``max_ongoing_requests`` cap (backpressure: the caller queues until a
slot frees). Replica membership arrives via long-poll from the
controller, so scale-ups and rolling updates apply without polling.
"""

from __future__ import annotations

import hashlib
import random
import threading
from collections import OrderedDict
from typing import Any

from ..core import api as ray
from ..core.worker import global_worker
from .long_poll import LongPollClient

HANDLE_MARKER = "__serve_handle_marker__"

CONTROLLER_NAME = "SERVE_CONTROLLER"

# Spill migration (KV migration, degenerate single-pool case): when a
# prefix-group request spills off its affine replica, the router ships
# the OLD replica's identity along with the request so the spill target
# can pull the group's hot KV pages instead of cold-prefilling them.
# Travels as a reserved kwarg (popped by the replica before the user
# callable sees it) and surfaces through a thread-local, mirroring the
# multiplexed-model-id plumbing.
MIGRATE_FROM_KWARG = "_serve_migrate_from"

# End-to-end request deadline (overload protection): an absolute wall
# clock (time.time()) stamped at proxy ingress from the
# `x-raytpu-deadline-ms` header / `timeout_s` body field /
# `serve_default_deadline_s` config, threaded router → replica queue →
# engine admission → mid-stream decode. Travels as a reserved kwarg
# (popped by the replica before the user callable sees it) and surfaces
# through a thread-local, exactly like the multiplexed-model-id.
DEADLINE_KWARG = "_serve_deadline"

_migration_context = threading.local()
_deadline_context = threading.local()


def set_request_deadline(deadline: float | None) -> None:
    """Install the current request's absolute wall-clock deadline for
    this request thread (called by the replica before invoking the user
    callable); None = no deadline."""
    _deadline_context.deadline = deadline


def get_request_deadline() -> float | None:
    """Inside a request: the absolute ``time.time()`` deadline the proxy
    stamped at ingress, or None when the request carries none."""
    return getattr(_deadline_context, "deadline", None)


class RequestShed(RuntimeError):
    """The request was refused by overload protection (bounded queue,
    circuit breaker, replica exhaustion) — an honest fast 503, not a
    failure of the request itself. ``retry_after`` derives from the
    observed per-replica service rate."""

    http_status = "503 Service Unavailable"

    def __init__(self, message: str, reason: str = "overload",
                 retry_after: int = 1):
        super().__init__(message)
        self.reason = reason
        self.retry_after = max(1, int(retry_after))


class DeadlineExceeded(TimeoutError):
    """The request's end-to-end deadline expired (here: while still
    queued in the router, before any replica was touched)."""

    http_status = "504 Gateway Timeout"


def set_migration_source(src: dict | None) -> None:
    """Install the spill-migration source ({"replica_id", "actor_id"} or
    None) for the current request thread (called by the replica before
    invoking the user callable)."""
    _migration_context.source = src


def get_migration_source() -> dict | None:
    """Inside a request: the replica this request spilled away from —
    the one holding its prefix group's cached KV — or None."""
    return getattr(_migration_context, "source", None)

# Request metrics (reference: serve_num_router_requests /
# serve_deployment_processing_latency_ms in serve/_private/router.py) —
# lazily created so importing serve doesn't start the metrics flusher.
_metrics_lock = threading.Lock()
_metrics: dict = {}


def _serve_metrics():
    with _metrics_lock:
        if not _metrics:
            from ..util.metrics import Counter, Gauge, Histogram

            _metrics["requests"] = Counter(
                "serve_num_requests_total",
                "Requests routed to replicas", tag_keys=("deployment",))
            _metrics["errors"] = Counter(
                "serve_num_errors_total",
                "Requests that raised", tag_keys=("deployment",))
            _metrics["latency"] = Histogram(
                "serve_request_latency_ms",
                "End-to-end handle latency",
                boundaries=(1, 5, 25, 100, 250, 500, 1000, 5000, 30000),
                tag_keys=("deployment",))
            _metrics["queue_wait"] = Histogram(
                "serve_queue_wait_ms",
                "Time a request waits in the router for a replica slot",
                tag_keys=("deployment",))
            _metrics["affinity_hits"] = Counter(
                "serve_affinity_hits_total",
                "Requests routed to their prefix group's affine replica",
                tag_keys=("deployment",))
            _metrics["affinity_misses"] = Counter(
                "serve_affinity_misses_total",
                "Prefix-group requests whose affine replica vanished "
                "(died/removed) — the KV must cold-prefill elsewhere",
                tag_keys=("deployment",))
            _metrics["affinity_new_groups"] = Counter(
                "serve_affinity_new_groups_total",
                "First-seen prefix groups (not an affinity failure; "
                "excluded from the hit rate)", tag_keys=("deployment",))
            _metrics["affinity_spills"] = Counter(
                "serve_affinity_spills_total",
                "Prefix-group requests spilled off an overloaded affine "
                "replica (load-aware spill)", tag_keys=("deployment",))
            _metrics["affinity_hit_rate"] = Gauge(
                "serve_prefix_affinity_hit_rate",
                "Fraction of prefix-group requests that landed on their "
                "affine replica (0-1, since router start)",
                tag_keys=("deployment",))
            _metrics["spill_migrations"] = Counter(
                "serve_spill_migrations",
                "Affinity spills shipped with a migrate-from source: the "
                "spill target pulls the group's hot KV pages from the "
                "previous replica instead of cold-prefilling",
                tag_keys=("deployment",))
            _metrics["shed"] = Counter(
                "serve_shed_requests",
                "Requests shed by overload protection (bounded router "
                "queue, circuit breaker, replica exhaustion) — fast "
                "honest 503s instead of queue collapse",
                tag_keys=("deployment", "reason", "tenant"))
            _metrics["deadline_expired"] = Counter(
                "serve_deadline_expired",
                "Requests whose end-to-end deadline expired, by where "
                "they were when it did (queued = never touched a "
                "replica)", tag_keys=("deployment", "where"))
            _metrics["circuit_open"] = Counter(
                "serve_circuit_open_total",
                "Replica circuit-breaker open transitions (N consecutive "
                "handle timeouts)", tag_keys=("deployment",))
        return _metrics


def prefix_group_key(session_id: str = "", text: str = "",
                     n_chars: int | None = None) -> str:
    """Prefix-group key for affinity routing: an explicit session id
    wins; otherwise the hash of the prompt's first ``n_chars`` characters
    — under the byte tokenizer that IS the first token blocks, so
    requests sharing a system prompt land in one group. Empty when
    neither is present (no affinity)."""
    if session_id:
        return f"sess:{session_id}"
    if not text:
        return ""
    if n_chars is None:
        from ..core.config import get_config

        n_chars = get_config().serve_prefix_group_chars
    head = text[:n_chars].encode("utf-8", errors="ignore")
    return "pfx:" + hashlib.sha1(head).hexdigest()[:16]


def _assign_traced(router: "Router", metrics: dict, deployment: str,
                   model_id: str, prefix_group: str = "",
                   spill_out: dict | None = None,
                   deadline: float | None = None,
                   cost: float = 1.0) -> tuple[str, Any]:
    """Assign a replica, recording the router queue wait as both a
    histogram observation and (inside an active trace) a span."""
    import time as _time

    from ..observability import tracing

    t0w, t0m = _time.time(), _time.monotonic()
    try:
        replica_id, actor = router.assign_replica(
            model_id=model_id, prefix_group=prefix_group,
            spill_out=spill_out, deadline=deadline, cost=cost)
    finally:
        wait_ms = 1000 * (_time.monotonic() - t0m)
        metrics["queue_wait"].observe(wait_ms, tags={"deployment": deployment})
        ctx = tracing.current()
        if ctx is not None:
            tracing.record_span(tracing.make_span(
                f"router.queue {deployment}", "serve", t0w, _time.time(),
                ctx.trace_id, ctx.span_id,
                attrs={"deployment": deployment}))
    return replica_id, actor


def resolve_handle_markers(obj):
    """Replace deploy-time handle markers with live DeploymentHandles
    (composition: a deployment's init args may reference other
    deployments)."""
    if isinstance(obj, tuple):
        return tuple(resolve_handle_markers(o) for o in obj)
    if isinstance(obj, list):
        return [resolve_handle_markers(o) for o in obj]
    if isinstance(obj, dict):
        if obj.get("t") == HANDLE_MARKER:
            return DeploymentHandle(obj["app"], obj["deployment"])
        return {k: resolve_handle_markers(v) for k, v in obj.items()}
    return obj


class Router:
    """Per-process router for one deployment."""

    def __init__(self, app_name: str, deployment_name: str):
        self._key = f"replicas::{app_name}::{deployment_name}"
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # replica_id -> {"actor": ActorHandle, "max_ongoing": int}
        self._replicas: dict[str, dict] = {}
        self._inflight: dict[str, int] = {}
        # multiplexing cache affinity: model_id -> last replica that served it
        self._model_affinity: dict[str, str] = {}
        # Prefix/session affinity: group key -> replica whose engine holds
        # that group's KV prefix (bounded LRU; load-aware spill keeps a
        # hot replica from queue-blowing on affinity alone).
        self._group_affinity: OrderedDict[str, str] = OrderedDict()
        self.affinity_stats = {"hits": 0, "misses": 0, "spills": 0,
                               "new_groups": 0}
        # Spills that shipped a migrate-from source with the request
        # (the KV moved instead of being recomputed).
        self.spill_migrations = 0
        self._init_overload_state()
        controller = ray.get_actor(CONTROLLER_NAME)
        # Kept for the first-request wake path: a request landing on an
        # empty replica table pokes the controller to un-park a
        # scaled-to-zero deployment (fire-and-forget, rate-limited).
        self._controller = controller
        self._wake_target = (app_name, deployment_name)
        self._last_wake_rpc = 0.0
        self._tenancy_key = f"tenancy::{app_name}::{deployment_name}"
        self._long_poll = LongPollClient(
            controller, {self._key: self._update_replicas,
                         self._tenancy_key: self._update_tenancy})
        # prime with the current table so the first request needn't wait a
        # full poll round-trip
        try:
            snap = ray.get(controller.get_snapshot.remote(self._key), timeout=30)
            if snap is not None:
                self._update_replicas(snap)
            tsnap = ray.get(
                controller.get_snapshot.remote(self._tenancy_key), timeout=30)
            if tsnap is not None:
                self._update_tenancy(tsnap)
        except Exception:
            pass

    def _init_overload_state(self) -> None:
        """Overload-protection state (split out so the bare-router test
        skeleton shares it): bounded wait queue with cost-aware shedding,
        per-replica circuit breaker, and the completion-rate window the
        503 Retry-After derives from."""
        from collections import deque as _deque

        from ..llm.tenancy import WeightedFairQueue

        # Requests currently blocked waiting for a replica slot:
        # [{"cheap": bool, "shed": bool, "tenant": str, "ticket": int}]
        # in arrival order. Over the serve_max_queued_requests bound, new
        # arrivals are shed — unless cost-aware shedding lets a cheap
        # (KV-cached) request preempt the queue slot of an expensive
        # (cold-suffix) waiter, or tenant-aware shedding lets a tenant
        # UNDER its weighted fair share of queue slots preempt the newest
        # waiter of the most over-share tenant.
        self._waiters: list[dict] = []
        # Weighted fair queueing among waiters (tenancy): under
        # saturation only the waiter holding the minimum virtual finish
        # time proceeds, so admitted throughput follows tenant weights.
        # Weights arrive via the tenancy:: long-poll key (empty = every
        # tenant weight 1.0 — FIFO-equivalent, the pre-tenancy behavior).
        self._wfq = WeightedFairQueue()
        self._tenant_weights: dict[str, float] = {}
        # Retire-time cost correction published by the controller (per
        # tenant, EWMA of actual/estimated token cost): scales the
        # estimated WFQ cost so tenants that systematically overrun
        # their max_tokens heuristic still pay their true share.
        self._cost_correction: dict[str, float] = {}
        # replica_id -> {"state": "closed"|"open"|"half_open",
        #                "failures": consecutive timeouts, "opened_at"}
        self._circuit: dict[str, dict] = {}
        # monotonic stamps of recent request completions (release()):
        # the observed service rate behind Retry-After.
        self._completions: "_deque[float]" = _deque()
        self.overload_stats = {"shed": {}, "shed_by_tenant": {},
                               "deadline_expired_queued": 0,
                               "circuit_opens": 0}

    def _update_tenancy(self, value: Any) -> None:
        """Long-poll push of the deployment's tenancy policy (published
        by the controller from the deployment's ``tenancy_config``):
        installs per-tenant WFQ weights."""
        weights = (value or {}).get("weights") if isinstance(value, dict) \
            else None
        correction = (value or {}).get("cost_correction") \
            if isinstance(value, dict) else None
        with self._cond:
            self._tenant_weights = dict(weights or {})
            self._wfq.set_weights(self._tenant_weights)
            self._cost_correction = dict(correction or {})
            self._cond.notify_all()

    def _update_replicas(self, table: Any) -> None:
        from ..core.api import ActorHandle

        table = table or []
        with self._cond:
            fresh = {}
            for entry in table:
                rid = entry["replica_id"]
                existing = self._replicas.get(rid)
                if existing is not None:
                    fresh[rid] = existing
                else:
                    fresh[rid] = {
                        "actor": ActorHandle(bytes.fromhex(entry["actor_id"])),
                        "max_ongoing": entry["max_ongoing"],
                    }
            self._replicas = fresh
            self._inflight = {rid: self._inflight.get(rid, 0) for rid in fresh}
            self._purge_affinity_locked()
            self._cond.notify_all()

    def _purge_affinity_locked(self) -> None:
        """Drop affinity entries pointing at replicas no longer in the
        table: a dead replica's KV died with it, so its groups must
        cold-prefill wherever they land next — never wait for the corpse."""
        for g, rid in list(self._group_affinity.items()):
            if rid not in self._replicas:
                del self._group_affinity[g]
        for m, rid in list(self._model_affinity.items()):
            if rid not in self._replicas:
                del self._model_affinity[m]
        for rid in list(self._circuit):
            if rid not in self._replicas:
                del self._circuit[rid]

    def _affinity_pick(self, prefix_group: str, candidates: list[str],
                       cfg, deployment: str,
                       spill_out: dict | None = None) -> str | None:
        """Prefix-group affinity with load-aware spill. A group's affine
        replica is used while its in-flight load is within
        ``serve_affinity_spill_margin`` of the coolest candidate;
        otherwise the request spills to pow-2 choice and the group
        REMAPS to the spill target. On a spill whose old replica is
        still ALIVE, ``spill_out["migrate_from"]`` records it so the
        spill target can MIGRATE the group's hot KV pages instead of
        cold-prefilling them (PR-10 residue b closed)."""
        def note(kind: str) -> None:
            self.affinity_stats[kind] += 1
            try:
                _serve_metrics()[f"affinity_{kind}"].inc(
                    tags={"deployment": deployment})
            except Exception:
                pass

        affine = self._group_affinity.get(prefix_group)
        if affine is None:
            note("new_groups")
            return None
        if affine not in candidates:
            # Saturated or dead: dead replicas were purged already, a
            # saturated one counts as a spill (never queue behind it).
            if affine in self._replicas:
                note("spills")
                if spill_out is not None:
                    spill_out["migrate_from"] = affine
            else:
                self._group_affinity.pop(prefix_group, None)
                note("misses")
            return None
        coolest = min(self._inflight.get(rid, 0) for rid in candidates)
        if (self._inflight.get(affine, 0) - coolest
                > cfg.serve_affinity_spill_margin):
            note("spills")
            if spill_out is not None:
                spill_out["migrate_from"] = affine
            return None
        note("hits")
        return affine

    def _note_affinity(self, prefix_group: str, pick: str, cfg,
                       deployment: str) -> None:
        self._group_affinity[prefix_group] = pick
        self._group_affinity.move_to_end(prefix_group)
        while len(self._group_affinity) > max(1, cfg.serve_affinity_map_size):
            self._group_affinity.popitem(last=False)
        stats = self.affinity_stats
        looked = stats["hits"] + stats["misses"] + stats["spills"]
        if looked:
            try:
                _serve_metrics()["affinity_hit_rate"].set(
                    stats["hits"] / looked, tags={"deployment": deployment})
            except Exception:
                pass

    # ------------------------------------------------------ overload hooks
    def _candidates_locked(self, cfg) -> tuple[list[str], int]:
        """Replicas eligible for a new request: below their max_ongoing
        cap and not circuit-blocked. An open circuit past its cooldown
        flips to half_open, where the replica admits ONE probe request at
        a time (eligible only while idle). Returns (candidates,
        circuit_blocked_count)."""
        import time

        now = time.monotonic()
        out: list[str] = []
        blocked = 0
        for rid, r in self._replicas.items():
            st = self._circuit.get(rid)
            if st is not None and st["state"] == "open":
                if now - st["opened_at"] >= \
                        cfg.serve_circuit_breaker_cooldown_s:
                    st["state"] = "half_open"
                else:
                    blocked += 1
                    continue
            if st is not None and st["state"] == "half_open" \
                    and self._inflight.get(rid, 0) > 0:
                blocked += 1  # probe already in flight
                continue
            if self._inflight.get(rid, 0) < r["max_ongoing"]:
                out.append(rid)
        return out, blocked

    def note_request_failure(self, replica_id: str,
                             timeout: bool = False) -> None:
        """A handle to ``replica_id`` failed. Consecutive TIMEOUTS trip
        the circuit breaker (``serve_circuit_breaker_failures``); a
        failed half-open probe re-opens immediately."""
        if not timeout:
            return
        from ..core.config import get_config

        import time

        n = get_config().serve_circuit_breaker_failures
        if not n:
            return
        deployment = self._key.rsplit("::", 1)[-1]
        with self._cond:
            if replica_id not in self._replicas:
                return
            st = self._circuit.setdefault(
                replica_id, {"state": "closed", "failures": 0,
                             "opened_at": 0.0})
            st["failures"] += 1
            if st["state"] == "half_open" or st["failures"] >= n:
                if st["state"] != "open":
                    self.overload_stats["circuit_opens"] += 1
                    try:
                        _serve_metrics()["circuit_open"].inc(
                            tags={"deployment": deployment})
                    except Exception:
                        pass
                st["state"] = "open"
                st["opened_at"] = time.monotonic()
                st["failures"] = 0
            self._cond.notify_all()

    def note_request_success(self, replica_id: str) -> None:
        """A handle to ``replica_id`` completed cleanly: reset its
        failure streak; a successful half-open probe closes the circuit
        and restores the replica to full routing."""
        with self._cond:
            st = self._circuit.get(replica_id)
            if st is None:
                return
            if st["state"] != "closed" or st["failures"]:
                st["state"] = "closed"
                st["failures"] = 0
                self._cond.notify_all()

    def circuit_state(self, replica_id: str) -> str:
        with self._cond:
            st = self._circuit.get(replica_id)
            return st["state"] if st is not None else "closed"

    def _service_rate_locked(self, window_s: float = 30.0) -> float:
        """Observed request completions/sec across this router's replicas
        over the trailing window (0.0 = nothing completed yet)."""
        import time

        now = time.monotonic()
        while self._completions and now - self._completions[0] > window_s:
            self._completions.popleft()
        if not self._completions:
            return 0.0
        return len(self._completions) / max(1e-3, now - self._completions[0])

    def _retry_after_locked(self) -> int:
        """Retry-After for a shed request: the backlog ahead of it (every
        waiter + everything in flight) divided by the observed service
        rate, clamped to [1, 60] seconds."""
        import math

        rate = self._service_rate_locked()
        backlog = len(self._waiters) + sum(self._inflight.values()) + 1
        if rate <= 0.0:
            return 1
        return max(1, min(60, int(math.ceil(backlog / rate))))

    def retry_after_hint(self) -> int:
        with self._cond:
            return self._retry_after_locked()

    def _note_shed_locked(self, deployment: str, reason: str,
                          tenant: str = "default") -> None:
        shed = self.overload_stats["shed"]
        shed[reason] = shed.get(reason, 0) + 1
        by_tenant = self.overload_stats["shed_by_tenant"]
        by_tenant[tenant] = by_tenant.get(tenant, 0) + 1
        try:
            _serve_metrics()["shed"].inc(
                tags={"deployment": deployment, "reason": reason,
                      "tenant": tenant})
        except Exception:
            pass

    def overload_snapshot(self) -> dict:
        """Shed/deadline/circuit counters + live circuit states, for
        ``serve.status()`` / ``cli serve status``."""
        with self._cond:
            return {
                "shed": dict(self.overload_stats["shed"]),
                "shed_by_tenant":
                    dict(self.overload_stats["shed_by_tenant"]),
                "deadline_expired_queued":
                    self.overload_stats["deadline_expired_queued"],
                "circuit_opens": self.overload_stats["circuit_opens"],
                "circuit": {rid: st["state"]
                            for rid, st in self._circuit.items()
                            if st["state"] != "closed"},
                "queued": len(self._waiters),
            }

    def assign_replica(self, timeout: float | None = None,
                       model_id: str = "",
                       prefix_group: str = "",
                       spill_out: dict | None = None,
                       deadline: float | None = None,
                       cost: float = 1.0) -> tuple[str, Any]:
        """Power-of-two choice among replicas below their cap; blocks while
        every replica is saturated (backpressure) — but only up to the
        ``serve_max_queued_requests`` bound: over it the request is SHED
        with a fast ``RequestShed`` (503 + Retry-After) instead of
        joining a collapse, preferring (``serve_shed_policy="cost"``) to
        shed requests with the largest cold suffix — a request whose
        prefix group's KV is resident is cheap and may preempt a cold
        waiter's queue slot. A wall-clock ``deadline`` caps the wait:
        expiry raises ``DeadlineExceeded`` without ever touching a
        replica. Replicas tripped by the circuit breaker are excluded
        until their half-open probe succeeds. With a multiplexed
        ``model_id``, replicas that served that model recently are
        preferred (cache affinity — reference multiplex-aware routing).
        With a ``prefix_group`` key, requests stick to the replica whose
        engine already holds the group's KV prefix, with load-aware
        spill (``_affinity_pick``). ``spill_out`` (out-param) reports a
        spill's still-alive previous replica as ``{"migrate_from",
        "actor_id"}`` so the caller can ship a KV-migration source with
        the request."""
        import time

        from ..core.config import get_config
        from ..llm.tenancy import tenant_of

        cfg = get_config()
        if timeout is None:
            timeout = cfg.serve_router_assign_timeout_s
        wait_deadline = time.monotonic() + timeout
        deployment = self._key.rsplit("::", 1)[-1]
        tenant = tenant_of(model_id)
        entry: dict | None = None
        with self._cond:
            try:
                while True:
                    candidates, circuit_blocked = \
                        self._candidates_locked(cfg)
                    queued = any(not e.get("shed") for e in self._waiters
                                 if e is not entry)
                    if candidates and (self._wfq_head_locked(entry)
                                       if entry is not None
                                       else not queued):
                        # Weighted fair queueing: a QUEUED request
                        # proceeds only while it holds the minimum
                        # virtual finish time among waiters, so under
                        # saturation admitted throughput follows tenant
                        # weights instead of arrival order — and a fresh
                        # arrival never barges past the wait queue (it
                        # joins it below instead).
                        if entry is not None:
                            self._wfq.complete(entry["ticket"])
                            entry["ticket"] = None
                            self._cond.notify_all()
                        return self._pick_locked(
                            candidates, cfg, deployment, model_id,
                            prefix_group, spill_out)
                    if deadline is not None and time.time() >= deadline:
                        self.overload_stats["deadline_expired_queued"] += 1
                        try:
                            _serve_metrics()["deadline_expired"].inc(
                                tags={"deployment": deployment,
                                      "where": "queued"})
                        except Exception:
                            pass
                        raise DeadlineExceeded(
                            f"request deadline expired before a replica "
                            f"slot freed for {self._key}")
                    if self._replicas and circuit_blocked and \
                            circuit_blocked >= len(self._replicas):
                        # Every replica's circuit is open (and still
                        # cooling): fail fast, never queue for a corpse.
                        self._note_shed_locked(deployment, "circuit_open",
                                               tenant)
                        raise RequestShed(
                            f"all {len(self._replicas)} replicas of "
                            f"{self._key} are circuit-open",
                            reason="circuit_open",
                            retry_after=self._retry_after_locked())
                    if entry is None:
                        entry = self._enqueue_waiter_locked(
                            cfg, deployment, prefix_group, tenant,
                            cost=cost)
                    elif entry.get("shed"):
                        self._note_shed_locked(deployment, "preempted",
                                               tenant)
                        raise RequestShed(
                            "queue slot preempted by a cached (cheap) "
                            "request under overload",
                            reason="preempted",
                            retry_after=self._retry_after_locked())
                    remaining = wait_deadline - time.monotonic()
                    if deadline is not None:
                        remaining = min(remaining, deadline - time.time())
                    if remaining <= 0:
                        raise TimeoutError(
                            f"No replica available for {self._key} within "
                            f"{timeout}s ({len(self._replicas)} replicas, "
                            "all saturated)")
                    if not self._replicas:
                        # Empty table: likely a scale-to-zero park — poke
                        # the controller to promote a standby, then keep
                        # waiting for the long-poll table push.
                        self._maybe_wake_locked()
                    self._cond.wait(min(remaining, 1.0))
            finally:
                if entry is not None:
                    if entry.get("ticket") is not None:
                        # Shed/timed out before service: drop the WFQ
                        # stamp without advancing the virtual clock.
                        self._wfq.cancel(entry["ticket"])
                    try:
                        self._waiters.remove(entry)
                    except ValueError:
                        pass

    def _wfq_head_locked(self, entry: dict) -> bool:
        ticket = entry.get("ticket")
        return ticket is None or self._wfq.is_head(ticket)

    def _maybe_wake_locked(self) -> None:
        """Fire-and-forget wake_deployment, at most once a second — the
        RPC is idempotent (sets a flag the next reconcile consumes), so
        rate-limiting only spares the controller queue, not correctness."""
        import time as _time

        now = _time.monotonic()
        if now - self._last_wake_rpc < 1.0:
            return
        self._last_wake_rpc = now
        try:
            app, deployment = self._wake_target
            self._controller.wake_deployment.remote(app, deployment)
        except Exception:
            pass

    def _enqueue_waiter_locked(self, cfg, deployment: str,
                               prefix_group: str,
                               tenant: str = "default",
                               cost: float = 1.0) -> dict:
        """Join the router wait queue, enforcing the bound. A cheap
        request (prefix group resident on a live replica → small cold
        suffix) over the bound preempts the oldest expensive waiter's
        slot under the "cost" policy; failing that, a tenant still UNDER
        its weighted fair share of queue slots preempts the newest
        waiter of the most over-share tenant (tenant-aware shedding: a
        noisy tenant's flood sheds its own waiters, not the quiet
        tenant's). Otherwise the incoming request is shed."""
        bound = cfg.serve_max_queued_requests
        cheap = bool(prefix_group
                     and self._group_affinity.get(prefix_group)
                     in self._replicas)
        live = [e for e in self._waiters if not e.get("shed")]
        if bound and self._replicas and len(live) >= bound:
            victim = None
            if cfg.serve_shed_policy == "cost" and cheap:
                victim = next((e for e in live if not e["cheap"]), None)
            if victim is None:
                victim = self._fair_share_victim_locked(live, tenant, bound)
            if victim is None:
                self._note_shed_locked(deployment, "queue_full", tenant)
                raise RequestShed(
                    f"router queue for {self._key} is full "
                    f"({len(live)} waiting, bound {bound})",
                    reason="queue_full",
                    retry_after=self._retry_after_locked())
            victim["shed"] = True
            if victim.get("ticket") is not None:
                # Unblock the WFQ head check immediately — the victim's
                # own thread only wakes to raise its shed.
                self._wfq.cancel(victim["ticket"])
                victim["ticket"] = None
            self._cond.notify_all()
        # WFQ cost = estimated tokens (prompt + max_tokens heuristic
        # from the proxy), scaled by the tenant's published retire-time
        # correction ratio — NOT a flat 1.0/request, so a tenant issuing
        # few huge requests can't out-consume one issuing many small
        # ones at equal weight.
        cost = max(1e-9, float(cost)) * \
            max(0.01, self._cost_correction.get(tenant, 1.0))
        entry = {"cheap": cheap, "shed": False, "tenant": tenant,
                 "ticket": self._wfq.enqueue(tenant, cost=cost)}
        self._waiters.append(entry)
        return entry

    def _fair_share_victim_locked(self, live: list[dict], tenant: str,
                                  bound: int) -> dict | None:
        """Tenant-aware preemption under a full queue: if the incoming
        tenant holds FEWER queue slots than its weight-proportional fair
        share, the newest waiter of the tenant most OVER its share (never
        the incoming tenant) gives up its slot. With one tenant — or no
        configured weights and balanced queues — this never fires, so
        single-tenant shedding behaves exactly as before."""
        counts: dict[str, int] = {}
        for e in live:
            counts[e.get("tenant", "default")] = \
                counts.get(e.get("tenant", "default"), 0) + 1
        tenants = set(counts) | {tenant}
        total_w = sum(max(1e-6, self._tenant_weights.get(t, 1.0))
                      for t in tenants)
        share = {t: bound * max(1e-6, self._tenant_weights.get(t, 1.0))
                 / total_w for t in tenants}
        if counts.get(tenant, 0) >= share[tenant]:
            return None
        worst, worst_over = None, 0.0
        for t, n in counts.items():
            if t == tenant:
                continue
            over = n - share[t]
            if over > worst_over:
                worst, worst_over = t, over
        if worst is None:
            return None
        for e in reversed(live):                     # newest first
            if e.get("tenant", "default") == worst:
                return e
        return None

    def _pick_locked(self, candidates: list[str], cfg, deployment: str,
                     model_id: str, prefix_group: str,
                     spill_out: dict | None) -> tuple[str, Any]:
        pick = None
        if prefix_group:
            pick = self._affinity_pick(prefix_group, candidates,
                                       cfg, deployment,
                                       spill_out=spill_out)
        if pick is None and model_id:
            affine = self._model_affinity.get(model_id)
            if affine in candidates:
                pick = affine
        if pick is None:
            if len(candidates) == 1:
                pick = candidates[0]
            else:
                a, b = random.sample(candidates, 2)
                pick = a if self._inflight.get(a, 0) <= self._inflight.get(b, 0) else b
        if model_id:
            self._model_affinity[model_id] = pick
            while len(self._model_affinity) > 1024:
                self._model_affinity.pop(next(iter(self._model_affinity)))
        if prefix_group:
            self._note_affinity(prefix_group, pick, cfg,
                                deployment)
        if spill_out is not None:
            src = spill_out.get("migrate_from")
            if src is None or src == pick \
                    or src not in self._replicas:
                # pow-2 re-picked the affine replica (or it
                # vanished): nothing to migrate.
                spill_out.pop("migrate_from", None)
            else:
                spill_out["actor_id"] = \
                    self._replicas[src]["actor"]._actor_id.hex()
        self._inflight[pick] = self._inflight.get(pick, 0) + 1
        return pick, self._replicas[pick]["actor"]

    def release(self, replica_id: str) -> None:
        import time

        with self._cond:
            if replica_id in self._inflight:
                self._inflight[replica_id] = max(0, self._inflight[replica_id] - 1)
            self._completions.append(time.monotonic())
            while len(self._completions) > 4096:
                self._completions.popleft()
            self._cond.notify_all()

    def remove_replica(self, replica_id: str) -> None:
        """Drop a replica observed dead from the local view immediately —
        the controller's long-poll update confirms it later, but a retry
        assigned in the meantime must not land on the same corpse."""
        with self._cond:
            self._replicas.pop(replica_id, None)
            self._inflight.pop(replica_id, None)
            self._purge_affinity_locked()
            self._cond.notify_all()

    def shutdown(self) -> None:
        self._long_poll.stop()


class DeploymentResponse:
    """Future-like result of handle.remote() (reference DeploymentResponse)."""

    def __init__(self, ref, on_done, on_error=None, retry=None):
        self._ref = ref
        self._on_done = on_done
        self._on_error = on_error
        # Optional resubmit hook: result() invokes it when the replica
        # died mid-request (ActorDiedError) — the request is re-routed to
        # a live replica instead of surfacing the infrastructure failure.
        self._retry = retry
        self._settle_lock = threading.Lock()
        self._settled = False
        worker = global_worker()
        oid = ref.id()

        def _cb(_oid):
            self._settle()

        if not worker.memory_store.add_callback(oid, _cb):
            self._settle()

    def _resolved_to_error(self) -> bool:
        """Did the replica call raise? (Inline error payloads carry the
        error metadata marker in the owner's memory store.)"""
        try:
            from ..core import serialization

            entry = global_worker().memory_store.get_if_exists(self._ref.id())
            return bool(entry is not None and not entry.in_plasma
                        and entry.metadata == serialization.META_ERROR)
        except Exception:
            return False

    def _settle(self) -> None:
        # atomic test-and-set: the store callback and a result() caller can
        # race here, and on_done (router slot release) must run exactly once
        with self._settle_lock:
            if self._settled:
                return
            self._settled = True
        try:
            if self._on_error is not None and self._resolved_to_error():
                self._on_error()
        except Exception:
            pass
        try:
            self._on_done()
        except Exception:
            pass

    def result(self, timeout: float | None = 60.0):
        from ..core.status import ActorDiedError

        try:
            value = ray.get(self._ref, timeout=timeout)
        except ActorDiedError:
            self._settle()
            if self._retry is not None:
                # Replica died under the request: re-route once to a live
                # replica (the dead one is already dropped from the local
                # router view by the retry hook).
                return self._retry().result(timeout)
            raise
        self._settle()
        return value

    @property
    def ref(self):
        return self._ref


class DeploymentStreamingResponse:
    """Iterable over a replica's streamed results (reference
    DeploymentResponseGenerator): wraps the core ObjectRefGenerator;
    the router slot is released when the stream ends or is closed.
    Outcomes feed the router's circuit breaker: a clean end notes
    success, an item timeout notes a (breaker-counted) failure, and a
    replica death purges the corpse from the local view. ``deadline``
    (absolute wall clock) caps each item wait — a stream whose next
    token cannot arrive inside the request deadline fails fast."""

    def __init__(self, gen, on_done, router: "Router | None" = None,
                 replica_id: str = "", deadline: float | None = None):
        self._gen = gen
        self._on_done = on_done
        self._router = router
        self._replica_id = replica_id
        self._deadline = deadline
        self._settle_lock = threading.Lock()
        self._settled = False

    def _settle(self) -> None:
        with self._settle_lock:
            if self._settled:
                return
            self._settled = True
        try:
            self._on_done()
        except Exception:
            pass

    def _item_timeout(self, base: float) -> float:
        if self._deadline is not None:
            import time as _time

            return max(0.05, min(base, self._deadline - _time.time()))
        return base

    def _note_outcome(self, ok: bool, timeout: bool = False,
                      died: bool = False) -> None:
        if self._router is None or not self._replica_id:
            return
        try:
            if died:
                self._router.remove_replica(self._replica_id)
            elif ok:
                self._router.note_request_success(self._replica_id)
            else:
                self._router.note_request_failure(self._replica_id,
                                                  timeout=timeout)
        except Exception:
            pass

    def _classify(self, e: BaseException) -> None:
        from ..core.status import ActorDiedError

        if isinstance(e, ActorDiedError):
            self._note_outcome(False, died=True)
        elif isinstance(e, TimeoutError):
            self._note_outcome(False, timeout=True)

    def __iter__(self):
        return self

    def __next__(self):
        from ..core.config import get_config

        try:
            ref = next(self._gen)
            return ray.get(ref, timeout=self._item_timeout(
                get_config().serve_stream_item_timeout_s))
        except StopIteration:
            self._note_outcome(True)
            self._settle()
            raise
        except BaseException as e:
            self._classify(e)
            self._settle()  # a failed get must still release the slot
            raise

    async def __anext__(self):
        try:
            ref = await self._gen.__anext__()
            entry = global_worker().memory_store.get_if_exists(ref.id())
            if entry is not None and not entry.in_plasma:
                # Just-reported inline item: the get is a dict lookup — run
                # it on the loop rather than burning an executor hop.
                return ray.get(ref, timeout=self._item_timeout(120))
            # Plasma-backed (large) item: the shm fetch + raylet RPC would
            # block the proxy loop and stall every other connection.
            import asyncio

            loop = asyncio.get_running_loop()
            timeout = self._item_timeout(120)
            return await loop.run_in_executor(
                None, lambda: ray.get(ref, timeout=timeout))
        except StopAsyncIteration:
            self._note_outcome(True)
            self._settle()
            raise
        except BaseException as e:
            self._classify(e)
            self._settle()
            raise

    def __aiter__(self):
        return self

    def close(self) -> None:
        """Abandon the stream: cancels the replica-side generator."""
        try:
            self._gen.close()
        finally:
            self._settle()


class DeploymentHandle:
    """Client-side handle to a deployment (reference serve.handle.DeploymentHandle)."""

    def __init__(self, app_name: str, deployment_name: str, method_name: str = "",
                 multiplexed_model_id: str = "", prefix_group: str = "",
                 deadline: float | None = None,
                 request_cost: float = 1.0,
                 _router_holder: dict | None = None):
        self.app_name = app_name
        self.deployment_name = deployment_name
        self._method_name = method_name
        self._multiplexed_model_id = multiplexed_model_id
        self._prefix_group = prefix_group
        # Absolute wall-clock request deadline (overload protection):
        # caps the router wait, rides the request to the replica, and
        # bounds engine admission/decode.
        self._deadline = deadline
        # Estimated WFQ cost in tokens (prompt + max_tokens heuristic);
        # 1.0 = unknown (plain per-request fairness, the old behavior).
        self._request_cost = request_cost
        # Shared, mutable: every handle derived from this one (h.method)
        # must reuse ONE router — a router per derived handle would leak a
        # long-poll thread per request.
        self._router_holder = (
            _router_holder if _router_holder is not None
            else {"router": None, "lock": threading.Lock()}
        )

    def _get_router(self) -> Router:
        with self._router_holder["lock"]:
            if self._router_holder["router"] is None:
                self._router_holder["router"] = Router(self.app_name, self.deployment_name)
            return self._router_holder["router"]

    def options(self, method_name: str = "",
                multiplexed_model_id: str = "",
                prefix_group: str = "",
                deadline: float | None = None,
                request_cost: float | None = None) -> "DeploymentHandle":
        return DeploymentHandle(
            self.app_name, self.deployment_name,
            method_name or self._method_name,
            multiplexed_model_id or self._multiplexed_model_id,
            prefix_group or self._prefix_group,
            deadline if deadline is not None else self._deadline,
            request_cost if request_cost is not None else self._request_cost,
            _router_holder=self._router_holder,
        )

    def __getattr__(self, item: str) -> "DeploymentHandle":
        if item.startswith("_"):
            raise AttributeError(item)
        return self.options(method_name=item)

    def _inject_migrate_from(self, router: Router, metrics: dict,
                             spill_out: dict, kwargs: dict) -> None:
        """Ship the spill's previous (still-alive) replica with the
        request so the target migrates the prefix group's KV pages
        instead of recomputing them (config ``serve_spill_migration``)."""
        src = spill_out.get("migrate_from")
        if not src or "actor_id" not in spill_out:
            return
        from ..core.config import get_config

        if not get_config().serve_spill_migration:
            return
        kwargs[MIGRATE_FROM_KWARG] = {"replica_id": src,
                                      "actor_id": spill_out["actor_id"]}
        router.spill_migrations += 1
        try:
            metrics["spill_migrations"].inc(
                tags={"deployment": self.deployment_name})
        except Exception:
            pass

    def remote(self, *args, _replica_death_retries: int = 1,
               **kwargs) -> DeploymentResponse:
        import time as _time

        from .multiplex import MULTIPLEXED_KWARG

        router = self._get_router()
        metrics = _serve_metrics()
        metrics["requests"].inc(tags={"deployment": self.deployment_name})
        t0 = _time.monotonic()
        spill_out: dict = {}
        replica_id, actor = _assign_traced(
            router, metrics, self.deployment_name, self._multiplexed_model_id,
            self._prefix_group, spill_out=spill_out,
            deadline=self._deadline, cost=self._request_cost)
        self._inject_migrate_from(router, metrics, spill_out, kwargs)
        if self._multiplexed_model_id:
            kwargs[MULTIPLEXED_KWARG] = self._multiplexed_model_id
        if self._deadline is not None:
            kwargs[DEADLINE_KWARG] = self._deadline
        try:
            ref = actor.handle_request.remote(self._method_name, args, kwargs)
        except Exception:
            router.release(replica_id)
            metrics["errors"].inc(tags={"deployment": self.deployment_name})
            raise

        def _done():
            router.release(replica_id)
            router.note_request_success(replica_id)
            metrics["latency"].observe(
                1000 * (_time.monotonic() - t0),
                tags={"deployment": self.deployment_name})

        def _retry():
            # The assigned replica died mid-request: purge it from the
            # local view and re-route (the controller replaces it async).
            router.remove_replica(replica_id)
            return self.remote(
                *args, _replica_death_retries=_replica_death_retries - 1,
                **kwargs)

        return DeploymentResponse(
            ref, on_done=_done,
            on_error=lambda: metrics["errors"].inc(
                tags={"deployment": self.deployment_name}),
            retry=_retry if _replica_death_retries > 0 else None)

    def remote_streaming(self, *args, **kwargs) -> DeploymentStreamingResponse:
        """Invoke through the replica's streaming path: results arrive
        item-by-item while the handler runs (token streaming, SSE)."""
        from .multiplex import MULTIPLEXED_KWARG

        import time as _time

        router = self._get_router()
        metrics = _serve_metrics()
        metrics["requests"].inc(tags={"deployment": self.deployment_name})
        t0 = _time.monotonic()
        spill_out: dict = {}
        replica_id, actor = _assign_traced(
            router, metrics, self.deployment_name, self._multiplexed_model_id,
            self._prefix_group, spill_out=spill_out,
            deadline=self._deadline, cost=self._request_cost)
        self._inject_migrate_from(router, metrics, spill_out, kwargs)
        if self._multiplexed_model_id:
            kwargs[MULTIPLEXED_KWARG] = self._multiplexed_model_id
        if self._deadline is not None:
            kwargs[DEADLINE_KWARG] = self._deadline
        try:
            from ..core.config import get_config

            gen = actor.handle_request_streaming.options(
                num_returns="streaming",
                _generator_backpressure_num_objects=get_config().serve_stream_backpressure_items,
            ).remote(self._method_name, args, kwargs)
        except Exception:
            router.release(replica_id)
            metrics["errors"].inc(tags={"deployment": self.deployment_name})
            raise

        def _done():
            # Latency of a stream = full stream duration (close/exhaust).
            router.release(replica_id)
            metrics["latency"].observe(
                1000 * (_time.monotonic() - t0),
                tags={"deployment": self.deployment_name})

        return DeploymentStreamingResponse(
            gen, on_done=_done, router=router, replica_id=replica_id,
            deadline=self._deadline)

    def __reduce__(self):
        return (DeploymentHandle, (self.app_name, self.deployment_name,
                                   self._method_name,
                                   self._multiplexed_model_id,
                                   self._prefix_group,
                                   self._deadline,
                                   self._request_cost))
