"""Serve controller: reconciles deployment target state onto replica actors.

Reference: ``python/ray/serve/_private/controller.py:84`` (ServeController)
+ ``deployment_state.py:1249`` (replica FSM / rolling updates) +
``autoscaling_state.py`` (queue-based autoscaling). One detached named
actor owns all Serve state: a reconcile thread diffs target vs running
replicas, starts/drains replica actors, health-checks them, and pushes
routing tables to routers via the long-poll host. State is checkpointed
to the GCS KV after every mutation so a restarted controller can
re-adopt running replicas.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from typing import Any

from .._vendor import cloudpickle

from ..core import api as ray
from ..chaos import clock as chaos_clock
from . import fleet as fleet_policy
from .long_poll import LongPollHost

logger = logging.getLogger(__name__)

# Replica FSM states (reference deployment_state.py ReplicaState).
STARTING = "STARTING"
RUNNING = "RUNNING"
STOPPING = "STOPPING"
# Always-warm fleet (serve/fleet.py): replica alive with weights in host
# RAM and the compile cache warm — excluded from routing (the table only
# carries RUNNING), promoted back via one fleet_promote RPC.
STANDBY = "STANDBY"

CHECKPOINT_KEY = "serve:controller:checkpoint"


class _Replica:
    def __init__(self, replica_id: str, version: str, actor_handle, actor_id: bytes):
        self.replica_id = replica_id
        self.version = version
        self.actor = actor_handle
        self.actor_id = actor_id
        self.state = STARTING
        self.ready_ref = None
        self.started_at = time.time()
        self.health_failures = 0
        self.draining_since = 0.0
        self.applied_user_config = None
        # GCS-resolved placement, filled lazily by the probe phase: the
        # preemption-eviction path needs replica -> node without an RPC
        # to the (possibly dying) replica itself.
        self.node_id = ""
        # Last latency/residency probe (monotonic): outside latency_slo
        # mode the snapshot is pulled at a relaxed cadence — residency
        # doesn't need the every-round freshness autoscaling does.
        self.last_latency_probe = 0.0
        # Set when a fleet_demote reported "unsupported" (plain callable
        # or sharded executor): the replica stays RUNNING and the
        # standby machinery stops retrying it.
        self.fleet_unsupported = False


class _DeploymentState:
    def __init__(self, app_name: str, config: dict):
        self.app_name = app_name
        self.config = config  # name, serialized_callable, init args, options
        self.version = config["version"]
        self.replicas: list[_Replica] = []
        self.next_replica_no = 0
        self.autoscale_history: list[tuple[float, float]] = []
        self.last_scale_up = 0.0
        self.last_scale_down = 0.0
        # latency_slo mode: ring of (ts, {metric: (buckets, boundaries,
        # count)}) cumulative snapshots for windowed quantiles, breach/
        # clear streak counters (hysteresis), and the decision history
        # surfaced in `cli serve status` / get_app_status.
        self.latency_history: list[tuple[float, dict]] = []
        self.slo_breach_streak = 0
        self.slo_ok_streak = 0
        self.scale_events: list[dict] = []
        self.target_replicas = config["num_replicas"]
        # crash-loop backoff: consecutive failed starts delay the next one
        # exponentially (a broken constructor must not spin replica churn)
        self.consecutive_start_failures = 0
        self.next_start_allowed = 0.0
        # The most recent replica-start failure's exception text — surfaced
        # in the controller log, get_app_status(), and the error-info
        # channel so "failed to start" is never cause-less.
        self.last_start_failure: str | None = None
        # Proactive preemption evictions (resilience): one row per replica
        # removed because its NODE got a preemption notice — `reroute_s`
        # (notice -> eviction+table push, chaos-clock) is the serve half
        # of the recovery SLO bench.
        self.preemption_evictions: list[dict] = []
        # Aggregated prefix-group residency from the replicas' probe
        # rows (affinity hit rates in status; empty = no LLM engines).
        self.prefix_affinity: dict = {}
        # Aggregated overload counters from the replicas' probe rows
        # (deadline expiries, engine-queue sheds, admission rejects).
        self.overload: dict = {}
        # Aggregated per-tenant state from the replicas' ``serve_tenancy``
        # probe rows (quota counters, windowed TTFT p95, resident
        # adapters) — surfaced in status and fed to the latency-SLO
        # autoscaler so one noisy tenant's breach triggers scaling.
        self.tenancy: dict = {}
        # Always-warm fleet: folded ``serve_fleet`` probe rows (fleet
        # idle age + weight residency), the scale-to-zero latch, the
        # router-signalled first-request wake, the last standby
        # promotion (timing surfaces in status / `cli serve status`),
        # and the TTFT trend samples predictive upscale extrapolates.
        self.fleet: dict = {}
        self.scaled_to_zero = False
        self.wake_pending = False
        self.last_promote: dict | None = None
        self.ttft_trend: list[tuple[float, float]] = []
        # Wall time of the last wake/scheduled un-zero: replicas keep
        # reporting their pre-wake idle age until the first request
        # lands, so scale-to-zero holds off for a grace window after a
        # wake or the pool would re-latch before serving anything.
        self.last_wake = 0.0

    @property
    def name(self) -> str:
        return self.config["name"]


class ServeController:
    """The detached SERVE_CONTROLLER actor."""

    def __init__(self):
        self._lock = threading.RLock()
        self._apps: dict[str, dict[str, _DeploymentState]] = {}
        self._routes: dict[str, tuple[str, str]] = {}  # prefix -> (app, ingress dep)
        self._long_poll = LongPollHost()
        self._stopped = threading.Event()
        # node_id -> PreemptionNotice for draining/preempted nodes
        # (resilience/preemption.py), refreshed by the reconcile loop.
        self._hazard_nodes: dict = {}
        self._hazard_refreshed = 0.0
        self._reconcile_thread = threading.Thread(
            target=self._reconcile_loop, daemon=True, name="serve-reconcile"
        )
        self._recover()
        self._reconcile_thread.start()

    # ------------------------------------------------------------ public API
    def deploy_application(self, app_name: str, route_prefix: str | None,
                           deployments: list[dict], ingress: str) -> bool:
        """Set/replace target state for an application (reference
        controller.deploy_application)."""
        with self._lock:
            existing = self._apps.get(app_name, {})
            new_states: dict[str, _DeploymentState] = {}
            for config in deployments:
                name = config["name"]
                state = existing.get(name)
                if state is None:
                    state = _DeploymentState(app_name, config)
                else:
                    state.config = config
                    if state.version != config["version"]:
                        state.version = config["version"]  # reconcile rolls replicas
                    auto = config.get("autoscaling")
                    if auto:
                        # keep the autoscaler's current target, clamped to
                        # the new bounds
                        state.target_replicas = max(
                            auto["min_replicas"],
                            min(auto["max_replicas"], state.target_replicas),
                        )
                    else:
                        state.target_replicas = config["num_replicas"]
                new_states[name] = state
            # deployments removed from the app drain in reconcile
            for name, state in existing.items():
                if name not in new_states:
                    state.target_replicas = 0
                    state.config["deleted"] = True
                    new_states[name] = state
            self._apps[app_name] = new_states
            if route_prefix is not None:
                self._routes = {p: t for p, t in self._routes.items() if t[0] != app_name}
                self._routes[route_prefix] = (app_name, ingress)
            self._push_routes()
            for state in new_states.values():
                self._push_tenancy(state)
            self._checkpoint()
        return True

    def delete_application(self, app_name: str) -> bool:
        with self._lock:
            app = self._apps.get(app_name)
            if app is None:
                return False
            for state in app.values():
                state.target_replicas = 0
                state.config["deleted"] = True
            self._routes = {p: t for p, t in self._routes.items() if t[0] != app_name}
            self._push_routes()
            self._checkpoint()
        return True

    def get_app_status(self, app_name: str) -> dict:
        with self._lock:
            app = self._apps.get(app_name, {})
            out = {}
            for name, state in app.items():
                running = [r for r in state.replicas if r.state == RUNNING and r.version == state.version]
                standby = [r for r in state.replicas
                           if r.state == STANDBY and r.version == state.version]
                auto = state.config.get("autoscaling") or {}
                out[name] = {
                    "target_replicas": state.target_replicas,
                    "running_replicas": len(running),
                    "standby_replicas": len(standby),
                    "version": state.version,
                    # Disaggregated pool membership ("prefill"/"decode",
                    # None for unified deployments).
                    "pool": state.config.get("pool"),
                    # A deployment parked at zero with a warm standby
                    # pool is healthy by design, not degraded.
                    "healthy": (len(running) >= state.target_replicas
                                or (state.scaled_to_zero and bool(standby))),
                    "scaled_to_zero": state.scaled_to_zero,
                    "fleet": dict(state.fleet),
                    "last_promote": (dict(state.last_promote)
                                     if state.last_promote else None),
                    "deleted": bool(state.config.get("deleted")),
                    "last_start_failure": state.last_start_failure,
                    "autoscaling_mode": auto.get("mode") if auto else None,
                    "autoscale_events": list(state.scale_events[-10:]),
                    "preemption_evictions": list(state.preemption_evictions[-10:]),
                    "prefix_affinity": dict(state.prefix_affinity),
                    "overload": dict(state.overload),
                    "tenancy": dict(state.tenancy),
                }
            return out

    def wake_deployment(self, app_name: str, name: str | None = None) -> bool:
        """First-request wake: routers call this (fire-and-forget) when a
        request lands on an empty replica table. The next reconcile
        round clears scale-to-zero and promotes standbys."""
        woke = False
        with self._lock:
            for dname, state in (self._apps.get(app_name) or {}).items():
                if name is not None and dname != name:
                    continue
                state.wake_pending = True
                woke = True
        return woke

    def update_tenancy_config(self, app_name: str, name: str | None,
                              tenancy_config: dict) -> dict:
        """Live tenant reconfigure: swap a deployment's tenancy config
        (WFQ weights / quotas) and re-publish the folded weights on the
        ``tenancy::`` long-poll key — routers pick the new shares up
        mid-run, no redeploy, no replica restart."""
        updated = []
        with self._lock:
            for dname, state in (self._apps.get(app_name) or {}).items():
                if name is not None and dname != name:
                    continue
                kwargs = dict(state.config.get("init_kwargs") or {})
                kwargs["tenancy_config"] = tenancy_config
                state.config["init_kwargs"] = kwargs
                self._push_tenancy(state)
                updated.append(dname)
        if updated:
            self._checkpoint()
        return {"updated": updated}

    def list_deployments(self) -> dict:
        with self._lock:
            return {
                app: {name: s.config["name"] for name, s in deps.items()}
                for app, deps in self._apps.items()
            }

    def get_ingress(self, route_prefix: str) -> tuple[str, str] | None:
        with self._lock:
            return self._routes.get(route_prefix)

    def listen_for_change(self, keys_to_snapshot_ids: dict) -> dict:
        return self._long_poll.listen_for_change(keys_to_snapshot_ids)

    def get_snapshot(self, key: str):
        return self._long_poll.get(key)[1]

    def register_proxy(self, actor_id: bytes) -> bool:
        # push the current routing table to the newly-attached proxy
        self._push_routes()
        return True

    def graceful_shutdown(self) -> bool:
        """Drain every replica before the controller itself is killed."""
        with self._lock:
            for app in self._apps.values():
                for state in app.values():
                    state.target_replicas = 0
                    state.config["deleted"] = True
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            with self._lock:
                if all(not s.replicas for app in self._apps.values() for s in app.values()):
                    break
            time.sleep(0.1)
        self._stopped.set()
        try:
            ray.global_worker()._gcs_call("KvDel", {"key": CHECKPOINT_KEY})
        except Exception:
            pass
        return True

    # ------------------------------------------------------- reconciliation
    def _reconcile_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                self._reconcile_once()
            except Exception:
                logger.exception("serve reconcile iteration failed")
            self._stopped.wait(0.25)

    def _refresh_hazard_nodes(self) -> None:
        """Poll the preemption signals (GCS node table ``draining`` flags
        + ``node_preempted`` ErrorEvents) at most twice a second. This is
        what makes replica eviction PROACTIVE: the router stops getting a
        doomed replica at the NOTICE, not after per-request deaths or
        three failed 10 s health probes."""
        now = time.monotonic()
        if now - self._hazard_refreshed < 0.5:
            return
        self._hazard_refreshed = now
        from ..resilience.preemption import hazard_nodes

        self._hazard_nodes = hazard_nodes(
            lambda method, payload: ray.global_worker()._gcs_call(method, payload))

    def _reconcile_once(self) -> None:
        self._refresh_hazard_nodes()
        with self._lock:
            apps = {a: dict(deps) for a, deps in self._apps.items()}
        dirty = False
        for app_name, deps in apps.items():
            for state in deps.values():
                dirty |= self._reconcile_deployment(state)
        with self._lock:
            # drop fully-drained deleted deployments
            for app_name in list(self._apps):
                deps = self._apps[app_name]
                for name in list(deps):
                    s = deps[name]
                    if s.config.get("deleted") and not s.replicas:
                        del deps[name]
                        dirty = True
                if not deps:
                    del self._apps[app_name]
        if dirty:
            self._checkpoint()

    def _reconcile_deployment(self, state: _DeploymentState) -> bool:
        # ---- probe phase: all blocking replica RPCs happen WITHOUT the
        # controller lock, so a hung replica can't freeze the control plane.
        with self._lock:
            replicas = list(state.replicas)
            user_config = state.config.get("user_config")
        probes: dict[str, dict] = {}
        for r in replicas:
            p: dict = {}
            if r.state == STARTING:
                if r.ready_ref is None:
                    r.ready_ref = r.actor.ready.remote()
                try:
                    done, _ = ray.wait([r.ready_ref], num_returns=1, timeout=0)
                    if done:
                        ray.get(done[0], timeout=5)
                        p["ready"] = True
                except Exception as e:
                    p["failed"] = True
                    # Keep the replica's ACTUAL exception (an ActorDiedError
                    # here embeds the creation task's traceback): the
                    # "failed to start" log line must name the cause.
                    p["failure"] = f"{type(e).__name__}: {e}"
            elif r.state in (RUNNING, STANDBY):
                # STANDBY replicas ride the same probe path: liveness,
                # reconfigure, and the fleet/latency snapshot all still
                # apply — only routing excludes them.
                if not r.node_id:
                    # Resolve placement from the GCS actor table (never
                    # from the replica: a preempted node may not answer).
                    try:
                        info = ray.global_worker()._gcs_call(
                            "GetActorInfo", {"actor_id": r.actor_id.hex()})
                        r.node_id = info.get("node_id") or ""
                    except Exception:
                        pass
                p["alive"] = self._replica_alive(r)
                try:
                    p["queue"] = ray.get(r.actor.get_queue_len.remote(), timeout=5)
                except Exception:
                    p["queue"] = 0
                # Probed in every mode (not only latency_slo): the same
                # snapshot carries the serve_prefix_residency row that
                # feeds the affinity hit rates in app status — but
                # outside slo mode only every ~2 s, not every round.
                auto = state.config.get("autoscaling") or {}
                now_m = time.monotonic()
                want_latency = (auto.get("mode") == "latency_slo"
                                or now_m - r.last_latency_probe >= 2.0)
                if p["alive"] and want_latency:
                    r.last_latency_probe = now_m
                    try:
                        p["latency"] = ray.get(
                            r.actor.latency_snapshot.remote(), timeout=5)
                    except Exception:
                        p["latency"] = []
                if p["alive"] and r.applied_user_config != user_config:
                    # config-only change: in-place reconfigure, no restart
                    try:
                        ray.get(r.actor.reconfigure.remote(user_config), timeout=30)
                        r.applied_user_config = user_config
                    except Exception:
                        logger.warning("reconfigure of %s failed", r.replica_id)
            elif r.state == STOPPING:
                try:
                    p["queue"] = ray.get(r.actor.get_queue_len.remote(), timeout=5)
                except Exception:
                    p["queue"] = 0
            probes[r.replica_id] = p

        # ---- decision phase: mutate under the lock, RPC-free.
        to_kill: list[_Replica] = []
        to_promote: list[_Replica] = []
        to_demote: list[_Replica] = []
        n_to_start = 0
        dirty = False
        with self._lock:
            self._fold_prefix_residency(state, probes)
            self._fold_overload(state, probes)
            self._fold_tenancy(state, probes)
            # Re-publish tenancy when the folded retire-time cost
            # correction moved, so routers scale their WFQ estimates.
            corr = {t: row.get("cost_correction")
                    for t, row in ((state.tenancy or {}).get("tenants")
                                   or {}).items()
                    if row.get("cost_correction") is not None}
            if not hasattr(self, "_pushed_corrections"):
                self._pushed_corrections = {}
            ckey = f"{state.app_name}::{state.name}"
            if corr and corr != self._pushed_corrections.get(ckey):
                self._pushed_corrections[ckey] = corr
                self._push_tenancy(state)
            self._fold_fleet(state, probes)
            self._autoscale_from_probes(state, probes)
            self._apply_fleet_policy(state)
            target = state.target_replicas
            for r in list(state.replicas):
                p = probes.get(r.replica_id, {})
                if r.state == STARTING:
                    if p.get("ready"):
                        r.state = RUNNING
                        # Keep the CONSTRUCTION-time user_config recorded at
                        # _start_replica: if the target config changed while
                        # this replica was starting, the next probe's
                        # reconfigure pass must still see the mismatch and
                        # apply it (overwriting with the probe-time config
                        # here silently skipped the update).
                        state.consecutive_start_failures = 0
                        state.next_start_allowed = 0.0
                        state.last_start_failure = None
                        dirty = True
                    elif p.get("failed"):
                        cause = p.get("failure") or "unknown cause"
                        state.consecutive_start_failures += 1
                        state.last_start_failure = cause
                        delay = min(30.0, 0.5 * 2 ** min(state.consecutive_start_failures, 6))
                        # Chaos clock: restart backoff replays deterministically
                        # under time=virtual (chaos/clock.py).
                        state.next_start_allowed = chaos_clock.now() + delay
                        logger.warning(
                            "replica %s failed to start; replacing in %.1fs "
                            "(%d consecutive failures): %s",
                            r.replica_id, delay,
                            state.consecutive_start_failures, cause)
                        from ..diagnostics.errors import publish_error_to_driver

                        publish_error_to_driver(
                            "replica_start_failure",
                            f"replica {r.replica_id} failed to start: "
                            + cause.splitlines()[0],
                            source="serve_controller", traceback=cause,
                            extra={"app": state.app_name,
                                   "deployment": state.name,
                                   "replica_id": r.replica_id})
                        state.replicas.remove(r)
                        to_kill.append(r)
                        dirty = True
                elif r.state == RUNNING and r.node_id in self._hazard_nodes:
                    # Proactive preemption eviction: the replica's NODE
                    # got a preemption notice — stop routing to it NOW,
                    # while it is still technically alive, instead of
                    # waiting for per-request ActorDiedErrors after the
                    # grace-window kill.
                    notice = self._hazard_nodes[r.node_id]
                    now_c = chaos_clock.now()
                    event = {
                        "replica_id": r.replica_id,
                        "node_id": r.node_id,
                        "reason": getattr(notice, "reason", ""),
                        "notice_clock": getattr(notice, "notice_clock", now_c),
                        "evicted_clock": now_c,
                    }
                    event["reroute_s"] = round(
                        max(0.0, now_c - event["notice_clock"]), 4)
                    state.preemption_evictions.append(event)
                    del state.preemption_evictions[:-20]
                    logger.warning(
                        "replica %s evicted: node %s preempted (reroute "
                        "%.2fs after the notice)", r.replica_id,
                        r.node_id[:8], event["reroute_s"])
                    # Drain, don't kill: routing stops immediately (the
                    # table only carries RUNNING replicas) while requests
                    # already on the replica finish inside the grace
                    # window. The STOPPING cleanup reaps it.
                    self._drain_replica(r)
                    dirty = True
                elif r.state in (RUNNING, STANDBY) and not p.get("alive", True):
                    logger.warning("replica %s died; removing", r.replica_id)
                    state.replicas.remove(r)
                    to_kill.append(r)
                    dirty = True
                elif r.state == STOPPING and (
                    p.get("queue", 0) == 0
                    or chaos_clock.now() - r.draining_since > 15.0
                ):
                    state.replicas.remove(r)
                    to_kill.append(r)
                    dirty = True
            current = [r for r in state.replicas if r.state in (STARTING, RUNNING)]
            cur_version = [r for r in current if r.version == state.version]
            old_version = [r for r in current if r.version != state.version]
            # Standby replicas of a superseded version (or of a deleted
            # deployment) carry stale weights — drain them; the warm pool
            # only ever serves the current version.
            for r in list(state.replicas):
                if r.state == STANDBY and (
                        r.version != state.version
                        or state.config.get("deleted")):
                    self._drain_replica(r)
                    dirty = True
            # rolling update: surge one new replica, then drain one old
            # (deployment_state.py rolling update with max surge 1)
            if old_version:
                if len(cur_version) < target + 1 and not any(r.state == STARTING for r in cur_version):
                    n_to_start = 1
                if any(r.state == RUNNING for r in cur_version):
                    self._drain_replica(old_version[0])
                    dirty = True
            else:
                auto = state.config.get("autoscaling")
                # Standby pool size only applies to fleet-capable
                # deployments (ones whose replicas report serve_fleet
                # rows) — a plain-callable deployment never demotes.
                # A deleted deployment must never refill its pool: the
                # stale-standby drain above empties it, and a nonzero
                # want_standby here would restart a replica every round
                # until the shutdown deadline (start→demote→drain storm).
                want_standby = (fleet_policy.desired_standby(auto)
                                if state.fleet
                                and not state.config.get("deleted") else 0)
                standby = [r for r in state.replicas
                           if r.state == STANDBY
                           and r.version == state.version]
                eff_target = 0 if state.scaled_to_zero else target
                deficit = eff_target - len(cur_version)
                if deficit > 0:
                    # Promote warm standbys before starting cold
                    # replicas: promotion is one host→device transfer on
                    # a warm compile cache, a start is a full init.
                    to_promote = standby[:deficit]
                    n_to_start = deficit - len(to_promote)
                elif deficit < 0:
                    running = [r for r in cur_version if r.state == RUNNING]
                    excess = -deficit
                    for r in (running or cur_version)[:excess]:
                        if (r.state == RUNNING and not r.fleet_unsupported
                                and len(standby) + len(to_demote)
                                < want_standby):
                            to_demote.append(r)
                        else:
                            self._drain_replica(r)
                            dirty = True
                # Standby pool maintenance: with the active set
                # satisfied, grow the pool one replica per round — the
                # extra start turns RUNNING, becomes excess next round,
                # and the branch above demotes it into the pool.
                if (deficit <= 0 and not to_demote
                        and len(standby) < want_standby
                        and n_to_start == 0
                        and not any(r.state == STARTING for r in cur_version)):
                    n_to_start = 1

        # ---- action phase: actor create/kill RPCs without the lock.
        for r in to_kill:
            try:
                ray.kill(r.actor)
            except Exception:
                pass
        if n_to_start and chaos_clock.now() < state.next_start_allowed:
            n_to_start = 0  # crash-loop backoff window
        for _ in range(n_to_start):
            self._start_replica(state)
            dirty = True
        # Fleet transitions are replica RPCs, so they stay out of the
        # lock too. Demotion parks weights in host RAM; promotion walks
        # the replica's ladder (broadcast stream → host copy → cold
        # re-init) so a dead donor never strands a standby.
        for r in to_demote:
            try:
                res = ray.get(r.actor.fleet_demote.remote(), timeout=30) or {}
            except Exception as e:
                res = {"ok": False, "reason": f"rpc_failed: {e}"}
            if res.get("ok"):
                with self._lock:
                    r.state = STANDBY
                logger.info("replica %s demoted to standby (%s bytes to host)",
                            r.replica_id, res.get("bytes"))
                dirty = True
            elif res.get("reason") == "unsupported":
                r.fleet_unsupported = True
            # "busy": leave RUNNING; retried next round once drained.
        if to_promote:
            addr = self._weight_donor_address(state, to_promote)
            for r in to_promote:
                try:
                    res = ray.get(r.actor.fleet_promote.remote(addr),
                                  timeout=120) or {}
                except Exception as e:
                    res = {"ok": False, "path": f"rpc_failed: {e}"}
                if res.get("ok"):
                    with self._lock:
                        r.state = RUNNING
                        state.last_promote = {
                            "replica_id": r.replica_id,
                            "path": res.get("path"),
                            "seconds": res.get("seconds"),
                            "ts": time.time(),
                        }
                    logger.info("replica %s promoted via %s in %.3fs",
                                r.replica_id, res.get("path"),
                                float(res.get("seconds") or 0.0))
                else:
                    logger.warning("promotion of %s failed (%s); draining",
                                   r.replica_id, res.get("path"))
                    with self._lock:
                        self._drain_replica(r)
                dirty = True
        if dirty:
            with self._lock:
                self._push_replica_table(state)
        return dirty

    def _weight_donor_address(self, state: _DeploymentState,
                              to_promote: list) -> str | None:
        """For a fan-out promotion, open ONE weight broadcast on a donor
        replica so N cold promotions stream from a single reader-backed
        source instead of N separate loads. A single promotion uses its
        own host copy (the 'host' ladder rung) — no wire needed."""
        if len(to_promote) < 2:
            return None
        promoting = {r.replica_id for r in to_promote}
        with self._lock:
            donors = [r for r in state.replicas
                      if r.state in (RUNNING, STANDBY)
                      and r.replica_id not in promoting
                      and not r.fleet_unsupported]
        for donor in donors:
            try:
                res = ray.get(
                    donor.actor.open_weight_stream.remote(len(to_promote)),
                    timeout=30)
            except Exception:
                continue
            if res and res.get("weight_address"):
                return res["weight_address"]
        return None

    def _fold_fleet(self, state: _DeploymentState, probes: dict) -> None:
        """Fold the replicas' ``serve_fleet`` probe rows (request-idle
        age, weight residency) into the deployment view the fleet policy
        consumes. Held under the controller lock by the decision phase."""
        rows = []
        for p in probes.values():
            for row in p.get("latency") or []:
                if row.get("name") == "serve_fleet":
                    rows.append(row)
        folded = fleet_policy.fold_fleet_rows(rows)
        if folded is not None:
            state.fleet = folded

    def _apply_fleet_policy(self, state: _DeploymentState) -> None:
        """Scheduled capacity, wake, and scale-to-zero — the pure
        policy lives in serve/fleet.py; this applies its answers to the
        deployment FSM (called under the controller lock)."""
        auto = state.config.get("autoscaling")
        if not auto or state.config.get("deleted"):
            return
        now = time.time()
        floor = fleet_policy.scheduled_floor(
            auto.get("scheduled_capacity"), now)
        if floor > 0:
            floor = min(floor, int(auto.get("max_replicas") or floor))
            if state.scaled_to_zero:
                state.scaled_to_zero = False
                self._record_scale_event(
                    state, 0, state.target_replicas, "scheduled_capacity",
                    floor, floor)
            if state.target_replicas < floor:
                self._record_scale_event(
                    state, state.target_replicas, floor,
                    "scheduled_capacity", floor, floor)
                state.target_replicas = floor
        if floor > 0:
            state.last_wake = now
        if state.wake_pending:
            state.wake_pending = False
            if state.scaled_to_zero:
                # First request after scale-to-zero: the router saw an
                # empty replica table and poked us — promote NOW, don't
                # wait for an idle-age flip.
                state.scaled_to_zero = False
                state.last_wake = now
                self._record_scale_event(
                    state, 0, state.target_replicas, "wake", None,
                    state.target_replicas)
        idle_thresh = float(fleet_policy._cfg_get(
            auto, "scale_to_zero_idle_s", 0) or 0)
        woke_recently = (idle_thresh > 0
                         and now - state.last_wake < idle_thresh)
        if (not state.scaled_to_zero and floor == 0 and not woke_recently
                and fleet_policy.should_scale_to_zero(
                    (state.fleet or {}).get("idle_s"), auto)
                and state.fleet.get("residency_capable")):
            state.scaled_to_zero = True
            self._record_scale_event(
                state, state.target_replicas, 0, "scale_to_zero",
                state.fleet.get("idle_s"),
                fleet_policy._cfg_get(auto, "scale_to_zero_idle_s"))

    @staticmethod
    def _fold_prefix_residency(state: _DeploymentState, probes: dict) -> None:
        """Sum the replicas' ``serve_prefix_residency`` probe rows into
        the deployment's affinity view: resident groups, requests, and
        the replica-local prefix-cache hit rate (how often an affine
        request found its KV where the router sent it)."""
        agg = {"replicas": 0, "groups": 0, "requests": 0, "cache_hits": 0}
        for p in probes.values():
            for row in p.get("latency") or []:
                if row.get("name") != "serve_prefix_residency":
                    continue
                agg["replicas"] += 1
                for k in ("groups", "requests", "cache_hits"):
                    agg[k] += int(row.get(k, 0) or 0)
        if agg["replicas"]:
            agg["hit_rate"] = (round(agg["cache_hits"] / agg["requests"], 4)
                               if agg["requests"] else 0.0)
            state.prefix_affinity = agg

    @staticmethod
    def _fold_overload(state: _DeploymentState, probes: dict) -> None:
        """Sum the replicas' ``serve_overload`` probe rows (engine-side
        deadline expiries, queue sheds, admission-watermark rejects)
        into the deployment's overload view for ``serve.status()``."""
        keys = ("deadline_expired_queued", "deadline_expired_running",
                "queue_rejects", "admission_rejects")
        agg = {k: 0 for k in keys}
        replicas = 0
        for p in probes.values():
            for row in p.get("latency") or []:
                if row.get("name") != "serve_overload":
                    continue
                replicas += 1
                for k in keys:
                    agg[k] += int(row.get(k, 0) or 0)
        if replicas:
            agg["replicas"] = replicas
            state.overload = agg

    @staticmethod
    def _fold_tenancy(state: _DeploymentState, probes: dict) -> None:
        """Merge the replicas' ``serve_tenancy`` probe rows into one
        per-tenant view: counters sum across replicas, the windowed TTFT
        p95 takes the worst replica (one hot replica breaching the SLO
        is a breach), and each replica's resident adapters are unioned.
        Feeds ``serve.status()`` and the latency-SLO autoscaler."""
        sum_keys = ("admitted", "shed", "quota_rejects",
                    "tokens_in", "tokens_out")
        tenants: dict[str, dict] = {}
        resident: list[str] = []
        last_breaches: list[dict] = []
        adapter_defers = 0
        replicas = 0
        for p in probes.values():
            for row in p.get("latency") or []:
                if row.get("name") != "serve_tenancy":
                    continue
                replicas += 1
                adapter_defers += int(row.get("adapter_defers", 0) or 0)
                for aid in row.get("resident_adapters") or []:
                    if aid not in resident:
                        resident.append(aid)
                last_breaches.extend(row.get("last_breaches") or [])
                for tenant, t_row in (row.get("tenants") or {}).items():
                    agg = tenants.setdefault(
                        tenant, {k: 0 for k in sum_keys})
                    for k in sum_keys:
                        agg[k] += int(t_row.get(k, 0) or 0)
                    agg["weight"] = t_row.get("weight", agg.get("weight", 1.0))
                    p95 = t_row.get("p95_ttft_ms")
                    if p95 is not None:
                        agg["p95_ttft_ms"] = max(
                            float(p95), float(agg.get("p95_ttft_ms") or 0.0))
                    burn = t_row.get("slo_burn_frac")
                    if burn is not None:
                        # like p95: one hot replica burning the SLO IS a
                        # burn — take the worst replica's fraction
                        agg["slo_burn_frac"] = max(
                            float(burn), float(agg.get("slo_burn_frac")
                                               or 0.0))
                        agg["ttft_slo_ms"] = t_row.get(
                            "ttft_slo_ms", agg.get("ttft_slo_ms"))
                        agg["slo_breaches"] = int(agg.get("slo_breaches", 0)) \
                            + int(t_row.get("slo_breaches", 0) or 0)
                    corr = t_row.get("cost_correction")
                    if corr is not None:
                        # mean across reporting replicas (each is already
                        # an EWMA over that replica's retires)
                        n = int(agg.get("_corr_n", 0))
                        prev = float(agg.get("cost_correction") or 0.0)
                        agg["cost_correction"] = round(
                            (prev * n + float(corr)) / (n + 1), 4)
                        agg["_corr_n"] = n + 1
                    remaining = t_row.get("quota_remaining")
                    if remaining is not None:
                        # quota buckets are per-replica: remaining budget
                        # across the deployment is their sum
                        agg["quota_remaining"] = round(
                            float(agg.get("quota_remaining") or 0.0)
                            + float(remaining), 1)
        for agg in tenants.values():
            agg.pop("_corr_n", None)
        if replicas:
            # Most recent breach dumps across the fleet, newest last.
            last_breaches.sort(key=lambda b: b.get("ts", 0.0))
            state.tenancy = {
                "replicas": replicas,
                "tenants": tenants,
                "resident_adapters": resident,
                "adapter_defers": adapter_defers,
                "last_breaches": last_breaches[-8:],
                # Counters/quota sum over N per-replica ledgers: an
                # N-replica deployment admits ~N× a single replica's
                # tokens_per_s quota (each replica meters independently).
                "scope": "per_replica_sum",
            }

    def _replica_alive(self, r: _Replica) -> bool:
        try:
            ray.get(r.actor.check_health.remote(), timeout=10)
            r.health_failures = 0
            return True
        except Exception:
            r.health_failures += 1
            return r.health_failures < 3

    def _start_replica(self, state: _DeploymentState) -> None:
        from .replica import ReplicaActor

        with self._lock:
            cfg = state.config
            state.next_replica_no += 1
            replica_id = f"{state.app_name}#{state.name}#{state.next_replica_no}"
            version = state.version
        actor_options = dict(cfg.get("ray_actor_options") or {})
        actor_options.setdefault("num_cpus", 0.1)
        cls = ray.remote(ReplicaActor)
        handle = cls.options(
            max_concurrency=cfg["max_ongoing"] + 8, **actor_options
        ).remote(
            cfg["serialized_callable"], cfg["init_args"], cfg["init_kwargs"],
            cfg.get("user_config"), state.name, state.app_name, replica_id,
        )
        r = _Replica(replica_id, version, handle, handle._actor_id)
        r.applied_user_config = cfg.get("user_config")
        with self._lock:
            state.replicas.append(r)
        logger.info("starting replica %s (version %s)", replica_id, version[:8])

    def _drain_replica(self, r: _Replica) -> None:
        """Stop routing to the replica; it is killed once its in-flight
        requests complete (graceful_shutdown_wait_loop in the reference)."""
        if r.state != STOPPING:
            r.state = STOPPING
            r.draining_since = chaos_clock.now()

    # ----------------------------------------------------------- autoscaling
    def _record_scale_event(self, state: _DeploymentState, old: int, new: int,
                            trigger: str, value, target) -> None:
        """Every scale decision becomes (a) a history row in
        ``get_app_status()`` / ``cli serve status`` and (b) a span in the
        trace store, so 'why did we scale at 12:04' is answerable from
        either surface."""
        now = time.time()
        event = {
            "ts": now, "from": old, "to": new, "trigger": trigger,
            "value": None if value is None else round(float(value), 2),
            "target": target,
        }
        state.scale_events.append(event)
        del state.scale_events[:-50]
        logger.info("autoscale %s: %d -> %d (%s=%s target=%s)",
                    state.name, old, new, trigger, event["value"], target)
        try:
            from ..observability import tracing

            span = tracing.make_span(
                f"serve.autoscale {state.name}", "serve", now, now,
                tracing.new_trace_id(),
                attrs={"deployment": state.name, "app": state.app_name,
                       "from": old, "to": new, "trigger": trigger,
                       "value": event["value"], "target": target})
            tracing.record_span(span)
        except Exception:
            pass

    def _autoscale_from_probes(self, state: _DeploymentState, probes: dict) -> None:
        auto = state.config.get("autoscaling")
        if not auto or state.config.get("deleted"):
            return
        running = [r for r in state.replicas if r.state == RUNNING]
        if not running:
            return
        if auto.get("mode") == "latency_slo":
            self._autoscale_latency_slo(state, auto, running, probes)
            return
        self._autoscale_queue_based(state, auto, running, probes)

    def _autoscale_queue_based(self, state: _DeploymentState, auto: dict,
                               running: list, probes: dict) -> None:
        """Queue-based autoscaling (reference autoscaling_state.py): desired
        replicas = ceil(total ongoing / target_ongoing_requests), clamped,
        with separate up/downscale delays."""
        total = float(sum(probes.get(r.replica_id, {}).get("queue", 0) for r in running))
        now = time.time()
        state.autoscale_history.append((now, total))
        state.autoscale_history = [(t, v) for t, v in state.autoscale_history if now - t <= 30.0]
        desired = math.ceil(total / auto["target_ongoing_requests"]) if total > 0 else auto["min_replicas"]
        desired = max(auto["min_replicas"], min(auto["max_replicas"], desired))
        cur = state.target_replicas
        if desired > cur and now - state.last_scale_up >= auto["upscale_delay_s"]:
            state.target_replicas = desired
            state.last_scale_up = now
            self._record_scale_event(state, cur, desired, "ongoing_requests",
                                     total, auto["target_ongoing_requests"])
        elif desired < cur and now - state.last_scale_down >= auto["downscale_delay_s"]:
            state.target_replicas = desired
            state.last_scale_down = now
            self._record_scale_event(state, cur, desired, "ongoing_requests",
                                     total, auto["target_ongoing_requests"])

    @staticmethod
    def _merge_latency_rows(probes: dict) -> dict:
        """Sum each latency histogram across replica probe snapshots:
        {metric_name: (buckets, boundaries, count)}."""
        merged: dict[str, tuple[list[int], list[float], int]] = {}
        for p in probes.values():
            for row in p.get("latency") or []:
                buckets = list(row.get("buckets") or [])
                if not buckets:
                    continue
                name = row["name"]
                cur = merged.get(name)
                if cur is None:
                    merged[name] = (buckets, list(row.get("boundaries") or []),
                                    int(row.get("count", 0)))
                else:
                    summed = [a + b for a, b in zip(cur[0], buckets)]
                    merged[name] = (summed, cur[1],
                                    cur[2] + int(row.get("count", 0)))
        return merged

    def _windowed_quantile(self, state: _DeploymentState, metric: str,
                           q: float, window_s: float, now: float):
        """Quantile of the observations that landed within the window:
        delta of the cumulative merged histogram vs the snapshot at the
        window's start (replica restarts can shrink counts — negative
        deltas clamp to 0). None = no traffic in the window."""
        from ..util.metrics import histogram_quantile

        latest = state.latency_history[-1][1].get(metric) if state.latency_history else None
        if latest is None:
            return None
        base = None
        for ts, snap in state.latency_history[:-1]:
            if now - ts <= window_s:
                break
            if metric in snap:
                base = snap[metric]
        buckets, boundaries, _ = latest
        if base is not None:
            buckets = [max(0, a - b) for a, b in zip(buckets, base[0])]
        if sum(buckets) == 0:
            return None
        return histogram_quantile(
            {"buckets": buckets, "boundaries": boundaries}, q)

    def _autoscale_latency_slo(self, state: _DeploymentState, auto: dict,
                               running: list, probes: dict) -> None:
        """Latency-SLO autoscaling: scale from the windowed TTFT quantile
        the replicas actually served (the PR-2 ``serve_ttft_ms`` /
        ``serve_queue_wait_ms`` histograms) instead of the queue-depth
        proxy. Hysteresis = ``breach_cycles`` consecutive breaching (or
        clear) probe rounds AND the up/downscale delay debounce."""
        now = time.time()
        merged = self._merge_latency_rows(probes)
        if auto.get("target_queue_wait_ms") is not None \
                and "serve_queue_wait_ms" not in merged:
            # Queue wait is observed router-side (proxy/driver processes),
            # so the replica probes never carry it — pull the cluster
            # aggregate from the GCS instead (flushed every ~5 s; fine
            # for a windowed quantile).
            try:
                from ..util.metrics import get_metrics

                for m in get_metrics():
                    if (m["name"] == "serve_queue_wait_ms" and m.get("buckets")
                            and m.get("tags", {}).get("deployment")
                            == state.name):
                        cur = merged.get("serve_queue_wait_ms")
                        buckets = list(m["buckets"])
                        if cur is not None:
                            buckets = [a + b for a, b in zip(cur[0], buckets)]
                        merged["serve_queue_wait_ms"] = (
                            buckets, list(m.get("boundaries") or []),
                            int(m.get("count", 0)) + (cur[2] if cur else 0))
            except Exception:
                pass
        state.latency_history.append((now, merged))
        window = float(auto.get("latency_window_s") or 30.0)
        state.latency_history = [
            (t, s) for t, s in state.latency_history if now - t <= 2 * window]
        q = float(auto.get("slo_quantile") or 0.95)
        target_ttft = float(auto.get("target_ttft_ms") or 500.0)
        p_ttft = self._windowed_quantile(state, "serve_ttft_ms", q, window, now)
        target_qw = auto.get("target_queue_wait_ms")
        p_qw = (self._windowed_quantile(state, "serve_queue_wait_ms", q,
                                        window, now)
                if target_qw else None)
        # Worst-tenant windowed TTFT p95 from the folded ``serve_tenancy``
        # rows: a single tenant breaching the SLO must scale the
        # deployment even when the aggregate histogram is diluted by a
        # healthy majority (the noisy-neighbor blind spot).
        tenant_p95 = None
        for t_row in (state.tenancy.get("tenants") or {}).values():
            t95 = t_row.get("p95_ttft_ms")
            if t95 is not None:
                tenant_p95 = max(float(t95), tenant_p95 or 0.0)
        # Predictive upscale (fleet round): extrapolate the windowed TTFT
        # trend ``predictive_horizon_s`` ahead — a projected breach counts
        # as a breach NOW, so capacity promotes before the p95 crosses
        # the SLO instead of after.
        pred_ttft = None
        if auto.get("predictive"):
            state.ttft_trend.append((now, p_ttft))
            state.ttft_trend = [
                (t, v) for t, v in state.ttft_trend if now - t <= 2 * window]
            pred_ttft = fleet_policy.slope_projection(
                state.ttft_trend,
                float(auto.get("predictive_horizon_s") or 10.0))
        pred_breach = pred_ttft is not None and pred_ttft > target_ttft
        ttft_breach = p_ttft is not None and p_ttft > target_ttft
        qw_breach = (target_qw is not None and p_qw is not None
                     and p_qw > float(target_qw))
        tenant_breach = tenant_p95 is not None and tenant_p95 > target_ttft
        breach = ttft_breach or qw_breach or tenant_breach or pred_breach
        headroom = float(auto.get("downscale_headroom") or 0.5)
        clear = (not pred_breach) and (
            p_ttft is None or p_ttft < headroom * target_ttft) and (
            target_qw is None or p_qw is None or p_qw < headroom * float(target_qw)) and (
            tenant_p95 is None or tenant_p95 < headroom * target_ttft)
        state.slo_breach_streak = state.slo_breach_streak + 1 if breach else 0
        state.slo_ok_streak = state.slo_ok_streak + 1 if clear else 0
        cycles = max(1, int(auto.get("breach_cycles") or 1))
        cur = state.target_replicas
        if qw_breach:
            trigger = "serve_queue_wait_ms_p%d" % round(100 * q)
            value, target = p_qw, float(target_qw)
        elif tenant_breach and not ttft_breach:
            trigger = "tenant_ttft_ms_p95"
            value, target = tenant_p95, target_ttft
        elif pred_breach and not ttft_breach:
            trigger = "predicted_ttft_ms"
            value, target = pred_ttft, target_ttft
        else:
            trigger = "serve_ttft_ms_p%d" % round(100 * q)
            value, target = p_ttft, target_ttft
        if (breach and cur < auto["max_replicas"]
                and state.slo_breach_streak >= cycles
                and now - state.last_scale_up >= auto["upscale_delay_s"]):
            state.target_replicas = cur + 1
            state.last_scale_up = now
            state.slo_breach_streak = 0
            self._record_scale_event(state, cur, cur + 1, trigger, value, target)
        elif (clear and cur > auto["min_replicas"]
                and state.slo_ok_streak >= cycles
                and now - state.last_scale_down >= auto["downscale_delay_s"]):
            state.target_replicas = cur - 1
            state.last_scale_down = now
            state.slo_ok_streak = 0
            self._record_scale_event(
                state, cur, cur - 1, "serve_ttft_ms_p%d" % round(100 * q),
                p_ttft, target_ttft)

    # ------------------------------------------------------------- push/ckpt
    def _push_replica_table(self, state: _DeploymentState) -> None:
        table = [
            {
                "replica_id": r.replica_id,
                "actor_id": r.actor_id.hex(),
                "max_ongoing": state.config["max_ongoing"],
            }
            for r in state.replicas
            if r.state == RUNNING
        ]
        self._long_poll.notify_changed(f"replicas::{state.app_name}::{state.name}", table)

    def _push_tenancy(self, state: _DeploymentState) -> None:
        """Publish the deployment's tenant weights — and the folded
        retire-time cost-correction ratios — on the ``tenancy::``
        long-poll key so every router's weighted-fair queue uses the
        same shares the replicas' quota ledgers were configured with and
        scales its token-cost estimates by observed reality."""
        tcfg = (state.config.get("init_kwargs") or {}).get("tenancy_config")
        weights = {}
        if tcfg:
            try:
                from ..llm.tenancy import TenancyConfig

                cfg = TenancyConfig.from_dict(tcfg)
                weights = cfg.weights() if cfg is not None else {}
            except Exception:
                logger.warning("bad tenancy_config for %s", state.name)
        correction = {
            t: row["cost_correction"]
            for t, row in ((state.tenancy or {}).get("tenants") or {}).items()
            if row.get("cost_correction") is not None}
        self._long_poll.notify_changed(
            f"tenancy::{state.app_name}::{state.name}",
            {"weights": weights, "cost_correction": correction})

    def _push_routes(self) -> None:
        self._long_poll.notify_changed(
            "routes", [{"prefix": p, "app": a, "deployment": d} for p, (a, d) in self._routes.items()]
        )

    def _checkpoint(self) -> None:
        with self._lock:
            blob = cloudpickle.dumps({
                "routes": self._routes,
                "apps": {
                    app: {
                        name: {
                            "config": s.config,
                            "target": s.target_replicas,
                            "replicas": [
                                (r.replica_id, r.version, r.actor_id, r.state)
                                for r in s.replicas
                            ],
                            "next_no": s.next_replica_no,
                            "scaled_to_zero": s.scaled_to_zero,
                        }
                        for name, s in deps.items()
                    }
                    for app, deps in self._apps.items()
                },
            })
        try:
            ray.global_worker()._gcs_call("KvPut", {"key": CHECKPOINT_KEY, "value": blob, "overwrite": True})
        except Exception:
            pass

    def _recover(self) -> None:
        """Re-adopt replicas from the checkpoint after a controller restart
        (reference: controller recovers DeploymentStateManager from the
        checkpointed state)."""
        from ..core.api import ActorHandle

        try:
            reply = ray.global_worker()._gcs_call("KvGet", {"key": CHECKPOINT_KEY})
        except Exception:
            return
        if not reply.get("found"):
            return
        data = cloudpickle.loads(reply["value"])
        self._routes = data["routes"]
        for app, deps in data["apps"].items():
            self._apps[app] = {}
            for name, saved in deps.items():
                state = _DeploymentState(app, saved["config"])
                state.target_replicas = saved["target"]
                state.next_replica_no = saved["next_no"]
                # Older checkpoints predate the fleet fields — .get keeps
                # them adoptable.
                state.scaled_to_zero = bool(saved.get("scaled_to_zero"))
                for replica_id, version, actor_id, rstate in saved["replicas"]:
                    # STANDBY replicas are re-adopted too: their host-RAM
                    # weights and warm compile cache survive a controller
                    # restart (the replica actor never died).
                    if rstate not in (RUNNING, STANDBY):
                        continue
                    try:
                        handle = ActorHandle(actor_id)
                        r = _Replica(replica_id, version, handle, actor_id)
                        r.state = rstate
                        state.replicas.append(r)
                    except Exception:
                        pass
                self._apps[app][name] = state
                self._push_replica_table(state)
        self._push_routes()
        logger.info("serve controller recovered %d app(s) from checkpoint", len(self._apps))
