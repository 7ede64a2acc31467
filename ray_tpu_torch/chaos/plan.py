"""Seeded, declarative fault plans.

The port's own copy of ``ray_tpu/chaos/plan.py``. A :class:`FaultPlan` is
a list of fault rules (RPC drops/delays/failures per method, node-pair
partitions and GCS blackouts, worker kill-on-Nth-lease, spill-disk write
errors, object-store allocation failures, a compiled-loop stage killed at
its Nth tick). ``plan.compile(seed)`` turns it into a
:class:`FaultSchedule`: every probabilistic decision pre-drawn from a
per-rule RNG seeded by ``(seed, rule index, rule identity)`` into
explicit call indices. The same plan and seed compile to a byte-identical
schedule on every machine, and the engine consults only the schedule
(never a live RNG) at injection time. PyYAML is imported only when a plan
is read from a YAML path.
"""

from __future__ import annotations

import hashlib
import json
import random
import threading
from typing import Callable

from ..core.rpc import RpcChaos
from .clock import get_clock

# Fault kinds a plan may declare.
KIND_RPC = "rpc"                    # drop/fail/delay one RPC method
KIND_KILL_WORKER = "kill_worker"    # SIGKILL the worker of the Nth lease
KIND_SPILL_ERROR = "spill_error"    # fail a spill-file disk write
KIND_STORE_FULL = "store_full"      # fail an object-store allocation
KIND_PARTITION = "partition"        # block a peer address set for a window
KIND_GCS_BLACKOUT = "gcs_blackout"  # partition targeting the GCS endpoint
KIND_HTTP_INGRESS = "http_ingress"  # drop/delay at the serve HTTP proxy
KIND_KILL_LOOP = "kill_loop_stage"  # os._exit a loop stage at its Nth tick
KIND_PREEMPT = "preempt_slice"      # GCE preemption notice at a node's Nth tick
KIND_REPLICA_DELAY = "replica_delay"  # stall a serve replica's handles

_COUNTED_KINDS = (KIND_RPC, KIND_KILL_WORKER, KIND_SPILL_ERROR,
                  KIND_STORE_FULL, KIND_HTTP_INGRESS, KIND_KILL_LOOP,
                  KIND_PREEMPT, KIND_REPLICA_DELAY)
_WINDOW_KINDS = (KIND_PARTITION, KIND_GCS_BLACKOUT)

# How many future calls a probabilistic rule pre-draws decisions for.
DEFAULT_HORIZON = 4096


class FaultPlanError(ValueError):
    pass


class FaultPlan:
    """Declarative schedule of faults (YAML/dict), seed-compiled."""

    def __init__(self, name: str, faults: list[dict],
                 description: str = ""):
        self.name = name
        self.description = description
        self.faults = [dict(f) for f in faults]
        for i, fault in enumerate(self.faults):
            kind = fault.get("kind")
            if kind in (KIND_RPC, KIND_HTTP_INGRESS):
                if kind == KIND_RPC and not fault.get("method"):
                    raise FaultPlanError(f"faults[{i}]: rpc rule needs a method")
                where = fault.get("where", "request")
                if where not in ("request", "response", "client"):
                    raise FaultPlanError(
                        f"faults[{i}]: where must be request|response|client")
            elif kind == KIND_REPLICA_DELAY:
                if float(fault.get("delay_ms") or 0.0) <= 0:
                    raise FaultPlanError(
                        f"faults[{i}]: replica_delay needs delay_ms")
            elif kind in (KIND_KILL_WORKER, KIND_SPILL_ERROR, KIND_STORE_FULL,
                          KIND_KILL_LOOP, KIND_PREEMPT):
                pass
            elif kind in _WINDOW_KINDS:
                if float(fault.get("duration_s", 0)) <= 0:
                    raise FaultPlanError(f"faults[{i}]: window needs duration_s")
            else:
                raise FaultPlanError(f"faults[{i}]: unknown kind {kind!r}")

    # ------------------------------------------------------------- loading
    @classmethod
    def from_dict(cls, data: dict) -> "FaultPlan":
        return cls(name=data.get("name", "unnamed"),
                   faults=list(data.get("faults") or []),
                   description=data.get("description", ""))

    @classmethod
    def from_yaml(cls, path: str) -> "FaultPlan":
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f) or {})

    def to_dict(self) -> dict:
        return {"name": self.name, "description": self.description,
                "faults": [dict(f) for f in self.faults]}

    # ------------------------------------------------------------ compiling
    def compile(self, seed: int = 0,
                horizon: int = DEFAULT_HORIZON) -> "FaultSchedule":
        """Pre-draw every probabilistic decision into explicit call
        indices. Deterministic: same plan + seed -> byte-identical
        schedule (``FaultSchedule.canonical_bytes()``)."""
        rules = []
        for i, fault in enumerate(self.faults):
            rule = dict(fault)
            kind = rule["kind"]
            if kind in _COUNTED_KINDS:
                nth = int(rule.get("nth") or rule.get("nth_lease") or 0)
                prob = float(rule.get("prob") or 0.0)
                cap = int(rule.get("max_injections") or 0)
                if nth:
                    rule["nth"] = nth
                elif prob:
                    rng = random.Random(
                        f"{seed}:{i}:{kind}:{rule.get('method', '')}:"
                        f"{rule.get('where', '')}")
                    indices = [k for k in range(1, horizon + 1)
                               if rng.random() < prob]
                    if cap:
                        indices = indices[:cap]
                    rule["indices"] = indices
                elif not float(rule.get("delay_ms") or 0.0):
                    raise FaultPlanError(
                        f"faults[{i}]: needs nth, prob, or delay_ms")
            rules.append(rule)
        return FaultSchedule(self.to_dict(), seed, rules)


class FaultSchedule:
    """A compiled plan: the full fault timetable, independent of runtime."""

    def __init__(self, plan: dict, seed: int, rules: list[dict]):
        self.plan = plan
        self.seed = seed
        self.rules = rules

    def to_dict(self) -> dict:
        return {"plan": self.plan, "seed": self.seed, "rules": self.rules}

    def canonical_bytes(self) -> bytes:
        """Canonical serialization — the byte-identical artifact two runs
        of ``cli chaos run <plan> --seed N`` must agree on."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":")).encode()

    def digest(self) -> str:
        return hashlib.sha1(self.canonical_bytes()).hexdigest()[:16]


class PlanChaos(RpcChaos):
    """Chaos engine driven by a compiled :class:`FaultSchedule`.

    Installed process-wide via ``core.rpc.set_chaos``; the RPC layer,
    raylet, object store, and serve proxy consult it at their injection
    points. All decisions are schedule lookups on per-rule call counters
    — no RNG at runtime — so a replay with the same call sequence injects
    the same faults.
    """

    def __init__(self, schedule: FaultSchedule,
                 publish: Callable[[str, str, str], None] | None = None,
                 partition_peers: dict[int, list[str]] | None = None):
        super().__init__("", seed=schedule.seed)
        self.schedule = schedule
        self._publish = publish
        self._counts: dict[int, int] = {}
        self._index_sets: dict[int, frozenset] = {
            idx: frozenset(rule.get("indices") or ())
            for idx, rule in enumerate(schedule.rules)}
        self._plock = threading.Lock()
        self._installed_at = get_clock().now()
        # rule index -> resolved peer addresses (partitions/blackouts);
        # filled by the runner, which knows the live cluster topology.
        self._partition_peers = dict(partition_peers or {})
        self.injection_log: list[dict] = []

    # ------------------------------------------------------------ internals
    def _fire(self, idx: int, rule: dict, kind: str, detail: str) -> None:
        method = rule.get("method", "") or rule.get("kind", "")
        self.record_injection(kind, method)
        with self._plock:
            if len(self.injection_log) < 1000:
                self.injection_log.append(
                    {"rule": idx, "kind": kind, "method": method,
                     "detail": detail})
        if self._publish is not None:
            try:
                self._publish(kind, method, detail)
            except Exception:
                pass

    def _take(self, idx: int, rule: dict) -> bool:
        """Advance rule ``idx``'s call counter; True if this call index is
        in the compiled schedule (and under the injection cap)."""
        with self._plock:
            n = self._counts.get(idx, 0) + 1
            self._counts[idx] = n
            cap = int(rule.get("max_injections") or 0)
            fired = self._fired_count(idx)
            if cap and fired >= cap:
                return False
            if rule.get("nth"):
                return n % int(rule["nth"]) == 0
            return n in self._index_sets.get(idx, frozenset())

    def _fired_count(self, idx: int) -> int:
        return sum(1 for e in self.injection_log if e["rule"] == idx)

    def _matching(self, kind: str, method: str = "", where: str = "",
                  tag: str = ""):
        for idx, rule in enumerate(self.schedule.rules):
            if rule["kind"] != kind:
                continue
            if kind in (KIND_RPC,):
                if rule.get("method") not in ("*", method):
                    continue
                if (rule.get("where", "request")) != where:
                    continue
                if rule.get("tag") and rule["tag"] != tag:
                    continue
            yield idx, rule

    # ------------------------------------------------------- decision hooks
    def should_fail_request(self, method: str, tag: str = "") -> bool:
        for idx, rule in self._matching(KIND_RPC, method, "request", tag):
            if not float(rule.get("delay_ms") or 0.0) and self._take(idx, rule):
                self._fire(idx, rule, "rpc_request_drop", method)
                return True
        return False

    def should_fail_response(self, method: str, tag: str = "") -> bool:
        for idx, rule in self._matching(KIND_RPC, method, "response", tag):
            if self._take(idx, rule):
                self._fire(idx, rule, "rpc_response_drop", method)
                return True
        return False

    def should_drop_client_send(self, method: str) -> bool:
        for idx, rule in self._matching(KIND_RPC, method, "client"):
            if self._take(idx, rule):
                self._fire(idx, rule, "rpc_client_drop", method)
                return True
        return False

    def request_delay_s(self, method: str, tag: str = "") -> float:
        for idx, rule in self._matching(KIND_RPC, method, "request", tag):
            delay_ms = float(rule.get("delay_ms") or 0.0)
            if delay_ms and self._take(idx, rule):
                self._fire(idx, rule, "rpc_delay", method)
                return delay_ms / 1000.0
        return 0.0

    def _window_active(self, rule: dict) -> bool:
        now = get_clock().now() - self._installed_at
        start = float(rule.get("start_s") or 0.0)
        return start <= now < start + float(rule["duration_s"])

    def peer_blocked(self, address: str) -> bool:
        for idx, rule in enumerate(self.schedule.rules):
            if rule["kind"] not in _WINDOW_KINDS:
                continue
            if not self._window_active(rule):
                continue
            peers = self._partition_peers.get(idx) or []
            if address in peers:
                kind = ("gcs_blackout" if rule["kind"] == KIND_GCS_BLACKOUT
                        else "partition")
                self._fire(idx, rule, kind, address)
                return True
        return False

    def take_kill_on_lease(self, node_id: str = "") -> bool:
        for idx, rule in self._matching(KIND_KILL_WORKER):
            if rule.get("node") and not node_id.startswith(rule["node"]):
                continue
            if self._take(idx, rule):
                self._fire(idx, rule, "kill_worker", node_id[:12])
                return True
        return False

    def take_kill_loop_tick(self) -> bool:
        """One compiled-loop stage tick in this process: die here? The
        tick index is the deterministic coordinate (``nth``-style rules
        fire at exactly the Nth tick the schedule pre-drew)."""
        for idx, rule in self._matching(KIND_KILL_LOOP):
            if self._take(idx, rule):
                self._fire(idx, rule, "kill_loop_stage", "")
                return True
        return False

    def take_preempt_slice(self, node_id: str = "") -> bool:
        """One heartbeat tick on ``node_id``: does the GCE-style
        preemption notice land here now? Rules target a node-id prefix
        (``node``) or a runner-resolved ``target: node:<i>`` (i-th alive
        node at install time); a targeted rule whose target did not
        resolve never fires — so the bundled plan is a safe no-op on a
        cluster too small to have the targeted node. Only MATCHING ticks
        advance the rule counter, so ``nth`` is deterministic per
        targeted node regardless of how many raylets share the engine."""
        for idx, rule in self._matching(KIND_PREEMPT):
            if rule.get("node"):
                if not node_id.startswith(rule["node"]):
                    continue
            elif rule.get("target"):
                targets = self._partition_peers.get(idx) or []
                if not any(node_id.startswith(t) for t in targets):
                    continue
            if self._take(idx, rule):
                self._fire(idx, rule, "preempt_slice", node_id[:12])
                return True
        return False

    def replica_delay_s(self, replica_id: str = "") -> float:
        """One serve-replica handle in this process: how long to stall
        it. Rules target a replica-id prefix (``replica``, e.g.
        "app#dep#2") or every replica when absent; ``nth: 1`` stalls
        every handle — the deterministic stand-in for a replica gone
        slow (the overload plan's delayed-replica fault)."""
        for idx, rule in self._matching(KIND_REPLICA_DELAY):
            if rule.get("replica") and \
                    not replica_id.startswith(rule["replica"]):
                continue
            if self._take(idx, rule):
                self._fire(idx, rule, "replica_delay", replica_id[:32])
                return float(rule.get("delay_ms") or 0.0) / 1000.0
        return 0.0

    def maybe_fail_spill(self) -> bool:
        for idx, rule in self._matching(KIND_SPILL_ERROR):
            if self._take(idx, rule):
                self._fire(idx, rule, "spill_error", "")
                return True
        return False

    def maybe_fail_store_create(self) -> bool:
        for idx, rule in self._matching(KIND_STORE_FULL):
            if self._take(idx, rule):
                self._fire(idx, rule, "store_full", "")
                return True
        return False

    def http_ingress_fault(self) -> tuple[bool, float]:
        """(drop?, delay_s) for one serve HTTP request."""
        drop, delay = False, 0.0
        for idx, rule in self._matching(KIND_HTTP_INGRESS):
            if self._take(idx, rule):
                delay_ms = float(rule.get("delay_ms") or 0.0)
                if delay_ms:
                    delay = delay_ms / 1000.0
                    self._fire(idx, rule, "http_delay", "http.ingress")
                else:
                    drop = True
                    self._fire(idx, rule, "http_drop", "http.ingress")
        return drop, delay


# Bundled plans: each must end RecoveryVerifier-green (tests/test_chaos.py
# runs the fast ones tier-1; the sweep exercises them across seeds).
BUILTIN_PLANS: dict[str, dict] = {
    "lease-reply-drop": {
        "name": "lease-reply-drop",
        "description": "Drop every 2nd RequestWorkerLease reply (the "
                       "ROADMAP-1c cascade trigger); owners must retry and "
                       "the raylet must reclaim the orphaned grants.",
        "faults": [
            {"kind": "rpc", "method": "RequestWorkerLease",
             "where": "response", "nth": 2, "max_injections": 4},
        ],
    },
    "push-client-drop": {
        "name": "push-client-drop",
        "description": "Drop task pushes on the owner side before they "
                       "reach the worker; task retries must succeed.",
        "faults": [
            {"kind": "rpc", "method": "PushTask", "where": "client",
             "nth": 2, "max_injections": 3},
        ],
    },
    "worker-kill": {
        "name": "worker-kill",
        "description": "SIGKILL the worker of the 1st lease; the owner "
                       "retries on a fresh worker.",
        "faults": [
            {"kind": "kill_worker", "nth_lease": 1, "max_injections": 1},
        ],
    },
    "spill-disk-error": {
        "name": "spill-disk-error",
        "description": "Fail the first 2 spill-file writes; objects must "
                       "stay restorable from the pending-write buffer.",
        "faults": [
            {"kind": "spill_error", "nth": 1, "max_injections": 2},
        ],
    },
    "gcs-blackout": {
        "name": "gcs-blackout",
        "description": "Black out the GCS endpoint for 2s; clients must "
                       "ride it out on retry backoff and reconnect.",
        "faults": [
            {"kind": "gcs_blackout", "start_s": 0.0, "duration_s": 2.0},
        ],
    },
    "slice-preempt": {
        "name": "slice-preempt",
        "description": "GCE-style preemption notice on the 2nd alive node "
                       "at its 2nd heartbeat tick: the raylet drains, the "
                       "GCS publishes node_preempted, and work re-routes "
                       "to survivors. No-ops when the targeted node does "
                       "not exist (single-node clusters).",
        "faults": [
            {"kind": "preempt_slice", "nth": 2, "max_injections": 1,
             "target": "node:1"},
        ],
    },
    "overload-storm": {
        "name": "overload-storm",
        "description": "Overload chaos: every handle on replica #2 of "
                       "the targeted deployment stalls 400 ms (a replica "
                       "gone slow under a thundering herd). Driven with "
                       "a deterministic burst arrival schedule + request "
                       "deadlines, the system must shed/expire honestly "
                       "and drain back to a verifier-green state with "
                       "page-pool refcounts at baseline.",
        "faults": [
            {"kind": "replica_delay", "replica": "overload#LLMDeployment#2",
             "nth": 1, "delay_ms": 400},
        ],
    },
    "actor-storm": {
        "name": "actor-storm",
        "description": "Actor-creation storm chaos: while a storm drives "
                       "hundreds of dedicated leases, SIGKILL the worker "
                       "of every 40th lease (3x) and deliver a GCE-style "
                       "preemption notice to the 2nd alive node mid-storm."
                       " Actor restarts must absorb the kills, survivors "
                       "must re-place off the draining node, and the "
                       "zygote pools must drain/refill to baseline. "
                       "No-ops the preempt rule on single-node clusters.",
        "faults": [
            {"kind": "kill_worker", "nth_lease": 40, "max_injections": 3},
            {"kind": "preempt_slice", "nth": 3, "max_injections": 1,
             "target": "node:1"},
        ],
    },
    "mixed-seeded": {
        "name": "mixed-seeded",
        "description": "Seeded probabilistic mix for randomized sweeps: "
                       "lease-reply drops + push drops + a worker kill.",
        "faults": [
            {"kind": "rpc", "method": "RequestWorkerLease",
             "where": "response", "prob": 0.3, "max_injections": 3},
            {"kind": "rpc", "method": "PushTask", "where": "client",
             "prob": 0.2, "max_injections": 3},
            {"kind": "kill_worker", "nth_lease": 3, "max_injections": 1},
        ],
    },
}


def load_plan(plan: "FaultPlan | dict | str") -> FaultPlan:
    """Accept a FaultPlan, a plan dict, a builtin plan name, or a path to
    a YAML file."""
    if isinstance(plan, FaultPlan):
        return plan
    if isinstance(plan, dict):
        return FaultPlan.from_dict(plan)
    if plan in BUILTIN_PLANS:
        return FaultPlan.from_dict(BUILTIN_PLANS[plan])
    return FaultPlan.from_yaml(plan)
