"""Chaos runner: install a compiled fault schedule, drive a workload,
then verify recovery.

``run_plan(plan, seed=N)`` is the one-call form, surfaced as
``ray_tpu_torch.chaos.run_plan()``. While a plan is installed its
identity is registered in the GCS KV (``chaos:active_plan``), so every
client can tell injected pain from real pain. A train loop's
``stage_init_hook`` installs a ``kill_loop_stage`` plan with
:func:`install` inside its step stage. Partition and preemption targets
resolve through ``util.state``.
"""

from __future__ import annotations

import json
import logging
import time

from ..core.rpc import set_chaos
from .plan import FaultSchedule, PlanChaos, load_plan
from .verifier import RecoveryVerifier

logger = logging.getLogger(__name__)

ACTIVE_PLAN_KEY = "chaos:active_plan"


def _resolve_partition_peers(schedule: FaultSchedule) -> dict[int, list[str]]:
    """Resolve window/targeted rules' abstract targets into live
    identities. ``gcs_blackout`` / ``target: gcs`` -> the GCS endpoint;
    ``target: node:<i>`` -> the i-th alive raylet (its ADDRESS for
    partitions, its NODE ID for ``preempt_slice``); explicit ``peers``
    lists pass through. A target that does not resolve stays absent —
    the rule then never fires (safe no-op on too-small clusters)."""
    from ..core.worker import global_worker

    peers: dict[int, list[str]] = {}
    nodes = None

    def _alive_nodes():
        nonlocal nodes
        if nodes is None:
            from ..util import state

            nodes = [n for n in state.list_nodes() if n["state"] == "ALIVE"]
        return nodes

    for idx, rule in enumerate(schedule.rules):
        if rule["kind"] == "gcs_blackout" or rule.get("target") == "gcs":
            peers[idx] = [global_worker().gcs_address]
        elif rule["kind"] == "partition":
            if rule.get("peers"):
                peers[idx] = list(rule["peers"])
            elif str(rule.get("target", "")).startswith("node:"):
                i = int(rule["target"].split(":", 1)[1])
                if i < len(_alive_nodes()):
                    peers[idx] = [_alive_nodes()[i]["address"]]
        elif rule["kind"] == "preempt_slice":
            if str(rule.get("target", "")).startswith("node:"):
                i = int(rule["target"].split(":", 1)[1])
                if i < len(_alive_nodes()):
                    peers[idx] = [_alive_nodes()[i]["node_id"]]
    return peers


def _publish_injection(plan_name: str, seed: int):
    """Build the per-injection ErrorEvent publisher: every injected fault
    lands on the diagnostics channel tagged ``chaos`` so ``list_errors()``
    and traces can separate it from organic failures."""
    from ..diagnostics.errors import publish_error_to_driver

    seen_windows: set[tuple] = set()
    published = [0]

    def publish(kind: str, method: str, detail: str) -> None:
        # Window faults (partitions/blackouts) publish ONCE per rule: the
        # publish RPC itself crosses the blocked endpoint, and a
        # per-blocked-call event would recurse — each suppressed call
        # still counts in the metric and the injection log.
        if kind in ("gcs_blackout", "partition"):
            if (kind, method) in seen_windows:
                return
            seen_windows.add((kind, method))
        if published[0] >= 200:
            return  # bounded: chaos must not flood the error channel
        published[0] += 1
        publish_error_to_driver(
            "chaos_injection",
            f"chaos[{plan_name}#{seed}]: injected {kind}"
            + (f" on {method}" if method else "")
            + (f" ({detail})" if detail else ""),
            source="chaos",
            extra={"chaos": True, "plan": plan_name, "seed": seed,
                   "kind": kind, "method": method})

    return publish


def install(plan, seed: int = 0, publish: bool = True) -> PlanChaos:
    """Compile + install ``plan`` as this process's chaos engine and
    register it in the GCS KV. Returns the live engine."""
    plan = load_plan(plan)
    schedule = plan.compile(seed)
    engine = PlanChaos(
        schedule,
        publish=_publish_injection(plan.name, seed) if publish else None,
        partition_peers=_resolve_partition_peers(schedule))
    set_chaos(engine)
    try:
        from ..core.worker import global_worker

        global_worker()._gcs_call("KvPut", {
            "key": ACTIVE_PLAN_KEY,
            "value": json.dumps({
                "name": plan.name, "seed": seed,
                "digest": schedule.digest(),
                "installed_at": time.time(),
            }).encode()})
    except Exception:
        pass  # no cluster (schedule-only use): engine still installs
    logger.warning("chaos: installed plan %r seed=%d digest=%s",
                   plan.name, seed, schedule.digest())
    return engine


def uninstall() -> None:
    """Remove the installed plan (reverts to the env-spec chaos, if any)."""
    set_chaos(None)
    try:
        from ..core.worker import global_worker

        global_worker()._gcs_call("KvDel", {"key": ACTIVE_PLAN_KEY})
    except Exception:
        pass


def active_plan() -> dict | None:
    """The cluster's registered FaultPlan, if one is installed (readable
    from any connected client — powers the ``cli doctor`` banner)."""
    try:
        from ..core.worker import global_worker

        reply = global_worker()._gcs_call("KvGet", {"key": ACTIVE_PLAN_KEY})
        if reply.get("found"):
            return json.loads(reply["value"])
    except Exception:
        pass
    return None


def default_workload() -> dict:
    """A small task workload exercising retry, plasma, and lineage paths
    under fault: used when ``run_plan`` is not given a workload."""
    import ray_tpu_torch

    @ray_tpu_torch.remote(max_retries=5)
    def _chaos_probe(i):
        return i * i

    @ray_tpu_torch.remote(max_retries=5)
    def _chaos_blob(_i):
        import numpy as np

        return np.zeros(64 * 1024, dtype=np.float32)  # plasma-sized

    refs = [_chaos_probe.remote(i) for i in range(8)]
    refs += [_chaos_blob.remote(i) for i in range(2)]
    ok, failures = 0, 0
    for ref in refs:
        try:
            ray_tpu_torch.get(ref, timeout=120)
            ok += 1
        except Exception:
            failures += 1
    del refs
    return {"tasks": ok + failures, "ok": ok, "failures": failures}


def run_plan(plan, seed: int = 0, workload=None, verify: bool = True,
             verify_timeout_s: float = 60.0,
             allowed_error_types=()) -> dict:
    """Run one seeded chaos scenario end to end:

    1. snapshot the verifier baseline,
    2. compile + install the plan's fault schedule,
    3. drive the workload (default: :func:`default_workload`),
    4. uninstall the plan,
    5. verify recovery (tasks terminal, lease queues drained, refcounts
       back to baseline, no orphaned errors).

    Returns the chaos report; raises ``ChaosVerificationError`` when
    ``verify=True`` and an invariant fails.
    """
    plan = load_plan(plan)
    schedule = plan.compile(seed)
    verifier = RecoveryVerifier(timeout_s=verify_timeout_s,
                                allowed_error_types=allowed_error_types)
    baseline = verifier.snapshot_baseline()
    engine = install(plan, seed)
    try:
        workload_report = (workload or default_workload)()
    finally:
        uninstall()
    report = {
        "plan": plan.name,
        "seed": seed,
        "schedule_digest": schedule.digest(),
        "injections": {f"{k}:{m}" if m else k: n
                       for (k, m), n in engine.injections_total.items()},
        "injection_log": list(engine.injection_log),
        "workload": workload_report,
    }
    if verify:
        result = verifier.verify(baseline)
        report["verify"] = {"ok": result.ok, "checks": result.checks,
                            "violations": result.violations}
        result.raise_if_failed()
    return report
