"""Installing a compiled fault schedule in a process.

The part of ``ray_tpu/chaos/runner.py`` that the port has: ``install``,
``uninstall`` and ``active_plan``. While a plan is installed its identity
is registered in the GCS KV (``chaos:active_plan``), so every client can
tell injected pain from real pain. A train loop's ``stage_init_hook``
installs a ``kill_loop_stage`` plan this way inside its step stage.
"""

from __future__ import annotations

import json
import logging
import time

from ..core.rpc import set_chaos
from .plan import FaultSchedule, PlanChaos, load_plan

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
            from ..core import api

            nodes = [n for n in api.nodes() if n["state"] == "ALIVE"]
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
