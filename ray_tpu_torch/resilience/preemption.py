"""Preemption-notice plumbing: the hazard view consumers share.

A preemption flows through the cluster as:

  raylet (GCE notice / ``preempt_slice`` chaos rule / PreemptionNotice
  RPC) -> draining: stops admitting leases, flushes task events, reports
  ``ReportNodeDraining`` -> the GCS flags the node ``draining`` in the
  node table AND publishes a ``node_preempted`` ErrorEvent -> after the
  grace window the raylet kills its workers and the GCS marks the node
  DEAD (``NodePreempted``).

:func:`hazard_nodes` merges both signals (table flags + error events)
into one ``node_id -> PreemptionNotice`` view. The serve controller uses
it to evict replicas proactively; the recovery bench uses the notice
clocks to measure ``recovery_*_s`` SLOs. Clocks are chaos-clock stamps
(:mod:`ray_tpu.chaos.clock`), so a VirtualClock run measures virtual
seconds.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..chaos import clock as chaos_clock


@dataclass
class PreemptionNotice:
    node_id: str
    reason: str = ""
    notice_clock: float = 0.0  # chaos-clock stamp at the notice
    state: str = "DRAINING"    # DRAINING while in grace, DEAD after


def hazard_nodes(gcs_call) -> dict[str, PreemptionNotice]:
    """``node_id -> PreemptionNotice`` for every node that is draining,
    preempted-dead, or named in a ``node_preempted`` ErrorEvent.

    ``gcs_call(method, payload) -> dict`` is a synchronous GCS RPC (the
    worker's ``_gcs_call``). Never raises — an unreachable control plane
    yields an empty view, not a new failure.
    """
    out: dict[str, PreemptionNotice] = {}
    try:
        for node in gcs_call("GetAllNodes", {}).get("nodes", []):
            nid = node.get("node_id") or ""
            if not nid:
                continue
            if node.get("draining"):
                out[nid] = PreemptionNotice(
                    node_id=nid,
                    reason=node.get("drain_reason") or "",
                    notice_clock=float(node.get("drain_notice_clock")
                                       or chaos_clock.now()),
                    state="DEAD" if node.get("state") == "DEAD" else "DRAINING",
                )
    except Exception:
        return out
    try:
        reply = gcs_call("ListErrors", {"type": "node_preempted", "limit": 1000})
        for event in reply.get("errors", []):
            nid = event.get("node_id") or ""
            if not nid or nid in out:
                continue
            extra = event.get("extra") or {}
            out[nid] = PreemptionNotice(
                node_id=nid,
                reason=extra.get("reason") or "",
                notice_clock=float(extra.get("notice_clock") or chaos_clock.now()),
            )
    except Exception:
        pass
    return out
