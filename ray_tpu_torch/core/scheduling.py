"""Scheduling policies: node selection for tasks, actors, placement groups.

Equivalent of the reference's ``src/ray/raylet/scheduling/policy/``:

  * hybrid (default)   — pack onto the best already-utilized feasible node
                         until its score exceeds the spread threshold, then
                         prefer the least-utilized (hybrid_scheduling_policy.cc)
  * spread             — round-robin over feasible nodes
  * node-affinity      — pin to a node (soft/hard)
  * node-label         — filter by labels then hybrid
  * placement-group bundles — PACK / SPREAD / STRICT_PACK / STRICT_SPREAD
                         (bundle_scheduling_policy.cc)

Node views are the GCS node table dicts: {node_id, resources: {total,
available, labels}, state}.
"""

from __future__ import annotations

import random

from .config import get_config
from .resources import NodeResources, ResourceSet

_spread_counter = 0


def _feasible(nodes: dict, request: ResourceSet, labels: dict | None = None) -> list[tuple[str, NodeResources]]:
    out = []
    for node_id, node in nodes.items():
        if node.get("state") != "ALIVE" or node.get("draining"):
            # Draining nodes (preemption notice) are capacity that is
            # about to vanish — never schedule new work onto them.
            continue
        nr = NodeResources.from_dict(node["resources"])
        if labels and not all(nr.labels.get(k) == v for k, v in labels.items()):
            continue
        if request.subset_of(nr.total):
            out.append((node_id, nr))
    return out


def select_node_for_resources(nodes: dict, resources: dict, strategy: dict) -> str | None:
    """Pick a node for one task/actor. Returns node_id hex or None."""
    request = ResourceSet(resources)
    kind = strategy.get("type", "hybrid")

    if kind == "node_affinity":
        target = strategy["node_id"]
        node = nodes.get(target)
        if node and node.get("state") == "ALIVE":
            nr = NodeResources.from_dict(node["resources"])
            if request.subset_of(nr.total):
                return target
        if strategy.get("soft"):
            kind = "hybrid"
        else:
            return None

    labels = strategy.get("labels") or {}
    feasible = _feasible(nodes, request, labels)
    if not feasible:
        return None
    available = [(nid, nr) for nid, nr in feasible if nr.can_fit(request)]

    if kind == "spread":
        global _spread_counter
        pool = available or feasible
        _spread_counter += 1
        return pool[_spread_counter % len(pool)][0]

    # hybrid: among nodes with capacity, prefer the highest-utilization node
    # whose score stays under the threshold (pack); otherwise least utilized
    # (spread). Reference: hybrid_scheduling_policy.cc.
    threshold = get_config().scheduler_spread_threshold
    if available:
        under = [(nid, nr) for nid, nr in available if nr.utilization() < threshold]
        if under:
            return max(under, key=lambda x: (x[1].utilization(), x[0]))[0]
        return min(available, key=lambda x: (x[1].utilization(), x[0]))[0]
    # No capacity now but feasible: queue on the least loaded feasible node.
    return min(feasible, key=lambda x: (x[1].utilization(), x[0]))[0]


def schedule_placement_group(
    nodes: dict, bundles: list[dict], strategy: str, use_total: bool = False
) -> list[str] | None:
    """Map each bundle to a node id. Returns per-bundle node list or None.

    ``use_total=True`` checks against node TOTAL resources (feasibility:
    could this ever be placed on an empty cluster?) rather than currently
    available ones. Reference: bundle_scheduling_policy.cc.
    """
    alive = {
        nid: NodeResources.from_dict(n["resources"])
        for nid, n in nodes.items()
        if n.get("state") == "ALIVE" and not n.get("draining")
    }
    if use_total:
        for nr in alive.values():
            # acquire() rebinds `available` rather than mutating, so sharing
            # the total ResourceSet here is safe.
            nr.available = nr.total
    if not alive:
        return None
    requests = [ResourceSet(b) for b in bundles]

    if strategy == "STRICT_PACK":
        # All bundles on one node (e.g. one TPU slice host group).
        total = ResourceSet()
        for r in requests:
            total = total.add(r)
        candidates = [nid for nid, nr in alive.items() if nr.can_fit(total)]
        if not candidates:
            return None
        return [candidates[0]] * len(bundles)

    if strategy == "STRICT_SPREAD":
        placement: list[str] = []
        used: set[str] = set()
        for r in requests:
            pick = None
            for nid, nr in sorted(alive.items(), key=lambda x: x[1].utilization()):
                if nid not in used and nr.can_fit(r):
                    pick = nid
                    break
            if pick is None:
                return None
            used.add(pick)
            alive[pick].acquire(r)
            placement.append(pick)
        return placement

    # PACK (best effort pack) / SPREAD (best effort spread).
    placement = []
    order = sorted(alive.items(), key=lambda x: x[1].utilization(), reverse=(strategy == "PACK"))
    for r in requests:
        pick = None
        nodes_sorted = sorted(
            alive.items(),
            key=lambda x: x[1].utilization(),
            reverse=(strategy == "PACK"),
        )
        for nid, nr in nodes_sorted:
            if nr.can_fit(r):
                pick = nid
                break
        if pick is None:
            return None
        alive[pick].acquire(r)
        placement.append(pick)
    return placement
