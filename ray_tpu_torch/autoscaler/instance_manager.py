"""Typed instance lifecycle + stuck-instance reconciliation (autoscaler v2).

Equivalent of the reference's ``python/ray/autoscaler/v2/instance_manager/``
(``common.py`` InstanceUtil state machine, ``reconciler.py``
``_handle_stuck_instances``): every cloud node the autoscaler manages is a
typed ``Instance`` moving through an explicit FSM

    QUEUED -> REQUESTED -> ALLOCATED -> RAY_RUNNING
                 |              |            |
                 v              v            v
        ALLOCATION_FAILED   TERMINATING -> TERMINATED

with per-state timestamps, validated transitions, bounded allocation
retries, and a reconcile pass that repairs stuck instances: requests the
cloud never fulfilled, nodes whose raylet never registered, and
terminations the cloud ignored. The v1-style dict provider "knows" none
of this — these are exactly the lifecycle edge cases the v2 model exists
for.

``InstanceManager`` duck-types ``NodeProvider`` (create/terminate/list/
node_id_of), so ``Autoscaler(provider=InstanceManager(real_provider))``
gains the lifecycle without changes.

The port of ``ray_tpu/autoscaler/instance_manager.py``; the state
machine is accelerator-neutral.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from dataclasses import dataclass, field

logger = logging.getLogger(__name__)

# ------------------------------------------------------------------ states
QUEUED = "QUEUED"                        # decided, not yet asked of the cloud
REQUESTED = "REQUESTED"                  # create_node issued
ALLOCATED = "ALLOCATED"                  # cloud lists the node
RAY_RUNNING = "RAY_RUNNING"              # raylet registered with the GCS
TERMINATING = "TERMINATING"              # terminate_node issued
TERMINATED = "TERMINATED"                # gone from the cloud listing
ALLOCATION_FAILED = "ALLOCATION_FAILED"  # create failed / timed out

_TRANSITIONS: dict[str, set[str]] = {
    QUEUED: {REQUESTED, TERMINATED},
    REQUESTED: {ALLOCATED, RAY_RUNNING, ALLOCATION_FAILED, QUEUED, TERMINATING},
    ALLOCATED: {RAY_RUNNING, TERMINATING, TERMINATED},
    RAY_RUNNING: {TERMINATING, TERMINATED},
    TERMINATING: {TERMINATED},
    TERMINATED: set(),
    ALLOCATION_FAILED: {QUEUED, TERMINATED},
}


@dataclass
class Instance:
    instance_id: str                 # manager-scoped id
    node_type: str
    state: str = QUEUED
    cloud_instance_id: str = ""      # provider id once REQUESTED
    node_id: str = ""                # GCS node id once RAY_RUNNING
    retries: int = 0
    resources: dict = field(default_factory=dict)  # shape for retries
    history: list = field(default_factory=list)  # [(state, ts)]

    def __post_init__(self):
        if not self.history:
            self.history = [(self.state, time.time())]

    def since(self) -> float:
        """Seconds in the current state."""
        return time.time() - self.history[-1][1]


class InvalidTransition(RuntimeError):
    pass


class InstanceManager:
    """Typed lifecycle around a ``NodeProvider``; also IS a NodeProvider."""

    def __init__(
        self,
        provider,
        *,
        request_timeout_s: float = 300.0,
        ray_boot_timeout_s: float = 600.0,
        terminate_timeout_s: float = 300.0,
        max_allocation_retries: int = 3,
        replace_preempted: bool = True,
    ):
        self.provider = provider
        self.request_timeout_s = request_timeout_s
        self.ray_boot_timeout_s = ray_boot_timeout_s
        self.terminate_timeout_s = terminate_timeout_s
        self.max_allocation_retries = max_allocation_retries
        # Spot preemption handling: providers that surface
        # ``preemption_notices()`` (GCE spot reclaim, the local harness)
        # get their preempted instances terminated AND replaced with a
        # same-shape launch in the same reconcile round.
        self.replace_preempted = replace_preempted
        self._lock = threading.Lock()
        self._instances: dict[str, Instance] = {}
        self._by_cloud_id: dict[str, str] = {}
        self._counter = itertools.count(1)
        # GCS nodes alive before we managed anything (the head, manually
        # started nodes): never claimable by _match_gcs.
        self._preexisting: set[str] | None = None

    # ----------------------------------------------------------- transitions
    def _transition(self, inst: Instance, to: str) -> None:
        if to not in _TRANSITIONS[inst.state]:
            raise InvalidTransition(f"{inst.instance_id}: {inst.state} -> {to}")
        logger.info("instance %s (%s): %s -> %s",
                    inst.instance_id, inst.node_type, inst.state, to)
        inst.state = to
        inst.history.append((to, time.time()))

    # -------------------------------------------------- NodeProvider surface
    def create_node(self, node_type: str, resources: dict) -> str:
        """QUEUED -> REQUESTED immediately (the queue exists so retries and
        reconcile-driven launches share one path)."""
        with self._lock:
            inst = Instance(f"inst-{next(self._counter)}", node_type,
                            resources=dict(resources or {}))
            self._instances[inst.instance_id] = inst
            self._request_locked(inst, inst.resources)
            return inst.cloud_instance_id or inst.instance_id

    def _request_locked(self, inst: Instance, resources: dict) -> None:
        self._transition(inst, REQUESTED)
        try:
            cloud_id = self.provider.create_node(inst.node_type, resources)
        except Exception as e:
            logger.warning("allocation of %s failed: %s", inst.instance_id, e)
            self._transition(inst, ALLOCATION_FAILED)
            return
        inst.cloud_instance_id = cloud_id
        self._by_cloud_id[cloud_id] = inst.instance_id

    def terminate_node(self, instance_id: str) -> None:
        with self._lock:
            iid = self._by_cloud_id.get(instance_id, instance_id)
            inst = self._instances.get(iid)
            if inst is None or inst.state in (TERMINATING, TERMINATED):
                return
            self._transition(inst, TERMINATING)
        try:
            self.provider.terminate_node(inst.cloud_instance_id or instance_id)
        except Exception as e:
            logger.warning("terminate of %s failed (reconcile will retry): %s",
                           inst.instance_id, e)

    def non_terminated_nodes(self) -> dict[str, str]:
        return self.provider.non_terminated_nodes()

    def node_id_of(self, instance_id: str) -> str | None:
        with self._lock:
            iid = self._by_cloud_id.get(instance_id, instance_id)
            inst = self._instances.get(iid)
            if inst is not None and inst.node_id:
                return inst.node_id
        return self.provider.node_id_of(instance_id)

    # ------------------------------------------------------------- reconcile
    def reconcile(self, gcs_nodes: list[dict] | None = None) -> dict[str, int]:
        """One reconciliation round: sync states with the cloud listing and
        the GCS node table, then repair stuck instances. Returns a count of
        repairs by kind (observability + tests)."""
        listing = self.provider.non_terminated_nodes()
        alive = {}
        for n in gcs_nodes or []:
            if n.get("state") == "ALIVE":
                alive[n["node_id"]] = n
        if self._preexisting is None:
            self._preexisting = set(alive)
        repairs = {"allocation_retried": 0, "allocation_failed": 0,
                   "ray_boot_timeout": 0, "terminate_reissued": 0,
                   "preempt_replaced": 0}
        notices: dict[str, str] = {}
        if self.replace_preempted:
            notices_fn = getattr(self.provider, "preemption_notices", None)
            if notices_fn is not None:
                try:
                    notices = dict(notices_fn() or {})
                except Exception:
                    notices = {}
        with self._lock:
            claimed = {i.cloud_instance_id for i in self._instances.values()
                       if i.cloud_instance_id}
            # Spot preemptions first: the cloud is reclaiming these
            # slices — confirm the terminate and queue a same-shape
            # replacement BEFORE the per-state pass, so the replacement
            # request lands in this same round.
            if notices:
                for inst in list(self._instances.values()):
                    if inst.cloud_instance_id not in notices:
                        continue
                    if inst.state not in (REQUESTED, ALLOCATED, RAY_RUNNING):
                        continue
                    logger.warning(
                        "instance %s (%s) preempted by the cloud: "
                        "terminating + requesting replacement",
                        inst.instance_id, inst.node_type)
                    repairs["preempt_replaced"] += 1
                    self._transition(inst, TERMINATING)
                    try:
                        self.provider.terminate_node(inst.cloud_instance_id)
                    except Exception:
                        pass
                    ack = getattr(self.provider, "ack_preemption", None)
                    if ack is not None:
                        try:
                            ack(inst.cloud_instance_id)
                        except Exception:
                            pass
                    replacement = Instance(
                        f"inst-{next(self._counter)}", inst.node_type,
                        resources=dict(inst.resources))
                    self._instances[replacement.instance_id] = replacement
                    self._request_locked(replacement, replacement.resources)
                    claimed.add(replacement.cloud_instance_id)
            for inst in list(self._instances.values()):
                if inst.state == REQUESTED:
                    if inst.cloud_instance_id not in listing:
                        # Identityless provider (e.g. KubeRay: create_node
                        # returns a synthetic launch id; the operator names
                        # the replica): ADOPT an unclaimed listed node of
                        # the same type — without this, every successful
                        # launch would read as an allocation failure and
                        # each "retry" would scale up ANOTHER real slice.
                        for cid, ctype in listing.items():
                            if ctype == inst.node_type and cid not in claimed:
                                self._by_cloud_id.pop(inst.cloud_instance_id, None)
                                inst.cloud_instance_id = cid
                                self._by_cloud_id[cid] = inst.instance_id
                                claimed.add(cid)
                                break
                    if inst.cloud_instance_id in listing:
                        self._transition(inst, ALLOCATED)
                        continue  # one transition per round (deterministic)
                    elif inst.cloud_instance_id == "" or inst.since() > self.request_timeout_s:
                        # Cloud never surfaced it (stockout / quota / lost
                        # call): fail, and retry with backoff-by-count.
                        if inst.state == REQUESTED:
                            self._transition(inst, ALLOCATION_FAILED)
                if inst.state == ALLOCATION_FAILED:
                    if inst.retries < self.max_allocation_retries:
                        inst.retries += 1
                        repairs["allocation_retried"] += 1
                        self._transition(inst, QUEUED)
                        self._request_locked(inst, inst.resources)
                    else:
                        repairs["allocation_failed"] += 1
                        self._transition(inst, TERMINATED)
                    continue
                if inst.state == ALLOCATED:
                    node_id = self.provider.node_id_of(inst.cloud_instance_id)
                    matched = node_id if node_id in alive else self._match_gcs(inst, alive)
                    if matched is not None:
                        inst.node_id = matched
                        self._transition(inst, RAY_RUNNING)
                    elif inst.cloud_instance_id not in listing:
                        self._transition(inst, TERMINATED)  # died while booting
                    elif inst.since() > self.ray_boot_timeout_s:
                        # Node exists but the raylet never registered
                        # (image/network broken): replace it.
                        repairs["ray_boot_timeout"] += 1
                        self._transition(inst, TERMINATING)
                        try:
                            self.provider.terminate_node(inst.cloud_instance_id)
                        except Exception:
                            pass
                    continue
                if inst.state == RAY_RUNNING:
                    if inst.cloud_instance_id not in listing:
                        self._transition(inst, TERMINATED)
                    continue
                if inst.state == TERMINATING:
                    if inst.cloud_instance_id not in listing:
                        self._transition(inst, TERMINATED)
                    elif inst.since() > self.terminate_timeout_s:
                        # The cloud ignored the delete: re-issue it.
                        repairs["terminate_reissued"] += 1
                        inst.history.append((TERMINATING, time.time()))
                        try:
                            self.provider.terminate_node(inst.cloud_instance_id)
                        except Exception:
                            pass
        return repairs

    def _match_gcs(self, inst: Instance, alive: dict) -> str | None:
        """Match an ALLOCATED instance to a GCS node when the provider has
        no identity mapping: claim an alive node no other instance owns."""
        owned = {i.node_id for i in self._instances.values() if i.node_id}
        for node_id in alive:
            if node_id not in owned and node_id not in (self._preexisting or set()):
                return node_id
        return None

    # -------------------------------------------------------------- queries
    def instances(self, *states: str) -> list[Instance]:
        with self._lock:
            if not states:
                return list(self._instances.values())
            return [i for i in self._instances.values() if i.state in states]
