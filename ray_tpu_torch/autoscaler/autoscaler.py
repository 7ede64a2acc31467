"""The reconciler: demand + capacity -> launch/terminate decisions.

Equivalent of the reference's
``autoscaler/v2/scheduler.py:624`` (ResourceDemandScheduler.schedule):
each round it
  1. reads live nodes (+ per-node pending lease shapes) from the GCS,
  2. gathers demand: pending shapes, PENDING/INFEASIBLE placement-group
     bundles, and the ``request_resources`` floor,
  3. first-fit bin-packs demand onto current AVAILABLE capacity,
  4. launches the cheapest node type that fits each unmet shape (bounded
     by ``max_workers``),
  5. terminates nodes idle past ``idle_timeout_s`` (bounded by
     ``min_workers``).
Deliberately synchronous and stateless between rounds (modulo launch
cooldown): every decision is derivable from cluster state, as in v2's
instance-manager reconciler.

The port of ``ray_tpu/autoscaler/autoscaler.py``. The reconciler is
accelerator-neutral: a node type and a demand shape name the port's
``GPU`` resource where the JAX package's name ``TPU``.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field

from .node_provider import NodeLaunchError, NodeProvider
from .sdk import REQUEST_KEY, get_requested_resources

logger = logging.getLogger(__name__)


@dataclass
class NodeTypeConfig:
    name: str
    resources: dict
    min_workers: int = 0
    max_workers: int = 10


@dataclass
class _Decision:
    launch: list[str] = field(default_factory=list)      # node type names
    terminate: list[str] = field(default_factory=list)   # instance ids


def _fits(shape: dict, available: dict) -> bool:
    return all(available.get(k, 0.0) >= v for k, v in shape.items() if v > 0)


def _consume(shape: dict, available: dict) -> None:
    for k, v in shape.items():
        available[k] = available.get(k, 0.0) - v


class Autoscaler:
    def __init__(
        self,
        gcs_call,
        provider: NodeProvider,
        node_types: list[NodeTypeConfig],
        *,
        idle_timeout_s: float = 5.0,
        launch_cooldown_s: float = 1.0,
        launch_backoff_base_s: float = 5.0,
        launch_backoff_max_s: float = 300.0,
    ):
        """``gcs_call(method, payload) -> dict`` — a synchronous GCS RPC
        (the driver worker's `_gcs_call` or a Cluster-loop closure)."""
        self._gcs_call = gcs_call
        self.provider = provider
        self.node_types = {t.name: t for t in node_types}
        self.idle_timeout_s = idle_timeout_s
        self.launch_cooldown_s = launch_cooldown_s
        self.launch_backoff_base_s = launch_backoff_base_s
        self.launch_backoff_max_s = launch_backoff_max_s
        # Per-node-type launch backoff after quota/stockout failures:
        # type -> (retry_after_ts, consecutive_failures). Types in
        # backoff are skipped during selection, so demand routes to the
        # next fitting type instead of hammering an exhausted one
        # (ref: v2 instance-manager allocation retry).
        self._launch_backoff: dict[str, tuple[float, int]] = {}
        self._idle_since: dict[str, float] = {}  # instance_id -> ts
        self._last_launch = 0.0
        # Launched instances not yet registered with the GCS: their
        # capacity counts during bin-packing so slow node boots don't
        # trigger a re-launch storm (reference: instance-manager pending
        # instances). Entries expire after `boot_timeout_s`.
        self._pending_launches: dict[str, tuple[str, float]] = {}  # iid -> (type, ts)
        self.boot_timeout_s = 120.0
        self._warned_unfittable: set = set()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- lifecycle
    def start(self, period_s: float = 0.5) -> None:
        def loop():
            while not self._stop.is_set():
                try:
                    self.reconcile_once()
                except Exception:
                    logger.exception("autoscaler reconcile failed")
                self._stop.wait(period_s)

        self._thread = threading.Thread(target=loop, daemon=True, name="autoscaler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # ------------------------------------------------------------- one round
    def _collect_demand(self, nodes: list[dict]) -> list[dict]:
        demand: list[dict] = []
        for node in nodes:
            if node.get("state") != "ALIVE":
                continue
            for entry in node.get("pending_demand") or []:
                demand.extend([dict(entry["shape"])] * int(entry["count"]))
        # Unplaced placement groups: every bundle is a demand shape.
        pgs = self._gcs_call("ListPlacementGroups", {}).get("placement_groups", [])
        for pg in pgs:
            if pg.get("state") in ("PENDING", "INFEASIBLE"):
                demand.extend([dict(b) for b in pg.get("bundles", [])])
        return demand

    def _capacity_views(self, nodes: list[dict]):
        available, total = [], []
        for node in nodes:
            # Draining (preempted) nodes must not absorb demand during
            # bin-packing — the replacement launch they displaced is the
            # entire point of surfacing the notice early.
            if node.get("state") != "ALIVE" or node.get("draining"):
                continue
            res = node.get("resources") or {}
            available.append(dict(res.get("available") or {}))
            total.append(dict(res.get("total") or {}))
        return available, total

    def _type_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for t in self.provider.non_terminated_nodes().values():
            counts[t] = counts.get(t, 0) + 1
        return counts

    def _fits_some_type(self, shape: dict) -> bool:
        return any(_fits(shape, dict(t.resources)) for t in self.node_types.values())

    def _expire_pending_launches(self, nodes: list[dict]) -> None:
        registered = {n["node_id"] for n in nodes if n.get("state") == "ALIVE"}
        now = time.time()
        for iid, (_type, ts) in list(self._pending_launches.items()):
            if self.provider.node_id_of(iid) in registered or now - ts > self.boot_timeout_s:
                self._pending_launches.pop(iid, None)

    def _in_backoff(self, type_name: str) -> bool:
        entry = self._launch_backoff.get(type_name)
        return entry is not None and time.time() < entry[0]

    def _try_launch(self, type_name: str) -> str | None:
        """create_node with capacity-failure handling: a transient
        failure (quota/stockout) puts the TYPE in exponential backoff and
        returns None — the round continues with other types/decisions
        instead of aborting."""
        try:
            iid = self.provider.create_node(
                type_name, self.node_types[type_name].resources)
        except NodeLaunchError as e:
            if not e.transient:
                raise
            _until, failures = self._launch_backoff.get(type_name, (0.0, 0))
            delay = min(self.launch_backoff_max_s,
                        self.launch_backoff_base_s * (2 ** failures))
            self._launch_backoff[type_name] = (time.time() + delay, failures + 1)
            logger.warning(
                "launch of %s failed (%s); backing off %.0fs (attempt %d)",
                type_name, e.reason or e, delay, failures + 1)
            return None
        self._launch_backoff.pop(type_name, None)
        self._pending_launches[iid] = (type_name, time.time())
        return iid

    def reconcile_once(self) -> _Decision:
        nodes = self._gcs_call("GetAllNodes", {}).get("nodes", [])
        decision = _Decision()

        self._expire_pending_launches(nodes)
        demand = self._collect_demand(nodes)
        available, total = self._capacity_views(nodes)
        # Booting nodes count as capacity (they haven't registered yet),
        # else every reconcile round until registration re-launches for
        # the same demand.
        for _iid, (type_name, _ts) in self._pending_launches.items():
            cfg = self.node_types.get(type_name)
            if cfg is not None:
                available.append(dict(cfg.resources))
                total.append(dict(cfg.resources))

        # Explicit floor: bundles that must fit in TOTAL capacity.
        floor = get_requested_resources(
            lambda key: self._gcs_call("KvGet", {"key": key}).get("value")
        )
        floor_unmet = []
        total_copy = [dict(t) for t in total]
        for bundle in floor:
            for cap in total_copy:
                if _fits(bundle, cap):
                    _consume(bundle, cap)
                    break
            else:
                floor_unmet.append(bundle)

        # Load demand: bundles that must fit in AVAILABLE capacity.
        unmet = list(floor_unmet)
        for shape in demand:
            for cap in available:
                if _fits(shape, cap):
                    _consume(shape, cap)
                    break
            else:
                unmet.append(shape)

        # Shapes no node type can EVER satisfy are hopeless, not pending:
        # drop them from `unmet` (warn once per shape) so they can't
        # immortalize idle nodes via the scale-down guard below.
        satisfiable = []
        for shape in unmet:
            if self._fits_some_type(shape):
                satisfiable.append(shape)
            else:
                key = tuple(sorted(shape.items()))
                if key not in self._warned_unfittable:
                    self._warned_unfittable.add(key)
                    logger.warning("autoscaler: no node type fits shape %s — ignoring", shape)
        unmet = satisfiable

        # Launch for unmet shapes (respecting per-type max and cooldown).
        if unmet and time.time() - self._last_launch >= self.launch_cooldown_s:
            counts = self._type_counts()
            pending_capacity: list[dict] = []
            for shape in unmet:
                placed = False
                for cap in pending_capacity:  # a node just decided on may absorb more
                    if _fits(shape, cap):
                        _consume(shape, cap)
                        placed = True
                        break
                if placed:
                    continue
                for t in self.node_types.values():
                    if counts.get(t.name, 0) + decision.launch.count(t.name) >= t.max_workers:
                        continue
                    if self._in_backoff(t.name):
                        continue  # quota/stockout: route to the next type
                    if _fits(shape, dict(t.resources)):
                        decision.launch.append(t.name)
                        cap = dict(t.resources)
                        _consume(shape, cap)
                        pending_capacity.append(cap)
                        placed = True
                        break
                if not placed:
                    pass  # at max_workers for every fitting type: wait
            # re-check backoff per launch: the FIRST quota failure this
            # round must stop further create calls for the same type
            launched = [n for n in decision.launch
                        if not self._in_backoff(n) and self._try_launch(n)]
            decision.launch = launched
            if launched:
                self._last_launch = time.time()
                logger.info("autoscaler launched: %s", launched)

        # min_workers floor: keep at least min_workers of each type.
        # (provider counts already include this round's launches)
        counts = self._type_counts()
        for t in self.node_types.values():
            if self._in_backoff(t.name):
                continue
            for _ in range(t.min_workers - counts.get(t.name, 0)):
                if self._try_launch(t.name) is None:
                    break
                decision.launch.append(t.name)

        # Idle termination with per-node busy tracking: a node's timer only
        # resets when THAT node is busy — unrelated trickle load elsewhere
        # must not immortalize an idle node. Nodes holding the
        # request_resources floor are exempt.
        node_by_id = {n["node_id"]: n for n in nodes if n.get("state") == "ALIVE"}
        counts = self._type_counts()
        floor_held = self._floor_held_instances(floor, node_by_id)
        now = time.time()
        for iid, type_name in list(self.provider.non_terminated_nodes().items()):
            node = node_by_id.get(self.provider.node_id_of(iid))
            if node is None:
                continue
            res = node.get("resources") or {}
            avail, tot = res.get("available") or {}, res.get("total") or {}
            busy = any(avail.get(k, 0.0) < v for k, v in tot.items()) or (
                node.get("pending_demand") or []
            )
            if busy:
                self._idle_since.pop(iid, None)
                continue
            first_idle = self._idle_since.setdefault(iid, now)
            if unmet:
                continue  # capacity crunch: don't shrink (timers keep running)
            cfg = self.node_types.get(type_name)
            if (
                cfg is not None
                and iid not in floor_held
                and counts.get(type_name, 0) > cfg.min_workers
                and now - first_idle >= self.idle_timeout_s
            ):
                logger.info("autoscaler terminating idle node %s (%s)", iid, type_name)
                self.provider.terminate_node(iid)
                self._idle_since.pop(iid, None)
                counts[type_name] -= 1
        return decision

    def _floor_held_instances(self, floor: list[dict], node_by_id: dict) -> set[str]:
        """Greedy-pack the request_resources floor onto provider nodes:
        every node that absorbs a floor bundle is exempt from idle
        termination (else the floor churns launch/terminate forever)."""
        held: set[str] = set()
        if not floor:
            return held
        remaining = [dict(b) for b in floor]
        for iid in self.provider.non_terminated_nodes():
            node = node_by_id.get(self.provider.node_id_of(iid))
            if node is None:
                continue
            cap = dict((node.get("resources") or {}).get("total") or {})
            for bundle in list(remaining):
                if _fits(bundle, cap):
                    _consume(bundle, cap)
                    remaining.remove(bundle)
                    held.add(iid)
        return held
