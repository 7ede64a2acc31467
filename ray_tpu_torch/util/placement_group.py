"""Placement groups: atomic reservation of resource bundles across nodes.

Reference: ``python/ray/util/placement_group.py`` (placement_group:147,
PACK/SPREAD/STRICT_PACK/STRICT_SPREAD:16-19). The GCS does the 2PC bundle
reservation (``ray_tpu/core/gcs.py handle_CreatePlacementGroup``,
mirroring ``gcs_placement_group_scheduler.h:117-119``).

TPU idiom: a ``STRICT_PACK`` group over per-host ``{"TPU": n}`` bundles
plus one ``TPU-{type}-head`` bundle is how a whole slice is claimed as an
atomic unit (reference scheme: ``_private/accelerators/tpu.py:70-192``).
"""

from __future__ import annotations

import time

from ..core.ids import PlacementGroupID
from ..core.status import PlacementGroupUnschedulableError, RayTpuError
from ..core.worker import global_worker


class PlacementGroup:
    """Handle to a created placement group."""

    def __init__(self, pg_id: bytes, bundles: list[dict], strategy: str):
        self.id = pg_id
        self.bundles = bundles
        self.strategy = strategy

    @property
    def bundle_count(self) -> int:
        return len(self.bundles)

    def _state(self) -> dict:
        reply = global_worker()._gcs_call(
            "GetPlacementGroup", {"pg_id": self.id.hex()}
        )
        return reply.get("pg") or {}

    def ready(self) -> bool:
        return self._state().get("state") == "CREATED"

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout_seconds
        while time.monotonic() < deadline:
            state = self._state().get("state")
            if state == "CREATED":
                return True
            if state == "INFEASIBLE":
                raise PlacementGroupUnschedulableError(
                    f"placement group {self.id.hex()} is infeasible: "
                    f"bundles {self.bundles} exceed any node's total resources"
                )
            time.sleep(0.05)
        return False

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundles, self.strategy))


def placement_group(
    bundles: list[dict],
    strategy: str = "PACK",
    *,
    name: str = "",
) -> PlacementGroup:
    """Create a placement group. Reference: placement_group.py:147."""
    if strategy not in ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"):
        raise ValueError(f"unknown placement strategy {strategy!r}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty dicts")
    worker = global_worker()
    pg_id = PlacementGroupID.of(worker.job_id if hasattr(worker, "job_id") else None)
    worker._gcs_call(
        "CreatePlacementGroup",
        {
            "pg_id": pg_id.binary().hex(),
            "bundles": bundles,
            "strategy": strategy,
            "name": name,
        },
    )
    return PlacementGroup(pg_id.binary(), bundles, strategy)


def remove_placement_group(pg: PlacementGroup) -> None:
    global_worker()._gcs_call("RemovePlacementGroup", {"pg_id": pg.id.hex()})
