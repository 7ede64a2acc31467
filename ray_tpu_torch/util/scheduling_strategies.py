"""Scheduling strategy objects.

Reference: ``python/ray/util/scheduling_strategies.py`` (
PlacementGroupSchedulingStrategy / NodeAffinitySchedulingStrategy /
NodeLabelSchedulingStrategy). ``to_wire()`` produces the dict consumed by
the raylet scheduler policies (``ray_tpu/core/scheduling.py``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: object  # PlacementGroup
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False

    @property
    def placement_group_id(self) -> bytes:
        return self.placement_group.id

    def to_wire(self) -> dict:
        return {
            "type": "placement_group",
            "pg_id": self.placement_group.id.hex()
            if isinstance(self.placement_group.id, bytes)
            else self.placement_group.id,
            "bundle_index": self.placement_group_bundle_index,
        }


@dataclasses.dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str
    soft: bool = False

    def to_wire(self) -> dict:
        return {"type": "node_affinity", "node_id": self.node_id, "soft": self.soft}


@dataclasses.dataclass
class NodeLabelSchedulingStrategy:
    hard: dict | None = None
    soft: dict | None = None

    def to_wire(self) -> dict:
        return {"type": "node_label", "hard": self.hard or {}, "soft": self.soft or {}}


@dataclasses.dataclass
class SpreadSchedulingStrategy:
    def to_wire(self) -> dict:
        return {"type": "spread"}
