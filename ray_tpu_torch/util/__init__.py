"""User-facing utilities: placement groups, scheduling strategies and
metrics. Reference: ``python/ray/util/placement_group.py``,
``python/ray/util/scheduling_strategies.py``.
"""

from .placement_group import (
    PlacementGroup,
    placement_group,
    remove_placement_group,
)
from .scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    PlacementGroupSchedulingStrategy,
    SpreadSchedulingStrategy,
)

__all__ = [
    "PlacementGroup",
    "placement_group",
    "remove_placement_group",
    "NodeAffinitySchedulingStrategy",
    "NodeLabelSchedulingStrategy",
    "PlacementGroupSchedulingStrategy",
    "SpreadSchedulingStrategy",
]
