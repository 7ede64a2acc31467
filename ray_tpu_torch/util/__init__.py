"""User-facing utilities: placement groups, scheduling strategies,
metrics, actor pools, distributed queues and a
``multiprocessing.Pool`` over actors. Reference:
``python/ray/util/placement_group.py``,
``python/ray/util/scheduling_strategies.py``, ``util/actor_pool.py``,
``util/queue.py``, ``util/multiprocessing/pool.py``.
"""

from .actor_pool import ActorPool
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
    "ActorPool",
    "PlacementGroup",
    "placement_group",
    "remove_placement_group",
    "NodeAffinitySchedulingStrategy",
    "NodeLabelSchedulingStrategy",
    "PlacementGroupSchedulingStrategy",
    "SpreadSchedulingStrategy",
]
