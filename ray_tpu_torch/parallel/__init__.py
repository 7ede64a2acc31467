"""Parallelism layer: device meshes, logical-axis sharding, collectives.

The port's counterpart of the JAX package's mesh stack: a
``DeviceMesh`` over the ranks of a ``torch.distributed`` process group
(NCCL on the card, gloo for CPU processes) with one named dimension per
axis, logical-axis rules that give DTensor placements, and
differentiable collectives over a named axis. The pipeline
(``pipeline.py``) is not ported yet.
"""

from .mesh import (
    MeshConfig,
    create_mesh,
    local_mesh,
    mesh_shape_for,
)
from .sharding import (
    LogicalAxisRules,
    DEFAULT_RULES,
    logical_sharding,
    shard_constraint,
    shard_params,
    unshard,
)
from .collectives import (
    all_gather,
    all_reduce,
    all_to_all,
    barrier,
    broadcast,
    ppermute,
    reduce_scatter,
)

__all__ = [
    "MeshConfig",
    "create_mesh",
    "local_mesh",
    "mesh_shape_for",
    "LogicalAxisRules",
    "DEFAULT_RULES",
    "logical_sharding",
    "shard_constraint",
    "shard_params",
    "unshard",
    "all_gather",
    "all_reduce",
    "all_to_all",
    "barrier",
    "broadcast",
    "ppermute",
    "reduce_scatter",
]
