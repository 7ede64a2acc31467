"""Logical operators + plan.

Reference: ``python/ray/data/_internal/logical/`` — logical ops are a DAG
of declarative nodes; the planner lowers them to physical operators, and
the optimizer fuses adjacent one-to-one maps into a single task per block.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass
class LogicalOp:
    name: str
    input: "LogicalOp | None" = None

    def chain(self) -> list["LogicalOp"]:
        ops: list[LogicalOp] = []
        op: LogicalOp | None = self
        while op is not None:
            ops.append(op)
            op = op.input
        return list(reversed(ops))


@dataclasses.dataclass
class Read(LogicalOp):
    """Leaf: produces read tasks, each yielding one block."""

    read_tasks: list[Callable[[], Any]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class MapBatches(LogicalOp):
    fn: Callable = None
    batch_format: str = "numpy"
    fn_kwargs: dict = dataclasses.field(default_factory=dict)
    # Actor-pool compute (ActorPoolStrategy) for stateful fns; None = tasks.
    compute: Any = None
    fn_constructor_args: tuple = ()
    fn_constructor_kwargs: dict = dataclasses.field(default_factory=dict)
    ray_actor_options: dict | None = None  # e.g. {"num_gpus": 1}


@dataclasses.dataclass
class MapRows(LogicalOp):
    fn: Callable = None


@dataclasses.dataclass
class FlatMap(LogicalOp):
    fn: Callable = None


@dataclasses.dataclass
class Filter(LogicalOp):
    fn: Callable = None


@dataclasses.dataclass
class Repartition(LogicalOp):
    num_blocks: int = 1


@dataclasses.dataclass
class RandomShuffle(LogicalOp):
    seed: int | None = None


@dataclasses.dataclass
class Sort(LogicalOp):
    key: str = ""
    descending: bool = False


@dataclasses.dataclass
class Limit(LogicalOp):
    limit: int = 0


@dataclasses.dataclass
class Union(LogicalOp):
    others: list[LogicalOp] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class GroupByAggregate(LogicalOp):
    """groupby(key) + aggregations or map_groups (reference
    ``grouped_data.py:21``)."""

    key: str = ""
    aggs: list = None  # [(col, "count"|"sum"|"min"|"max"|"mean")]
    map_groups_fn: Any = None
    num_out: int | None = None


@dataclasses.dataclass
class Join(LogicalOp):
    """Hash join against a pre-materialized right side (reference
    ``Dataset.join``)."""

    key: str = ""
    join_type: str = "inner"
    right_refs: list = dataclasses.field(default_factory=list)
    num_out: int | None = None
