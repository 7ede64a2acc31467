"""Task specification: the unit handed from owner → scheduler → worker.

Equivalent of the reference's ``TaskSpecification``
(``src/ray/common/task/task_spec.h:257``) minus protobuf: a plain dict
(msgpack-encodable) so it crosses the RPC layer untouched. Function bodies
are NOT in the spec — they live in the GCS function table keyed by
``function_id`` (reference ``python/ray/_private/function_manager.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

TASK_KIND_NORMAL = 0
TASK_KIND_ACTOR_CREATION = 1
TASK_KIND_ACTOR_TASK = 2


@dataclass
class TaskSpec:
    task_id: bytes
    job_id: bytes
    name: str
    function_id: bytes  # GCS function-table key
    kind: int = TASK_KIND_NORMAL
    # Serialized args: list of dicts
    #   {"t": "v", "meta": bytes, "blob": bytes}                — inline value
    #   {"t": "r", "id": bytes, "owner": str}                   — ObjectRef arg
    args: list = field(default_factory=list)
    # -1 = streaming generator (``num_returns="streaming"``): returns are
    # reported item-by-item while the task runs (reference _raylet.pyx:294).
    num_returns: int = 1
    generator_backpressure: int = 0  # 0 = unbounded
    resources: dict = field(default_factory=dict)
    max_retries: int = 0
    retry_exceptions: bool = False
    # Owner info so executors/raylets can report back / locate values.
    owner_address: str = ""
    parent_task_id: bytes = b""
    # Actor fields.
    actor_id: bytes = b""
    actor_method: str = ""
    seq_no: int = -1
    max_restarts: int = 0
    max_concurrency: int = 1
    # Named per-method concurrency pools (reference
    # concurrency_group_manager.cc): creation carries the group table,
    # each actor task the group it runs in ("" = default pool).
    concurrency_groups: dict = field(default_factory=dict)
    concurrency_group: str = ""
    # Scheduling.
    scheduling_strategy: dict = field(default_factory=dict)
    placement_group_id: bytes = b""
    placement_group_bundle_index: int = -1
    label_selector: dict = field(default_factory=dict)
    runtime_env: dict = field(default_factory=dict)
    # Distributed-trace context (observability/tracing.py): the task's
    # own span id plus its parent, propagated owner → raylet → executor
    # so every hop records into one connected span tree.
    trace_id: str = ""
    span_id: str = ""
    parent_span_id: str = ""

    def to_wire(self) -> dict[str, Any]:
        return {
            "task_id": self.task_id,
            "job_id": self.job_id,
            "name": self.name,
            "function_id": self.function_id,
            "kind": self.kind,
            "args": self.args,
            "num_returns": self.num_returns,
            "generator_backpressure": self.generator_backpressure,
            "resources": self.resources,
            "max_retries": self.max_retries,
            "retry_exceptions": self.retry_exceptions,
            "owner_address": self.owner_address,
            "parent_task_id": self.parent_task_id,
            "actor_id": self.actor_id,
            "actor_method": self.actor_method,
            "seq_no": self.seq_no,
            "max_restarts": self.max_restarts,
            "max_concurrency": self.max_concurrency,
            "concurrency_groups": self.concurrency_groups,
            "concurrency_group": self.concurrency_group,
            "scheduling_strategy": self.scheduling_strategy,
            "placement_group_id": self.placement_group_id,
            "placement_group_bundle_index": self.placement_group_bundle_index,
            "label_selector": self.label_selector,
            "runtime_env": self.runtime_env,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
        }

    @classmethod
    def from_wire(cls, d: dict) -> "TaskSpec":
        return cls(**d)

    def required_resources(self) -> dict:
        if self.kind == TASK_KIND_ACTOR_TASK:
            return {}  # actor tasks run on the actor's existing worker
        res = dict(self.resources)
        if self.kind == TASK_KIND_NORMAL and not res:
            res = {"CPU": 1.0}
        return res

    def is_actor_creation(self) -> bool:
        return self.kind == TASK_KIND_ACTOR_CREATION

    def is_actor_task(self) -> bool:
        return self.kind == TASK_KIND_ACTOR_TASK
