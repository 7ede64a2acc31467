"""Workflows: durable DAG execution with exactly-once step semantics.

Equivalent of the reference's ``python/ray/workflow/``: a DAG of steps
runs as cluster tasks with every step result checkpointed to storage;
re-running (``resume``) after a crash skips completed steps, so side
effects execute once per workflow id. Dynamic workflows — a step
returning ``continuation(sub_dag)`` extends the DAG at runtime
(reference ``workflow.continuation``) — checkpoint level by level, and
event steps (``wait_for_event`` / ``EventListener`` /
``trigger_event``) park a step until an external event arrives.
"""

from .api import (
    Continuation,
    EventListener,
    KVEventListener,
    StepNode,
    continuation,
    get_output,
    get_status,
    list_all,
    resume,
    run,
    step,
    trigger_event,
    wait_for_event,
)

__all__ = [
    "step",
    "run",
    "resume",
    "get_output",
    "get_status",
    "list_all",
    "StepNode",
    "Continuation",
    "continuation",
    "EventListener",
    "KVEventListener",
    "trigger_event",
    "wait_for_event",
]
