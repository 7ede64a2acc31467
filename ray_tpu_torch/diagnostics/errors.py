"""ErrorEvent: the structured record carried on the GCS error-info channel.

Reference: ``src/ray/gcs/pubsub`` RAY_ERROR_INFO_CHANNEL +
``ray._private.utils.publish_error_to_driver`` — worker errors reach the
driver through the control plane, not through scraping logs. Events are
plain dicts on the wire (msgpack-friendly); ``ErrorEvent`` is a typed
view for in-process consumers.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

ERROR_INFO_CHANNEL = "error_info"

# Chaos convention: every fault the chaos subsystem injects publishes an
# ErrorEvent with ``source="chaos"`` and ``extra={"chaos": True, ...}``
# so list_errors()/doctor/traces can separate injected pain from organic
# failures (chaos/runner.py tags them; RecoveryVerifier relies on it).
CHAOS_SOURCE = "chaos"


def is_chaos_event(event: dict) -> bool:
    """True when the event was published by an injected fault."""
    return bool(event.get("source") == CHAOS_SOURCE
                or (event.get("extra") or {}).get("chaos"))


@dataclass
class ErrorEvent:
    type: str  # task_failure | actor_creation_failure | replica_start_failure | lease_wedge | oom_kill | ...
    source: str  # worker | raylet | gcs | serve_controller | serve_replica | ...
    message: str
    traceback: str = ""
    node_id: str = ""
    worker_id: str = ""
    actor_id: str = ""
    job_id: str = ""
    timestamp: float = 0.0
    extra: dict = field(default_factory=dict)

    def to_wire(self) -> dict:
        return {
            "type": self.type,
            "source": self.source,
            "message": self.message,
            "traceback": self.traceback,
            "node_id": self.node_id,
            "worker_id": self.worker_id,
            "actor_id": self.actor_id,
            "job_id": self.job_id,
            "timestamp": self.timestamp or time.time(),
            "extra": self.extra or {},
        }

    @classmethod
    def from_wire(cls, wire: dict) -> "ErrorEvent":
        return cls(
            type=wire.get("type", ""),
            source=wire.get("source", ""),
            message=wire.get("message", ""),
            traceback=wire.get("traceback", ""),
            node_id=wire.get("node_id", ""),
            worker_id=wire.get("worker_id", ""),
            actor_id=wire.get("actor_id", ""),
            job_id=wire.get("job_id", ""),
            timestamp=wire.get("timestamp", 0.0),
            extra=wire.get("extra") or {},
        )


def make_event(
    error_type: str,
    message: str,
    *,
    source: str,
    traceback: str = "",
    node_id: str = "",
    worker_id: str = "",
    actor_id: str = "",
    job_id: str = "",
    extra: dict | None = None,
) -> dict:
    """Build a wire-format event dict."""
    return ErrorEvent(
        type=error_type,
        source=source,
        message=message,
        traceback=traceback,
        node_id=node_id,
        worker_id=worker_id,
        actor_id=actor_id,
        job_id=job_id,
        timestamp=time.time(),
        extra=extra or {},
    ).to_wire()


def publish_error_to_driver(
    error_type: str,
    message: str,
    *,
    source: str = "worker",
    traceback: str = "",
    actor_id: str = "",
    extra: dict | None = None,
) -> None:
    """Fire-and-forget an ErrorEvent from any connected process (worker,
    serve replica/controller, driver). Never raises: diagnostics must not
    turn a failure into a different failure."""
    try:
        from ..core.worker import global_worker

        w = global_worker()
        job = getattr(w, "job_id", None)
        event = make_event(
            error_type,
            message,
            source=source,
            traceback=traceback,
            node_id=getattr(w, "node_id", "") or "",
            worker_id=getattr(w, "worker_id", "") or "",
            actor_id=actor_id,
            job_id=str(job.int_value()) if job is not None else "",
            extra=extra,
        )
        w.io.run_coro(w.gcs.call("PublishError", {"event": event}, 10.0))
    except Exception:
        pass
