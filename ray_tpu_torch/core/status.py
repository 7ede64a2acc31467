"""Exception hierarchy for the runtime.

Equivalent of the reference's ``Status`` codes (``src/ray/common/status.h``)
plus the user-facing exception types in ``python/ray/exceptions.py``.
"""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all framework errors."""


class RayTaskError(RayTpuError):
    """Wraps an exception raised inside a remote task.

    Stored as the task's return object; re-raised at ``ray.get`` on the
    caller (reference ``python/ray/exceptions.py`` RayTaskError).
    """

    def __init__(self, function_name: str, traceback_str: str, cause: Exception | None = None):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(f"Task {function_name} failed:\n{traceback_str}")

    def __reduce__(self):
        return (RayTaskError, (self.function_name, self.traceback_str, self.cause))

    def as_instanceof_cause(self):
        """Return an exception that is also an instance of the cause's type."""
        if self.cause is None:
            return self
        cause_cls = type(self.cause)
        if cause_cls is RayTaskError:
            return self
        try:
            class _Wrapped(RayTaskError, cause_cls):  # type: ignore[misc]
                def __init__(self, inner):
                    self._inner = inner

                def __getattr__(self, item):
                    return getattr(self._inner, item)

                def __str__(self):
                    return str(self._inner)

            _Wrapped.__name__ = f"RayTaskError({cause_cls.__name__})"
            _Wrapped.__qualname__ = _Wrapped.__name__
            return _Wrapped(self)
        except TypeError:
            return self


class WorkerCrashedError(RayTpuError):
    """The worker executing the task died unexpectedly."""


class ActorDiedError(RayTpuError):
    def __init__(self, actor_id=None, reason: str = ""):
        self.actor_id = actor_id
        self.reason = reason
        super().__init__(f"Actor {actor_id} died: {reason}")


class ActorUnavailableError(RayTpuError):
    """Actor is temporarily unreachable (e.g. restarting)."""


class ObjectLostError(RayTpuError):
    """Object was lost and could not be reconstructed from lineage."""

    def __init__(self, object_id=None, reason: str = ""):
        self.object_id = object_id
        super().__init__(f"Object {object_id} lost: {reason}")


class ObjectReconstructionFailedError(ObjectLostError):
    pass


class OwnerDiedError(ObjectLostError):
    """The owner of the object died; its value can never be recovered."""


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class TaskCancelledError(RayTpuError):
    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__(f"Task {task_id} was cancelled")


class PendingCallsLimitExceeded(RayTpuError):
    pass


class OutOfMemoryError(RayTpuError):
    pass


class ObjectStoreFullError(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class NodeDiedError(RayTpuError):
    pass


class RpcError(RayTpuError):
    """Transport-level RPC failure."""


class PlacementGroupUnschedulableError(RayTpuError):
    pass
