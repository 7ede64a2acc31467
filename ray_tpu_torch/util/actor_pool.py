"""ActorPool: distribute a stream of tasks over a fixed set of actors.

Equivalent of the reference's ``python/ray/util/actor_pool.py``: submit
``fn(actor, value)`` calls to whichever actor is free, fetch results in
submission order (``get_next``) or completion order
(``get_next_unordered``), and ``map``/``map_unordered`` over iterables.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator

from ..core import api as ray


class ActorPool:
    def __init__(self, actors: list):
        self._idle = list(actors)
        self._future_to_actor: dict = {}
        self._index_to_future: dict[int, Any] = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending_submits: list[tuple[Callable, Any]] = []

    def submit(self, fn: Callable, value: Any) -> None:
        """``fn(actor, value) -> ObjectRef``; queued if all actors busy."""
        if self._idle:
            actor = self._idle.pop()
            future = fn(actor, value)
            self._future_to_actor[future] = actor
            self._index_to_future[self._next_task_index] = future
            self._next_task_index += 1
        else:
            self._pending_submits.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._index_to_future)

    def has_free(self) -> bool:
        return bool(self._idle) and not self._pending_submits

    def _return_actor(self, future) -> None:
        actor = self._future_to_actor.pop(future, None)
        if actor is not None:
            self._idle.append(actor)
        if self._pending_submits:
            fn, value = self._pending_submits.pop(0)
            self.submit(fn, value)

    def get_next(self, timeout: float | None = None):
        """Next result in SUBMISSION order. On timeout the task stays
        pending (retryable); on task error the actor still returns to the
        pool before the exception propagates."""
        if not self.has_next():
            raise StopIteration("No more results to get")
        idx = self._next_return_index
        future = self._index_to_future[idx]
        ready, _ = ray.wait([future], num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("Timed out waiting for result")
        del self._index_to_future[idx]
        self._next_return_index += 1
        self._return_actor(future)
        return ray.get(future)

    def get_next_unordered(self, timeout: float | None = None):
        """Next result in COMPLETION order."""
        if not self.has_next():
            raise StopIteration("No more results to get")
        ready, _ = ray.wait(list(self._index_to_future.values()), num_returns=1,
                            timeout=timeout)
        if not ready:
            raise TimeoutError("Timed out waiting for result")
        future = ready[0]
        for idx, fut in list(self._index_to_future.items()):
            if fut is future or fut == future:
                del self._index_to_future[idx]
                # As the reference does: an ordered get after unordered
                # ones starts past every index already returned.
                self._next_return_index = max(self._next_return_index,
                                              idx + 1)
                break
        self._return_actor(future)
        return ray.get(future)

    def map(self, fn: Callable, values: Iterable) -> Iterator:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable) -> Iterator:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def push(self, actor) -> None:
        """Add an idle actor to the pool."""
        self._idle.append(actor)
        if self._pending_submits:
            fn, value = self._pending_submits.pop(0)
            self.submit(fn, value)

    def pop_idle(self):
        return self._idle.pop() if self._idle else None
