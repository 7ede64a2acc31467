"""Streaming generators: tasks that yield results before they finish.

Equivalent of the reference's ``ObjectRefGenerator`` / streaming-generator
protocol (``python/ray/_raylet.pyx:294`` ObjectRefGenerator;
``src/ray/core_worker/task_manager.h:212`` owner-side streaming refs):

  * A task or actor method declared ``num_returns="streaming"`` must return
    a (sync or async) generator. The executor reports each yielded item to
    the owner the moment it is produced — inline for small values, via the
    shm store for large ones — so consumers read results while the task is
    still running.
  * Item object IDs are the deterministic task-return IDs
    (``ObjectID.for_task_return(task_id, index+1)``), so a retried
    generator regenerates the same refs and reports are idempotent.
  * Backpressure: with ``_generator_backpressure_num_objects=N`` the
    executor pauses once N reported items are unconsumed, long-polling the
    owner (``WaitGeneratorConsumed``) until the consumer catches up —
    the reference's generator pause/resume protocol.
"""

from __future__ import annotations

import threading
import time
from typing import Any

from .ids import ObjectID, TaskID
from .status import GetTimeoutError


class StreamState:
    """Owner-side state of one executing streaming generator
    (reference ``task_manager.h`` ObjectRefStream)."""

    def __init__(self, task_id: bytes):
        self.task_id = task_id
        self.cond = threading.Condition()
        self.num_items = 0          # high-water mark of reported items
        self.consumed = 0           # items handed to the consumer
        self.finished = False
        self.total: int | None = None
        self.error: Exception | None = None
        # Producer backpressure long-polls park asyncio futures here instead
        # of blocking an executor thread: (until, loop, future).
        self._async_waiters: list[tuple[int, Any, Any]] = []
        # Consumer-side async item waits: (cursor, loop, future) fired when
        # item `cursor` is reported (or the stream ends) — lets async
        # consumers (Serve proxy) wait loop-natively, no thread per stream.
        self._item_waiters: list[tuple[int, Any, Any]] = []

    def _fire_async_waiters_locked(self) -> None:
        remaining = []
        for until, loop, fut in self._async_waiters:
            if self.consumed >= until or self.error is not None or self.finished:
                loop.call_soon_threadsafe(lambda f=fut: f.done() or f.set_result(True))
            else:
                remaining.append((until, loop, fut))
        self._async_waiters = remaining

    def add_async_waiter(self, until: int, loop, fut) -> bool:
        """Register a loop-native waiter for ``consumed >= until``.
        Returns False if the condition already holds (no wait needed)."""
        with self.cond:
            if self.consumed >= until or self.error is not None or self.finished:
                return False
            self._async_waiters.append((until, loop, fut))
            return True

    def _fire_item_waiters_locked(self) -> None:
        remaining = []
        for cursor, loop, fut in self._item_waiters:
            if cursor < self.num_items or self.finished:
                loop.call_soon_threadsafe(lambda f=fut: f.done() or f.set_result(True))
            else:
                remaining.append((cursor, loop, fut))
        self._item_waiters = remaining

    def add_item_waiter(self, cursor: int, loop, fut) -> bool:
        """Register a loop-native waiter for item ``cursor`` (or stream
        end). Returns False if it is already available."""
        with self.cond:
            if cursor < self.num_items or self.finished:
                return False
            self._item_waiters.append((cursor, loop, fut))
            return True

    def report_item(self, index: int) -> None:
        with self.cond:
            if index + 1 > self.num_items:
                self.num_items = index + 1
            self.cond.notify_all()
            self._fire_item_waiters_locked()

    def finish(self, total: int) -> None:
        with self.cond:
            self.finished = True
            if self.total is None or total > self.total:
                self.total = total
            if self.total > self.num_items:
                self.num_items = self.total
            self.cond.notify_all()
            self._fire_async_waiters_locked()
            self._fire_item_waiters_locked()

    def fail(self, error: Exception) -> None:
        with self.cond:
            if self.error is None:
                self.error = error
            self.finished = True
            self.cond.notify_all()
            self._fire_async_waiters_locked()
            self._fire_item_waiters_locked()

    def mark_consumed(self) -> int:
        with self.cond:
            self.consumed += 1
            self.cond.notify_all()
            self._fire_async_waiters_locked()
            return self.consumed


class ObjectRefGenerator:
    """User-facing handle over a streaming task: iterating yields
    ``ObjectRef``s in yield order, blocking until the next item has been
    reported (reference ``ObjectRefGenerator``, ``_raylet.pyx:294``)."""

    def __init__(self, worker, stream: StreamState, owner_address: str):
        self._worker = worker
        self._stream = stream
        self._owner_address = owner_address
        self._cursor = 0
        self._released = False

    @property
    def task_id(self) -> bytes:
        return self._stream.task_id

    def __iter__(self):
        return self

    def __next__(self):
        return self._next_sync(timeout=None)

    def _next_sync(self, timeout: float | None):
        from .object_ref import ObjectRef

        stream = self._stream
        deadline = None if timeout is None else time.monotonic() + timeout
        with stream.cond:
            while self._cursor >= stream.num_items and not stream.finished:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise GetTimeoutError(
                        f"Timed out waiting for streaming item {self._cursor}"
                    )
                stream.cond.wait(remaining)
            error = stream.error
        if self._cursor >= stream.num_items:
            # Exhausted (or failed): drop owner-side stream state.
            self._release()
            if error is not None:
                raise error
            raise StopIteration
        index = self._cursor
        self._cursor += 1
        stream.mark_consumed()
        oid = ObjectID.for_task_return(TaskID(stream.task_id), index + 1)
        return ObjectRef(oid, self._owner_address)

    def __aiter__(self):
        return self

    async def __anext__(self):
        import asyncio

        loop = asyncio.get_running_loop()
        # Loop-native wait for the next item: no executor thread is parked
        # per waiting stream (matters with many concurrent token streams).
        fut = loop.create_future()
        if self._stream.add_item_waiter(self._cursor, loop, fut):
            await fut
        try:
            # Item (or end) is available: _next_sync returns without blocking.
            return self._next_sync(timeout=30.0)
        except StopIteration:
            raise StopAsyncIteration

    def completed(self) -> bool:
        with self._stream.cond:
            return self._stream.finished

    def _release(self) -> None:
        if self._released:
            return
        self._released = True
        try:
            self._worker.release_stream(self._stream.task_id)
        except Exception:
            pass  # interpreter shutdown / worker already gone

    def close(self) -> None:
        """Abandon the stream: the producer is cancelled at its next report
        (reference: generator cancellation on consumer release)."""
        self._release()

    def __del__(self):
        self._release()

    def __repr__(self):
        return f"ObjectRefGenerator(task={self._stream.task_id.hex()[:12]}, cursor={self._cursor})"
