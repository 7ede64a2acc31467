"""In-process memory store for small objects and pending futures.

Equivalent of the reference's ``CoreWorkerMemoryStore``
(``src/ray/core_worker/store_provider/memory_store/``): small task returns
and inlined values live here; ``get`` blocks on a threading event until the
value arrives (task completion) or a timeout fires. Error objects are stored
like values and re-raised on deserialization.
"""

from __future__ import annotations

import threading
from typing import Iterable

from .ids import ObjectID


class _Entry:
    __slots__ = ("metadata", "blob", "in_plasma", "node_id")

    def __init__(self, metadata: bytes, blob: bytes, in_plasma: bool = False, node_id: bytes | None = None):
        self.metadata = metadata
        self.blob = blob
        self.in_plasma = in_plasma
        self.node_id = node_id


class MemoryStore:
    def __init__(self):
        self._lock = threading.Lock()
        self._objects: dict[ObjectID, _Entry] = {}
        self._waiters: dict[ObjectID, list[threading.Event]] = {}
        # Event-driven (non-blocking) waiters: oid -> list of callbacks fired
        # once, from the putting thread, when the object becomes present.
        self._callbacks: dict[ObjectID, list] = {}

    def _store(self, object_id: ObjectID, entry: _Entry) -> None:
        with self._lock:
            self._objects[object_id] = entry
            events = self._waiters.pop(object_id, [])
            callbacks = self._callbacks.pop(object_id, [])
        for ev in events:
            ev.set()
        for cb in callbacks:
            try:
                cb(object_id)
            except Exception:
                pass

    def put(self, object_id: ObjectID, metadata: bytes, blob: bytes) -> None:
        self._store(object_id, _Entry(metadata, blob))

    def put_plasma_marker(self, object_id: ObjectID, node_id: bytes) -> None:
        """Record that the value lives in plasma on ``node_id`` (the
        reference stores an IN_PLASMA_ERROR sentinel the same way)."""
        self._store(object_id, _Entry(b"", b"", in_plasma=True, node_id=node_id))

    def add_callback(self, object_id: ObjectID, callback) -> bool:
        """Register ``callback(oid)`` for when ``object_id`` appears.
        Returns False (callback NOT registered) if it is already present."""
        with self._lock:
            if object_id in self._objects:
                return False
            self._callbacks.setdefault(object_id, []).append(callback)
            return True

    def remove_callback(self, object_id: ObjectID, callback) -> None:
        with self._lock:
            cbs = self._callbacks.get(object_id)
            if cbs is not None:
                try:
                    cbs.remove(callback)
                except ValueError:
                    pass
                if not cbs:
                    self._callbacks.pop(object_id, None)

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._objects

    def get_if_exists(self, object_id: ObjectID) -> _Entry | None:
        with self._lock:
            return self._objects.get(object_id)

    def wait_ready(self, object_ids: Iterable[ObjectID], num_returns: int, timeout: float | None) -> tuple[list[ObjectID], list[ObjectID]]:
        """Block until ``num_returns`` of ``object_ids`` are present."""
        object_ids = list(object_ids)
        ev = threading.Event()
        with self._lock:
            ready = [oid for oid in object_ids if oid in self._objects]
            if len(ready) >= num_returns:
                return ready[:num_returns], [o for o in object_ids if o not in ready[:num_returns]]
            for oid in object_ids:
                if oid not in self._objects:
                    self._waiters.setdefault(oid, []).append(ev)
        import time

        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            fired = ev.wait(remaining)
            ev.clear()
            with self._lock:
                ready = [oid for oid in object_ids if oid in self._objects]
                if len(ready) >= num_returns or not fired:
                    ready = ready[:max(len(ready), 0)]
                    ready_set = set(ready[:num_returns]) if len(ready) >= num_returns else set(ready)
                    return (
                        [o for o in object_ids if o in ready_set],
                        [o for o in object_ids if o not in ready_set],
                    )
                for oid in object_ids:
                    if oid not in self._objects:
                        self._waiters.setdefault(oid, []).append(ev)

    def delete(self, object_id: ObjectID) -> None:
        with self._lock:
            self._objects.pop(object_id, None)

    def size(self) -> int:
        with self._lock:
            return len(self._objects)
