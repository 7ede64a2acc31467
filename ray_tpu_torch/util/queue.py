"""Distributed FIFO queue backed by a named actor.

Equivalent of the reference's ``python/ray/util/queue.py``: a ``Queue``
handle is cheap to pickle into tasks/actors; all operations go through
one queue actor, so producers and consumers anywhere in the cluster see
one total order. Blocking get/put are implemented with bounded polling
from the caller side (the actor itself never blocks its event loop).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any

from ..core import api as ray


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self.items: deque = deque()

    def qsize(self) -> int:
        return len(self.items)

    def put(self, item) -> bool:
        if self.maxsize > 0 and len(self.items) >= self.maxsize:
            return False
        self.items.append(item)
        return True

    def put_many(self, items: list) -> bool:
        """All-or-nothing: never partially inserts (a retry after Full
        must not duplicate a prefix)."""
        if self.maxsize > 0 and len(self.items) + len(items) > self.maxsize:
            return False
        self.items.extend(items)
        return True

    def get(self):
        if not self.items:
            return False, None
        return True, self.items.popleft()

    def get_many(self, n: int) -> tuple[bool, list]:
        """All-or-nothing: items stay queued unless n are available (a
        failed batch get must not discard data)."""
        if len(self.items) < n:
            return False, []
        return True, [self.items.popleft() for _ in range(n)]


class Queue:
    def __init__(self, maxsize: int = 0, *, actor_options: dict | None = None):
        opts = {"num_cpus": 0, **(actor_options or {})}
        self._actor = ray.remote(_QueueActor).options(**opts).remote(maxsize)
        self.maxsize = maxsize

    def qsize(self) -> int:
        return ray.get(self._actor.qsize.remote(), timeout=60)

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        return self.maxsize > 0 and self.qsize() >= self.maxsize

    def put(self, item: Any, block: bool = True, timeout: float | None = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if ray.get(self._actor.put.remote(item), timeout=60):
                return
            if not block:
                raise Full
            if deadline is not None and time.monotonic() > deadline:
                raise Full
            time.sleep(0.01)

    def get(self, block: bool = True, timeout: float | None = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, item = ray.get(self._actor.get.remote(), timeout=60)
            if ok:
                return item
            if not block:
                raise Empty
            if deadline is not None and time.monotonic() > deadline:
                raise Empty
            time.sleep(0.01)

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def put_nowait_batch(self, items: list) -> None:
        items = list(items)
        if not ray.get(self._actor.put_many.remote(items), timeout=60):
            raise Full(f"batch of {len(items)} items does not fit")

    def get_nowait_batch(self, num_items: int) -> list:
        ok, out = ray.get(self._actor.get_many.remote(num_items), timeout=60)
        if not ok:
            raise Empty(f"fewer than {num_items} items available")
        return out

    def shutdown(self) -> None:
        try:
            ray.kill(self._actor)
        except Exception:
            pass
