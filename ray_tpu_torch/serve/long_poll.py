"""Long-poll config push: controller → routers/proxies.

Reference: ``python/ray/serve/_private/long_poll.py:204`` (LongPollHost) —
clients ask "anything newer than snapshot N for these keys?" and the host
parks the request until an update lands or a timeout fires. This replaces
polling for routing tables: a replica-set change reaches every router in
one RTT.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable


class LongPollHost:
    """Lives inside the Serve controller actor."""

    def __init__(self, poll_timeout_s: float = 5.0):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._snapshot_ids: dict[str, int] = {}
        self._objects: dict[str, Any] = {}
        self._poll_timeout_s = poll_timeout_s

    def notify_changed(self, key: str, obj: Any) -> None:
        with self._cond:
            self._snapshot_ids[key] = self._snapshot_ids.get(key, 0) + 1
            self._objects[key] = obj
            self._cond.notify_all()

    def listen_for_change(self, keys_to_snapshot_ids: dict[str, int]) -> dict:
        """Block until any key moves past the client's snapshot (or time
        out, returning {}). Returns {key: {"snapshot_id", "object"}}."""
        deadline = time.monotonic() + self._poll_timeout_s
        with self._cond:
            while True:
                out = {}
                for key, seen in keys_to_snapshot_ids.items():
                    cur = self._snapshot_ids.get(key, 0)
                    if cur > seen:
                        out[key] = {"snapshot_id": cur, "object": self._objects.get(key)}
                if out:
                    return out
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {}
                self._cond.wait(remaining)

    def get(self, key: str) -> tuple[int, Any]:
        with self._lock:
            return self._snapshot_ids.get(key, 0), self._objects.get(key)


class LongPollClient:
    """Runs a daemon thread long-polling the controller for a set of keys.

    ``callbacks``: {key: fn(object)} invoked on each update (and once with
    the current value at startup).
    """

    def __init__(self, controller_handle, callbacks: dict[str, Callable[[Any], None]]):
        from ..core import api as ray

        self._ray = ray
        self._controller = controller_handle
        self._callbacks = callbacks
        self._snapshots = {key: 0 for key in callbacks}
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="serve-longpoll")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stopped.is_set():
            try:
                updates = self._ray.get(
                    self._controller.listen_for_change.remote(dict(self._snapshots)),
                    timeout=30.0,
                )
            except Exception:
                if self._stopped.is_set():
                    return
                time.sleep(0.2)
                continue
            for key, update in (updates or {}).items():
                self._snapshots[key] = update["snapshot_id"]
                try:
                    self._callbacks[key](update["object"])
                except Exception:
                    pass

    def stop(self) -> None:
        self._stopped.set()
