"""Cluster-wide virtual time.

Deterministic-simulation support in the FoundationDB style: every
timeout-driven control loop (lease-wedge watchdog, orphan-lease reclaim,
GCS leak watcher, serve restart backoff, elastic-train debounce) reads
time through this module instead of ``time.monotonic`` directly. Under
the default :class:`WallClock` that is byte-for-byte the old behavior;
installing a :class:`VirtualClock` (directly via :func:`set_clock`, or
in every spawned process via the ``chaos_clock`` config entry /
``RAY_TPU_chaos_clock`` env var) lets a chaos test replay a multi-minute
timeout cascade in milliseconds, deterministically.

The clock intentionally does NOT replace the asyncio event-loop clock or
RPC deadlines: transport-level timeouts stay on wall time so a virtual
clock can run arbitrarily fast without fabricating transport failures.
"""

from __future__ import annotations

import asyncio
import threading
import time

__all__ = [
    "Clock",
    "WallClock",
    "VirtualClock",
    "get_clock",
    "set_clock",
    "now",
    "sleep",
]


class Clock:
    """Interface: monotonic ``now()`` seconds + an async ``sleep``."""

    def now(self) -> float:  # pragma: no cover - interface
        raise NotImplementedError

    async def sleep(self, duration: float) -> None:  # pragma: no cover
        raise NotImplementedError


class WallClock(Clock):
    """Real time: ``time.monotonic`` / ``asyncio.sleep`` (the default)."""

    def now(self) -> float:
        return time.monotonic()

    async def sleep(self, duration: float) -> None:
        await asyncio.sleep(duration)


class VirtualClock(Clock):
    """Virtual time that can run faster than (or detached from) wall time.

    ``rate`` scales real elapsed time into virtual seconds (``rate=60``
    replays one virtual minute per real second); ``rate=0`` freezes time
    entirely so only explicit :meth:`advance` calls move it — the fully
    deterministic mode. ``sleep`` polls in tiny real slices so sleepers
    on ANY event loop or thread observe advances without coordination
    (this runtime runs raylets, the GCS, and the driver on separate
    loops/threads in one process).
    """

    def __init__(self, start: float = 0.0, rate: float = 0.0,
                 tick_s: float = 0.002):
        self._base = start
        self._rate = float(rate)
        self._offset = 0.0
        self._t0 = time.monotonic()
        self._tick_s = tick_s
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._base + self._offset + (
                time.monotonic() - self._t0) * self._rate

    def advance(self, duration: float) -> None:
        """Jump virtual time forward by ``duration`` seconds."""
        with self._lock:
            self._offset += float(duration)

    async def sleep(self, duration: float) -> None:
        deadline = self.now() + duration
        while self.now() < deadline:
            await asyncio.sleep(self._tick_s)

    def sleep_sync(self, duration: float) -> None:
        """Blocking variant for thread-based loops (serve controller)."""
        deadline = self.now() + duration
        while self.now() < deadline:
            time.sleep(self._tick_s)


_WALL = WallClock()
_clock: Clock | None = None
_clock_lock = threading.Lock()


def _from_spec(spec: str) -> Clock:
    """``"" | "wall" -> WallClock``; ``"virtual" | "virtual:RATE"`` ->
    VirtualClock (default rate 0 = manual advance only)."""
    spec = (spec or "").strip()
    if not spec or spec == "wall":
        return _WALL
    if spec.startswith("virtual"):
        _, _, rate = spec.partition(":")
        return VirtualClock(rate=float(rate) if rate else 0.0)
    raise ValueError(f"Unknown chaos_clock spec: {spec!r}")


def get_clock() -> Clock:
    """The process clock; initialized from the ``chaos_clock`` config
    entry (so workers spawned with ``RAY_TPU_chaos_clock=virtual:50``
    inherit virtual time) and replaceable via :func:`set_clock`."""
    global _clock
    if _clock is None:
        with _clock_lock:
            if _clock is None:
                try:
                    from ..core.config import get_config

                    _clock = _from_spec(get_config().chaos_clock)
                except Exception:
                    _clock = _WALL
    return _clock


def set_clock(clock: Clock | None) -> None:
    """Install a clock for this process (tests / chaos runner).
    ``None`` resets to the config-derived default."""
    global _clock
    with _clock_lock:
        _clock = clock


def now() -> float:
    return get_clock().now()


async def sleep(duration: float) -> None:
    await get_clock().sleep(duration)


def sleep_sync(duration: float) -> None:
    clock = get_clock()
    if isinstance(clock, VirtualClock):
        clock.sleep_sync(duration)
    else:
        time.sleep(duration)
