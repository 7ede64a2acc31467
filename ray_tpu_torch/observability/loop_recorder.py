"""Per-request flight recorder.

The port of ``RequestTimeline`` and the ``EV_*`` event codes of
``ray_tpu/observability/loop_recorder.py``: one bounded event log per
engine request, always on (admission, prefix hit, COW fork, prefill
chunks, first token, every token, speculation rounds, shed or deadline,
retire), kept in preallocated ``array`` buffers of a few hundred bytes.
On a breach (a deadline, a shed) the engine dumps the whole timeline once
as an ``llm.request_timeline`` span. Recording never raises into the
recorded path.
"""

from __future__ import annotations

import time
from array import array

EV_ADMIT = 1          # value: prompt length
EV_SHED = 2           # value: 0=queue_full 1=admission
EV_PREFIX_HIT = 3     # value: cached prefix tokens served from the trie
EV_COW_FORK = 4       # value: the page the shared partial tail forked to
EV_PREFILL_CHUNK = 5  # value: tokens prefilled by this chunk
EV_FIRST_TOKEN = 6    # value: tokens prefilled in total
EV_TOKEN = 7          # value: generated-so-far (ITL = delta to prev event)
EV_SPEC_ROUND = 8     # value: tokens accepted this speculation round
EV_DEADLINE = 9       # value: generated tokens at expiry
EV_MIGRATE = 10       # value: prompt tokens imported from a peer's KV
EV_RETIRE = 11        # value: total generated tokens

EVENT_NAMES = {
    EV_ADMIT: "admit", EV_SHED: "shed", EV_PREFIX_HIT: "prefix_hit",
    EV_COW_FORK: "cow_fork", EV_PREFILL_CHUNK: "prefill_chunk",
    EV_FIRST_TOKEN: "first_token", EV_TOKEN: "token",
    EV_SPEC_ROUND: "spec_round", EV_DEADLINE: "deadline_expired",
    EV_MIGRATE: "kv_migrate_in", EV_RETIRE: "retire",
}


class RequestTimeline:
    """Bounded per-request event log: preallocated code/time/value
    arrays, overwritten in a circle that keeps the newest ``capacity``
    events. The early one-shot events (admission, prefix hit, first
    token) are also mirrored into ``_pinned``, so a lapped timeline still
    opens at its admission."""

    __slots__ = ("capacity", "_codes", "_times", "_values", "n",
                 "dumped", "_pinned")

    #: Event codes kept even after the ring laps them: the request's
    #: shape is unreadable without its opening acts.
    PIN = frozenset((EV_ADMIT, EV_PREFIX_HIT, EV_MIGRATE, EV_FIRST_TOKEN))

    def __init__(self, capacity: int = 64):
        self.capacity = int(capacity)
        self._codes = array("B", bytes(self.capacity))
        self._times = array("d", bytes(8 * self.capacity))
        self._values = array("i", bytes(4 * self.capacity))
        self.n = 0
        self.dumped = False
        self._pinned: list[tuple[int, float, int]] = []

    def add(self, code: int, value: int = 0, now: float | None = None) -> None:
        """Record one event: three array stores and a counter. A value
        outside int32 is stored as 0 (a pinned copy keeps it whole), one
        that is not an integer as 0; a code outside 0..255 drops the
        event."""
        try:
            v = int(value)
        except (TypeError, ValueError, OverflowError):
            v = 0
        i = self.n % self.capacity
        t = time.time() if now is None else now
        try:
            self._codes[i] = code
        except (TypeError, OverflowError):
            return
        self._times[i] = t
        self._values[i] = v if -2**31 <= v < 2**31 else 0
        self.n += 1
        if code in self.PIN and len(self._pinned) < 8:
            self._pinned.append((code, t, v))

    @property
    def overflowed(self) -> bool:
        return self.n > self.capacity

    def nbytes(self) -> int:
        """The preallocated arrays' storage: what 1k concurrent requests'
        recorders cost is 1k times this."""
        return (self._codes.itemsize * self.capacity
                + self._times.itemsize * self.capacity
                + self._values.itemsize * self.capacity)

    def events(self) -> list[dict]:
        """Surviving events, oldest to newest; lapped pinned events are
        put back in front, so a dumped timeline always reads
        admission … terminal."""
        n = min(self.n, self.capacity)
        start = self.n - n
        out = []
        if self.overflowed:
            kept = {(self._codes[k % self.capacity],
                     self._times[k % self.capacity])
                    for k in range(start, self.n)}
            for code, t, v in self._pinned:
                if (code, t) not in kept:
                    out.append({"ev": EVENT_NAMES.get(code, code),
                                "t": t, "v": v, "pinned": True})
        for k in range(start, self.n):
            i = k % self.capacity
            out.append({"ev": EVENT_NAMES.get(self._codes[i],
                                              int(self._codes[i])),
                        "t": self._times[i], "v": self._values[i]})
        return out

    def to_payload(self) -> dict:
        """The attrs of the ``llm.request_timeline`` dump."""
        evs = self.events()
        return {
            "events": evs,
            "n_events": self.n,
            "dropped": max(0, self.n - self.capacity),
            "overflowed": self.overflowed,
            "start": evs[0]["t"] if evs else 0.0,
            "end": evs[-1]["t"] if evs else 0.0,
        }
