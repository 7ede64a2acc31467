"""Tick-level stall attribution and the per-request flight recorder.

The port of ``ray_tpu/observability/loop_recorder.py``: two fixed-size
recorders, allocation-free on the recorded path, that never raise into
it.

* :class:`StallRing` lives inside a resident compiled-loop stage process
  (``dag/loop.py::_loop_tick``) and records, per tick, how the wall time
  split between waiting on upstream input (``wait_up``), computing
  (``compute``) and waiting on downstream credits (``wait_down``), in
  three preallocated ``array('d')`` buffers. Aggregates leave the process
  only on the loop's span cadence (``dag_loop_span_every``), never per
  tick; ``classify_stage`` and ``classify_loop`` name where a stage's
  time goes and which stage is the loop's bottleneck.
* :class:`RequestTimeline`: one bounded event log per engine request,
  always on (admission, prefix hit, COW fork, prefill chunks, first
  token, every token, speculation rounds, shed or deadline, retire), kept
  in preallocated ``array`` buffers of a few hundred bytes. On a breach
  (a deadline, a shed) the engine dumps the whole timeline once as an
  ``llm.request_timeline`` span.
"""

from __future__ import annotations

import threading
import time
from array import array

# ----------------------------------------------------------- stall attribution

#: Phase order inside one tick; also the ``bucket`` tag values of the
#: ``ray_tpu_dag_loop_tick_ms`` histogram.
STALL_BUCKETS = ("wait_up", "compute", "wait_down")
WAIT_UP, COMPUTE, WAIT_DOWN = 0, 1, 2

#: Millisecond-scale boundaries tuned for tick phases (ticks run µs–ms;
#: the default LATENCY_MS_BOUNDARIES start at 1ms and would collapse a
#: healthy loop into one bucket).
TICK_MS_BOUNDARIES = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
    50.0, 100.0, 500.0,
)


class StallRing:
    """Fixed-size per-stage ring of (wait_up, compute, wait_down) tick
    splits, in milliseconds. Written by exactly one thread (the resident
    tick executor); snapshots tolerate torn reads (diagnostic data)."""

    __slots__ = ("capacity", "ticks", "_flushed", "_ms", "totals_ms",
                 "last_file_ts")

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self.ticks = 0          # total ticks ever recorded
        self._flushed = 0       # ticks already drained to the histogram
        self._ms = tuple(array("d", bytes(8 * self.capacity))
                         for _ in range(3))
        self.totals_ms = array("d", (0.0, 0.0, 0.0))
        # monotonic stamp of the last snapshot-file write (owned by the
        # flusher in dag/loop.py; lives here so it resets with the ring)
        self.last_file_ts = 0.0

    def record(self, wait_up_ms: float, compute_ms: float,
               wait_down_ms: float) -> None:
        i = self.ticks % self.capacity
        ms = self._ms
        ms[WAIT_UP][i] = wait_up_ms
        ms[COMPUTE][i] = compute_ms
        ms[WAIT_DOWN][i] = wait_down_ms
        t = self.totals_ms
        t[WAIT_UP] += wait_up_ms
        t[COMPUTE] += compute_ms
        t[WAIT_DOWN] += wait_down_ms
        self.ticks += 1

    @property
    def overflowed(self) -> bool:
        """True once older ticks have been overwritten (newest-N kept)."""
        return self.ticks > self.capacity

    def drain(self) -> list[tuple[float, float, float]]:
        """Per-tick splits recorded since the previous ``drain`` (capped
        at ``capacity`` — a long flush gap keeps only the newest-N)."""
        n = min(self.ticks - self._flushed, self.capacity)
        out = []
        for k in range(self.ticks - n, self.ticks):
            i = k % self.capacity
            out.append((self._ms[WAIT_UP][i], self._ms[COMPUTE][i],
                        self._ms[WAIT_DOWN][i]))
        self._flushed = self.ticks
        return out

    def snapshot(self) -> dict:
        """Aggregate view: lifetime totals + mean split over the newest-N
        resident ticks. Plain dict so it serializes anywhere."""
        n = min(self.ticks, self.capacity)
        recent = [0.0, 0.0, 0.0]
        for k in range(self.ticks - n, self.ticks):
            i = k % self.capacity
            for p in range(3):
                recent[p] += self._ms[p][i]
        total = sum(self.totals_ms) or 1.0
        return {
            "ticks": self.ticks,
            "overflowed": self.overflowed,
            "totals_ms": {b: round(self.totals_ms[p], 3)
                          for p, b in enumerate(STALL_BUCKETS)},
            "frac": {b: round(self.totals_ms[p] / total, 4)
                     for p, b in enumerate(STALL_BUCKETS)},
            "recent_mean_ms": {b: round(recent[p] / n, 4) if n else 0.0
                               for p, b in enumerate(STALL_BUCKETS)},
        }


def classify_stage(frac: dict | None, ticks: int = 0) -> str:
    """One word for where a stage's time goes: ``compute_bound`` when
    compute dominates, ``starved`` when it mostly waits on upstream,
    ``backpressured`` when it mostly waits on downstream credits."""
    if not frac or not ticks:
        return "idle"
    if frac.get("compute", 0.0) >= 0.5:
        return "compute_bound"
    if frac.get("wait_up", 0.0) >= frac.get("wait_down", 0.0):
        return "starved"
    return "backpressured"


def classify_loop(stages: dict) -> str | None:
    """The loop's bottleneck stage: the one spending the largest
    fraction of its time computing — everyone else is waiting on it
    (directly or through credit backpressure)."""
    best, best_frac = None, -1.0
    for name, st in stages.items():
        frac = (st.get("frac") or {}).get("compute", 0.0)
        if st.get("ticks") and frac > best_frac:
            best, best_frac = name, frac
    return best


# In-process registry: (loop_id, stage) -> StallRing, so a stage actor
# hosting several sequential loops over its lifetime keeps them apart.
_rings_lock = threading.Lock()
_rings: dict[tuple[str, str], StallRing] = {}
_RINGS_MAX = 64  # a stage process hosts few loops; bound leakage anyway


def get_stall_ring(loop_id: str, stage: str,
                   capacity: int = 256) -> StallRing:
    key = (loop_id, stage)
    with _rings_lock:
        ring = _rings.get(key)
        if ring is None:
            if len(_rings) >= _RINGS_MAX:
                _rings.pop(next(iter(_rings)))
            ring = _rings[key] = StallRing(capacity)
        return ring


def stall_snapshots(loop_id: str) -> dict[str, dict]:
    """All of this process's stage snapshots for one loop."""
    with _rings_lock:
        items = [(k[1], r) for k, r in _rings.items() if k[0] == loop_id]
    return {stage: ring.snapshot() for stage, ring in items}


# ------------------------------------------------------ request flight recorder

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
