"""Trace-context propagation and span recording.

The port of ``ray_tpu/observability/tracing.py``. A span is a plain dict::

    {"trace_id", "span_id", "parent_id", "name", "kind",
     "start", "end",              # wall-clock seconds (time.time())
     "attrs": {...}}

The active context is thread-local: it is installed explicitly at every
thread hop (``bind``) or around a block (``use_context``, ``span``).

Finished spans go to a bounded process-local buffer readable through
``local_spans()``; the port has no runtime yet to ship them to. Tracing is
always on, and recording never raises into the traced operation.
"""

from __future__ import annotations

import contextlib
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable

TRACE_HEADER = "x-raytpu-trace"

_tls = threading.local()

_local_lock = threading.Lock()
_local_spans: list[dict] = []
_LOCAL_MAX = 4096


# One trace id and one span id per request: a process-seeded Random gives
# the bits tracing needs without an os.urandom call each (a forked child
# reseeds, so it never replays its parent's ids).
_id_rng = random.Random()
_id_rng.seed(int.from_bytes(os.urandom(16), "big") ^ os.getpid())
_id_pid = os.getpid()
_id_lock = threading.Lock()


def _id_hex(bits: int) -> str:
    global _id_pid
    with _id_lock:
        if os.getpid() != _id_pid:
            _id_rng.seed(int.from_bytes(os.urandom(16), "big") ^ os.getpid())
            _id_pid = os.getpid()
        return f"{_id_rng.getrandbits(bits):0{bits // 4}x}"


def new_trace_id() -> str:
    return _id_hex(128)


def new_span_id() -> str:
    return _id_hex(64)


@dataclass(frozen=True)
class TraceContext:
    trace_id: str
    span_id: str
    parent_id: str = ""

    def child(self) -> "TraceContext":
        return TraceContext(self.trace_id, new_span_id(), self.span_id)

    def to_wire(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id}


def current() -> TraceContext | None:
    return getattr(_tls, "ctx", None)


def current_wire() -> dict | None:
    ctx = current()
    return ctx.to_wire() if ctx is not None else None


def set_current(ctx: TraceContext | None) -> TraceContext | None:
    """Install ``ctx`` as this thread's active context; returns the
    previous one so callers can restore it."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    return prev


@contextlib.contextmanager
def use_context(ctx: TraceContext | None):
    prev = set_current(ctx)
    try:
        yield ctx
    finally:
        set_current(prev)


def bind(ctx: TraceContext | None, fn: Callable, *args, **kwargs) -> Callable:
    """Wrap ``fn`` so it runs under ``ctx`` on whatever thread executes
    it (thread-locals do not survive a hop to another thread)."""

    def _wrapped():
        prev = set_current(ctx)
        try:
            return fn(*args, **kwargs)
        finally:
            set_current(prev)

    return _wrapped


def context_from_headers(headers: dict | None) -> TraceContext:
    """Root context for an ingress request: continue an incoming
    ``x-raytpu-trace: <trace_id>:<span_id>`` header (the remote span
    becomes our parent) or start a fresh trace."""
    raw = (headers or {}).get(TRACE_HEADER, "")
    if raw and ":" in raw:
        trace_id, _, parent = raw.partition(":")
        if trace_id:
            return TraceContext(trace_id, new_span_id(), parent)
    return TraceContext(new_trace_id(), new_span_id())


def make_span(name: str, kind: str, start: float, end: float,
              trace_id: str, parent_id: str = "", span_id: str | None = None,
              attrs: dict | None = None) -> dict:
    return {
        "trace_id": trace_id,
        "span_id": span_id or new_span_id(),
        "parent_id": parent_id,
        "name": name,
        "kind": kind,
        "start": start,
        "end": end,
        "attrs": attrs or {},
    }


def record_span(span_dict: dict) -> None:
    """Buffer one finished span (a span without a trace id is dropped).
    The buffer keeps the newest ``_LOCAL_MAX``: when full, its oldest
    quarter goes."""
    if not span_dict.get("trace_id"):
        return
    with _local_lock:
        if len(_local_spans) >= _LOCAL_MAX:
            del _local_spans[: _LOCAL_MAX // 4]
        _local_spans.append(span_dict)


def local_spans(trace_id: str | None = None) -> list[dict]:
    """Spans recorded in this process, oldest first; only ``trace_id``'s
    when given."""
    with _local_lock:
        out = list(_local_spans)
    if trace_id:
        out = [s for s in out if s["trace_id"] == trace_id]
    return out


@contextlib.contextmanager
def span(name: str, kind: str = "app", attrs: dict | None = None,
         root: bool = False):
    """Record a span around a code block. Opens a child of the current
    context (or a fresh root trace when there is none or ``root=True``)
    and installs itself as the current context for the duration, so
    anything started inside (an engine request, say) chains under it."""
    parent = None if root else current()
    if parent is None:
        ctx = TraceContext(new_trace_id(), new_span_id())
    else:
        ctx = parent.child()
    start = time.time()
    with use_context(ctx):
        try:
            yield ctx
        finally:
            record_span(make_span(name, kind, start, time.time(),
                                  ctx.trace_id, ctx.parent_id, ctx.span_id,
                                  attrs))
