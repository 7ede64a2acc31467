"""Observability: trace-context propagation, spans and the per-request
flight recorder.

A ``TraceContext`` (trace id and parent span id) captured when a request
enters the engine parents the engine's spans (``llm.prefix_match``,
``llm.prefill``, ``llm.decode``, ``llm.speculate``, ``llm.adapter_load``
and the ``llm.request_timeline`` dump of a breached request); finished
spans are kept in a bounded process-local buffer (``local_spans``).
"""

from .loop_recorder import EVENT_NAMES, RequestTimeline
from .tracing import (
    TraceContext,
    bind,
    context_from_headers,
    current,
    current_wire,
    local_spans,
    make_span,
    new_span_id,
    new_trace_id,
    record_span,
    set_current,
    span,
    use_context,
)

__all__ = [
    "EVENT_NAMES",
    "RequestTimeline",
    "TraceContext",
    "bind",
    "context_from_headers",
    "current",
    "current_wire",
    "local_spans",
    "make_span",
    "new_span_id",
    "new_trace_id",
    "record_span",
    "set_current",
    "span",
    "use_context",
]
