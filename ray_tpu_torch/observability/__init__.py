"""Observability: trace-context propagation, spans, cluster memory and
the per-request flight recorder.

A ``TraceContext`` (trace id and parent span id) captured when a request
enters the engine parents the engine's spans (``llm.prefix_match``,
``llm.prefill``, ``llm.decode``, ``llm.speculate``, ``llm.adapter_load``
and the ``llm.request_timeline`` dump of a breached request). In a
process with a core worker, finished spans ride its task-event buffer to
the GCS (``spans``); elsewhere they stay in a bounded process-local
buffer (``local_spans``). ``memory`` holds the reference debugging and
node accounting (RSS, CUDA memory) the runtime reports.
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
from .spans import GcsSpanStore, format_trace_tree, spans_to_chrome
from .memory import (
    GcsMemoryStore,
    capture_callsite,
    classify_ref,
    format_memory_summary,
    hbm_stats,
    process_rss_bytes,
)

__all__ = [
    "EVENT_NAMES",
    "GcsMemoryStore",
    "GcsSpanStore",
    "RequestTimeline",
    "TraceContext",
    "bind",
    "capture_callsite",
    "classify_ref",
    "context_from_headers",
    "current",
    "current_wire",
    "format_memory_summary",
    "format_trace_tree",
    "hbm_stats",
    "local_spans",
    "make_span",
    "new_span_id",
    "new_trace_id",
    "process_rss_bytes",
    "record_span",
    "set_current",
    "span",
    "spans_to_chrome",
    "use_context",
]
