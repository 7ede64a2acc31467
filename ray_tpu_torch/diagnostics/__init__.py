"""ray_tpu.diagnostics: cluster failure visibility.

Three legs (reference: ``ray._private.utils.publish_error_to_driver``,
the raylet's periodic ``debug_state.txt`` dumps, and the ``ray
health-check`` / ``ray status`` CLIs):

  * an **error-info pub/sub channel** through the GCS: any worker,
    raylet, or serve component publishes a structured ``ErrorEvent``;
    drivers auto-subscribe and log them, and ``util.state.list_errors()``
    queries the retained buffer;
  * **debug-state dumps**: every raylet (lease queue, worker pool,
    store/spill counters) and the GCS (actor/PG FSM counts) periodically
    snapshot their internals to ``debug_state_*.txt`` in the session dir,
    and serve the same snapshot over a ``GetDebugState`` RPC;
  * a **lease-wedge watchdog** in the raylet that fires an ErrorEvent
    (with a full queue snapshot) when a lease sits pending past a
    threshold while matching resources are free — the head-of-line /
    missed-wake signature of a wedged admission queue.
"""

from .errors import (
    ERROR_INFO_CHANNEL,
    ErrorEvent,
    make_event,
    publish_error_to_driver,
)
from .debug_state import format_debug_state, write_debug_state

__all__ = [
    "ERROR_INFO_CHANNEL",
    "ErrorEvent",
    "format_debug_state",
    "make_event",
    "publish_error_to_driver",
    "write_debug_state",
]
