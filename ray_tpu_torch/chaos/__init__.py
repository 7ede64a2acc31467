"""Chaos support the runtime reads: the cluster clock.

``clock`` holds the process-wide clock (wall time, or a ``VirtualClock``
under the ``chaos_clock`` config entry) that the raylet, GCS, workers and
Serve controller read for their timeouts and backoffs.
"""

from .clock import Clock, VirtualClock, WallClock, get_clock, set_clock

__all__ = ["Clock", "VirtualClock", "WallClock", "get_clock", "set_clock"]
