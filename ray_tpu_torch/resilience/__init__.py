"""Preemption notices: hazard views over the GCS node table, read by the
Serve controller (proactive replica eviction), and the GCE metadata
watcher a raylet runs when ``preempt_metadata_watch`` is on.
"""

from .metadata_watcher import GceMetadataPreemptionWatcher
from .preemption import PreemptionNotice, hazard_nodes

__all__ = ["GceMetadataPreemptionWatcher", "PreemptionNotice", "hazard_nodes"]
