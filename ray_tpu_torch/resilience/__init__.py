"""Elastic resilience: async, atomically committed train-state
checkpoints (each committed version registered with the GCS, so
recovery finds the latest one without touching a dead node), and the
preemption notices: hazard views over the GCS node table, read by the
Serve controller (proactive replica eviction), and the GCE metadata
watcher a raylet runs when ``preempt_metadata_watch`` is on.
"""

from .checkpoint import (
    AsyncCheckpointManager,
    latest_committed,
    latest_registered,
    list_committed,
    load_checkpoint,
    register_latest,
)
from .metadata_watcher import GceMetadataPreemptionWatcher
from .preemption import PreemptionNotice, hazard_nodes

__all__ = [
    "AsyncCheckpointManager",
    "GceMetadataPreemptionWatcher",
    "PreemptionNotice",
    "hazard_nodes",
    "latest_committed",
    "latest_registered",
    "list_committed",
    "load_checkpoint",
    "register_latest",
]
