"""Autoscaler: demand-driven reconciliation of GPU worker pools.

Equivalent of the reference's autoscaler v2
(``python/ray/autoscaler/v2/scheduler.py:624`` ResourceDemandScheduler +
``instance_manager``): pending lease shapes (reported by raylets in
heartbeats), unplaceable placement groups, and explicit
``request_resources`` floors are bin-packed against live capacity; the
shortfall launches typed nodes through a NodeProvider, and idle nodes
above ``min_workers`` are terminated after a timeout.

The port of ``ray_tpu/autoscaler``: the reconciler and the instance
lifecycle are the JAX package's, the cloud providers create GPU VMs
(``GceGpuNodeProvider``) or scale KubeRay GPU worker groups
(``GkeGpuNodeProvider``).
"""

from .autoscaler import Autoscaler, NodeTypeConfig
from .gce import GceGpuNodeProvider
from .gke import GkeGpuNodeProvider
from .instance_manager import Instance, InstanceManager
from .node_provider import LocalNodeProvider, NodeProvider
from .sdk import request_resources

__all__ = [
    "Autoscaler",
    "GceGpuNodeProvider",
    "GkeGpuNodeProvider",
    "Instance",
    "InstanceManager",
    "NodeTypeConfig",
    "NodeProvider",
    "LocalNodeProvider",
    "request_resources",
]
