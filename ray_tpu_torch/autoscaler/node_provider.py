"""NodeProvider: the cloud-side interface the reconciler drives.

Equivalent of the reference's ``python/ray/autoscaler/node_provider.py``
(create/terminate/list). A real GPU deployment implements this against
its VM or pod API (``gce.GceGpuNodeProvider``,
``gke.GkeGpuNodeProvider``); ``LocalNodeProvider`` backs it with
in-process raylets on the Cluster harness so autoscaling is testable
end-to-end — launched "nodes" really join the GCS and run work.

The port of ``ray_tpu/autoscaler/node_provider.py``, on the port's
``cluster_utils.Cluster``.
"""

from __future__ import annotations

import threading


class NodeLaunchError(Exception):
    """A node launch the provider could not fulfil. ``transient=True``
    marks capacity-class failures (quota exhausted, zone stockout — the
    dominant real accelerator failure) the reconciler should back off on and
    route around, rather than config errors worth surfacing loudly."""

    def __init__(self, message: str, *, transient: bool = False,
                 reason: str = ""):
        super().__init__(message)
        self.transient = transient
        self.reason = reason


class NodeProvider:
    def create_node(self, node_type: str, resources: dict) -> str:
        """Launch a node of `node_type`; returns a provider instance id."""
        raise NotImplementedError

    def terminate_node(self, instance_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> dict[str, str]:
        """instance_id -> node_type for nodes this provider launched."""
        raise NotImplementedError

    def node_id_of(self, instance_id: str) -> str | None:
        """Cluster node id (hex) for a launched instance, once known."""
        raise NotImplementedError


class LocalNodeProvider(NodeProvider):
    """Launch raylets on a ``cluster_utils.Cluster`` (the harness plays the
    role of the cloud API)."""

    def __init__(self, cluster):
        self.cluster = cluster
        self._lock = threading.Lock()
        self._instances: dict[str, dict] = {}  # instance_id -> {type, raylet}
        self._counter = 0
        self._preempted: dict[str, str] = {}  # instance_id -> node_type

    def create_node(self, node_type: str, resources: dict) -> str:
        res = dict(resources)
        num_cpus = res.pop("CPU", 0)
        raylet = self.cluster.add_node(wait=False, num_cpus=num_cpus, resources=res)
        with self._lock:
            self._counter += 1
            iid = f"local-{node_type}-{self._counter}"
            self._instances[iid] = {"type": node_type, "raylet": raylet}
        return iid

    def terminate_node(self, instance_id: str) -> None:
        with self._lock:
            inst = self._instances.pop(instance_id, None)
        if inst is not None:
            self.cluster.remove_node(inst["raylet"], allow_graceful=True)

    def non_terminated_nodes(self) -> dict[str, str]:
        with self._lock:
            return {iid: inst["type"] for iid, inst in self._instances.items()}

    def node_id_of(self, instance_id: str) -> str | None:
        with self._lock:
            inst = self._instances.get(instance_id)
        return inst["raylet"].node_id.hex() if inst else None

    # ------------------------------------------------------------- preemption
    def preempt_node(self, instance_id: str,
                     grace_s: float | None = None) -> bool:
        """Simulate a GCE spot reclaim of a launched node: the raylet gets
        a preemption notice (drains, then its workers die after the
        grace) and the instance surfaces in ``preemption_notices()`` so
        the reconciler terminates + replaces it — the full preemption
        path, end to end, on the in-process harness."""
        with self._lock:
            inst = self._instances.get(instance_id)
        if inst is None:
            return False
        self.cluster._loop.run_sync(inst["raylet"].handle_PreemptionNotice({
            "reason": "spot reclaim (simulated)", "grace_s": grace_s}))
        with self._lock:
            self._preempted[instance_id] = inst["type"]
        return True

    def preemption_notices(self) -> dict[str, str]:
        with self._lock:
            return dict(self._preempted)

    def ack_preemption(self, instance_id: str) -> None:
        with self._lock:
            self._preempted.pop(instance_id, None)
