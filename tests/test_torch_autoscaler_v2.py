"""The port's autoscaler v2 pieces: ``tests/test_autoscaler_v2.py``'s
cases against fake clouds — the typed instance lifecycle
(``InstanceManager``) with GPU shapes, the GCE GPU provider's reclaim
notices, and ``GkeGpuNodeProvider``'s KubeRay CR patches for one-host
GPU groups and multi-host groups (``replicaIndex``)."""

import pytest

from ray_tpu_torch.autoscaler import GkeGpuNodeProvider
from ray_tpu_torch.autoscaler.gce import GceGpuNodeProvider
from ray_tpu_torch.autoscaler.instance_manager import (
    ALLOCATED,
    ALLOCATION_FAILED,
    RAY_RUNNING,
    REQUESTED,
    TERMINATED,
    TERMINATING,
    InstanceManager,
    InvalidTransition,
)


class FakeCloud:
    """NodeProvider test double with controllable visibility/failures."""

    def __init__(self):
        self.created = []
        self.terminated = []
        self.visible = set()
        self.fail_create = False
        self.ignore_terminate = False
        self._n = 0
        self.preempted = {}  # iid -> node_type (reclaim notices)

    def create_node(self, node_type, resources):
        if self.fail_create:
            raise RuntimeError("stockout")
        self._n += 1
        iid = f"vm-{self._n}"
        self.created.append(iid)
        self.visible.add(iid)
        return iid

    def terminate_node(self, iid):
        self.terminated.append(iid)
        if not self.ignore_terminate:
            self.visible.discard(iid)

    def non_terminated_nodes(self):
        return {iid: "t" for iid in self.visible}

    def node_id_of(self, iid):
        return None

    def preempt(self, iid):
        """The cloud reclaims a spot VM: it leaves the listing and a
        notice surfaces (GceGpuNodeProvider semantics)."""
        self.visible.discard(iid)
        self.preempted[iid] = "t"

    def preemption_notices(self):
        return dict(self.preempted)

    def ack_preemption(self, iid):
        self.preempted.pop(iid, None)


def test_instance_lifecycle_happy_path():
    cloud = FakeCloud()
    mgr = InstanceManager(cloud)
    iid = mgr.create_node("t", {"CPU": 1, "GPU": 1})
    (inst,) = mgr.instances()
    assert inst.state == REQUESTED and inst.cloud_instance_id == iid

    mgr.reconcile([])
    assert mgr.instances()[0].state == ALLOCATED

    mgr.reconcile([{"node_id": "gcs-node-1", "state": "ALIVE"}])
    inst = mgr.instances()[0]
    assert inst.state == RAY_RUNNING and inst.node_id == "gcs-node-1"

    mgr.terminate_node(iid)
    assert mgr.instances()[0].state == TERMINATING
    mgr.reconcile([])
    assert mgr.instances()[0].state == TERMINATED
    assert [s for s, _ in mgr.instances()[0].history] == [
        "QUEUED", REQUESTED, ALLOCATED, RAY_RUNNING, TERMINATING, TERMINATED]


def test_allocation_failure_retries_then_gives_up():
    cloud = FakeCloud()
    cloud.fail_create = True
    mgr = InstanceManager(cloud, max_allocation_retries=2)
    mgr.create_node("t", {"GPU": 1})
    assert mgr.instances()[0].state == ALLOCATION_FAILED
    repairs = mgr.reconcile([])
    assert repairs["allocation_retried"] == 1
    assert mgr.instances()[0].state == ALLOCATION_FAILED  # retry also failed
    mgr.reconcile([])
    repairs = mgr.reconcile([])
    assert repairs["allocation_failed"] == 1
    assert mgr.instances()[0].state == TERMINATED

    # ...but a recovered cloud lets a retry succeed
    cloud2 = FakeCloud()
    cloud2.fail_create = True
    mgr2 = InstanceManager(cloud2, max_allocation_retries=2)
    mgr2.create_node("t", {"GPU": 1})
    cloud2.fail_create = False
    mgr2.reconcile([])
    assert mgr2.instances()[0].state == REQUESTED
    assert mgr2.instances()[0].retries == 1


def test_stuck_ray_boot_replaced():
    cloud = FakeCloud()
    mgr = InstanceManager(cloud, ray_boot_timeout_s=0.0)
    mgr.create_node("t", {})
    mgr.reconcile([])  # -> ALLOCATED
    repairs = mgr.reconcile([])  # boot timeout immediately (0s)
    assert repairs["ray_boot_timeout"] == 1
    inst = mgr.instances()[0]
    assert inst.state == TERMINATING
    assert cloud.terminated == [inst.cloud_instance_id]


def test_stuck_terminate_reissued():
    cloud = FakeCloud()
    cloud.ignore_terminate = True
    mgr = InstanceManager(cloud, terminate_timeout_s=0.0)
    iid = mgr.create_node("t", {})
    mgr.reconcile([])
    mgr.terminate_node(iid)
    repairs = mgr.reconcile([])
    assert repairs["terminate_reissued"] == 1
    assert cloud.terminated.count(iid) == 2


def test_preexisting_gcs_nodes_never_claimed():
    """The head node (alive before any managed instance) is never matched
    to an ALLOCATED instance."""
    cloud = FakeCloud()
    mgr = InstanceManager(cloud)
    mgr.reconcile([{"node_id": "head", "state": "ALIVE"}])  # snapshot
    mgr.create_node("t", {})
    mgr.reconcile([{"node_id": "head", "state": "ALIVE"}])
    assert mgr.instances()[0].state == ALLOCATED  # not RAY_RUNNING via head
    mgr.reconcile([{"node_id": "head", "state": "ALIVE"},
                   {"node_id": "w1", "state": "ALIVE"}])
    inst = mgr.instances()[0]
    assert inst.state == RAY_RUNNING and inst.node_id == "w1"


def test_preempted_instance_detected_and_replaced():
    """A RAY_RUNNING instance the cloud reclaims is terminated AND a
    same-shape replacement is requested in the SAME reconcile round."""
    cloud = FakeCloud()
    mgr = InstanceManager(cloud)
    iid = mgr.create_node("t", {"CPU": 26, "GPU": 1})
    mgr.reconcile([])  # -> ALLOCATED
    mgr.reconcile([{"node_id": "n1", "state": "ALIVE"}])  # -> RAY_RUNNING
    assert mgr.instances()[0].state == RAY_RUNNING

    cloud.preempt(iid)
    repairs = mgr.reconcile([{"node_id": "n1", "state": "ALIVE"}])
    assert repairs["preempt_replaced"] == 1
    by_state = {i.state: i for i in mgr.instances()}
    assert by_state.get(TERMINATING) or by_state.get(TERMINATED)
    replacement = by_state[REQUESTED]
    assert replacement.node_type == "t"
    assert replacement.resources == {"CPU": 26, "GPU": 1}
    assert len(cloud.created) == 2
    # the notice was acked: a second round must not replace again
    repairs = mgr.reconcile([{"node_id": "n1", "state": "ALIVE"}])
    assert repairs["preempt_replaced"] == 0
    assert len(cloud.created) == 2


def test_preemption_replacement_disabled():
    """replace_preempted=False: the reclaimed instance still terminates (it
    left the listing) but no replacement is requested."""
    cloud = FakeCloud()
    mgr = InstanceManager(cloud, replace_preempted=False)
    iid = mgr.create_node("t", {})
    mgr.reconcile([])
    mgr.reconcile([{"node_id": "n1", "state": "ALIVE"}])
    cloud.preempt(iid)
    repairs = mgr.reconcile([])
    assert repairs["preempt_replaced"] == 0
    assert len(cloud.created) == 1
    assert mgr.instances()[0].state == TERMINATED  # listing-vanish path


@pytest.mark.parametrize("status", ["TERMINATED", "STOPPING"])
def test_gce_provider_surfaces_reclaim_notices(status):
    """The GCE GPU provider turns a tracked VM the cloud stopped (listed
    STOPPING or TERMINATED, the part the TPU API's PREEMPTED plays) into a
    typed notice, and out of the live listing, until the reconciler acks
    it."""
    class FakeTransport:
        def __init__(self):
            self.items = []

        def request(self, method, url, body=None):
            if method == "GET":
                return {"items": self.items}
            return {}

    transport = FakeTransport()
    p = GceGpuNodeProvider(
        "proj", "zone", gcs_address="host:1", source_image="img",
        node_types={"h100": {"machine_type": "a3-highgpu-1g",
                             "spot": True}},
        transport=transport)
    iid = p.create_node("h100", {})
    transport.items = [{
        "name": iid, "status": "RUNNING",
        "labels": {"raytpu-cluster": "raytpu", "raytpu-node-type": "h100"},
    }]
    assert iid in p.non_terminated_nodes()
    assert p.preemption_notices() == {}

    transport.items[0]["status"] = status
    assert iid not in p.non_terminated_nodes()
    assert p.preemption_notices() == {iid: "h100"}
    p.ack_preemption(iid)
    assert p.preemption_notices() == {}


def test_invalid_transition_rejected():
    cloud = FakeCloud()
    mgr = InstanceManager(cloud)
    mgr.create_node("t", {})
    inst = mgr.instances()[0]
    with pytest.raises(InvalidTransition):
        mgr._transition(inst, TERMINATED)  # REQUESTED -> TERMINATED


# ---------------------------------------------------------------- GKE/KubeRay


class FakeK8s:
    """Mimics the RayCluster CR + the operator's pod actuation: the
    operator deletes exactly the named workers and creates fresh replicas
    to reach the requested count (KubeRay semantics). A one-host group's
    pod is named for its replica and carries no ``replicaIndex``; a
    multi-host group's pods share one."""

    def __init__(self, groups):
        self.cr = {"spec": {"workerGroupSpecs": [
            {"groupName": name, "replicas": 0, "numOfHosts": hosts}
            for name, hosts in groups.items()
        ]}}
        self.live: dict[str, list[str]] = {name: [] for name in groups}
        self._next: dict[str, int] = {name: 0 for name in groups}
        self.patches = []

    def _operate(self):
        for g in self.cr["spec"]["workerGroupSpecs"]:
            name = g["groupName"]
            deleted = set((g.get("scaleStrategy") or {}).get("workersToDelete") or [])
            self.live[name] = [r for r in self.live[name] if r not in deleted]
            while len(self.live[name]) < int(g.get("replicas") or 0):
                self.live[name].append(f"{name}-r{self._next[name]}")
                self._next[name] += 1

    def request(self, method, path, body=None):
        if method == "GET" and "/rayclusters/" in path:
            return self.cr
        if method == "PATCH":
            self.patches.append(body)
            for op in body:
                parts = op["path"].strip("/").split("/")
                target = self.cr
                for p in parts[:-1]:
                    target = target[int(p)] if p.isdigit() else target[p]
                target[parts[-1]] = op["value"]
            self._operate()
            return {}
        if method == "GET" and "/pods" in path:
            items = []
            for g in self.cr["spec"]["workerGroupSpecs"]:
                hosts = int(g.get("numOfHosts") or 1)
                for rid in self.live[g["groupName"]]:
                    for h in range(hosts):
                        labels = {"ray.io/node-type": "worker",
                                  "ray.io/group": g["groupName"]}
                        if hosts > 1:
                            labels["replicaIndex"] = rid
                        items.append({
                            "metadata": {
                                "name": rid if hosts == 1 else f"{rid}-host{h}",
                                "labels": labels},
                            "status": {"phase": "Running"},
                        })
            return {"items": items}
        raise AssertionError((method, path))


def make_gke(groups=None):
    k8s = FakeK8s(groups or {"gpu-h100": 1, "gpu-h100-x2": 2})
    return GkeGpuNodeProvider("ns", "rc", transport=k8s), k8s


@pytest.mark.parametrize("group", ["gpu-h100", "gpu-h100-x2"])
def test_gke_scale_up_patches_replicas(group):
    p, k8s = make_gke()
    p.create_node(group, {})
    idx = [g["groupName"] for g in k8s.cr["spec"]["workerGroupSpecs"]].index(group)
    assert k8s.patches == [[{"op": "replace",
                             "path": f"/spec/workerGroupSpecs/{idx}/replicas",
                             "value": 1}]]
    # one REPLICA == one node, whether it has one pod or two
    assert p.non_terminated_nodes() == {f"{group}-r0": group}


def test_gke_precise_scale_down():
    p, k8s = make_gke()
    p.create_node("gpu-h100", {})
    p.create_node("gpu-h100", {})
    assert len(p.non_terminated_nodes()) == 2
    p.terminate_node("gpu-h100-r0")
    spec = k8s.cr["spec"]["workerGroupSpecs"][0]
    assert spec["replicas"] == 1
    assert spec["scaleStrategy"]["workersToDelete"] == ["gpu-h100-r0"]
    assert list(p.non_terminated_nodes()) == ["gpu-h100-r1"]
    # an id that is not a live replica is ignored, not guessed at
    p.terminate_node("gpu-h100-launch-9")
    assert spec["replicas"] == 1


def test_gke_unknown_group_rejected():
    p, _ = make_gke()
    with pytest.raises(ValueError, match="worker group"):
        p.create_node("nope", {})


def test_gke_under_instance_manager():
    """The v2 lifecycle wraps the GKE provider: the synthetic launch id is
    adopted by the listed replica of its group."""
    p, _ = make_gke()
    mgr = InstanceManager(p)
    mgr.create_node("gpu-h100", {})
    assert mgr.instances()[0].state == REQUESTED
    mgr.reconcile([])
    assert p.non_terminated_nodes() == {"gpu-h100-r0": "gpu-h100"}
    inst = mgr.instances()[0]
    assert inst.state == ALLOCATED and inst.cloud_instance_id == "gpu-h100-r0"
