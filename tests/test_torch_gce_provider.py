"""The port's GCE GPU NodeProvider: ``tests/test_gce_provider.py``'s
cases against an injected transport (the Compute Engine v1 instances
API): the request bodies of an on-demand and a spot ``a3-highgpu-1g``
VM, label-scoped listing, externally stopped VMs, the create grace under
listing lag, quota and stockout backoff, and the reconciler driving it
from GPU demand."""

import time
import urllib.parse

import pytest

from ray_tpu_torch.autoscaler import Autoscaler, NodeTypeConfig
from ray_tpu_torch.autoscaler.gce import GceGpuNodeProvider

API = "https://compute.googleapis.com/compute/v1"
ZONE = "us-central1-a"
INSTANCES = f"{API}/projects/proj/zones/{ZONE}/instances"
H100 = {"CPU": 26.0, "GPU": 1.0}


class FakeTransport:
    """Records Compute Engine REST calls and mimics the VM lifecycle."""

    def __init__(self):
        self.calls = []
        self.vms = {}  # instance name -> instance resource

    def request(self, method, url, body=None):
        self.calls.append((method, url, body))
        if method == "POST":
            assert url == INSTANCES, url
            self.vms[body["name"]] = {
                "name": body["name"], "status": "PROVISIONING",
                "labels": body["labels"],
                "machineType": body["machineType"],
            }
            return {"kind": "compute#operation",
                    "name": f"operation-create-{body['name']}"}
        if method == "DELETE":
            name = url.rsplit("/", 1)[-1]
            self.vms.pop(name, None)
            return {"kind": "compute#operation",
                    "name": f"operation-delete-{name}"}
        if method == "GET":
            base, _, query = url.partition("?")
            assert base == INSTANCES, url
            assert urllib.parse.parse_qs(query)["filter"] == [
                "labels.raytpu-cluster=raytpu"]
            return {"items": list(self.vms.values())}
        raise AssertionError(method)


def make_provider(transport=None, **kw):
    return GceGpuNodeProvider(
        project="proj", zone=ZONE, gcs_address="10.0.0.2:6379",
        source_image="projects/img-project/global/images/family/cuda-img",
        node_types={
            "h100": {"machine_type": "a3-highgpu-1g", "resources": H100},
            "h100-spot": {"machine_type": "a3-highgpu-1g", "spot": True,
                          "resources": H100},
        },
        transport=transport or FakeTransport(), **kw)


def test_create_list_terminate_lifecycle():
    t = FakeTransport()
    p = make_provider(t)
    iid = p.create_node("h100", {})
    method, url, body = t.calls[0]
    assert method == "POST" and url == INSTANCES
    assert body["name"] == iid == "raytpu-h100-1"
    assert body["machineType"] == f"zones/{ZONE}/machineTypes/a3-highgpu-1g"
    assert body["scheduling"] == {"onHostMaintenance": "TERMINATE",
                                  "automaticRestart": False}
    assert body["labels"] == {"raytpu-cluster": "raytpu",
                              "raytpu-node-type": "h100"}
    (item,) = body["metadata"]["items"]
    assert item["key"] == "startup-script"
    assert "ray_tpu_torch.cli start --address=10.0.0.2:6379" in item["value"]
    (disk,) = body["disks"]
    assert disk["boot"] and disk["initializeParams"]["sourceImage"].endswith(
        "family/cuda-img")
    assert body["networkInterfaces"] == [{"network": "global/networks/default"}]

    assert p.non_terminated_nodes() == {iid: "h100"}
    t.vms[iid]["status"] = "RUNNING"
    assert p.non_terminated_nodes() == {iid: "h100"}
    p.terminate_node(iid)
    assert t.calls[-1][:2] == ("DELETE", f"{INSTANCES}/{iid}")
    assert p.non_terminated_nodes() == {}


def test_spot_type_body_and_custom_startup_script():
    t = FakeTransport()
    p = make_provider(t, startup_script="#! /bin/bash\necho custom\n")
    p.create_node("h100-spot", {})
    (spot,) = (c[2] for c in t.calls if c[0] == "POST")
    assert spot["machineType"] == f"zones/{ZONE}/machineTypes/a3-highgpu-1g"
    assert spot["scheduling"] == {
        "onHostMaintenance": "TERMINATE", "automaticRestart": False,
        "provisioningModel": "SPOT", "instanceTerminationAction": "STOP"}
    assert spot["metadata"]["items"][0]["value"] == "#! /bin/bash\necho custom\n"
    assert spot["labels"]["raytpu-node-type"] == "h100-spot"


def test_listing_reconciles_externally_stopped_vms():
    """A spot VM the cloud reclaims (listed TERMINATED) disappears from
    non_terminated_nodes so the reconciler can relaunch."""
    t = FakeTransport()
    p = make_provider(t)
    iid = p.create_node("h100-spot", {})
    t.vms[iid]["status"] = "TERMINATED"
    assert p.non_terminated_nodes() == {}
    assert p.preemption_notices() == {iid: "h100-spot"}


def test_listing_ignores_foreign_clusters():
    t = FakeTransport()
    p = make_provider(t)
    t.vms["other"] = {"name": "other", "status": "RUNNING",
                      "labels": {"raytpu-cluster": "someone-else"}}
    assert p.non_terminated_nodes() == {}


def test_unknown_node_type_rejected():
    p = make_provider()
    with pytest.raises(ValueError, match="unknown node_type"):
        p.create_node("b200-mega", {})


def _demand_gcs(nodes):
    def gcs_call(method, payload):
        if method == "GetAllNodes":
            return {"nodes": nodes}
        if method == "ListPlacementGroups":
            return {"placement_groups": []}
        if method == "KvGet":
            return {"value": None}
        raise AssertionError(method)

    return gcs_call


def test_reconciler_launches_gpu_vms_for_demand():
    """The reconciler drives the GCE provider end to end: GPU demand ->
    instances.insert calls for the fitting machine type."""
    t = FakeTransport()
    provider = make_provider(t)
    nodes = [{
        "node_id": "head", "state": "ALIVE",
        "resources": {"total": {"CPU": 4.0}, "available": {"CPU": 4.0}},
        "pending_demand": [{"shape": {"GPU": 1.0}, "count": 2}],
    }]
    scaler = Autoscaler(
        _demand_gcs(nodes), provider,
        [NodeTypeConfig("h100", H100, max_workers=4)], launch_cooldown_s=0.0)
    decision = scaler.reconcile_once()
    assert decision.launch == ["h100", "h100"]
    creates = [c for c in t.calls if c[0] == "POST"]
    assert len(creates) == 2
    assert all(c[2]["machineType"].endswith("/a3-highgpu-1g") for c in creates)
    # pending launches count as capacity: a second pass must not relaunch
    assert scaler.reconcile_once().launch == []


class LaggyTransport(FakeTransport):
    """Insert succeeds but the VM does not appear in listings yet."""

    def __init__(self):
        super().__init__()
        self.visible = False

    def request(self, method, url, body=None):
        if method == "GET" and not self.visible:
            self.calls.append((method, url, body))
            return {"items": []}
        return super().request(method, url, body)


def test_creating_vm_survives_listing_lag():
    """A just-created VM missing from the listing stays tracked (and counts
    as live) until it appears or the grace period expires."""
    t = LaggyTransport()
    p = make_provider(t)
    iid = p.create_node("h100", {})
    assert p.non_terminated_nodes() == {iid: "h100"}
    assert p.non_terminated_nodes() == {iid: "h100"}
    t.visible = True
    assert p.non_terminated_nodes() == {iid: "h100"}
    t.visible = False
    p._instances[iid]["state"] = "CREATING"
    p._instances[iid]["created_at"] = 0.0
    assert p.non_terminated_nodes() == {}


class QuotaTransport(FakeTransport):
    """Insert fails with a zone stockout for one machine type until
    ``relent()``."""

    def __init__(self, blocked="a3-highgpu-1g"):
        super().__init__()
        self.blocked = blocked

    def relent(self):
        self.blocked = None

    def request(self, method, url, body=None):
        if (method == "POST" and self.blocked
                and body["machineType"].endswith("/" + self.blocked)):
            self.calls.append((method, url, body))
            raise RuntimeError(
                "HTTP 503: ZONE_RESOURCE_POOL_EXHAUSTED: The zone "
                f"'projects/proj/zones/{ZONE}' does not have enough "
                "resources available to fulfill the request.")
        return super().request(method, url, body)


def test_stockout_backs_off_and_routes_to_other_type():
    """A stockout puts the type in exponential backoff, demand routes to
    the next fitting type, and the type is retried after the backoff."""
    t = QuotaTransport()
    provider = GceGpuNodeProvider(
        project="proj", zone=ZONE, gcs_address="10.0.0.2:6379",
        source_image="img",
        node_types={
            "h100-1": {"machine_type": "a3-highgpu-1g"},
            "h100-2": {"machine_type": "a3-highgpu-2g"},
        },
        transport=t)
    nodes = [{
        "node_id": "head", "state": "ALIVE",
        "resources": {"total": {"CPU": 4.0}, "available": {"CPU": 4.0}},
        "pending_demand": [{"shape": {"GPU": 1.0}, "count": 1}],
    }]
    scaler = Autoscaler(
        _demand_gcs(nodes), provider,
        [NodeTypeConfig("h100-1", {"CPU": 26.0, "GPU": 1.0}, max_workers=4),
         NodeTypeConfig("h100-2", {"CPU": 52.0, "GPU": 2.0}, max_workers=4)],
        launch_cooldown_s=0.0, launch_backoff_base_s=0.3)
    assert scaler.reconcile_once().launch == []
    assert scaler._in_backoff("h100-1")
    assert scaler.reconcile_once().launch == ["h100-2"]

    t.relent()
    nodes[0]["pending_demand"] = [{"shape": {"GPU": 1.0}, "count": 3}]
    time.sleep(0.4)
    assert "h100-1" in scaler.reconcile_once().launch


def test_live_transport_needs_the_metadata_server(monkeypatch):
    """Without an injected transport a call goes to the metadata server;
    where that fails, the error says what to do. (The lookup is stubbed
    here: no request leaves the process.)"""
    from ray_tpu_torch.autoscaler import gce

    def refuse(req, timeout):
        raise gce.urllib.error.URLError("no route")

    monkeypatch.setattr(gce.urllib.request, "urlopen", refuse)
    p = GceGpuNodeProvider("proj", ZONE, gcs_address="h:1",
                           source_image="img",
                           node_types={"h100": {"machine_type": "a3-highgpu-1g"}})
    with pytest.raises(RuntimeError, match="metadata server"):
        p.create_node("h100", {})
