"""GCE GPU-VM NodeProvider: autoscaling Compute Engine VMs with NVIDIA cards.

Equivalent of the reference's GCP provider
(``python/ray/autoscaler/_private/gcp/node_provider.py``): nodes are
Compute Engine VMs created through the public Compute Engine v1
instances API (``compute.googleapis.com/compute/v1/projects/{p}/zones/
{z}/instances``), authenticated with the instance metadata server's
service-account token, and bootstrapped into the cluster via a startup
script that starts a raylet pointed at the head GCS.

The port of ``ray_tpu/autoscaler/gce.py``'s ``GceTpuNodeProvider``:
  * A node type names a ``machine_type``, such as ``a3-highgpu-1g`` (one
    H100 80GB), whose cards come with the machine.
  * A VM with cards cannot live-migrate, so every body sets
    ``scheduling.onHostMaintenance = TERMINATE``; a type with
    ``"spot": True`` asks for ``provisioningModel = SPOT`` and stops
    (not deletes) the VM when the cloud reclaims it.
  * A tracked VM listed as ``TERMINATED`` was reclaimed (spot) or
    stopped by host maintenance: it plays the part of the TPU API's
    ``PREEMPTED`` and surfaces as a preemption notice.
  * The labels, the startup-script metadata, listing by label, the
    create grace and the capacity classification are the TPU
    provider's.
  * The HTTP transport is injectable: production uses urllib against the
    live APIs; tests drive the full provider + reconciler against a fake
    transport, and a live call without the metadata server fails with an
    actionable error.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any

from .node_provider import NodeLaunchError, NodeProvider

_METADATA_TOKEN_URL = (
    "http://metadata.google.internal/computeMetadata/v1/instance/"
    "service-accounts/default/token"
)

# Capacity-class failure markers in Compute Engine error bodies: quota
# exhaustion and zone stockout (the dominant real-world GPU launch
# failures; the reconciler backs off this node type and tries others).
# Deliberately SPECIFIC — a 403 "API not enabled ... check quota project"
# config error must NOT match, or a permanent misconfiguration would be
# retried silently forever.
_CAPACITY_MARKERS = ("RESOURCE_EXHAUSTED", "ZONE_RESOURCE_POOL_EXHAUSTED",
                     "QUOTA_EXCEEDED", "Quota exceeded", "quota exceeded",
                     "stockout", "out of capacity", "no more capacity",
                     "insufficient capacity", "There is no more capacity")

# Compute Engine instance statuses of a VM that is gone or going: it no
# longer counts as a node. TERMINATED is a stopped VM (a spot reclaim or a
# host-maintenance stop of a VM with cards); a tracked VM seen STOPPING or
# TERMINATED was stopped by the cloud, since this provider only deletes.
_GONE = ("STOPPING", "STOPPED", "SUSPENDING", "SUSPENDED", "TERMINATED")
_RECLAIMED = ("STOPPING", "TERMINATED")


def _classify_launch_error(e: Exception) -> Exception:
    """Wrap a create-node failure: HTTP 429 always, or an error whose
    body carries a capacity marker, becomes a TRANSIENT NodeLaunchError;
    anything else (auth, API-disabled, bad request) passes through."""
    if isinstance(e, NodeLaunchError):
        return e
    code = getattr(e, "code", None)
    body = ""
    try:
        body = e.read().decode(errors="replace") if hasattr(e, "read") else str(e)
    except Exception:
        body = str(e)
    if code == 429 or any(m in body for m in _CAPACITY_MARKERS):
        return NodeLaunchError(
            f"GPU capacity unavailable (HTTP {code}): {body[:300]}",
            transient=True, reason="quota/stockout")
    return e


class GceTransport:
    """Live transport: metadata-server auth + Compute Engine REST calls."""

    def __init__(self, timeout_s: float = 30.0):
        self._timeout = timeout_s
        self._token: str | None = None
        self._token_expiry = 0.0

    def _auth_token(self) -> str:
        if self._token and time.time() < self._token_expiry - 60:
            return self._token
        req = urllib.request.Request(
            _METADATA_TOKEN_URL, headers={"Metadata-Flavor": "Google"})
        try:
            with urllib.request.urlopen(req, timeout=5.0) as resp:
                blob = json.loads(resp.read())
        except (urllib.error.URLError, OSError) as e:
            raise RuntimeError(
                "GceGpuNodeProvider needs the GCE metadata server (run on a "
                "GCE VM with a service account, or inject a transport): "
                f"{e}") from e
        self._token = blob["access_token"]
        self._token_expiry = time.time() + blob.get("expires_in", 3600)
        return self._token

    def request(self, method: str, url: str, body: dict | None = None) -> dict:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method, headers={
            "Authorization": f"Bearer {self._auth_token()}",
            "Content-Type": "application/json",
        })
        with urllib.request.urlopen(req, timeout=self._timeout) as resp:
            payload = resp.read()
        return json.loads(payload) if payload else {}


class GceGpuNodeProvider(NodeProvider):
    """Compute Engine VMs with NVIDIA cards as autoscaler nodes (reference
    gcp/node_provider.py)."""

    API = "https://compute.googleapis.com/compute/v1"
    # How long a just-created VM may be absent from the list API before we
    # conclude it never materialized.
    CREATE_GRACE_S = 300.0

    def __init__(
        self,
        project: str,
        zone: str,
        *,
        gcs_address: str,
        source_image: str,
        node_types: dict[str, dict] | None = None,
        cluster_name: str = "raytpu",
        network: str = "global/networks/default",
        transport: Any = None,
        startup_script: str | None = None,
    ):
        """``node_types``: name -> {"machine_type": "a3-highgpu-1g",
        "resources": {...}, "spot": False, "source_image": ...,
        "disk_size_gb": ...} (the shapes the
        reconciler may request). ``source_image`` is the boot image of a
        type that names none: an image with the CUDA driver and Python."""
        self.project = project
        self.zone = zone
        self.gcs_address = gcs_address
        self.source_image = source_image
        self.node_types = node_types or {}
        self.cluster_name = cluster_name
        self.network = network
        self.transport = transport or GceTransport()
        self._startup = startup_script
        self._lock = threading.Lock()
        self._instances: dict[str, dict] = {}  # instance_id -> {type, state}
        self._counter = 0
        # Reclaim notices: tracked VMs the cloud listed as TERMINATED,
        # held until the reconciler acks them (preemption_notices /
        # ack_preemption) so it can terminate + replace the VM.
        self._preempted: dict[str, str] = {}  # instance_id -> node_type

    # ------------------------------------------------------------- helpers
    def _parent(self) -> str:
        return f"projects/{self.project}/zones/{self.zone}"

    def _instances_url(self) -> str:
        return f"{self.API}/{self._parent()}/instances"

    def _startup_script(self) -> str:
        if self._startup is not None:
            return self._startup
        # The VM starts a raylet joined to the head GCS; the raylet
        # advertises the VM's cards as GPU. Neither package's CLI has a
        # `start` subcommand yet: a real deployment passes its own
        # ``startup_script``.
        return (
            "#! /bin/bash\n"
            f"python -m ray_tpu_torch.cli start --address={self.gcs_address} "
            "--num-cpus=$(nproc)\n"
        )

    def _body(self, instance_id: str, node_type: str, spec: dict) -> dict:
        scheduling = {"onHostMaintenance": "TERMINATE",
                      "automaticRestart": False}
        if spec.get("spot"):
            scheduling["provisioningModel"] = "SPOT"
            scheduling["instanceTerminationAction"] = "STOP"
        body = {
            "name": instance_id,
            "machineType": f"zones/{self.zone}/machineTypes/"
                           f"{spec['machine_type']}",
            "scheduling": scheduling,
            "disks": [{
                "boot": True, "autoDelete": True,
                "initializeParams": {
                    "sourceImage": spec.get("source_image", self.source_image),
                    "diskSizeGb": str(spec.get("disk_size_gb", 200)),
                },
            }],
            # No access config: no external IP (the TPU provider's
            # enableExternalIps=False).
            "networkInterfaces": [{"network": self.network}],
            "metadata": {"items": [
                {"key": "startup-script", "value": self._startup_script()}]},
            "labels": {"raytpu-cluster": self.cluster_name,
                       "raytpu-node-type": node_type},
        }
        return body

    # ------------------------------------------------------ NodeProvider API
    def create_node(self, node_type: str, resources: dict) -> str:
        spec = self.node_types.get(node_type)
        if spec is None:
            raise ValueError(f"unknown node_type {node_type!r} "
                             f"(configured: {list(self.node_types)})")
        with self._lock:
            self._counter += 1
            instance_id = f"{self.cluster_name}-{node_type}-{self._counter}"
            self._instances[instance_id] = {
                "type": node_type, "state": "CREATING", "created_at": time.time()}
        try:
            self.transport.request(
                "POST", self._instances_url(),
                self._body(instance_id, node_type, spec))
        except Exception as e:
            with self._lock:
                self._instances.pop(instance_id, None)
            raise _classify_launch_error(e) from e
        return instance_id

    def terminate_node(self, instance_id: str) -> None:
        with self._lock:
            inst = self._instances.pop(instance_id, None)
        if inst is None:
            return
        try:
            self.transport.request(
                "DELETE", f"{self._instances_url()}/{instance_id}")
        except Exception:
            with self._lock:  # keep tracking: the VM still exists
                self._instances[instance_id] = inst
            raise

    def non_terminated_nodes(self) -> dict[str, str]:
        # Reconcile against the API (VMs can die outside our control).
        query = urllib.parse.urlencode(
            {"filter": f"labels.raytpu-cluster={self.cluster_name}"})
        try:
            listing = self.transport.request(
                "GET", f"{self._instances_url()}?{query}")
        except Exception:
            with self._lock:  # API hiccup: serve the cached view
                return {i: v["type"] for i, v in self._instances.items()}
        live: dict[str, str] = {}
        listed: set[str] = set()
        with self._lock:
            for vm in listing.get("items", []):
                labels = vm.get("labels") or {}
                if labels.get("raytpu-cluster") != self.cluster_name:
                    continue
                iid = vm["name"].rsplit("/", 1)[-1]
                listed.add(iid)
                status = vm.get("status", "")
                if status in _GONE:
                    if status in _RECLAIMED and iid in self._instances:
                        # Surface the reclaim as a typed notice the
                        # reconciler consumes (terminate + replace).
                        self._preempted[iid] = labels.get(
                            "raytpu-node-type", "unknown")
                    continue
                live[iid] = labels.get("raytpu-node-type", "unknown")
                entry = self._instances.setdefault(
                    iid, {"type": live[iid], "state": status})
                # Track the observed status, but keep created_at until grace
                # expiry: a still-provisioning VM can flap back OUT of an
                # eventually-consistent listing, and pruning it then would
                # re-enable the double-create.
                entry["state"] = status or entry.get("state", "")
            for iid in list(self._instances):
                if iid in live:
                    continue
                # A VM we just created (not yet visible in the listing) must
                # not be pruned, or the reconciler under-counts pending
                # nodes and double-creates it. Keep it — and report it live
                # — until it shows up in a listing (any status) or exceeds a
                # creation grace period. A VM LISTED in a gone status is
                # pruned.
                inst = self._instances[iid]
                created_at = inst.get("created_at")
                if (iid not in listed
                        and inst.get("state") == "CREATING"
                        and created_at is not None
                        and time.time() - created_at < self.CREATE_GRACE_S):
                    live[iid] = inst["type"]
                    continue
                self._instances.pop(iid)
        return live

    def node_id_of(self, instance_id: str) -> str | None:
        # The raylet started by the startup script registers itself with
        # the GCS; mapping instance -> cluster node id happens there (the
        # reconciler matches by pending-launch expiry, not identity).
        return None

    # ------------------------------------------------------------- preemption
    def preemption_notices(self) -> dict[str, str]:
        """instance_id -> node_type for VMs the cloud listed TERMINATED
        and nobody acked yet. The ``InstanceManager`` consumes these:
        terminate the instance, request a same-shape replacement."""
        with self._lock:
            return dict(self._preempted)

    def ack_preemption(self, instance_id: str) -> None:
        with self._lock:
            self._preempted.pop(instance_id, None)
