"""GKE/KubeRay-style NodeProvider: GPU node pools on Kubernetes.

Equivalent of the reference's KubeRay provider
(``python/ray/autoscaler/_private/kuberay/node_provider.py`` —
``BatchingNodeProvider`` semantics: the autoscaler PATCHes the RayCluster
custom resource's ``workerGroupSpecs[i].replicas`` /
``scaleStrategy.workersToDelete`` and the operator actuates pods). A GPU
worker group has one host a replica, so one autoscaler "node" is one
pod; a group with ``numOfHosts > 1`` is a MULTI-HOST replica whose pods
share a ``replicaIndex`` label, and one node is that whole REPLICA,
never a single pod of it.

The Kubernetes API transport is injectable: in-cluster it reads the
service-account token and talks to ``KUBERNETES_SERVICE_HOST``; tests
drive the full provider + reconciler against a fake transport (zero
egress here).

The port of ``ray_tpu/autoscaler/gke.py``'s ``GkeTpuNodeProvider``: the
same CR patches and pod listing.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Any

from .node_provider import NodeProvider

logger = logging.getLogger(__name__)

GROUP_LABEL = "ray.io/group"          # worker group == autoscaler node type
KIND_LABEL = "ray.io/node-type"       # head | worker
REPLICA_INDEX_LABEL = "replicaIndex"  # GKE multi-host replica id

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class KubernetesTransport:
    """In-cluster API access via the pod service account."""

    def __init__(self, timeout_s: float = 60.0):
        self._timeout = timeout_s
        host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default")
        port = os.environ.get("KUBERNETES_SERVICE_PORT_HTTPS", "443")
        self._base = f"https://{host}:{port}"

    def _token(self) -> str:
        try:
            with open(os.path.join(_SA_DIR, "token")) as f:
                return f.read().strip()
        except OSError as e:
            raise RuntimeError(
                "GkeGpuNodeProvider needs an in-cluster service account "
                "(or inject a transport)") from e

    def request(self, method: str, path: str, body: dict | None = None) -> dict:
        import ssl
        import urllib.request

        ctx = ssl.create_default_context(cafile=os.path.join(_SA_DIR, "ca.crt"))
        headers = {
            "Authorization": f"Bearer {self._token()}",
            "Content-Type": ("application/json-patch+json" if method == "PATCH"
                             else "application/json"),
        }
        req = urllib.request.Request(
            self._base + path,
            data=json.dumps(body).encode() if body is not None else None,
            method=method, headers=headers)
        with urllib.request.urlopen(req, timeout=self._timeout, context=ctx) as resp:
            payload = resp.read()
        return json.loads(payload) if payload else {}


class GkeGpuNodeProvider(NodeProvider):
    """Scale GPU worker groups of a RayCluster CR (KubeRay semantics).

    A "node" is one worker-group REPLICA: one pod for a GPU group of one
    host, and for a multi-host group (``numOfHosts`` > 1) the whole
    replica — its pods carry the same ``replicaIndex`` and are
    created/deleted together by the operator."""

    def __init__(
        self,
        namespace: str,
        cluster_name: str,
        *,
        transport: Any = None,
        crd_version: str = "v1",
    ):
        self.namespace = namespace
        self.cluster_name = cluster_name
        self.transport = transport or KubernetesTransport()
        self._crd = crd_version
        self._lock = threading.Lock()
        # replica-name -> group, for nodes we created this process (the CR
        # itself is the durable source of truth; this is only a hint).
        self._counter = 0

    # ------------------------------------------------------------- CR access
    def _cr_path(self) -> str:
        return (f"/apis/ray.io/{self._crd}/namespaces/{self.namespace}"
                f"/rayclusters/{self.cluster_name}")

    def _pods_path(self) -> str:
        return (f"/api/v1/namespaces/{self.namespace}/pods"
                f"?labelSelector=ray.io/cluster={self.cluster_name}")

    def _get_cr(self) -> dict:
        return self.transport.request("GET", self._cr_path())

    def _group_index(self, cr: dict, group: str) -> int:
        groups = cr["spec"].get("workerGroupSpecs") or []
        for i, g in enumerate(groups):
            if g.get("groupName") == group:
                return i
        raise ValueError(
            f"worker group {group!r} not in RayCluster {self.cluster_name} "
            f"(groups: {[g.get('groupName') for g in groups]})")

    # ------------------------------------------------------ NodeProvider API
    def create_node(self, node_type: str, resources: dict) -> str:
        """Scale the group up by one replica (the operator creates the
        pod(s)); returns a synthetic replica id resolved against pod
        listings by group membership."""
        cr = self._get_cr()
        idx = self._group_index(cr, node_type)
        replicas = int(cr["spec"]["workerGroupSpecs"][idx].get("replicas") or 0)
        self.transport.request("PATCH", self._cr_path(), [
            {"op": "replace",
             "path": f"/spec/workerGroupSpecs/{idx}/replicas",
             "value": replicas + 1},
        ])
        with self._lock:
            self._counter += 1
            return f"{self.cluster_name}-{node_type}-launch-{self._counter}"

    def terminate_node(self, instance_id: str) -> None:
        """Scale down via ``workersToDelete`` so the operator removes THIS
        replica, not an arbitrary one (the KubeRay precise-scale-down
        contract). Only LIVE replica ids are accepted: decrementing
        replicas for an unknown name would make the operator delete an
        arbitrary (possibly busy) replica instead."""
        replicas_live = self._replicas()
        if instance_id not in replicas_live:
            logger.warning(
                "terminate of %s ignored: not a live replica (synthetic "
                "launch ids resolve to replica ids once the operator "
                "creates the pods)", instance_id)
            return
        group = replicas_live[instance_id]
        cr = self._get_cr()
        idx = self._group_index(cr, group)
        spec = cr["spec"]["workerGroupSpecs"][idx]
        replicas = int(spec.get("replicas") or 0)
        # Prune confirmed deletions (no longer live) so workersToDelete
        # doesn't grow forever, then add this one.
        to_delete = [
            w for w in ((spec.get("scaleStrategy") or {}).get("workersToDelete") or [])
            if w in replicas_live
        ]
        if instance_id not in to_delete:
            to_delete.append(instance_id)
        self.transport.request("PATCH", self._cr_path(), [
            {"op": "replace",
             "path": f"/spec/workerGroupSpecs/{idx}/replicas",
             "value": max(0, replicas - 1)},
            {"op": "replace",
             "path": f"/spec/workerGroupSpecs/{idx}/scaleStrategy",
             "value": {"workersToDelete": to_delete}},
        ])

    def _replicas(self) -> dict[str, str]:
        """replica id -> group from live pods. A multi-host replica's pods
        collapse into ONE entry keyed by (group, replicaIndex); a one-host
        replica's pod is keyed by its name."""
        pods = self.transport.request("GET", self._pods_path()).get("items", [])
        out: dict[str, str] = {}
        for pod in pods:
            meta = pod.get("metadata") or {}
            labels = meta.get("labels") or {}
            if labels.get(KIND_LABEL) != "worker":
                continue
            phase = (pod.get("status") or {}).get("phase")
            if phase in ("Succeeded", "Failed"):
                continue
            group = labels.get(GROUP_LABEL, "unknown")
            replica = labels.get(REPLICA_INDEX_LABEL) or meta.get("name", "")
            out[replica] = group
        return out

    def non_terminated_nodes(self) -> dict[str, str]:
        return self._replicas()

    def node_id_of(self, instance_id: str) -> str | None:
        return None  # the raylet self-registers; reconciler matches by expiry
