"""Multi-node test harness: many raylets, one GCS, one host.

Equivalent of the reference's ``python/ray/cluster_utils.py:135``
(``Cluster.add_node`` / ``remove_node``) — the backbone of its distributed
test strategy (SURVEY.md §4.1). Raylets run as asyncio services on one
dedicated thread; their worker processes are real subprocesses, so task
execution, object transfer and failure detection cross real process
boundaries exactly as in production. Node death is simulated by killing a
raylet's server + workers without a drain; the GCS discovers it through
failed health checks, as it would a crashed host.
"""

from __future__ import annotations

import os
import time

from .core.config import get_config
from .core.gcs import GcsServer
from .core.raylet import Raylet
from .core.rpc import EventLoopThread


class Cluster:
    def __init__(
        self,
        initialize_head: bool = True,
        head_node_args: dict | None = None,
        _system_config: dict | None = None,
        enable_gcs_ft: bool = False,
    ):
        if _system_config:
            get_config().apply_dict(_system_config)
        self._loop = EventLoopThread("raytpu-torch-cluster")
        self._gcs_storage = None
        self._gcs_ft_dir: str | None = None
        if enable_gcs_ft:
            import tempfile

            from .core.gcs_storage import FileStorage

            self._gcs_ft_dir = tempfile.mkdtemp(prefix="raytpu-torch-gcs-ft-")
            self._gcs_storage = FileStorage(
                os.path.join(self._gcs_ft_dir, "gcs_tables.msgpack")
            )
        self.gcs = GcsServer(storage=self._gcs_storage)
        self._loop.run_sync(self.gcs.start())
        self.nodes: list[Raylet] = []
        self.head_node: Raylet | None = None
        if initialize_head:
            self.head_node = self.add_node(**(head_node_args or {}))

    @property
    def address(self) -> str:
        """GCS address — pass to ``ray_tpu_torch.init(address=...)``."""
        return self.gcs.address

    def add_node(self, wait: bool = True, **node_args) -> Raylet:
        """Start one more raylet joined to this cluster's GCS."""
        raylet = Raylet(self.gcs.address, **node_args)
        self._loop.run_sync(raylet.start())
        self.nodes.append(raylet)
        if wait:
            self.wait_for_nodes(len(self.nodes))
        return raylet

    def remove_node(self, raylet: Raylet, allow_graceful: bool = False) -> None:
        """Take a node down. Non-graceful (default) simulates a crashed
        host: workers SIGKILLed, no drain — the GCS must detect the death
        via health checks and run its node-failure handling."""
        if raylet in self.nodes:
            self.nodes.remove(raylet)
        if allow_graceful:
            self._loop.run_sync(raylet.stop(), timeout=15)
            self._loop.run_sync(
                self.gcs.handle_DrainNode({"node_id": raylet.node_id.hex()})
            )
        else:
            self._loop.run_sync(raylet.kill(), timeout=15)

    def crash_gcs(self) -> None:
        """Kill the GCS abruptly (no final snapshot flush) — reference
        equivalent: SIGKILL the gcs_server process in FT tests."""
        self._loop.run_sync(self.gcs.crash(), timeout=10)

    def restart_gcs(self) -> None:
        """Start a fresh GCS on the SAME port with the same storage; it
        restores durable tables and raylets re-register on heartbeat.
        Requires enable_gcs_ft=True for state to survive."""
        port = self.gcs.port
        self.gcs = GcsServer(port=port, storage=self._gcs_storage)
        self._loop.run_sync(self.gcs.start())

    def wait_for_nodes(self, count: int, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            alive = [n for n in self.gcs._nodes.values() if n["state"] == "ALIVE"]
            if len(alive) >= count:
                return
            time.sleep(0.05)
        raise TimeoutError(f"cluster did not reach {count} alive nodes in {timeout}s")

    def wait_for_node_death(self, raylet: Raylet, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        node_id = raylet.node_id.hex()
        while time.monotonic() < deadline:
            node = self.gcs._nodes.get(node_id)
            if node is not None and node["state"] == "DEAD":
                return
            time.sleep(0.05)
        raise TimeoutError(f"node {node_id[:8]} not marked DEAD in {timeout}s")

    def shutdown(self) -> None:
        for raylet in list(self.nodes):
            try:
                self._loop.run_sync(raylet.stop(), timeout=15)
            except Exception:
                pass
        self.nodes = []
        try:
            self._loop.run_sync(self.gcs.stop(), timeout=5)
        except Exception:
            pass
        self._loop.stop()
        if self._gcs_ft_dir is not None:
            import shutil

            shutil.rmtree(self._gcs_ft_dir, ignore_errors=True)
            self._gcs_ft_dir = None
