"""Node bootstrap: start/stop the head services and the driver CoreWorker.

Equivalent of the reference's ``python/ray/_private/node.py``
(``start_head_processes``:1401) and ``services.py``. Difference from the
reference: the GCS and the raylet run as asyncio services on a dedicated
thread inside the driver process rather than as separate C++ processes —
worker processes are real subprocesses either way, and the
``cluster.Cluster`` harness can start additional raylets to get full
multi-node semantics on one machine (reference ``cluster_utils.py:135``).
"""

from __future__ import annotations

import os
import tempfile
import time

from .config import get_config
from .gcs import GcsServer
from .ids import JobID
from .raylet import Raylet
from .rpc import EventLoopThread
from .worker import MODE_DRIVER, CoreWorker, set_global_worker


class Node:
    def __init__(
        self,
        *,
        head: bool = True,
        gcs_address: str | None = None,
        num_cpus: float | None = None,
        resources: dict | None = None,
        labels: dict | None = None,
        object_store_memory: int | None = None,
        session_dir: str | None = None,
    ):
        self.session_dir = session_dir or tempfile.mkdtemp(prefix="raytpu-torch-session-")
        self.services_loop = EventLoopThread("raytpu-services")
        self.gcs: GcsServer | None = None
        if head:
            from .gcs_storage import storage_from_config

            self.gcs = GcsServer(storage=storage_from_config(self.session_dir),
                                 session_dir=self.session_dir)
            self.services_loop.run_sync(self.gcs.start())
            gcs_address = self.gcs.address
        assert gcs_address is not None
        self.gcs_address = gcs_address
        self.raylet = Raylet(
            gcs_address,
            num_cpus=num_cpus,
            resources=resources,
            labels=labels,
            object_store_capacity=object_store_memory,
            session_dir=self.session_dir,
        )
        self.services_loop.run_sync(self.raylet.start())

    def connect_driver(self, job_id: int = 1) -> CoreWorker:
        worker = CoreWorker(
            mode=MODE_DRIVER,
            gcs_address=self.gcs_address,
            raylet_address=self.raylet.address,
            node_id=self.raylet.node_id.hex(),
            store_path=self.raylet.store_path,
            store_capacity=self.raylet.object_store_capacity,
            job_id=JobID.from_int(job_id),
        )
        worker.connect()
        worker._gcs_call("AddJob", {"driver_address": worker.address})
        set_global_worker(worker)
        return worker

    def shutdown(self) -> None:
        try:
            self.services_loop.run_sync(self.raylet.stop(), timeout=30)
        except Exception:
            pass
        if self.gcs is not None:
            try:
                self.services_loop.run_sync(self.gcs.stop(), timeout=5)
            except Exception:
                pass
        self.services_loop.stop()
        _reap_worker_children(self.raylet)


def _reap_worker_children(raylet, deadline_s: float = 10.0) -> None:
    """Last-ditch sweep after raylet.stop: kill any worker of THIS NODE
    that survived stop() — e.g. stuck in a device call with SIGTERM
    pending. A GPU worker that outlives its cluster keeps its device
    memory and starves whatever claims the card next — the next
    ``init()`` in this same driver process (bench phases, test suites)
    must start from a clean slate. Workers of OTHER in-process raylets
    (the Cluster harness) are left alone: victims are the raylet's own
    tracked worker pids plus direct ``worker_main`` children spawned with
    this node's id (zygote-forked workers are always tracked)."""
    import signal

    node_id_hex = raylet.node_id.hex()
    me = os.getpid()
    victims: list[int] = []
    for w in list(raylet._workers.values()):
        if w.proc is not None and w.proc.poll() is None:
            victims.append(w.proc.pid)
    try:
        entries = os.listdir("/proc")
    except OSError:
        entries = []
    for pid_dir in entries:
        if not pid_dir.isdigit():
            continue
        pid = int(pid_dir)
        if pid in victims:
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().decode(errors="replace")
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[-1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        if ppid == me and "worker_main" in cmd and node_id_hex in cmd:
            victims.append(pid)
    for pid in victims:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    deadline = time.monotonic() + deadline_s
    for pid in victims:
        while time.monotonic() < deadline:
            try:
                done, _ = os.waitpid(pid, os.WNOHANG)
                if done == pid:
                    break
            except (ChildProcessError, OSError):
                # Not our child (zygote-forked, auto-reaped there): poll
                # for existence instead of waiting.
                try:
                    os.kill(pid, 0)
                except OSError:
                    break
            time.sleep(0.05)
