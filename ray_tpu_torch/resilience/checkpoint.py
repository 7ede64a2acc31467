"""Async, atomically-committed train-state checkpoints.

The failure mode this module exists for: a train worker's node is
preempted mid-train, and the last "checkpoint" on disk is a half-written directory
that *loads* (pickle happily reads a prefix that happens to frame) or a
complete one nobody can find because the node that knew about it is
gone. Both are fixed structurally:

  * **The train step never blocks on I/O.** ``save()`` snapshots the
    pytree to host memory synchronously (cheap) and hands it to ONE
    background writer thread. A save arriving while a write is in flight
    replaces any still-queued snapshot (latest-wins coalescing) — a slow
    disk degrades checkpoint *freshness*, never step time.
  * **Commits are atomic.** The writer serializes into a hidden temp
    directory, fsyncs the payload and a ``COMMITTED`` marker, then
    renames the directory to its final ``ckpt_<step>`` name and fsyncs
    the parent. Readers only trust directories whose marker exists, so a
    kill at ANY point leaves the previous version (or nothing) visible —
    never a corrupt, loadable-looking one.
  * **Every committed version is registered with the GCS** (KV entry per
    run name). Recovery resolves the latest checkpoint from the control
    plane, not from the dead worker's local state.

Reference inspiration: orbax's async checkpointing + Ray Train's
``CheckpointManager``; the commit-marker discipline is the classic
tmp+fsync+rename pattern databases use for their WAL segments.
"""

from __future__ import annotations

import contextlib
import copy
import json
import logging
import os
import shutil
import threading
import time
import uuid

logger = logging.getLogger(__name__)

GCS_KEY_PREFIX = "resilience:ckpt:"
COMMIT_MARKER = "COMMITTED"
_CKPT_PREFIX = "ckpt_"
_TMP_PREFIX = ".tmp-"


def _snapshot(tree):
    """Host-side copy of a (possibly on-device) tree: the train loop may
    mutate its buffers the moment save() returns. Every tensor is copied
    to fresh CPU memory, never aliased (a CPU tensor too); other leaves
    are deep-copied."""
    import torch

    from ..train.checkpoint import map_tree

    return map_tree(
        lambda x: (x.detach().to("cpu", copy=True)
                   if isinstance(x, torch.Tensor) else copy.deepcopy(x)),
        tree)


def _fsync_dir(path: str) -> None:
    with contextlib.suppress(OSError):
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


def _write_json_synced(path: str, data: dict) -> None:
    with open(path, "w") as f:
        json.dump(data, f, default=str)
        f.flush()
        os.fsync(f.fileno())


def _default_write(tree, path: str) -> None:
    from ..train.checkpoint import save_pytree

    save_pytree(tree, path)


def list_committed(root: str) -> list[tuple[int, str]]:
    """(step, path) for every COMMITTED checkpoint under ``root``,
    ascending by step. Directories without the marker (a commit that died
    mid-flight) are invisible."""
    out: list[tuple[int, str]] = []
    try:
        entries = os.listdir(root)
    except OSError:
        return out
    for name in entries:
        if not name.startswith(_CKPT_PREFIX):
            continue
        path = os.path.join(root, name)
        if not os.path.exists(os.path.join(path, COMMIT_MARKER)):
            continue
        try:
            out.append((int(name[len(_CKPT_PREFIX):]), path))
        except ValueError:
            continue
    out.sort()
    return out


def latest_committed(root: str) -> dict | None:
    """The newest committed version under ``root`` (local-scan fallback
    when no GCS registration is reachable)."""
    committed = list_committed(root)
    if not committed:
        return None
    step, path = committed[-1]
    return {"step": step, "path": path}


def load_checkpoint(path: str, *, like=None) -> tuple:
    """Load a committed checkpoint dir -> ``(tree, meta)``. Refuses
    uncommitted directories — a half-written checkpoint must never be
    mistaken for a real one."""
    if not os.path.exists(os.path.join(path, COMMIT_MARKER)):
        raise FileNotFoundError(
            f"{path}: no {COMMIT_MARKER} marker — not a committed checkpoint")
    from ..train.checkpoint import load_pytree

    tree = load_pytree(path, like=like)
    meta: dict = {}
    with contextlib.suppress(OSError, ValueError):
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
    return tree, meta


def register_latest(run_name: str, path: str, step: int) -> bool:
    """Record the latest committed version in the GCS KV so recovery can
    find it without touching the (possibly dead) writer node."""
    try:
        from ..core.worker import global_worker

        global_worker()._gcs_call("KvPut", {
            "key": GCS_KEY_PREFIX + run_name,
            "value": json.dumps({
                "path": path, "step": int(step), "ts": time.time(),
            }).encode(),
            "overwrite": True,
        })
        return True
    except Exception:
        return False


def latest_registered(run_name: str) -> dict | None:
    """The GCS-registered latest committed version for ``run_name``
    (``{"path", "step", "ts"}``), or None. Entries whose path no longer
    holds a commit marker are ignored (storage was GC'd or lost)."""
    try:
        from ..core.worker import global_worker

        reply = global_worker()._gcs_call("KvGet", {"key": GCS_KEY_PREFIX + run_name})
        if not reply.get("found"):
            return None
        entry = json.loads(reply["value"])
    except Exception:
        return None
    path = entry.get("path") or ""
    if not os.path.exists(os.path.join(path, COMMIT_MARKER)):
        return None
    return entry


class AsyncCheckpointManager:
    """Background-committed checkpoints with keep-K retention.

    ``save(step, tree)`` returns in snapshot time; serialization, fsync,
    and the atomic rename happen on a daemon writer thread. One pending
    snapshot is held at most: a newer save replaces an unwritten older
    one (the drop is counted — under a slow disk you keep the freshest
    state, not a backlog).
    """

    def __init__(self, root: str, *, run_name: str = "", keep_k: int | None = 2,
                 register_with_gcs: bool = True, write_fn=None):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.run_name = run_name
        self.keep_k = keep_k
        self._register = register_with_gcs
        self._write_fn = write_fn or _default_write
        self._cv = threading.Condition()
        self._pending: tuple[int, object, dict] | None = None
        self._writing = False
        self._closed = False
        self.last_committed: dict | None = latest_committed(self.root)
        self.metrics = {"saves": 0, "commits": 0, "dropped": 0,
                        "commit_errors": 0, "max_save_block_ms": 0.0}
        self._thread = threading.Thread(
            target=self._writer_loop, daemon=True,
            name=f"async-ckpt-{run_name or 'anon'}")
        self._thread.start()

    # ------------------------------------------------------------- train side
    def save(self, step: int, tree, metrics: dict | None = None) -> float:
        """Snapshot ``tree`` and enqueue its commit. Returns the
        milliseconds the CALLER was blocked (snapshot only — the contract
        the non-blocking test asserts)."""
        t0 = time.perf_counter()
        snapshot = _snapshot(tree)
        with self._cv:
            if self._closed:
                raise RuntimeError("AsyncCheckpointManager is closed")
            if self._pending is not None:
                self.metrics["dropped"] += 1
            self._pending = (int(step), snapshot, dict(metrics or {}))
            self.metrics["saves"] += 1
            self._cv.notify_all()
        block_ms = (time.perf_counter() - t0) * 1000.0
        self.metrics["max_save_block_ms"] = max(
            self.metrics["max_save_block_ms"], block_ms)
        return block_ms

    def wait(self, timeout: float | None = 30.0) -> bool:
        """Block until every enqueued snapshot is committed (or timeout)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._pending is not None or self._writing:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(remaining if remaining is None else min(remaining, 0.5))
        return True

    def close(self, timeout: float = 30.0) -> None:
        """Flush pending commits, then stop the writer thread."""
        self.wait(timeout)
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=5.0)

    # ------------------------------------------------------------ writer side
    def _writer_loop(self) -> None:
        while True:
            with self._cv:
                while self._pending is None and not self._closed:
                    self._cv.wait(0.5)
                if self._pending is None and self._closed:
                    return
                step, snapshot, metrics = self._pending
                self._pending = None
                self._writing = True
            try:
                self._commit(step, snapshot, metrics)
            except Exception:
                self.metrics["commit_errors"] += 1
                logger.exception("async checkpoint commit of step %d failed", step)
            finally:
                with self._cv:
                    self._writing = False
                    self._cv.notify_all()

    def _commit(self, step: int, snapshot, metrics: dict) -> None:
        final = os.path.join(self.root, f"{_CKPT_PREFIX}{step:08d}")
        tmp = os.path.join(self.root, f"{_TMP_PREFIX}{step:08d}-{uuid.uuid4().hex[:8]}")
        os.makedirs(tmp)
        try:
            self._write_fn(snapshot, tmp)
            _write_json_synced(os.path.join(tmp, "meta.json"), {
                "step": step, "metrics": metrics, "ts": time.time(),
                "run_name": self.run_name,
            })
            # The marker is written LAST inside tmp; the rename publishes
            # marker+payload as one unit. Readers key on the marker, so
            # there is no window where a visible dir lacks its payload.
            _write_json_synced(os.path.join(tmp, COMMIT_MARKER), {"step": step})
            if os.path.exists(final):  # re-commit of the same step: replace
                shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            _fsync_dir(self.root)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self.last_committed = {"step": step, "path": final}
        self.metrics["commits"] += 1
        if self._register and self.run_name:
            register_latest(self.run_name, final, step)
        self._gc()

    def _gc(self) -> None:
        if self.keep_k is None or self.keep_k <= 0:
            return
        committed = list_committed(self.root)
        for _step, path in committed[: max(0, len(committed) - self.keep_k)]:
            shutil.rmtree(path, ignore_errors=True)
