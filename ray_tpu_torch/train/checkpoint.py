"""Checkpoints: directory handles + top-K retention.

Reference: ``python/ray/train/_checkpoint.py:56`` (Checkpoint),
``_internal/checkpoint_manager.py`` (top-K by metric). Tensor trees are
saved with ``torch.save`` (``save_pytree``/``load_pytree``), plain
directories otherwise.
"""

from __future__ import annotations

import contextlib
import heapq
import json
import os
import shutil
import tempfile
import uuid


class Checkpoint:
    """A handle to a checkpoint directory. Reference: _checkpoint.py:56."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def to_directory(self, dest: str | None = None) -> str:
        dest = dest or os.path.join(tempfile.gettempdir(), f"ckpt_{uuid.uuid4().hex[:8]}")
        if os.path.abspath(dest) != self.path:
            shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    @contextlib.contextmanager
    def as_directory(self):
        yield self.path

    def __repr__(self):
        return f"Checkpoint({self.path})"

    def __reduce__(self):
        return (Checkpoint, (self.path,))


def map_tree(fn, tree):
    """``fn`` over the leaves of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def _to_host(leaf):
    import torch

    return leaf.detach().cpu() if isinstance(leaf, torch.Tensor) else leaf


def save_pytree(tree, path: str, *, name: str = "state") -> None:
    """Save a tree of tensors under ``path/name.pt`` with ``torch.save``,
    every tensor moved to the CPU first (dtypes kept: bf16 stays bf16).

    The write is ATOMIC: the bytes go to a same-directory temp file, are
    fsynced, and replace the target in one ``os.replace`` — a reader sees
    the previous complete version or none, never a partial one.
    """
    import torch

    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, name) + ".pt"
    tmp = final + f".tmp-{uuid.uuid4().hex[:8]}"
    try:
        with open(tmp, "wb") as f:
            torch.save(map_tree(_to_host, tree), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def load_pytree(path: str, *, name: str = "state", like=None):
    """Load a tree saved by ``save_pytree`` (``weights_only``: tensors,
    numbers, strings and containers). With ``like``, a tree of the same
    structure, each tensor goes to the device and dtype of ``like``'s
    leaf in its place."""
    import torch

    with open(os.path.join(path, name) + ".pt", "rb") as f:
        tree = torch.load(f, map_location="cpu", weights_only=True)
    if like is None:
        return tree
    return _like(tree, like)


def _like(tree, like):
    import torch

    if isinstance(like, dict):
        return {k: _like(tree[k], v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_like(t, v) for t, v in zip(tree, like))
    if isinstance(like, torch.Tensor) and isinstance(tree, torch.Tensor):
        return tree.to(device=like.device, dtype=like.dtype)
    return tree


class CheckpointManager:
    """Keeps the top-K reported checkpoints by a score attribute."""

    def __init__(self, config) -> None:
        self._config = config
        self._entries: list[tuple[float, int, Checkpoint]] = []  # (score, seq, ckpt)
        self._seq = 0
        self.latest: Checkpoint | None = None

    def register(self, checkpoint: Checkpoint, metrics: dict) -> None:
        self.latest = checkpoint
        attr = self._config.checkpoint_score_attribute
        keep = self._config.num_to_keep
        score = 0.0
        if attr is not None and attr in (metrics or {}):
            score = float(metrics[attr])
            if self._config.checkpoint_score_order == "min":
                score = -score
        self._seq += 1
        heapq.heappush(self._entries, (score, self._seq, checkpoint))
        meta = {"metrics": metrics or {}}
        try:
            with open(os.path.join(checkpoint.path, ".metrics.json"), "w") as f:
                json.dump(meta, f, default=str)
        except OSError:
            pass
        if keep is not None:
            while len(self._entries) > keep:
                _, _, evicted = heapq.heappop(self._entries)
                if evicted.path != checkpoint.path:
                    shutil.rmtree(evicted.path, ignore_errors=True)

    @property
    def best(self) -> Checkpoint | None:
        if not self._entries:
            return self.latest
        return max(self._entries)[2]
