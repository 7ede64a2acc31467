"""Carry parameter and page trees across as host arrays, keep the weights
in host RAM while an engine stands by, and broadcast them over the loop
wire.

The port of ``ray_tpu/llm/weights.py`` plus the numpy loaders of the
parity tests:

* **host arrays, bit for bit**: :func:`tensor_to_host` and
  :func:`host_to_tensor` carry a tensor as a numpy array and a dtype
  name. bfloat16 travels as its raw 16-bit integers (the card's machine
  has no numpy bfloat16), half the bytes of a detour through float32;
  a numpy bfloat16 array (the ``ml_dtypes`` type of a JAX tree) is read
  through its bits.
* **numpy loaders**: :func:`params_from_numpy` and
  :func:`pages_from_numpy` take the JAX package's trees (nested dicts of
  arrays) through :func:`host_to_tensor` and cast floating leaves to the
  target dtype on the device.
* **host tier**: :func:`tree_to_host` / :func:`host_to_device` move a
  params tree between the card and (pinned) host memory; a demoted
  engine keeps the host copy and promotion is one copy sweep.
* **broadcast wire**: :class:`WeightBroadcastSource` streams a params
  tree over the credit-bounded ``TcpLoopServer`` (``dag/channel.py``) to
  ``n_readers`` readers at once; :func:`receive_weight_stream` rebuilds
  it.

Trees are nested dicts whose leaves are tensors or numpy arrays. Their
leaf order is the JAX package's (``jax.tree_util`` sorts dict keys), so
:func:`params_fingerprint` equals the JAX package's on the same tree.

Wire protocol (pickled dicts, exactly once, in order):

    {"kind": "meta",  "model", "n_leaves", "total_bytes",
                      "paths": [[key, ...], ...], "fingerprint"}
    {"kind": "chunk", "leaf", "dtype", "shape", "offset", "data"}
    {"kind": "end",   "fingerprint"}                 # complete
    {"kind": "abort"}                                # source failed

``paths`` (each leaf's key path, in leaf order) stands where the JAX
package sends a pickled treedef, which only JAX can read. A receiver that
loses the stream (source death, timeout, digest mismatch) returns
``params=None`` with a status string, and the caller falls back to its
own load path.
"""

from __future__ import annotations

import hashlib
import logging
import pickle
import threading
import time

import numpy as np
import torch

from .._device import resolve_device
from ..dag.channel import (WIRE_TIMEOUT_S, ChannelClosed, TcpLoopReader,
                           TcpLoopServer)

logger = logging.getLogger(__name__)

# One chunk per write keeps the credit window meaningful: 4 MiB chunks x
# 8 slots bound the writer's lead at ~32 MiB whatever the model's size.
DEFAULT_CHUNK_BYTES = 4 << 20


# ---------------------------------------------------- host arrays, bit-exact
def dtype_name(dtype) -> str:
    """A torch or numpy dtype as numpy spells it ("bfloat16", "float32")."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def tensor_to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A tensor -> ``(numpy array, dtype name)``, bfloat16 as its raw
    16-bit integers. The copy to the host is synchronous, so the array is
    filled when this returns."""
    t = t.detach()
    name = dtype_name(t.dtype)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy(), name


def host_to_tensor(a, dtype: str | None = None) -> torch.Tensor:
    """The inverse of :func:`tensor_to_host`, bit for bit: a CPU tensor
    from a numpy array. ``dtype="bfloat16"`` reads 16-bit integers as
    bfloat16 bits; a numpy bfloat16 array (``ml_dtypes``, what a JAX
    payload holds) is read through its bits too."""
    # torch shares the array's memory: a read-only one (a JAX payload's)
    # is copied first
    a = np.require(np.asarray(a), requirements=["C", "W"])
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if dtype is None or dtype == a.dtype.name:
        return torch.from_numpy(a)
    if dtype == "bfloat16" and a.dtype.kind in "iu" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    raise ValueError(f"cannot read a {a.dtype} array as {dtype}")


# ------------------------------------------------------------ numpy loaders
def _to_tensor(a, device, dtype: torch.dtype | None) -> torch.Tensor:
    t = host_to_tensor(a)
    if not t.is_floating_point():
        dtype = None
    # a copy on the CPU too: the tensor never shares the caller's array
    return t.to(device=device, dtype=dtype, copy=True)


def _tree_to(tree, device, dtype):
    return _map(tree, lambda a: _to_tensor(a, device, dtype))


def params_from_numpy(tree, device=None, dtype: torch.dtype | None = None):
    """Nested dict of numpy arrays -> the same dict of tensors on
    ``device`` (``None``: the card, raising where there is none). Floating
    arrays take ``dtype`` (default: their own, with numpy bfloat16 mapped
    to ``torch.bfloat16``), except a MoE ``router``, which a given
    ``dtype`` makes float32 (``init_moe_params`` keeps it so); integer
    arrays keep theirs. Layouts are unchanged."""
    device = resolve_device(device)

    def load(node, key=None):
        if isinstance(node, dict):
            return {k: load(v, k) for k, v in node.items()}
        return _to_tensor(node, device, torch.float32
                          if key == "router" and dtype is not None else dtype)

    return load(tree)


def pages_from_numpy(pages: dict, device=None,
                     dtype: torch.dtype | None = None) -> dict:
    """A ``{"k", "v"}`` page pool [L, P, KH, page, D] of numpy arrays ->
    tensors on ``device`` (``None``: the card, raising where there is
    none)."""
    if set(pages) != {"k", "v"}:
        raise ValueError(f"a page pool has keys k and v, not {sorted(pages)}")
    device = resolve_device(device)
    out = {k: _to_tensor(v, device, dtype) for k, v in pages.items()}
    if out["k"].dim() != 5 or out["k"].shape != out["v"].shape:
        raise ValueError("page pool arrays must both be [L, P, KH, page, D]")
    return out


# ----------------------------------------------------------------- host tier
def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree, path=()):
    """``(key path, leaf)`` of every leaf, dict keys in sorted order (the
    JAX package's leaf order); a list's items in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _unflatten(paths, leaves) -> dict:
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    if t.device.type == "cpu":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)  # synchronous: the copy is done when this returns
    return host


def tree_to_host(params) -> dict:
    """Copy every leaf of ``params`` on the card to pinned host memory —
    the standby form; a leaf already on the host is kept as it is. The
    device tensors are NOT freed here: drop every reference to them to
    release the memory."""
    return _map(params, _pinned_copy)


def host_to_device(host_tree, device=None) -> dict:
    """Promote a host tree to ``device`` (``None``: the card). Returns
    once every copy is done (on the card, after a synchronize: the copies
    from pinned memory run without one in between)."""
    device = resolve_device(device)
    out = _map(host_tree, lambda t: t.to(device, non_blocking=True))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(np.asarray(leaf).nbytes)


def tree_bytes(params) -> int:
    return sum(_nbytes(leaf) for _, leaf in _leaves(params))


def _leaf_bytes(leaf) -> np.ndarray:
    """A leaf's raw bytes as a flat uint8 array (a host copy for a tensor
    on the card)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous().reshape(-1)
        return t.view(torch.uint8).numpy()
    return np.ascontiguousarray(leaf).reshape(-1).view(np.uint8)


def params_fingerprint(params) -> str:
    """Order-stable digest of a params tree: each leaf's dtype (as numpy
    spells it), shape and raw bytes, in leaf order. Equal to the JAX
    package's digest of the same tree, so a received tree and a direct
    load compare by fingerprint."""
    h = hashlib.sha256()
    for _, leaf in _leaves(params):
        h.update(dtype_name(leaf.dtype).encode())
        h.update(repr(tuple(leaf.shape)).encode())
        h.update(_leaf_bytes(leaf))
    return h.hexdigest()


# ------------------------------------------------------------ broadcast wire
def _host_leaf(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().contiguous()
    return host_to_tensor(leaf)


class WeightBroadcastSource:
    """Warm-side exporter: snapshots ``params`` to the host in the
    caller's thread (so the source stays valid if the donor demotes
    afterwards), then streams it chunk by chunk from a background thread
    to ``n_readers`` readers. ``_die_after_chunks`` drops the wire after
    that many chunks, as a dead donor would (tests)."""

    def __init__(self, params, model: str = "", n_readers: int = 1,
                 chunk_bytes: int | None = None,
                 advertise: str | None = None,
                 _die_after_chunks: int | None = None):
        flat = list(_leaves(params))
        self._paths = [list(path) for path, _ in flat]
        self._leaves = [_host_leaf(leaf) for _, leaf in flat]
        self.model = model
        self.fingerprint = params_fingerprint(self._leaves)
        self.chunk_bytes = max(64 << 10, chunk_bytes or DEFAULT_CHUNK_BYTES)
        self._server = TcpLoopServer(n_slots=8, n_readers=max(1, n_readers),
                                     advertise=advertise)
        self._die_after = _die_after_chunks
        self.stats = {"leaves": len(self._leaves), "bytes": 0, "chunks": 0,
                      "total_bytes": sum(_nbytes(t) for t in self._leaves)}
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="weight-broadcast-src")
        self._thread.start()

    @property
    def address(self) -> str:
        return self._server.address

    def _send(self, msg: dict) -> None:
        blob = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
        self._server.write(blob, timeout=WIRE_TIMEOUT_S)
        self.stats["bytes"] += len(blob)

    def _run(self) -> None:
        try:
            self._send({"kind": "meta", "model": self.model,
                        "n_leaves": len(self._leaves),
                        "total_bytes": self.stats["total_bytes"],
                        "paths": self._paths,
                        "fingerprint": self.fingerprint})
            for i, leaf in enumerate(self._leaves):
                raw = leaf.reshape(-1).view(torch.uint8)
                off = 0
                # A zero-size leaf still sends one chunk, so the receiver
                # makes it.
                while True:
                    data = raw[off:off + self.chunk_bytes].numpy().tobytes()
                    self._send({"kind": "chunk", "leaf": i,
                                "dtype": dtype_name(leaf.dtype),
                                "shape": tuple(leaf.shape),
                                "offset": off, "data": data})
                    off += len(data)
                    self.stats["chunks"] += 1
                    if self._die_after is not None \
                            and self.stats["chunks"] >= self._die_after:
                        self._server.close()  # simulated donor death
                        return
                    if off >= raw.numel():
                        break
            self._send({"kind": "end", "fingerprint": self.fingerprint})
        except Exception:
            # The source thread's boundary: readers see an abort (or a
            # closed wire) and fall back to their own load path.
            logger.warning("weight broadcast failed", exc_info=True)
            try:
                self._send({"kind": "abort"})
            except (ChannelClosed, TimeoutError):
                pass
        finally:
            # Close after drain: queued chunks (and the end marker) still
            # reach every reader, then they see ChannelClosed.
            self._server.close_writer()

    def join(self, timeout: float | None = 60.0) -> None:
        self._thread.join(timeout)

    def close(self) -> None:
        self._thread.join(timeout=5.0)
        self._server.close()


def receive_weight_stream(address: str, like=None,
                          timeout_s: float | None = None) -> dict:
    """Cold-side importer: pull one weight broadcast into host tensors and
    rebuild the tree from the wire's key paths (or from ``like``'s
    structure when the wire carries none).

    Degrades, never fails: a wire error, an incomplete leaf set or a
    digest mismatch returns ``params=None`` with a ``status`` string.
    Returns ``{"params", "bytes", "leaves", "seconds", "complete",
    "status", "fingerprint", "model"}``."""
    t0 = time.monotonic()
    out = {"params": None, "bytes": 0, "leaves": 0, "seconds": 0.0,
           "complete": False, "status": "ok", "fingerprint": "",
           "model": ""}
    if timeout_s is None:
        timeout_s = WIRE_TIMEOUT_S
    n_leaves = 0
    paths = None
    claimed = ""
    bufs: dict[int, dict] = {}
    reader = None

    def done(status: str | None = None) -> dict:
        if status is not None:
            out["status"] = status
        out["seconds"] = round(time.monotonic() - t0, 6)
        return out

    try:
        reader = TcpLoopReader(address)
        deadline = time.monotonic() + timeout_s
        while True:
            blob = reader.read(timeout=max(0.1, deadline - time.monotonic()))
            out["bytes"] += len(blob)
            msg = pickle.loads(blob)
            kind = msg.get("kind")
            if kind == "meta":
                n_leaves = int(msg.get("n_leaves", 0))
                paths = msg.get("paths")
                claimed = msg.get("fingerprint") or ""
                out["model"] = msg.get("model") or ""
            elif kind == "chunk":
                ent = bufs.setdefault(int(msg["leaf"]), {
                    "dtype": msg["dtype"], "shape": tuple(msg["shape"]),
                    "data": bytearray()})
                ent["data"] += msg["data"]  # in-order wire: offsets append
            elif kind == "end":
                out["complete"] = True
                claimed = msg.get("fingerprint") or claimed
                break
            elif kind == "abort":
                out["status"] = "aborted"
                break
    except (ChannelClosed, TimeoutError, ConnectionError, OSError,
            EOFError, pickle.UnpicklingError) as e:
        out["status"] = type(e).__name__
    finally:
        if reader is not None:
            reader.close()
    out["leaves"] = len(bufs)
    if not out["complete"] or len(bufs) != n_leaves or n_leaves == 0:
        out["complete"] = False
        return done("incomplete" if out["status"] == "ok" else None)
    leaves = []
    for i in range(n_leaves):
        ent = bufs[i]
        dtype = getattr(torch, ent["dtype"])
        if ent["data"]:
            t = torch.frombuffer(ent["data"], dtype=torch.uint8).view(dtype)
        else:
            t = torch.empty(0, dtype=dtype)
        leaves.append(t.reshape(ent["shape"]))
    out["fingerprint"] = params_fingerprint(leaves)
    if claimed and out["fingerprint"] != claimed:
        out["complete"] = False
        return done("digest_mismatch")
    if paths is None and like is not None:
        paths = [list(path) for path, _ in _leaves(like)]
    if paths is None:
        return done("no_structure")
    if len(paths) != n_leaves:
        return done("structure_mismatch")
    out["params"] = _unflatten(paths, leaves)
    return done()
