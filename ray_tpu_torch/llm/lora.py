"""Multi-LoRA serving: device-resident adapter stacks and per-slot routing.

The port of ``ray_tpu/llm/lora.py``. Adapters live in a fixed stack on
the device, one pair of tensors per attention projection:

    A[proj]: [L, max_loras + 1, E_in, r]     B[proj]: [L, max_loras + 1, r, E_out]

Slot 0 is the identity adapter (zeros), so requests for the base model
ride the same programs. A decode batch carries one adapter index per
slot; the decode programs gather each slot's rows once a dispatch
(``slot_rows``) and add ``(h @ A) @ B`` to the frozen projections, so a
batch mixing adapters decodes in one call. The products are plain
``torch`` batched matmuls, as the JAX package's are gathered einsums
outside any Pallas kernel.

Host side, ``LoRAManager`` maps adapter ids to stack slots (LRU over the
slots, pins for in-flight requests, through ``tenancy.AdapterPool``) and
loads an adapter by writing its rank-padded A/B into the stack in place
(``install_slot``).

Cuts against the JAX package:
  * adapters are ``.npz`` files (``{wq|wk|wv|wo}.{A|B}`` arrays, rank
    <= max_rank) read and written with numpy on local paths only; a path
    with a ``scheme://`` raises ``ValueError`` (the JAX package reads
    URIs through ``pyarrow.fs``). The files are the same format both
    ways;
  * ``LoRAServingConfig`` has no ``max_loaded_adapters`` (a residency
    cap below ``max_loras``): only the tenant serve layer sets it, and
    it comes with that layer. Every stack slot can hold an adapter.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from ..observability import tracing
from .tenancy import AdapterPool

PROJS = ("wq", "wk", "wv", "wo")


@dataclass(frozen=True)
class LoRAServingConfig:
    """The engine's ``lora_config``."""

    max_loras: int = 4          # stack slots (excluding the identity slot)
    max_rank: int = 16
    dynamic_lora_loading_path: str | None = None  # directory of adapters


def proj_dims(c) -> dict:
    """(E_in, E_out) of each adapted projection."""
    E, H, KH, D = c.hidden, c.n_heads, c.n_kv_heads, c.head_dim
    return {"wq": (E, H * D), "wk": (E, KH * D), "wv": (E, KH * D),
            "wo": (H * D, E)}


def init_lora_stack(config, max_loras: int, max_rank: int,
                    device=None) -> dict:
    """All-zero adapter stacks in the config's dtype on ``device``
    (``None``: the card, raising where there is none). Slot 0 is the
    identity and is never written."""
    device = resolve_device(device)
    L, n = config.n_layers, max_loras + 1
    stack = {}
    for p, (ein, eout) in proj_dims(config).items():
        stack[f"{p}.A"] = torch.zeros((L, n, ein, max_rank),
                                      dtype=config.dtype, device=device)
        stack[f"{p}.B"] = torch.zeros((L, n, max_rank, eout),
                                      dtype=config.dtype, device=device)
    return stack


def install_slot(stack: dict, slot: int, arrays: dict) -> None:
    """Write one adapter's rank-padded A/B ([L, E_in, r] / [L, r, E_out]
    arrays) into stack slot ``slot``, in place: one copy per tensor and
    no new stack."""
    for k, v in arrays.items():
        stack[k][:, slot].copy_(torch.from_numpy(
            np.ascontiguousarray(v, dtype=np.float32)))


def lora_delta(h, A, B, l: int, idx):
    """Batched per-slot LoRA delta for one projection at layer ``l``.

    h [n, S, E_in]; A [L, slots, E_in, r]; B [L, slots, r, E_out]; idx [n]
    int — each batch row's adapter slot (0 = identity). Returns
    [n, S, E_out]."""
    idx = idx.long()
    return torch.bmm(torch.bmm(h, A[l][idx]), B[l][idx])


def lora_delta_single(h, A, B, l: int, idx):
    """Single-sequence (prefill) variant: h [1, C, E_in], scalar ``idx``
    (an int or a 0-d tensor). Returns [1, C, E_out]."""
    return h @ A[l, idx] @ B[l, idx]


def slot_rows(lora: dict, idx) -> dict:
    """Each batch row's adapter, gathered from the stack once a dispatch:
    ``qkv.A`` [L, n, E, 3r] (the q, k and v A's side by side, so one
    product serves all three), ``{wq|wk|wv|wo}.B`` and ``wo.A`` [L, n,
    ...]. ``idx`` [n] is the device copy of the slots' adapter indices;
    nothing is read back to the host."""
    idx = idx.long()
    qkv_a = torch.cat([lora[f"{p}.A"] for p in PROJS[:3]], dim=-1)
    rows = {"qkv.A": qkv_a.index_select(1, idx)}
    for k in ("wq.B", "wk.B", "wv.B", "wo.A", "wo.B"):
        rows[k] = lora[k].index_select(1, idx)
    return rows


def add_qkv_deltas(q, k, v, h, rows: dict, l: int):
    """q/k/v [n, heads, 1, D] plus each slot's delta at layer ``l``, from
    ``slot_rows``: one product ``h @ [A_q A_k A_v]`` for all three, then
    each ``+ (h @ A) @ B`` as one ``baddbmm_`` on the flattened
    projection (heads, head_dim order, as B's columns)."""
    r = rows["wq.B"].shape[2]
    t = torch.bmm(h, rows["qkv.A"][l])                       # [n, 1, 3r]
    out = []
    for i, (x, p) in enumerate(zip((q, k, v), PROJS)):
        n, heads, _, d = x.shape
        flat = x.transpose(1, 2).reshape(n, 1, heads * d)
        flat.baddbmm_(t[..., i * r:(i + 1) * r], rows[f"{p}.B"][l])
        out.append(flat.view(n, 1, heads, d).transpose(1, 2))
    return tuple(out)


def add_wo_delta_(out, attn, rows: dict, l: int):
    """``out += (attn @ A_o) @ B_o`` in place, per slot: attn [n, 1, H*D]
    (heads, head_dim order, as wo's rows), out [n, 1, E]."""
    return out.baddbmm_(torch.bmm(attn, rows["wo.A"][l]), rows["wo.B"][l])


def load_adapter_arrays(path: str) -> dict[str, np.ndarray]:
    """Read ``{proj}.{A|B}`` arrays from a local ``.npz``: A [L, E_in, r],
    B [L, r, E_out] (r <= max_rank)."""
    _check_local(path)
    with np.load(path) as npz:
        return {k: npz[k] for k in npz.files}


def save_adapter(path: str, arrays: dict[str, np.ndarray]) -> None:
    """Write an adapter ``.npz`` at a local path, exactly at ``path``."""
    _check_local(path)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def _check_local(path: str) -> None:
    if "://" in path:
        raise ValueError(f"adapter path {path!r} has a scheme; this package "
                         "reads and writes local paths only")


class LoRAManager:
    """Host-side adapter registry: id -> stack slot, LRU evicted.

    Slot 0 is the base model. ``acquire`` returns the slot for an adapter
    id, loading it into a free or evicted slot on first use; residency,
    pins and LRU live in ``tenancy.AdapterPool``; this class owns naming,
    loading and the device install. When every resident adapter is
    pinned by in-flight requests, ``acquire`` raises
    ``AdapterCapacityError`` and the engine defers admission.
    """

    def __init__(self, config, serving: LoRAServingConfig, install_fn):
        """``install_fn(slot, arrays)`` writes into the device stack (the
        executor owns the stack; the manager owns naming)."""
        self._config = config
        self._serving = serving
        self._install = install_fn
        self._pool = AdapterPool(capacity=serving.max_loras)
        # An explicit eviction zeroes the device slot at once, so a slot
        # that is reused never keeps stale rows. The hook holds no
        # reference to the manager: a bound method would make a cycle
        # (manager -> pool -> hook -> manager), and a dropped engine's
        # executor (its weights, pool and stack) would stay on the card
        # until the cycle collector ran.
        self._pool.on_evict = functools.partial(
            self._zero_slot, config, serving.max_rank, install_fn)

    def resolve_path(self, adapter_id: str) -> str:
        base = self._serving.dynamic_lora_loading_path
        if base is None:
            raise ValueError(
                "lora_config.dynamic_lora_loading_path is not set; cannot "
                f"load adapter {adapter_id!r}")
        return f"{base.rstrip('/')}/{adapter_id}.npz"

    def acquire(self, adapter_id: str | None) -> int:
        """Slot for a request's adapter (0 = base), pinned for the
        request's lifetime; pair with ``release``. A cold adapter loads
        (file read and device copy) and records an ``llm.adapter_load``
        span under the current trace context; ``AdapterCapacityError``
        propagates so admission can defer rather than fail."""
        if not adapter_id:
            return 0
        slot = self._pool.lookup(adapter_id)
        if slot is not None:
            return slot
        slot = self._pool.begin_load(adapter_id)   # may raise capacity
        t0 = time.time()
        try:
            arrays = self._pad(load_adapter_arrays(
                self.resolve_path(adapter_id)))
            self._install(slot, arrays)
        except Exception:
            self._pool.abort_load(adapter_id)
            raise
        load_ms = (time.time() - t0) * 1000.0
        self._pool.commit_load(adapter_id, load_ms)
        wire = tracing.current_wire() or {}
        tracing.record_span(tracing.make_span(
            "llm.adapter_load", "llm", t0, t0 + load_ms / 1000.0,
            wire.get("trace_id", ""), wire.get("span_id", ""),
            attrs={"adapter": adapter_id, "slot": slot,
                   "load_ms": round(load_ms, 3)}))
        return slot

    def release(self, slot: int) -> None:
        if slot == 0:
            return
        self._pool.unpin_slot(slot)

    @staticmethod
    def _zero_slot(c, r_max: int, install_fn, adapter_id: str,
                   slot: int) -> None:
        """Write the identity (all-zero) adapter over an evicted slot."""
        zeros = {}
        for p, (ein, eout) in proj_dims(c).items():
            zeros[f"{p}.A"] = np.zeros((c.n_layers, ein, r_max), np.float32)
            zeros[f"{p}.B"] = np.zeros((c.n_layers, r_max, eout), np.float32)
        install_fn(slot, zeros)

    def evict(self, adapter_id: str) -> bool:
        """Unload one idle adapter (its device slot zeroed)."""
        return self._pool.evict(adapter_id) is not None

    def unload_idle(self) -> int:
        """Unload every adapter no in-flight request pins. Returns how
        many were released."""
        return len(self._pool.evict_idle())

    def resident(self) -> dict[str, int]:
        """adapter_id -> stack slot, LRU order."""
        return self._pool.resident()

    def stats(self) -> dict:
        return self._pool.stats()

    def _pad(self, arrays: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """Zero-pad the rank to max_rank and check the shapes."""
        c, r_max = self._config, self._serving.max_rank
        out = {}
        for p, (ein, eout) in proj_dims(c).items():
            a, b = arrays[f"{p}.A"], arrays[f"{p}.B"]
            if a.ndim != 3 or a.shape[0] != c.n_layers or a.shape[1] != ein:
                raise ValueError(f"{p}.A shape {a.shape} does not match model")
            r = a.shape[2]
            if r > r_max:
                raise ValueError(f"adapter rank {r} > max_rank {r_max}")
            if b.shape != (c.n_layers, r, eout):
                raise ValueError(f"{p}.B shape {b.shape} does not match model")
            out[f"{p}.A"] = np.pad(a, ((0, 0), (0, 0), (0, r_max - r)))
            out[f"{p}.B"] = np.pad(b, ((0, 0), (0, r_max - r), (0, 0)))
        return out
