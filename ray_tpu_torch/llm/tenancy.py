"""Adapter residency for multi-LoRA serving: which adapters occupy the
device stack's slots, who pins them, and LRU eviction.

The port's own copy of the parts of ``ray_tpu/llm/tenancy.py`` that the
engine and ``lora.LoRAManager`` use: ``AdapterCapacityError``,
``_AdapterState`` and ``AdapterPool``, with the same slot numbering, LRU
order and ``stats()`` keys. Tenant quotas and the weighted fair queue
(``TokenBucket``, ``WeightedFairQueue``, ``TenantLedger``,
``QuotaExceeded``) serve the HTTP/serve layer, which the port does not
have yet. Plain host-side Python: the device write stays with the
manager's install hook.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass


class AdapterCapacityError(RuntimeError):
    """Every resident adapter slot is pinned by an in-flight request: the
    engine defers admission (the request waits at the head of the queue)
    instead of failing it."""


@dataclass
class _AdapterState:
    slot: int
    pins: int = 0
    loads: int = 0
    last_load_ms: float = 0.0


class AdapterPool:
    """Resident adapters for one engine: LRU over ``capacity`` stack slots
    (1..capacity; slot 0 is the base model), with a pin count per
    in-flight request. The JAX package's residency cap below
    ``capacity`` (``max_resident``) comes with the serve layer that sets
    it; ``stats()["max_resident"]`` reports ``capacity``.

    The caller owns the device write: ``begin_load`` reserves (and pins) a
    slot, and ``commit_load`` or ``abort_load`` finishes it, so a failed
    load rolls back. ``on_evict(adapter_id, slot)``, when set, runs after
    an explicit eviction returns a slot to the free list (the manager
    zeroes the device slot there); LRU replacement inside ``begin_load``
    skips it, since the incoming install overwrites the slot at once.
    Thread-safe.
    """

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._resident: dict[str, _AdapterState] = {}   # id -> state
        self._order: list[str] = []                     # LRU, oldest first
        self._free = list(range(1, self.capacity + 1))
        self._loads = 0
        self._evictions = 0
        self._hits = 0
        self._load_ms_total = 0.0
        self._device_unloads = 0
        self.on_evict = None

    # -- residency -------------------------------------------------------
    def lookup(self, adapter_id: str) -> int | None:
        """Slot if resident (pins it and refreshes its LRU place), else
        None."""
        with self._lock:
            st = self._resident.get(adapter_id)
            if st is None:
                return None
            self._order.remove(adapter_id)
            self._order.append(adapter_id)
            st.pins += 1
            self._hits += 1
            return st.slot

    def begin_load(self, adapter_id: str) -> int:
        """Reserve a slot for a cold adapter, evicting the oldest unpinned
        one when no slot is free. Raises
        ``AdapterCapacityError`` when every resident adapter is pinned.
        The reservation is pinned; finish with ``commit_load`` or
        ``abort_load``."""
        with self._lock:
            if adapter_id in self._resident:
                # Lost a race with a concurrent load: behave like lookup.
                st = self._resident[adapter_id]
                self._order.remove(adapter_id)
                self._order.append(adapter_id)
                st.pins += 1
                return st.slot
            slot = self._claim_slot_locked()
            st = _AdapterState(slot=slot, pins=1)
            self._resident[adapter_id] = st
            self._order.append(adapter_id)
            return slot

    def _claim_slot_locked(self) -> int:
        if self._free:
            return self._free.pop()
        for aid in self._order:                        # oldest first
            st = self._resident[aid]
            if st.pins == 0:
                self._order.remove(aid)
                del self._resident[aid]
                self._evictions += 1
                return st.slot
        raise AdapterCapacityError(
            f"all {len(self._resident)} resident adapters pinned "
            f"({self.capacity} slots); admission defers until a request "
            "finishes")

    def commit_load(self, adapter_id: str, load_ms: float = 0.0) -> None:
        with self._lock:
            st = self._resident.get(adapter_id)
            if st is not None:
                st.loads += 1
                st.last_load_ms = load_ms
                self._loads += 1
                self._load_ms_total += load_ms

    def abort_load(self, adapter_id: str) -> None:
        """Roll back a ``begin_load`` whose device write failed."""
        with self._lock:
            st = self._resident.pop(adapter_id, None)
            if st is None:
                return
            if adapter_id in self._order:
                self._order.remove(adapter_id)
            st.pins -= 1
            if st.pins <= 0:
                self._free.append(st.slot)
            else:
                # Another request pinned it mid-load; the slot returns
                # once those pins drain.
                self._resident[adapter_id] = st
                self._order.append(adapter_id)

    def unpin_slot(self, slot: int) -> None:
        with self._lock:
            for st in self._resident.values():
                if st.slot == slot and st.pins > 0:
                    st.pins -= 1
                    return

    # -- explicit eviction ----------------------------------------------
    def evict(self, adapter_id: str) -> int | None:
        """Evict one unpinned resident adapter, return its slot to the
        free list, then run ``on_evict`` outside the lock. Returns the
        freed slot, or None when the adapter is absent or pinned."""
        with self._lock:
            st = self._resident.get(adapter_id)
            if st is None or st.pins > 0:
                return None
            self._order.remove(adapter_id)
            del self._resident[adapter_id]
            self._free.append(st.slot)
            self._evictions += 1
            self._device_unloads += 1
            slot = st.slot
        if self.on_evict is not None:
            try:
                self.on_evict(adapter_id, slot)
            except Exception:
                # The slot is free either way; a later load overwrites it.
                pass
        return slot

    def evict_idle(self) -> list[tuple[str, int]]:
        """Evict every unpinned resident adapter. Returns the
        ``(adapter_id, slot)`` pairs released."""
        with self._lock:
            victims = [aid for aid in list(self._order)
                       if self._resident[aid].pins == 0]
        out = []
        for aid in victims:
            slot = self.evict(aid)
            if slot is not None:
                out.append((aid, slot))
        return out

    # -- introspection ---------------------------------------------------
    def resident(self) -> dict[str, int]:
        """adapter_id -> slot, LRU order (oldest first)."""
        with self._lock:
            return {aid: self._resident[aid].slot for aid in self._order}

    def stats(self) -> dict:
        with self._lock:
            return {
                "resident": list(self._order),
                "resident_count": len(self._resident),
                "max_resident": self.capacity,
                "capacity": self.capacity,
                "hits": self._hits,
                "loads": self._loads,
                "evictions": self._evictions,
                # slots free (zeroed or never used), and evictions that
                # zeroed the device slot
                "free_slots": len(self._free),
                "device_unloads": self._device_unloads,
                "avg_load_ms": (self._load_ms_total / self._loads
                                if self._loads else 0.0),
            }
