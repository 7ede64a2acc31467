"""Distributed reference counting (owner side).

Equivalent of the reference's ``ReferenceCounter``
(``src/ray/core_worker/reference_count.h:66``): per-object counts of

  * local refs        — live Python ``ObjectRef`` instances in this process
  * submitted refs    — in-flight tasks that take the object as an arg
  * contained refs    — objects serialized inside other objects (nesting)
  * borrower count    — other workers holding a deserialized copy of the ref

When all counts reach zero the owner frees the object: memory-store entry
dropped, plasma copies deleted on every node that reported a location, and
lineage unpinned. Borrowing here is a simplified variant of the reference
protocol: a borrower reports itself to the owner on deserialization and
sends a single release when its local count drains (the reference batches
this via ``WaitForRefRemoved`` pub/sub).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable

from .ids import ObjectID


@dataclass
class _Ref:
    local: int = 0
    submitted: int = 0
    borrowers: int = 0
    contained_in: int = 0
    # Object IDs this object's value contains (nested refs).
    contains: set = field(default_factory=set)
    # Nodes known to hold a plasma copy.
    locations: set = field(default_factory=set)
    owned: bool = False
    lineage_pinned: bool = False
    # For non-owned (borrowed) refs: the owner's RPC address, so the last
    # local release can send RemoveBorrower back to the owner.
    owner_address: str = ""
    # Borrow registration with the owner has been initiated.
    borrow_registered: bool = False
    # Memory observability (observability/memory.py): Python creation
    # callsite, serialized size, and entry age for memory_summary().
    callsite: str = ""
    size: int = 0
    created_at: float = 0.0

    def total(self) -> int:
        return self.local + self.submitted + self.borrowers + self.contained_in


class ReferenceCounter:
    def __init__(self, on_object_freed: Callable[[ObjectID, set], None] | None = None):
        self._lock = threading.RLock()
        self._refs: dict[ObjectID, _Ref] = {}
        self._on_object_freed = on_object_freed

    def _entry(self, oid: ObjectID) -> _Ref:
        ref = self._refs.get(oid)
        if ref is None:
            ref = self._refs[oid] = _Ref(created_at=time.time())
        return ref

    # -- memory observability ------------------------------------------------
    def set_callsite(self, oid: ObjectID, callsite: str) -> None:
        """First recorded callsite wins: it names the creation line, not
        later touches."""
        if not callsite:
            return
        with self._lock:
            ref = self._refs.get(oid)
            if ref is not None and not ref.callsite:
                ref.callsite = callsite

    def set_size(self, oid: ObjectID, nbytes: int) -> None:
        with self._lock:
            ref = self._refs.get(oid)
            if ref is not None:
                ref.size = int(nbytes)

    def summary(self, limit: int = 200) -> tuple[list[dict], int, int]:
        """(entries, num_refs, total_bytes) for memory_summary(): every
        live entry classified per observability.memory.classify_ref,
        biggest first, capped at ``limit`` rows (totals are uncapped)."""
        from ..observability.memory import classify_ref

        now = time.time()
        entries: list[dict] = []
        total_bytes = 0
        with self._lock:
            num_refs = len(self._refs)
            for oid, ref in self._refs.items():
                total_bytes += ref.size
                entries.append({
                    "object_id": oid.hex(),
                    "size": ref.size,
                    "ref_type": classify_ref(
                        local=ref.local, submitted=ref.submitted,
                        contained_in=ref.contained_in,
                        borrowers=ref.borrowers,
                        pinned=bool(ref.locations)),
                    "callsite": ref.callsite,
                    "age_s": max(0.0, now - ref.created_at) if ref.created_at else 0.0,
                    "local": ref.local,
                    "submitted": ref.submitted,
                    "borrowers": ref.borrowers,
                    "contained_in": ref.contained_in,
                    "owned": ref.owned,
                })
        entries.sort(key=lambda e: e["size"], reverse=True)
        return entries[:limit], num_refs, total_bytes

    # -- ownership -----------------------------------------------------------
    def add_owned_object(self, oid: ObjectID, contained: list[ObjectID] | None = None) -> None:
        with self._lock:
            ref = self._entry(oid)
            ref.owned = True
            for child in contained or []:
                ref.contains.add(child)
                self._entry(child).contained_in += 1

    def is_owned(self, oid: ObjectID) -> bool:
        with self._lock:
            ref = self._refs.get(oid)
            return bool(ref and ref.owned)

    def note_borrowed(self, oid: ObjectID, owner_address: str) -> bool:
        """Record that this process borrows ``oid`` from ``owner_address``.
        Returns True exactly once per borrow episode — the caller must then
        send AddBorrower to the owner (reference: borrower registration,
        ``reference_count.h:66``)."""
        with self._lock:
            ref = self._entry(oid)
            if ref.owned or ref.borrow_registered:
                return False
            ref.owner_address = owner_address
            ref.borrow_registered = True
            return True

    def add_containment(self, outer: ObjectID, children: list[ObjectID]) -> None:
        """outer's value embeds the children (nested refs): children live at
        least as long as outer does in this process."""
        with self._lock:
            ref = self._entry(outer)
            for child in children:
                if child not in ref.contains:
                    ref.contains.add(child)
                    self._entry(child).contained_in += 1

    # -- counts --------------------------------------------------------------
    def add_local_ref(self, oid: ObjectID) -> None:
        with self._lock:
            self._entry(oid).local += 1

    def remove_local_ref(self, oid: ObjectID) -> None:
        self._dec(oid, "local")

    def add_submitted_ref(self, oid: ObjectID) -> None:
        with self._lock:
            self._entry(oid).submitted += 1

    def remove_submitted_ref(self, oid: ObjectID) -> None:
        self._dec(oid, "submitted")

    def add_borrower(self, oid: ObjectID) -> None:
        with self._lock:
            self._entry(oid).borrowers += 1

    def remove_borrower(self, oid: ObjectID) -> None:
        self._dec(oid, "borrowers")

    def _dec(self, oid: ObjectID, kind: str) -> None:
        freed: list[_Ref] = []
        freed_ids: list[ObjectID] = []
        with self._lock:
            ref = self._refs.get(oid)
            if ref is None:
                return
            setattr(ref, kind, max(0, getattr(ref, kind) - 1))
            self._maybe_free(oid, ref, freed_ids, freed)
        for oid_, ref_ in zip(freed_ids, freed):
            if self._on_object_freed is not None:
                self._on_object_freed(oid_, ref_)

    def _maybe_free(self, oid: ObjectID, ref: _Ref, freed_ids: list, freed: list) -> None:
        if ref.total() > 0:
            return
        self._refs.pop(oid, None)
        freed_ids.append(oid)
        freed.append(ref)
        for child in ref.contains:
            child_ref = self._refs.get(child)
            if child_ref is not None:
                child_ref.contained_in = max(0, child_ref.contained_in - 1)
                self._maybe_free(child, child_ref, freed_ids, freed)

    def drop(self, oid: ObjectID) -> None:
        """Forget an object outright, without invoking the free callback for
        it (the caller already disposed of the value). Used by the owner for
        stream items the consumer never materialized a ref for — their
        ``add_owned_object`` bookkeeping would otherwise persist forever.
        Containment edges are still released (children may free normally)."""
        freed_ids: list[ObjectID] = []
        freed: list[_Ref] = []
        with self._lock:
            ref = self._refs.pop(oid, None)
            if ref is None:
                return
            for child in ref.contains:
                child_ref = self._refs.get(child)
                if child_ref is not None:
                    child_ref.contained_in = max(0, child_ref.contained_in - 1)
                    self._maybe_free(child, child_ref, freed_ids, freed)
        for oid_, ref_ in zip(freed_ids, freed):
            if self._on_object_freed is not None:
                self._on_object_freed(oid_, ref_)

    # -- locations -----------------------------------------------------------
    def add_location(self, oid: ObjectID, node_id: bytes) -> None:
        with self._lock:
            self._entry(oid).locations.add(node_id)

    def remove_location(self, oid: ObjectID, node_id: bytes) -> None:
        with self._lock:
            ref = self._refs.get(oid)
            if ref:
                ref.locations.discard(node_id)

    def get_locations(self, oid: ObjectID) -> set:
        with self._lock:
            ref = self._refs.get(oid)
            return set(ref.locations) if ref else set()

    def has_ref(self, oid: ObjectID) -> bool:
        with self._lock:
            return oid in self._refs

    def num_objects(self) -> int:
        with self._lock:
            return len(self._refs)

    def debug(self, oid: ObjectID) -> dict:
        with self._lock:
            ref = self._refs.get(oid)
            if ref is None:
                return {}
            return {
                "local": ref.local,
                "submitted": ref.submitted,
                "borrowers": ref.borrowers,
                "contained_in": ref.contained_in,
                "locations": {n.hex() if isinstance(n, bytes) else n for n in ref.locations},
                "owned": ref.owned,
            }
