"""ObjectRef: the user-facing distributed future.

Equivalent of the reference's ``ObjectRef`` (``python/ray/includes/object_ref.pxi``):
wraps an :class:`ObjectID` plus the owner's RPC address. Python refcount
integrates with the distributed ``ReferenceCounter`` — ``__del__`` removes a
local ref, and pickling inside task args / ``ray.put`` records containment
(borrowing, reference ``reference_count.h:66``).
"""

from __future__ import annotations

from . import serialization
from .ids import ObjectID


class ObjectRef:
    __slots__ = ("_id", "_owner_address", "_skip_refcount", "_callsite", "__weakref__")

    def __init__(self, object_id: ObjectID, owner_address: str = "", *, _add_local_ref: bool = True):
        self._id = object_id
        self._owner_address = owner_address
        self._skip_refcount = not _add_local_ref
        if _add_local_ref:
            # Creation callsite for `ray memory`-style reference debugging
            # (observability/memory.py; reference record_ref_creation_sites):
            # the first user frame above the ray_tpu call that made the ref.
            from ..observability.memory import capture_callsite

            self._callsite = capture_callsite()
            _refcounter_hook("add_local", self)
        else:
            self._callsite = ""

    @property
    def callsite(self) -> str:
        return self._callsite

    def id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    def task_id(self):
        return self._id.task_id()

    @property
    def owner_address(self) -> str:
        return self._owner_address

    def __eq__(self, other) -> bool:
        return isinstance(other, ObjectRef) and other._id == self._id

    def __hash__(self) -> int:
        return hash(self._id)

    def __repr__(self) -> str:
        return f"ObjectRef({self._id.hex()})"

    def __del__(self):
        if not self._skip_refcount:
            try:
                _refcounter_hook("remove_local", self)
            except Exception:
                pass

    # Support `ray.get(ref)` style plus direct await in async actors.
    def __await__(self):
        from . import worker as worker_mod

        def _get():
            return worker_mod.global_worker().get([self])[0]

        import concurrent.futures

        loop_result = yield from _run_in_thread(_get).__await__()
        return loop_result


async def _run_in_thread(fn):
    import asyncio

    return await asyncio.get_running_loop().run_in_executor(None, fn)


_hooks = {}


def _refcounter_hook(kind: str, ref: ObjectRef) -> None:
    hook = _hooks.get(kind)
    if hook is not None:
        hook(ref)


def install_refcount_hooks(add_local, remove_local) -> None:
    _hooks["add_local"] = add_local
    _hooks["remove_local"] = remove_local


def clear_refcount_hooks() -> None:
    _hooks.clear()


def _reconstruct_ref(id_binary: bytes, owner_address: str) -> ObjectRef:
    """Unpickle an ObjectRef: registers a local ref in the deserializing
    worker (the borrower) — the borrowing entry point."""
    return ObjectRef(ObjectID(id_binary), owner_address)


def _reduce_object_ref(ref: ObjectRef):
    return _reconstruct_ref, (ref.binary(), ref.owner_address)


serialization.register_object_ref_serializer(ObjectRef, _reduce_object_ref)
