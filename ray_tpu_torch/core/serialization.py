"""Object serialization: cloudpickle + pickle-5 out-of-band buffers.

Equivalent of the reference's ``python/ray/_private/serialization.py:122``
(``SerializationContext``): values are cloudpickled with protocol 5 so large
contiguous buffers (numpy / jax host arrays / arrow) are extracted
out-of-band and written verbatim, enabling zero-copy reads from the
shared-memory store. The on-wire layout is one contiguous blob:

    [u32 magic][u32 n_buffers][n_buffers x (u64 offset, u64 size)]
    [padding to 64B][buffer 0 = pickle stream][buffer 1..][...]

Buffers are 64-byte aligned so vectorized consumers can use them in place.
Nested ``ObjectRef`` capture is supported via a thread-local context the
owner installs around serialize/deserialize (the reference does this for
borrowed-ref bookkeeping, ``reference_count.h:66``).
"""

from __future__ import annotations

import pickle
import struct
import sys
import threading
from typing import Any, Callable

from .._vendor import cloudpickle

_MAGIC = 0x52545055  # "RTPU"
_ALIGN = 64
_HEADER = struct.Struct("<II")
_ENTRY = struct.Struct("<QQ")


class PlasmaBuffer:
    """Buffer-protocol wrapper tying a shm read to the deserialized value's
    lifetime.

    Values deserialized from plasma alias arena memory (zero-copy numpy);
    the store must not spill or evict the object while any view is alive.
    The reference solves this with plasma ``Buffer`` objects that hold a
    client ref until GC'd (``python/ray/_private/serialization.py:122`` via
    ``plasma::Buffer``); here the PEP-688 buffer protocol counts live
    exports and fires ``on_release`` when the last derived view (including
    pickle5-reconstructed arrays) is released.
    """

    __slots__ = ("_mv", "_on_release", "_exports")

    def __init__(self, mv: memoryview, on_release: Callable[[], None] | None = None):
        self._mv = mv
        self._on_release = on_release
        self._exports = 0

    def __buffer__(self, flags: int) -> memoryview:
        self._exports += 1
        return memoryview(self._mv)

    def __release_buffer__(self, view: memoryview) -> None:
        self._exports -= 1
        if self._exports == 0 and self._on_release is not None:
            cb, self._on_release = self._on_release, None
            try:
                cb()
            except Exception:
                pass

    def __del__(self):
        # Never exported (e.g. deserialize raised before unframing).
        if self._on_release is not None:
            cb, self._on_release = self._on_release, None
            try:
                cb()
            except Exception:
                pass

    def copy_and_release(self) -> bytes:
        """Pre-3.12 fallback (no PEP-688 ``__buffer__``): copy out of the
        arena and release the read pin eagerly — loses zero-copy, keeps
        correctness."""
        data = bytes(self._mv)
        if self._on_release is not None:
            cb, self._on_release = self._on_release, None
            try:
                cb()
            except Exception:
                pass
        return data


_HAS_PEP688 = sys.version_info >= (3, 12)

# Metadata tags (reference: ray_constants OBJECT_METADATA_TYPE_*).
META_PICKLE5 = b"PICKLE5"
META_ERROR = b"ERROR"
META_ACTOR_HANDLE = b"ACTOR_HANDLE"
META_RAW = b"RAW"


class _SerializationThreadContext(threading.local):
    def __init__(self):
        self.contained_refs: list | None = None
        self.outer_object_id = None


_ctx = _SerializationThreadContext()

# Registered by object_ref.py to avoid a circular import: maps ObjectRef
# instances through pickling while recording containment.
_object_ref_reducer: Callable | None = None
_object_ref_class: type | None = None


def register_object_ref_serializer(ref_class: type, reducer: Callable) -> None:
    global _object_ref_class, _object_ref_reducer
    _object_ref_class = ref_class
    _object_ref_reducer = reducer


def record_contained_ref(ref) -> None:
    if _ctx.contained_refs is not None:
        _ctx.contained_refs.append(ref)


class _Pickler(cloudpickle.Pickler):
    def reducer_override(self, obj):
        if _object_ref_class is not None and type(obj) is _object_ref_class:
            record_contained_ref(obj)
            return _object_ref_reducer(obj)
        # Delegate to cloudpickle's own reducer_override — it is how
        # closures/lambdas/local classes get pickled by value; returning
        # NotImplemented here would silently fall back to stock pickle's
        # by-reference handling, which breaks on any <locals> object.
        return super().reducer_override(obj)


class Serialized:
    """A serialized value as its raw buffer list — framing deferred.

    The frame (header + aligned buffers) can be written DIRECTLY into a
    destination (``write_into`` — e.g. the shm arena via mmap) without
    ever materializing the concatenated blob: for a 10 MB put that is
    the difference between one copy and three (BytesIO concat, bytearray
    frame, bytes() of it, mmap write)."""

    __slots__ = ("metadata", "buffers", "contained")

    def __init__(self, metadata: bytes, buffers: list, contained: list):
        self.metadata = metadata
        self.buffers = buffers
        self.contained = contained

    @property
    def nbytes(self) -> int:
        if self.metadata == META_RAW:
            return memoryview(self.buffers[0]).nbytes
        return framed_size(self.buffers)

    def to_blob(self) -> bytes:
        if self.metadata == META_RAW:
            return bytes(self.buffers[0])
        return _frame(self.buffers)

    def write_into(self, view: memoryview) -> int:
        if self.metadata == META_RAW:
            mv = memoryview(self.buffers[0]).cast("B")
            view[: mv.nbytes] = mv
            return mv.nbytes
        return frame_into(view, self.buffers)


def serialize_value(value: Any) -> Serialized:
    """Serialize ``value`` keeping its raw buffers separate (pickle5
    out-of-band). Top-level ``bytes`` take the RAW path — no pickle at
    all (the C pickler never consults ``reducer_override`` for bytes, so
    they'd otherwise be copied through the pickle stream)."""
    if type(value) is bytes:
        return Serialized(META_RAW, [value], [])
    _ctx.contained_refs = []
    try:
        buffers: list[pickle.PickleBuffer] = []
        import io

        stream = io.BytesIO()
        pickler = _Pickler(stream, protocol=5, buffer_callback=buffers.append)
        pickler.dump(value)
        payload = stream.getvalue()
        raw_buffers = [payload] + [b.raw() for b in buffers]
        return Serialized(META_PICKLE5, raw_buffers, list(_ctx.contained_refs))
    finally:
        _ctx.contained_refs = None


def serialize(value: Any) -> tuple[bytes, bytes, list]:
    """Serialize ``value`` → (metadata, blob, contained_object_refs)."""
    s = serialize_value(value)
    return s.metadata, s.to_blob(), s.contained


def serialize_error(error) -> tuple[bytes, bytes, list]:
    payload = cloudpickle.dumps(error)
    return META_ERROR, _frame([payload]), []


def deserialize(metadata: bytes, blob: bytes | memoryview) -> Any:
    if metadata == META_RAW:
        return bytes(blob)
    bufs = _unframe(blob)
    if metadata == META_ERROR:
        # Return (not raise) so callers can re-raise with the cause's type
        # (RayTaskError.as_instanceof_cause, reference exceptions.py).
        error = pickle.loads(bufs[0])
        return error if isinstance(error, BaseException) else RuntimeError(str(error))
    if metadata in (META_PICKLE5, META_ACTOR_HANDLE):
        return pickle.loads(bufs[0], buffers=[pickle.PickleBuffer(b) for b in bufs[1:]])
    raise ValueError(f"Unknown object metadata: {metadata!r}")


def _frame_layout(buffers: list) -> tuple[list[tuple[int, int]], int]:
    """(offset, size) per buffer + total framed size."""
    n = len(buffers)
    table_end = _HEADER.size + n * _ENTRY.size
    entries = []
    offset = _pad(table_end)
    for buf in buffers:
        offset = _pad(offset)
        size = memoryview(buf).nbytes
        entries.append((offset, size))
        offset += size
    return entries, offset


def framed_size(buffers: list) -> int:
    return _frame_layout(buffers)[1]


def frame_into(view: memoryview, buffers: list) -> int:
    """Write the frame (header + aligned buffers) into ``view``; returns
    total bytes written. ``view`` must hold ``framed_size(buffers)``."""
    entries, total = _frame_layout(buffers)
    n = len(buffers)
    table_end = _HEADER.size + n * _ENTRY.size
    header = _HEADER.pack(_MAGIC, n) + b"".join(
        _ENTRY.pack(o, s) for o, s in entries)
    view[: len(header)] = header
    pos = len(header)
    for (offset, size), buf in zip(entries, buffers):
        if offset != pos:
            view[pos:offset] = b"\x00" * (offset - pos)
        view[offset : offset + size] = memoryview(buf).cast("B")
        pos = offset + size
    return total


def _frame(buffers: list) -> bytes:
    out = bytearray(framed_size(buffers))
    frame_into(memoryview(out), buffers)
    return bytes(out)


def _unframe(blob: bytes | memoryview) -> list[memoryview]:
    if not _HAS_PEP688 and isinstance(blob, PlasmaBuffer):
        # memoryview(PlasmaBuffer) needs PEP-688 (__buffer__, 3.12+); on
        # older interpreters copy out and release the read pin eagerly.
        blob = blob.copy_and_release()
    mv = memoryview(blob)
    magic, n = _HEADER.unpack_from(mv, 0)
    if magic != _MAGIC:
        raise ValueError("Corrupt object blob (bad magic)")
    bufs = []
    pos = _HEADER.size
    for _ in range(n):
        offset, size = _ENTRY.unpack_from(mv, pos)
        pos += _ENTRY.size
        bufs.append(mv[offset : offset + size])
    return bufs


def _pad(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN
