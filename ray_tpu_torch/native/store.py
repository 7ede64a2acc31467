"""ctypes binding for the native shared-memory object store.

The C++ library (``src/shm_store.cc``) is the plasma equivalent
(reference ``src/ray/object_manager/plasma/store.h:55``); this module
auto-builds it with g++ into ``ray_tpu_torch/build/`` on first use (no
pip/pybind11 dependency) and exposes a thread-safe :class:`ShmStore`
owner handle plus a lightweight :class:`ShmClient` that other processes
use for zero-copy reads/writes via ``mmap`` of the same /dev/shm file.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "shm_store.cc")
# Built at first use into the package's build directory (not committed).
_LIB = os.path.join(os.path.dirname(_DIR), "build", "libshm_store.so")

_lib_handle = None
_lib_lock = threading.Lock()


def _build_if_needed() -> str:
    if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
        os.makedirs(os.path.dirname(_LIB), exist_ok=True)
        # Build beside the target and rename into place: several processes
        # (raylets, workers) may build at once, and none may load a
        # half-written library.
        tmp = f"{_LIB}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, _LIB)
    return _LIB


def _load():
    global _lib_handle
    with _lib_lock:
        if _lib_handle is None:
            lib = ctypes.CDLL(_build_if_needed())
            u64, u32, u8p = ctypes.c_uint64, ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint8)
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            lib.store_create.restype = vp
            lib.store_create.argtypes = [ctypes.c_char_p, u64]
            lib.store_destroy.argtypes = [vp]
            lib.store_create_object.restype = i32
            lib.store_create_object.argtypes = [vp, ctypes.c_char_p, u32, u64, u64, ctypes.POINTER(u64)]
            lib.store_seal.restype = i32
            lib.store_seal.argtypes = [vp, ctypes.c_char_p, u32]
            lib.store_get.restype = i32
            lib.store_get.argtypes = [vp, ctypes.c_char_p, u32, ctypes.POINTER(u64), ctypes.POINTER(u64), ctypes.POINTER(u64)]
            for name in ("store_add_ref", "store_release", "store_contains",
                         "store_pin", "store_unpin"):
                fn = getattr(lib, name)
                fn.restype = i32
                fn.argtypes = [vp, ctypes.c_char_p, u32]
            lib.store_ref_count.restype = ctypes.c_int64
            lib.store_ref_count.argtypes = [vp, ctypes.c_char_p, u32]
            lib.store_delete.restype = i32
            lib.store_delete.argtypes = [vp, ctypes.c_char_p, u32, i32]
            lib.store_evict.restype = u64
            lib.store_evict.argtypes = [vp, u64]
            for name in ("store_used", "store_capacity", "store_num_objects"):
                fn = getattr(lib, name)
                fn.restype = u64
                fn.argtypes = [vp]
            _lib_handle = lib
        return _lib_handle


class ShmStoreError(Exception):
    pass


class ObjectExistsError(ShmStoreError):
    pass


class StoreFullError(ShmStoreError):
    pass


class ShmStore:
    """Owner-side handle: allocation, sealing, eviction, refcounts.

    Lives inside the raylet process (single writer); all methods are
    guarded by a lock so RPC handlers may call from multiple tasks.
    """

    def __init__(self, path: str, capacity: int):
        self._lib = _load()
        self.path = path
        self.capacity = capacity
        self._handle = self._lib.store_create(path.encode(), capacity)
        if not self._handle:
            raise ShmStoreError(f"Failed to create store at {path}")
        self._lock = threading.Lock()
        self._mm = ShmClient(path, capacity)

    def create(self, object_id: bytes, data_size: int, meta_size: int = 0) -> int:
        """Allocate space; returns byte offset into the arena."""
        from ..core.rpc import get_chaos

        if get_chaos().maybe_fail_store_create():
            # Chaos injection point (store_full FaultPlan rule): surface
            # as the real allocation failure so callers exercise their
            # spill / fallback-allocation paths.
            raise StoreFullError(
                f"chaos-injected store-full creating {object_id.hex()}")
        offset = ctypes.c_uint64()
        with self._lock:
            rc = self._lib.store_create_object(
                self._handle, object_id, len(object_id), data_size, meta_size, ctypes.byref(offset)
            )
        if rc == -1:
            raise ObjectExistsError(object_id.hex())
        if rc == -2:
            raise StoreFullError(
                f"Object of {data_size + meta_size} bytes doesn't fit "
                f"(capacity {self.capacity}, used {self.used()})"
            )
        return offset.value

    def seal(self, object_id: bytes) -> None:
        with self._lock:
            rc = self._lib.store_seal(self._handle, object_id, len(object_id))
        if rc != 0:
            raise ShmStoreError(f"seal({object_id.hex()}) rc={rc}")

    def get_info(self, object_id: bytes) -> tuple[int, int, int] | None:
        """Return (offset, data_size, meta_size) for a sealed object, else None."""
        off, dsz, msz = ctypes.c_uint64(), ctypes.c_uint64(), ctypes.c_uint64()
        with self._lock:
            rc = self._lib.store_get(
                self._handle, object_id, len(object_id),
                ctypes.byref(off), ctypes.byref(dsz), ctypes.byref(msz),
            )
        if rc != 0:
            return None
        return off.value, dsz.value, msz.value

    def add_ref(self, object_id: bytes) -> None:
        with self._lock:
            self._lib.store_add_ref(self._handle, object_id, len(object_id))

    def release(self, object_id: bytes) -> None:
        with self._lock:
            self._lib.store_release(self._handle, object_id, len(object_id))

    def delete(self, object_id: bytes, force: bool = False) -> bool:
        with self._lock:
            return self._lib.store_delete(self._handle, object_id, len(object_id), int(force)) == 0

    def contains(self, object_id: bytes) -> int:
        """0 = absent, 1 = created/unsealed, 2 = sealed."""
        with self._lock:
            return self._lib.store_contains(self._handle, object_id, len(object_id))

    def pin(self, object_id: bytes) -> None:
        """Exclude a primary copy from LRU eviction (reference
        ``local_object_manager.h:110`` pinned-object semantics)."""
        with self._lock:
            self._lib.store_pin(self._handle, object_id, len(object_id))

    def unpin(self, object_id: bytes) -> None:
        with self._lock:
            self._lib.store_unpin(self._handle, object_id, len(object_id))

    def ref_count(self, object_id: bytes) -> int:
        """-1 if absent."""
        with self._lock:
            return self._lib.store_ref_count(self._handle, object_id, len(object_id))

    def evict(self, nbytes: int) -> int:
        with self._lock:
            return self._lib.store_evict(self._handle, nbytes)

    def used(self) -> int:
        with self._lock:
            return self._lib.store_used(self._handle)

    def num_objects(self) -> int:
        with self._lock:
            return self._lib.store_num_objects(self._handle)

    # -- direct data access (owner process shares the same mmap) ------------
    def write(self, offset: int, data: bytes | memoryview) -> None:
        self._mm.write(offset, data)

    def read(self, offset: int, size: int) -> memoryview:
        return self._mm.read(offset, size)

    def put_sealed(self, object_id: bytes, data: bytes | memoryview, meta: bytes = b"") -> None:
        """Convenience: create + write data+meta + seal, creator ref released."""
        mv = memoryview(data)
        offset = self.create(object_id, mv.nbytes, len(meta))
        self._mm.write(offset, mv)
        if meta:
            self._mm.write(offset + mv.nbytes, meta)
        self.seal(object_id)
        self.release(object_id)

    def close(self) -> None:
        with self._lock:
            if self._handle:
                self._mm.close()
                self._lib.store_destroy(self._handle)
                self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class ShmClient:
    """Zero-copy reader/writer used by worker processes: mmaps the arena file."""

    def __init__(self, path: str, capacity: int):
        self.path = path
        self._fd = os.open(path, os.O_RDWR)
        self._mm = mmap.mmap(self._fd, capacity)
        self._view = memoryview(self._mm)

    def read(self, offset: int, size: int) -> memoryview:
        return self._view[offset : offset + size]

    def write(self, offset: int, data: bytes | memoryview) -> None:
        mv = memoryview(data)
        self._view[offset : offset + mv.nbytes] = mv

    def close(self) -> None:
        try:
            self._view.release()
            self._mm.close()
            os.close(self._fd)
        except Exception:
            pass
