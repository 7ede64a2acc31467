"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` exposes plain C entry points. It is
compiled on first use by ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``build/`` (listed in ``.gitignore``), keyed on a hash of
the source, the shared headers and the flags so an unchanged source is
never rebuilt, and loaded with ``ctypes``. Several ``CudaKernel``s may
name one source (one library, one entry point and one launch count
each). Nothing here runs at import time: the CPU-only test
environment has no ``nvcc`` and imports every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


class CudaKernel:
    """One ``csrc/<source>`` library and the C function it exports.

    ``launches`` counts the kernel's launches: the wrapper adds one where
    it launches the kernel and nowhere else, so a run can show that a path
    went through it. ``build_seconds`` and ``build_log`` (nvcc's
    ``-Xptxas -v`` report: registers, shared memory, spills) are set by the
    build that ran in this process, if one did.
    """

    def __init__(self, source: str, function: str, argtypes: list,
                 restype=ctypes.c_int):
        self.source = SRC_DIR / source
        self.function = function
        self.argtypes = argtypes
        self.restype = restype
        self.launches = 0
        self.build_seconds: float | None = None
        self.build_log = ""
        self._lib = None
        self._fn = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes())
        # Shared headers (csrc/*.cuh) are part of every source's build.
        for header in sorted(SRC_DIR.glob("*.cuh")):
            digest.update(header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}-{digest.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the source unless a library for this exact source and
        flag set is already there. Returns the library's path."""
        out = self.library_path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Compile to a private name, then rename: a concurrent process
        # never loads a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {self.source.name}:\n{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stderr
        return out

    def fn(self):
        """The loaded C function, building the library on first call."""
        with self._lock:
            if self._fn is None:
                self._lib = ctypes.CDLL(str(self.build()))
                fn = getattr(self._lib, self.function)
                fn.argtypes = self.argtypes
                fn.restype = self.restype
                self._fn = fn
            return self._fn
