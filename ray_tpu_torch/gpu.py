"""GPU detection for the raylet's resources.

The counterpart of the JAX package's ``tpu.py``: the node advertises its
host's CUDA cards as a ``GPU`` resource. It counts them with
``nvidia-smi -L`` and never through the CUDA runtime, because the
processes that call it (the driver, the raylet's thread, a zygote) must
not create a CUDA context: the runtime forks workers, and CUDA does not
survive a fork. A worker that holds a ``GPU`` lease runs with
``CUDA_VISIBLE_DEVICES`` unset and sees every card of the host.
"""

from __future__ import annotations

import functools
import os
import shutil
import subprocess


@functools.lru_cache(maxsize=1)
def detect_num_gpus() -> int:
    """Number of CUDA cards this process may use: the host's cards as
    ``nvidia-smi -L`` lists them, cut to ``CUDA_VISIBLE_DEVICES`` where
    that is set (empty means none)."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None and not visible.strip():
        return 0
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return 0
    try:
        out = subprocess.run([exe, "-L"], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return 0
    n = sum(1 for line in out.splitlines() if line.startswith("GPU "))
    if visible is not None:
        n = min(n, len([d for d in visible.split(",") if d.strip()]))
    return n


def detect_gpu_resources() -> dict:
    """``{"GPU": n}`` for a host with n cards, else ``{}``."""
    n = detect_num_gpus()
    return {"GPU": float(n)} if n else {}
