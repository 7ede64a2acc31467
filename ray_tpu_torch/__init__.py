"""ray_tpu_torch: the serving path of ray_tpu on PyTorch and CUDA (Hopper).

A second package beside ``ray_tpu``. It keeps the JAX package's module
layout, names, parameter tree and page-pool layouts, and replaces its
Pallas TPU kernel on this path with a CUDA kernel written for sm_90a
(``csrc/``). It imports neither JAX nor ``ray_tpu``.

Entry point: ``ray_tpu_torch.llm.InferenceEngine``, on the CUDA card by
default (``device="cpu"`` for the CPU).
"""

from . import llm, models, ops

__all__ = ["llm", "models", "ops"]
