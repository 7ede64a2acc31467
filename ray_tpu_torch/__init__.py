"""ray_tpu_torch: the serving and training paths of ray_tpu on PyTorch and
CUDA (Hopper).

A second package beside ``ray_tpu``. It keeps the JAX package's module
layout, names, parameter tree and page-pool layouts, and replaces its
Pallas TPU kernels on these paths with CUDA kernels written for sm_90a
(``csrc/``): the paged decode kernel (serving) and the flash-attention
forward, dQ and dK/dV kernels (training; bf16 runs the forward and dK/dV
on wgmma fed by TMA, float32 on exact FMAs). It imports neither JAX nor
``ray_tpu``.

Entry points: ``ray_tpu_torch.llm.InferenceEngine``, on the CUDA card by
default (``device="cpu"`` for the CPU); ``ray_tpu_torch.models.loss_fn``
over ``init_params`` (or params carried from numpy), differentiated with
``torch.autograd``, on whatever device the params lie.
"""

from . import llm, models, ops

__all__ = ["llm", "models", "ops"]
