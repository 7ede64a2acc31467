"""ray_tpu_torch: the serving and training paths of ray_tpu on PyTorch and
CUDA (Hopper).

A second package beside ``ray_tpu``. It keeps the JAX package's module
layout, names, parameter tree and page-pool layouts, and replaces its
Pallas TPU kernels on these paths with CUDA kernels written for sm_90a
(``csrc/``): the paged decode kernel (serving; bf16 splits each slot's
page walk over several blocks, float32 walks it in one) and the
flash-attention forward, dQ and dK/dV kernels (training; bf16 runs all
three on wgmma fed by TMA, float32 on exact FMAs). Each family picks its
kernel by dtype alone (``ops.paged_attention.paged_route``,
``ops.attention.flash_route``). It imports neither JAX nor ``ray_tpu``.

Entry points: ``ray_tpu_torch.llm.InferenceEngine``, ``init_pages``,
``params_from_numpy`` and ``pages_from_numpy``, on the CUDA card by
default (``device="cpu"`` for the CPU; raising where there is no card);
``ray_tpu_torch.models.loss_fn`` over ``init_params`` (or params carried
from numpy), differentiated with ``torch.autograd``, on whatever device
the params lie.
"""

from . import llm, models, observability, ops

__all__ = ["llm", "models", "observability", "ops"]
