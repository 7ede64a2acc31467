"""ray_tpu_torch: ray_tpu on PyTorch and CUDA (Hopper).

A second package beside ``ray_tpu``. It keeps the JAX package's module
layout, names, parameter tree and page-pool layouts, and replaces its
Pallas TPU kernels with CUDA kernels written for sm_90a (``csrc/``): the
paged decode kernel (serving; bf16 splits each slot's page walk over
several blocks, float32 walks it in one) and the flash-attention
forward, dQ and dK/dV kernels (training; bf16 runs all three on wgmma
fed by TMA, float32 on exact FMAs). Each family picks its kernel by dtype
alone (``ops.paged_attention.paged_route``, ``ops.attention.flash_route``).
It imports neither JAX nor ``ray_tpu``.

The runtime is the JAX package's own, copied: tasks, actors, the
shared-memory object store and ``GPU`` leases (``init``, ``remote``,
``get``, ...), Serve (``ray_tpu_torch.serve``), which runs the LLM
app (``ray_tpu_torch.llm.build_llm_app``), and the Train and Data
libraries (``ray_tpu_torch.train.TorchTrainer`` over
``ray_tpu_torch.data`` shards, with async checkpoints from
``ray_tpu_torch.resilience``), Tune (``ray_tpu_torch.tune.Tuner``, whose
trials reach the card through a ``TorchTrainer.fit``), durable workflows
(``ray_tpu_torch.workflow``), job submission (``ray_tpu_torch.job``),
actor pools, queues and ``multiprocessing.Pool`` (``ray_tpu_torch.util``)
and the multi-node test harness (``ray_tpu_torch.cluster_utils``). A port
cluster keeps its own session dir, environment names, results, workflow
and job directories, so it never meets a ``ray_tpu`` one.

Entry points: ``ray_tpu_torch.llm.InferenceEngine``, ``LLMDeployment``,
``build_llm_app``, ``init_pages``, ``params_from_numpy`` and
``pages_from_numpy``, on the CUDA card by default (``device="cpu"`` for
the CPU; raising where there is no card); ``ray_tpu_torch.models.loss_fn``
over ``init_params`` (or params carried from numpy), differentiated with
``torch.autograd``, on whatever device the params lie. The subpackages
load on first use, so a worker that runs no tensor code never imports
torch.
"""

from .core.api import (
    ActorClass,
    ActorHandle,
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    get_runtime_context,
    init,
    is_initialized,
    kill,
    method,
    nodes,
    put,
    remote,
    shutdown,
    timeline,
    wait,
)
from .core.object_ref import ObjectRef
from .core.generator import ObjectRefGenerator
from .core import status as exceptions
from .core.status import (
    ActorDiedError,
    GetTimeoutError,
    ObjectLostError,
    RayTaskError,
    RayTpuError,
    TaskCancelledError,
    WorkerCrashedError,
)

__version__ = "0.1.0"

_LAZY = ("chaos", "data", "llm", "models", "observability", "ops",
         "resilience", "serve", "train")


def __getattr__(name):
    # Subpackages load on first use: `ray_tpu_torch.llm.InferenceEngine`
    # and `ray_tpu_torch.chaos.run_plan(...)` work right after
    # `import ray_tpu_torch`, and a worker process that never touches them
    # never pays for torch.
    if name in _LAZY:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ActorClass", "ActorDiedError", "ActorHandle", "GetTimeoutError",
    "ObjectLostError", "ObjectRef", "ObjectRefGenerator", "RayTaskError",
    "RayTpuError", "TaskCancelledError", "WorkerCrashedError",
    "available_resources", "cancel", "cluster_resources", "exceptions",
    "get", "get_actor", "get_runtime_context", "init", "is_initialized",
    "kill", "method", "nodes", "put", "remote", "shutdown", "timeline",
    "wait", *_LAZY,
]
