"""Device-mesh construction with named parallelism axes.

Axis vocabulary (every downstream component uses these names):

- ``dp``   — data parallel: replicate params, shard batch. Gradient
  all-reduce.
- ``fsdp`` — fully-sharded data parallel (ZeRO-3): shard params *and*
  batch; all-gather params per layer, reduce-scatter grads.
- ``tp``   — tensor parallel (Megatron-style): shard attention heads and
  MLP hidden dim; all-reduce activations at block boundaries.
- ``sp``   — sequence/context parallel: shard the sequence axis; ring
  attention moves KV blocks around the ring.
- ``pp``   — pipeline parallel: shard layers into stages.
- ``ep``   — expert parallel: shard MoE experts.
- ``dcn``  — multi-host data parallel: the outermost axis spans hosts;
  only per-step gradient all-reduces cross it.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the process group, one card (or one CPU process under gloo) a rank,
with one named dimension per axis in ``AXIS_ORDER``.
"""

from __future__ import annotations

import dataclasses
import math
import socket
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXIS_ORDER = ("dcn", "pp", "dp", "fsdp", "sp", "ep", "tp")
# tp innermost: tensor-parallel collectives are per-layer and latency-bound,
# so they take adjacent ranks (the same host, NVLink); dcn/pp/dp outermost,
# their collectives are per-step and bandwidth-tolerant.


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes for each parallelism axis. -1 on at most one axis means
    "absorb all remaining devices"."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1
    dcn: int = 1

    def sizes(self) -> dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    def resolve(self, n_devices: int) -> "MeshConfig":
        """Fill in a single -1 axis so the product equals ``n_devices``."""
        sizes = self.sizes()
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one axis may be -1, got {wild}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}"
                )
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {fixed} devices but {n_devices} available"
            )
        return MeshConfig(**sizes)


def mesh_shape_for(n_devices: int, config: MeshConfig | None = None) -> MeshConfig:
    """Resolve a config against a device count; default is pure data parallel."""
    config = config or MeshConfig(dp=-1)
    return config.resolve(n_devices)


def _device_type(device) -> str:
    """``None`` means the card; asking for CUDA where there is none raises."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' for a "
                           "gloo mesh of CPU processes")
    return kind


def create_mesh(config: MeshConfig | None = None, *,
                ranks: Sequence[int] | None = None, device=None) -> DeviceMesh:
    """A ``DeviceMesh`` over every rank of the process group (or the given
    ``ranks``, in that order), shaped by ``config`` in ``AXIS_ORDER``.
    Every rank of the group calls it. ``device`` ``None`` is the card (one
    a rank); ``"cpu"`` builds it for gloo processes.

    Ranks are laid out in order, tp innermost: ``initialize_process``
    numbers a host's ranks consecutively, so tp-adjacent ranks share a
    host, and a ``dcn`` axis equal to the host count spans hosts."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "parallel.distributed.initialize_process first")
    kind = _device_type(device)
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    sizes = mesh_shape_for(len(ranks), config).sizes()
    shape = tuple(sizes[a] for a in AXIS_ORDER)
    return DeviceMesh(kind, torch.tensor(ranks, dtype=torch.int).reshape(shape),
                      mesh_dim_names=AXIS_ORDER)


def local_mesh(config: MeshConfig | None = None, *, device=None) -> DeviceMesh:
    """Mesh over this host's ranks only (the ranks whose processes share
    this host name, consecutive as ``initialize_process`` numbers them).
    Every rank of the group calls it; each host gets its own mesh."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "parallel.distributed.initialize_process first")
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    mine = [r for r, h in enumerate(hosts) if h == hosts[dist.get_rank()]]
    if len(mine) == len(hosts):
        return create_mesh(config, device=device)
    # every rank builds every host's mesh, in host order, so the groups'
    # creation is collective; each keeps its own host's
    meshes = {}
    for host in dict.fromkeys(hosts):
        ranks = [r for r, h in enumerate(hosts) if h == host]
        meshes[host] = create_mesh(config, ranks=ranks, device=device)
    return meshes[hosts[dist.get_rank()]]
