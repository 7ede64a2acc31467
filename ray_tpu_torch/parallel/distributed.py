"""Multi-process (multi-host) ``torch.distributed`` bootstrap helpers.

A controller creates one actor per process, rank 0 picks a coordinator
endpoint, and every process calls :func:`initialize_process` — the
reference's ``_setup_torch_process_group``
(``python/ray/train/torch/config.py:66``). Shared by Train worker groups
and multi-host LLM engine shards.
"""

from __future__ import annotations


def pick_coordinator_address() -> str:
    """Pick a routable ``host:port`` for the process group's rendezvous
    (rank 0 binds and serves it). A UDP "connect" selects the outbound
    interface without sending traffic — ``gethostbyname(gethostname())``
    resolves to loopback on common /etc/hosts setups, which would break
    every cross-host join."""
    import socket

    try:
        probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        probe.connect(("8.8.8.8", 80))
        host = probe.getsockname()[0]
        probe.close()
    except OSError:
        host = socket.gethostbyname(socket.gethostname())
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return f"{host}:{port}"


# How long a rank waits for the others at the rendezvous and in a collective.
TIMEOUT_S = 300.0


def initialize_process(coordinator: str, num_processes: int, process_id: int,
                       *, device=None) -> int:
    """``torch.distributed.init_process_group`` for one process of the
    group, rendezvous at ``coordinator`` (``host:port``, served by rank
    0); returns the world's device count (one card a process). ``device``
    ``None`` is the card (NCCL; raises where there is none); ``"cpu"``
    takes gloo."""
    import datetime

    import torch
    import torch.distributed as dist

    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' for gloo")
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if kind == "cuda" else "gloo",
            init_method=f"tcp://{coordinator}", world_size=num_processes,
            rank=process_id, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dist.get_world_size()
