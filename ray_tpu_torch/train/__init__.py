"""ray_tpu_torch.train: training on CUDA cards through the port's runtime.

Reference: ``python/ray/train/`` v1+v2 (SURVEY.md §2.3, §3.4). The
controller-actor pattern is kept: ``TorchTrainer.fit`` places a worker
group (one ``GPU`` each), feeds each worker its Data shard, collects
``train.report`` metrics and checkpoints, and restarts the group from
the latest checkpoint on failure. ``torch.distributed`` groups are not
ported yet (ROADMAP queue A item 7).
"""

from .checkpoint import Checkpoint, load_pytree, save_pytree
from .config import (
    CheckpointConfig,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)
from .controller import ElasticScalingPolicy, FixedScalingPolicy
from .loop import TrainLoopConfig, TrainLoopRunner
from .session import get_checkpoint, get_context, get_dataset_shard, report
from .trainer import DataParallelTrainer, TorchTrainer

__all__ = [
    "Checkpoint",
    "CheckpointConfig",
    "DataParallelTrainer",
    "ElasticScalingPolicy",
    "FixedScalingPolicy",
    "FailureConfig",
    "TorchTrainer",
    "TrainLoopConfig",
    "TrainLoopRunner",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "get_checkpoint",
    "get_dataset_shard",
    "get_context",
    "report",
    "load_pytree",
    "save_pytree",
]
