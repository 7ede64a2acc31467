"""Trainers: the user-facing fit() entry points.

Reference: ``python/ray/train/v2/api/data_parallel_trainer.py:89``
(DataParallelTrainer.fit → TrainController) and
``v2/torch/torch_trainer.py:17``. ``TorchTrainer`` is the counterpart of
the JAX package's ``JaxTrainer``: the train_fn runs in each worker
process, on the card its ``GPU`` lease gives it.
"""

from __future__ import annotations

from .checkpoint import Checkpoint
from .config import Result, RunConfig, ScalingConfig
from .controller import TrainController


class DataParallelTrainer:
    """Generic function trainer: N workers run ``train_loop_per_worker``.

    ``train_loop_per_worker`` is either the classic closure (eager,
    ``train.report()``-driven — the default path) or a
    :class:`~ray_tpu_torch.train.TrainLoopConfig` structured step spec:
    data-loader → train-step → checkpoint-snapshot stage actors, driven
    eagerly (one dispatch chain per step). The compiled loop
    (``use_compiled_loop=True``) is not ported yet and raises.

    ``use_compiled_loop``: ``None`` (default) defers to
    ``TrainLoopConfig.use_compiled_loop``; ignored for closure specs.
    """

    def __init__(
        self,
        train_loop_per_worker,
        *,
        train_loop_config: dict | None = None,
        scaling_config: ScalingConfig | None = None,
        run_config: RunConfig | None = None,
        resume_from_checkpoint: Checkpoint | None = None,
        datasets: dict | None = None,
        scaling_policy=None,
        use_compiled_loop: bool | None = None,
    ):
        self._train_fn = train_loop_per_worker
        self._train_loop_config = train_loop_config
        self._scaling_config = scaling_config or ScalingConfig()
        self._run_config = run_config or RunConfig()
        self._resume = resume_from_checkpoint
        self._datasets = datasets or {}
        self._scaling_policy = scaling_policy
        self._use_compiled_loop = use_compiled_loop

    def fit(self) -> Result:
        controller = TrainController(
            self._train_fn,
            train_loop_config=self._train_loop_config,
            scaling_config=self._scaling_config,
            run_config=self._run_config,
            resume_from_checkpoint=self._resume,
            datasets=self._datasets,
            scaling_policy=self._scaling_policy,
            use_compiled_loop=self._use_compiled_loop,
        )
        return controller.run()


class TorchTrainer(DataParallelTrainer):
    """The PyTorch trainer (the JAX package's ``JaxTrainer``).

    Each worker is one process holding one ``GPU`` lease
    (``ScalingConfig(use_gpu=True)``, the default); model and optimizer
    live in the train_fn, on ``"cuda"``. Workers share no
    ``torch.distributed`` group yet (ROADMAP queue A item 7).

    Resilience: with ``CheckpointConfig(async_save=True,
    every_n_steps=N)`` the train_fn passes its state tree to
    ``train.report(metrics, state=...)`` — rank 0 snapshots it to host
    memory and commits it atomically from a background thread, and
    registers each version with the GCS, so a restarted group resumes
    from the latest committed step (``ray_tpu_torch/resilience/``).
    """
