"""ray_tpu_torch.tune: hyperparameter search on the port's runtime.

Reference: ``python/ray/tune/`` (SURVEY.md §2.3): Tuner.fit over trial
actors with searchers (grid/random) and schedulers (ASHA, PBT).
``tune.report`` shares the Train session plumbing — a trial is a
one-worker train run. A trial reaches the card the way a Ray user's
does: its trainable starts a ``TorchTrainer.fit``, whose worker leases
the ``GPU``.
"""

from ..train.session import get_checkpoint, get_context, report
from .callback import (
    Callback,
    CSVLoggerCallback,
    JsonLoggerCallback,
    TBXLoggerCallback,
)
from .schedulers import (
    AsyncHyperBandScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    PB2,
    PopulationBasedTraining,
)
from .search import (
    BasicVariantGenerator,
    OptunaSearch,
    Searcher,
    TPESearcher,
    choice,
    grid_search,
    loguniform,
    randint,
    uniform,
)
from .tuner import ResultGrid, TuneConfig, Tuner

ASHAScheduler = AsyncHyperBandScheduler

__all__ = [
    "ASHAScheduler",
    "Callback",
    "CSVLoggerCallback",
    "JsonLoggerCallback",
    "TBXLoggerCallback",
    "AsyncHyperBandScheduler",
    "BasicVariantGenerator",
    "FIFOScheduler",
    "HyperBandScheduler",
    "MedianStoppingRule",
    "PB2",
    "PopulationBasedTraining",
    "OptunaSearch",
    "Searcher",
    "TPESearcher",
    "ResultGrid",
    "TuneConfig",
    "Tuner",
    "choice",
    "get_checkpoint",
    "get_context",
    "grid_search",
    "loguniform",
    "randint",
    "report",
    "uniform",
]
