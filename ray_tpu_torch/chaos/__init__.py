"""Deterministic chaos: the cluster clock and seeded fault plans.

* ``clock`` holds the process-wide clock (wall time, or a ``VirtualClock``
  under the ``chaos_clock`` config entry) that the raylet, GCS, workers
  and Serve controller read for their timeouts and backoffs.
* ``plan`` compiles a :class:`FaultPlan` into a byte-identical
  :class:`FaultSchedule` for a seed; :class:`PlanChaos` is the engine
  that the RPC layer, raylet, store and compiled-loop stages consult.
* ``runner``'s :func:`install` / :func:`uninstall` make a plan this
  process's chaos engine and register it with the GCS;
  :func:`active_plan` reads the registration back; :func:`run_plan`
  drives one seeded scenario end to end (baseline, install, a workload,
  by default :func:`default_workload`, uninstall, verify).
* ``verifier``'s :class:`RecoveryVerifier` asserts the cluster heals
  after a fault: all tasks terminal, lease queues drained, refcounts at
  baseline, no orphaned ErrorEvents.
"""

from .clock import Clock, VirtualClock, WallClock, get_clock, set_clock
from .plan import (
    BUILTIN_PLANS,
    FaultPlan,
    FaultPlanError,
    FaultSchedule,
    PlanChaos,
    load_plan,
)
from .runner import active_plan, default_workload, install, run_plan, uninstall
from .verifier import ChaosVerificationError, RecoveryVerifier, VerifyResult

__all__ = [
    "BUILTIN_PLANS",
    "ChaosVerificationError",
    "Clock",
    "FaultPlan",
    "FaultPlanError",
    "FaultSchedule",
    "PlanChaos",
    "RecoveryVerifier",
    "VerifyResult",
    "VirtualClock",
    "WallClock",
    "active_plan",
    "default_workload",
    "get_clock",
    "install",
    "load_plan",
    "run_plan",
    "set_clock",
    "uninstall",
]
