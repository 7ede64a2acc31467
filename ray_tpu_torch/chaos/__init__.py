"""Deterministic chaos: the cluster clock and seeded fault plans.

* ``clock`` holds the process-wide clock (wall time, or a ``VirtualClock``
  under the ``chaos_clock`` config entry) that the raylet, GCS, workers
  and Serve controller read for their timeouts and backoffs.
* ``plan`` compiles a :class:`FaultPlan` into a byte-identical
  :class:`FaultSchedule` for a seed; :class:`PlanChaos` is the engine
  that the RPC layer, raylet, store and compiled-loop stages consult.
* ``runner``'s :func:`install` / :func:`uninstall` make a plan this
  process's chaos engine and register it with the GCS;
  :func:`active_plan` reads the registration back.

The JAX package's ``run_plan``, ``default_workload`` and recovery
verifier are not ported yet (ROADMAP queue A item 4).
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
from .runner import active_plan, install, uninstall

__all__ = [
    "BUILTIN_PLANS",
    "Clock",
    "FaultPlan",
    "FaultPlanError",
    "FaultSchedule",
    "PlanChaos",
    "VirtualClock",
    "WallClock",
    "active_plan",
    "get_clock",
    "install",
    "load_plan",
    "set_clock",
    "uninstall",
]
