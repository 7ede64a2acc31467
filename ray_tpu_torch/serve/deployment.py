"""Deployment definitions and application graphs.

Reference: ``python/ray/serve/api.py`` (@serve.deployment),
``deployment.py``, ``build_app.py``. A Deployment wraps a user class or
function with replica/autoscaling settings; ``bind()`` produces an
Application node whose init args may contain other bound deployments
(composed into handles at deploy time).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass
class AutoscalingConfig:
    """Replica autoscaling policy.

    ``mode="ongoing_requests"`` (default) is the reference's queue-based
    policy: desired = ceil(total ongoing / target_ongoing_requests).

    ``mode="latency_slo"`` scales directly from the serving latency SLO:
    the controller pulls each replica's local ``serve_ttft_ms`` histogram
    through the probe path, computes the windowed ``slo_quantile`` (p95
    by default) over ``latency_window_s``, and steps the replica count up
    when it breaches ``target_ttft_ms`` (or ``target_queue_wait_ms``
    against the cluster ``serve_queue_wait_ms`` histogram, when set) and
    down when it sits below ``downscale_headroom * target``. Hysteresis:
    a breach/clear must persist ``breach_cycles`` consecutive probe
    rounds AND the up/downscale delays still debounce, so one slow
    request never doubles the fleet."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 2.0
    downscale_delay_s: float = 10.0
    # --- latency_slo mode ---
    mode: str = "ongoing_requests"
    target_ttft_ms: float = 500.0
    target_queue_wait_ms: float | None = None
    latency_window_s: float = 30.0
    slo_quantile: float = 0.95
    downscale_headroom: float = 0.5
    breach_cycles: int = 2
    # --- always-warm fleet (serve/fleet.py) ---
    # Replicas kept STANDBY: started, compile cache warm, weights in
    # host RAM. Promotion to RUNNING is a device_put, not a cold start.
    standby_replicas: int = 0
    # After this many request-idle seconds the deployment demotes every
    # RUNNING replica to standby (first request promotes one back).
    # None/0 disables scale-to-zero.
    scale_to_zero_idle_s: float | None = None
    # [{"start": unix, "end": unix, "min_replicas": N}, ...]: capacity
    # floors for known spikes, applied before any breach is observed.
    scheduled_capacity: list | None = None
    # Predictive upscale (latency_slo mode): project the windowed TTFT
    # quantile ``predictive_horizon_s`` ahead by its rate of change and
    # scale up when the PROJECTION breaches — before the p95 does.
    predictive: bool = False
    predictive_horizon_s: float = 10.0


class Deployment:
    def __init__(
        self,
        func_or_class: Any,
        *,
        name: str | None = None,
        num_replicas: int | None = None,
        max_ongoing_requests: int = 8,
        autoscaling_config: AutoscalingConfig | dict | None = None,
        ray_actor_options: dict | None = None,
        user_config: Any = None,
        pool: str | None = None,
    ):
        self.func_or_class = func_or_class
        self.name = name or getattr(func_or_class, "__name__", "deployment")
        self.num_replicas = num_replicas or 1
        self.max_ongoing_requests = max_ongoing_requests
        if isinstance(autoscaling_config, dict):
            autoscaling_config = AutoscalingConfig(**autoscaling_config)
        self.autoscaling_config = autoscaling_config
        self.ray_actor_options = ray_actor_options or {}
        self.user_config = user_config
        # Pool membership label for disaggregated apps (e.g. "prefill" /
        # "decode"): pure metadata, surfaced in serve.status() so pool
        # topology is observable; routing never reads it.
        self.pool = pool

    def options(self, **kwargs) -> "Deployment":
        merged = dict(
            name=self.name,
            num_replicas=self.num_replicas,
            max_ongoing_requests=self.max_ongoing_requests,
            autoscaling_config=self.autoscaling_config,
            ray_actor_options=self.ray_actor_options,
            user_config=self.user_config,
            pool=self.pool,
        )
        merged.update(kwargs)
        return Deployment(self.func_or_class, **merged)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def __repr__(self):
        return f"Deployment({self.name}, replicas={self.num_replicas})"


class Application:
    """A bound deployment DAG node. Reference: serve's built app graph."""

    def __init__(self, deployment: Deployment, args: tuple, kwargs: dict):
        self.deployment = deployment
        self.init_args = args
        self.init_kwargs = kwargs

    def walk(self) -> list["Application"]:
        """All Application nodes reachable from this one (deps first)."""
        seen: list[Application] = []

        def visit(node: Application):
            for a in list(node.init_args) + list(node.init_kwargs.values()):
                if isinstance(a, Application):
                    visit(a)
            if node not in seen:
                seen.append(node)

        visit(self)
        return seen


def deployment(_func_or_class: Any = None, **kwargs) -> Any:
    """@serve.deployment decorator / factory. Reference: serve/api.py.
    Both forms carry their options: ``@serve.deployment(num_replicas=2)``
    and ``serve.deployment(Cls, num_replicas=2)``."""
    if _func_or_class is not None:
        return Deployment(_func_or_class, **kwargs)

    def wrap(fc):
        return Deployment(fc, **kwargs)

    return wrap
