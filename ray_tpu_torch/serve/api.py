"""Public Serve API: serve.run / serve.delete / serve.status / handles.

Reference: ``python/ray/serve/api.py`` (run:571, delete, status) and
``_private/client.py``. The controller is a detached named actor; the
proxy is created on demand with ``serve.start(http_options=...)`` or the
first ``serve.run``.
"""

from __future__ import annotations

import hashlib
import time
from typing import Any

from .._vendor import cloudpickle

from ..core import api as ray
from .deployment import Application, AutoscalingConfig, Deployment
from .router import CONTROLLER_NAME, HANDLE_MARKER, DeploymentHandle

_PROXY_NAME = "SERVE_PROXY"


def _get_or_create_controller():
    try:
        return ray.get_actor(CONTROLLER_NAME)
    except ValueError:
        pass
    from .controller import ServeController

    handle = ray.remote(ServeController).options(
        name=CONTROLLER_NAME, lifetime="detached", num_cpus=0, max_concurrency=64
    ).remote()
    # wait until it serves requests
    ray.get(handle.list_deployments.remote(), timeout=60)
    return handle


def start(http_options: dict | None = None):
    """Ensure the Serve instance (controller + HTTP proxy) is running."""
    controller = _get_or_create_controller()
    try:
        proxy = ray.get_actor(_PROXY_NAME)
    except ValueError:
        from .http_proxy import ProxyActor

        opts = http_options or {}
        proxy = ray.remote(ProxyActor).options(
            name=_PROXY_NAME, lifetime="detached", num_cpus=0, max_concurrency=32
        ).remote(opts.get("host", "127.0.0.1"), opts.get("port", 0))
        ray.get(proxy.ready.remote(), timeout=60)
        ray.get(controller.register_proxy.remote(proxy._actor_id), timeout=30)
    return controller


def http_address() -> str:
    proxy = ray.get_actor(_PROXY_NAME)
    return ray.get(proxy.address.remote(), timeout=30)


def _encode_arg(arg: Any, app_name: str):
    if isinstance(arg, Application):
        return {"t": HANDLE_MARKER, "app": app_name, "deployment": arg.deployment.name}
    return arg


def _deployment_config(app: Application, app_name: str) -> dict:
    d = app.deployment
    serialized = cloudpickle.dumps(d.func_or_class)
    init_args = tuple(_encode_arg(a, app_name) for a in app.init_args)
    init_kwargs = {k: _encode_arg(v, app_name) for k, v in app.init_kwargs.items()}
    auto = d.autoscaling_config
    # user_config is EXCLUDED from the version: config-only changes apply
    # in place via replica.reconfigure, not a rolling restart.
    version_src = serialized + cloudpickle.dumps((init_args, init_kwargs, d.num_replicas, d.max_ongoing_requests))
    return {
        "name": d.name,
        "serialized_callable": serialized,
        "init_args": init_args,
        "init_kwargs": init_kwargs,
        "num_replicas": d.num_replicas,
        "max_ongoing": d.max_ongoing_requests,
        "user_config": getattr(d, "user_config", None),
        "pool": getattr(d, "pool", None),
        "ray_actor_options": d.ray_actor_options,
        "autoscaling": (
            {
                "min_replicas": auto.min_replicas,
                "max_replicas": auto.max_replicas,
                "target_ongoing_requests": auto.target_ongoing_requests,
                "upscale_delay_s": auto.upscale_delay_s,
                "downscale_delay_s": auto.downscale_delay_s,
                "mode": auto.mode,
                "target_ttft_ms": auto.target_ttft_ms,
                "target_queue_wait_ms": auto.target_queue_wait_ms,
                "latency_window_s": auto.latency_window_s,
                "slo_quantile": auto.slo_quantile,
                "downscale_headroom": auto.downscale_headroom,
                "breach_cycles": auto.breach_cycles,
                "standby_replicas": auto.standby_replicas,
                "scale_to_zero_idle_s": auto.scale_to_zero_idle_s,
                "scheduled_capacity": auto.scheduled_capacity,
                "predictive": auto.predictive,
                "predictive_horizon_s": auto.predictive_horizon_s,
            }
            if auto
            else None
        ),
        "version": hashlib.sha1(version_src).hexdigest(),
    }


def run(app: Application, *, name: str = "default", route_prefix: str | None = "/",
        _blocking: bool = True, timeout_s: float = 120.0,
        _local_testing_mode: bool = False) -> DeploymentHandle:
    """Deploy an application and wait for it to be healthy. Reference:
    serve/api.py run().

    ``_local_testing_mode=True`` instantiates the deployments in THIS
    process and returns a local handle — no controller, proxy, or actors
    (reference ``serve/_private/local_testing_mode.py``). For unit
    tests of handler logic."""
    if _local_testing_mode:
        from .local_testing_mode import make_local_deployment_handle

        return make_local_deployment_handle(app, name)
    controller = start()
    nodes = app.walk()
    configs = [_deployment_config(node, name) for node in nodes]
    ingress = app.deployment.name
    ray.get(
        controller.deploy_application.remote(name, route_prefix, configs, ingress),
        timeout=60,
    )
    if _blocking:
        deadline = time.monotonic() + timeout_s
        while True:
            status = ray.get(controller.get_app_status.remote(name), timeout=30)
            live = {k: v for k, v in status.items() if not v["deleted"]}
            if live and all(v["healthy"] for v in live.values()):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"application {name!r} not healthy in {timeout_s}s: {status}")
            time.sleep(0.2)
    return DeploymentHandle(name, ingress)


def get_app_handle(name: str = "default") -> DeploymentHandle:
    controller = ray.get_actor(CONTROLLER_NAME)
    deps = ray.get(controller.list_deployments.remote(), timeout=30)
    if name not in deps:
        raise ValueError(f"no Serve application named {name!r}")
    routes = {r["app"]: r["deployment"] for r in (ray.get(controller.get_snapshot.remote("routes"), timeout=30) or [])}
    ingress = routes.get(name) or next(iter(deps[name]))
    return DeploymentHandle(name, ingress)


def get_deployment_handle(deployment_name: str, app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(app_name, deployment_name)


def status() -> dict:
    controller = ray.get_actor(CONTROLLER_NAME)
    deps = ray.get(controller.list_deployments.remote(), timeout=30)
    out = {
        app: ray.get(controller.get_app_status.remote(app), timeout=30) for app in deps
    }
    # Fold in the HTTP proxy's router-side overload view (front-door
    # sheds by reason, router-queue deadline expiries, circuit states):
    # the replica probes only see requests that reached a replica.
    try:
        proxy = ray.get_actor(_PROXY_NAME)
        stats = ray.get(proxy.overload_stats.remote(), timeout=10)
        for app, dep_stats in (stats or {}).items():
            for dep, snap in dep_stats.items():
                slot = out.get(app, {}).get(dep)
                if slot is not None:
                    slot.setdefault("overload", {})["router"] = snap
    except Exception:
        pass
    return out


def update_tenancy_config(tenancy_config: dict, *, app_name: str = "default",
                          deployment_name: str | None = None) -> dict:
    """Live-reconfigure a deployment's tenant WFQ weights/quotas without
    a redeploy: the controller swaps the stored ``tenancy_config`` and
    re-publishes the folded weights long-poll key, so every router picks
    the change up on its next poll (PR 16 residue c). Returns the
    controller's ``{"updated": [deployment names]}`` summary."""
    controller = ray.get_actor(CONTROLLER_NAME)
    return ray.get(
        controller.update_tenancy_config.remote(
            app_name, deployment_name, tenancy_config),
        timeout=30)


def delete(name: str) -> None:
    controller = ray.get_actor(CONTROLLER_NAME)
    ray.get(controller.delete_application.remote(name), timeout=60)


def shutdown() -> None:
    """Tear down the whole Serve instance (controller, proxy, replicas)."""
    try:
        controller = ray.get_actor(CONTROLLER_NAME)
    except ValueError:
        return
    try:
        ray.get(controller.graceful_shutdown.remote(), timeout=60)
    except Exception:
        pass
    try:
        ray.kill(controller)
    except Exception:
        pass
    try:
        proxy = ray.get_actor(_PROXY_NAME)
        ray.kill(proxy)
    except Exception:
        pass
