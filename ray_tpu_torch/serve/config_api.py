"""Declarative Serve config: YAML/dict app specs + REST deployment.

Equivalent of the reference's ``python/ray/serve/schema.py``
(ServeDeploySchema) + ``serve run config.yaml`` + the dashboard's
``/api/serve/applications`` REST endpoints: applications are described
as data — import path, args, per-deployment overrides — and deployed
without touching Python.

Schema::

    applications:
      - name: my_app
        route_prefix: /my
        import_path: my_module:app_builder   # Application OR callable
        args: {preset: debug-128}            # kwargs for a builder
        deployments:                         # per-deployment overrides
          - name: LLMDeployment
            num_replicas: 2
            max_ongoing_requests: 16
"""

from __future__ import annotations

import importlib
from typing import Any

from .deployment import Application


def _resolve_import(import_path: str):
    module_name, _, attr = import_path.partition(":")
    module = importlib.import_module(module_name)
    target = module
    for part in attr.split(".") if attr else []:
        target = getattr(target, part)
    return target


def build_app_from_spec(spec: dict) -> Application:
    """Build one application from a config entry (reference
    ``serve/_private/api.py`` build_app)."""
    target = _resolve_import(spec["import_path"])
    if isinstance(target, Application):
        if spec.get("args"):
            raise ValueError(
                f"{spec['import_path']} is a bound Application; `args` only "
                "apply to builder functions")
        app = target
    elif callable(target):
        app = target(**(spec.get("args") or {}))
    else:
        raise TypeError(f"{spec['import_path']} is not an Application or builder")
    if not isinstance(app, Application):
        raise TypeError(f"{spec['import_path']} did not produce an Application")
    # App-level runtime_env (reference schema: ships the import_path's
    # code to replicas via py_modules/working_dir/pip).
    app_renv = spec.get("runtime_env")
    # Per-deployment overrides (num_replicas etc).
    overrides = {d["name"]: d for d in (spec.get("deployments") or [])}
    for node in app.walk():
        if app_renv:
            opts = dict(node.deployment.ray_actor_options or {})
            opts.setdefault("runtime_env", app_renv)
            node.deployment.ray_actor_options = opts
        o = overrides.get(node.deployment.name)
        if not o:
            continue
        for key in ("num_replicas", "max_ongoing_requests", "user_config"):
            if key in o:
                setattr(node.deployment, key if key != "num_replicas" else "num_replicas",
                        o[key])
        if "autoscaling_config" in o:
            from .deployment import AutoscalingConfig

            node.deployment.autoscaling_config = AutoscalingConfig(**o["autoscaling_config"])
        if "ray_actor_options" in o:
            node.deployment.ray_actor_options = o["ray_actor_options"]
    return app


def deploy_config(config: dict | str, *, _blocking: bool = True) -> dict:
    """Deploy every application in a config dict, YAML string, or YAML
    file path (reference ``serve deploy`` / ServeDeploySchema)."""
    from . import api as serve_api

    config = _load(config)
    deployed = {}
    for spec in config.get("applications", []):
        app = build_app_from_spec(spec)
        name = spec.get("name", "default")
        serve_api.run(app, name=name,
                      route_prefix=spec.get("route_prefix", f"/{name}"),
                      _blocking=_blocking)
        deployed[name] = spec.get("route_prefix", f"/{name}")
    return deployed


def _load(config: dict | str) -> dict:
    if isinstance(config, dict):
        return config
    import os

    import yaml

    if os.path.exists(config):
        with open(config) as f:
            return yaml.safe_load(f)
    return yaml.safe_load(config)


def serve_status() -> dict:
    """Application/deployment status for the REST surface (reference
    ``serve status`` / GET /api/serve/applications/)."""
    from ..core import api as ray
    from .router import CONTROLLER_NAME

    try:
        controller = ray.get_actor(CONTROLLER_NAME)
    except ValueError:
        return {"applications": {}}
    deps = ray.get(controller.list_deployments.remote(), timeout=30)
    out: dict[str, Any] = {}
    for app, dep_map in deps.items():
        statuses = ray.get(controller.get_app_status.remote(app), timeout=30)
        live = {k: v for k, v in statuses.items() if not v.get("deleted")}
        out[app] = {
            "status": "RUNNING" if live and all(v["healthy"] for v in live.values())
            else ("DELETED" if not live else "DEPLOYING"),
            "deployments": {
                k: {"healthy": v["healthy"], "replicas": v.get("replicas", 0)}
                for k, v in live.items()
            },
        }
    return {"applications": out}
