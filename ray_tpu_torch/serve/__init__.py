"""ray_tpu.serve: model serving.

Reference: ``python/ray/serve/`` (SURVEY.md §2.3/§3.5): controller actor
reconciling a replica FSM with rolling updates, per-process routers with
power-of-two replica choice, long-poll config push, queue-based
autoscaling, and an HTTP ingress proxy.
"""

from .api import (
    delete,
    get_app_handle,
    get_deployment_handle,
    http_address,
    run,
    shutdown,
    start,
    status,
    update_tenancy_config,
)
from .batching import batch
from .config_api import build_app_from_spec, deploy_config, serve_status
from .local_testing_mode import make_local_deployment_handle
from .grpc_proxy import start_grpc
from .deployment import Application, AutoscalingConfig, Deployment, deployment
from .multiplex import get_multiplexed_model_id, multiplexed
from .replica import Request
from .router import (
    DeadlineExceeded,
    DeploymentHandle,
    DeploymentResponse,
    DeploymentStreamingResponse,
    RequestShed,
    get_request_deadline,
)

__all__ = [
    "Application",
    "AutoscalingConfig",
    "DeadlineExceeded",
    "Deployment",
    "DeploymentHandle",
    "DeploymentResponse",
    "DeploymentStreamingResponse",
    "RequestShed",
    "get_request_deadline",
    "Request",
    "batch",
    "build_app_from_spec",
    "deploy_config",
    "serve_status",
    "start_grpc",
    "delete",
    "deployment",
    "get_app_handle",
    "get_deployment_handle",
    "get_multiplexed_model_id",
    "http_address",
    "make_local_deployment_handle",
    "multiplexed",
    "run",
    "shutdown",
    "start",
    "status",
    "update_tenancy_config",
]
