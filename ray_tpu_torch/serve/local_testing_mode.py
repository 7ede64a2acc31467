"""In-process Serve deployments for unit tests — no cluster boot.

Reference: ``python/ray/serve/_private/local_testing_mode.py:49``
(``make_local_deployment_handle``). Deployments are instantiated in THIS
process and driven through the real ``Replica`` request path
(``replica.py`` — method resolution, multiplex kwarg, reconfigure,
streaming), so a handler unit-tested here behaves identically on a real
replica actor; what's skipped is the cluster: controller, proxy, router,
and actor scheduling. A serve test that needs none of those drops from
tens of seconds (cluster boot) to milliseconds.

Use either directly::

    handle = make_local_deployment_handle(MyDeployment.bind(arg))
    assert handle.remote(1).result() == 2

or through the public API::

    handle = serve.run(app, _local_testing_mode=True)
"""

from __future__ import annotations

import concurrent.futures
from typing import Any

from .._vendor import cloudpickle

from .deployment import Application

# Shared pool: nested handle calls from inside a handler must not
# deadlock on the caller's own worker thread.
_POOL = concurrent.futures.ThreadPoolExecutor(max_workers=32,
                                              thread_name_prefix="serve-local")


class LocalDeploymentResponse:
    """Future-backed stand-in for ``DeploymentResponse``."""

    def __init__(self, fut: concurrent.futures.Future):
        self._fut = fut

    def result(self, timeout: float | None = 60.0):
        return self._fut.result(timeout)


class LocalStreamingResponse:
    """Iterates the handler's generator — ``DeploymentStreamingResponse``
    stand-in (items arrive as produced; here the handler runs lazily on
    the consumer's thread, which is fine for tests)."""

    def __init__(self, gen):
        self._gen = gen

    def __iter__(self):
        return iter(self._gen)


class LocalDeploymentHandle:
    """Mirrors the ``DeploymentHandle`` call surface against an
    in-process ``Replica``."""

    def __init__(self, replica, deployment_name: str, method_name: str = "",
                 multiplexed_model_id: str = ""):
        self._replica = replica
        self.deployment_name = deployment_name
        self._method_name = method_name
        self._multiplexed_model_id = multiplexed_model_id

    def __getattr__(self, name: str) -> "LocalDeploymentHandle":
        if name.startswith("_"):
            raise AttributeError(name)
        return LocalDeploymentHandle(self._replica, self.deployment_name,
                                     name, self._multiplexed_model_id)

    def options(self, *, method_name: str | None = None,
                multiplexed_model_id: str = "") -> "LocalDeploymentHandle":
        return LocalDeploymentHandle(
            self._replica, self.deployment_name,
            method_name if method_name is not None else self._method_name,
            multiplexed_model_id or self._multiplexed_model_id)

    def _kwargs(self, kwargs: dict) -> dict:
        if self._multiplexed_model_id:
            from .multiplex import MULTIPLEXED_KWARG

            kwargs = dict(kwargs)
            kwargs[MULTIPLEXED_KWARG] = self._multiplexed_model_id
        return kwargs

    def remote(self, *args, **kwargs) -> LocalDeploymentResponse:
        fut = _POOL.submit(self._replica.handle_request, self._method_name,
                           args, self._kwargs(kwargs))
        return LocalDeploymentResponse(fut)

    def remote_streaming(self, *args, **kwargs) -> LocalStreamingResponse:
        return LocalStreamingResponse(self._replica.handle_request_streaming(
            self._method_name, args, self._kwargs(kwargs)))


def make_local_deployment_handle(app: Application,
                                 app_name: str = "local") -> LocalDeploymentHandle:
    """Instantiate the application graph in-process and return a handle
    to its ingress. Shared nodes (diamond graphs) are instantiated once;
    nested ``Application`` init args become local handles."""
    from .api import _deployment_config
    from .replica import ReplicaActor as Replica
    from .router import HANDLE_MARKER

    nodes = app.walk()
    configs = {n.deployment.name: _deployment_config(n, app_name) for n in nodes}
    replicas: dict[str, Replica] = {}

    def build(name: str) -> Replica:
        if name in replicas:
            return replicas[name]
        cfg = configs[name]

        def decode(a):
            if isinstance(a, dict) and a.get("t") == HANDLE_MARKER:
                dep = a["deployment"]
                return LocalDeploymentHandle(build(dep), dep)
            return a

        init_args = tuple(decode(a) for a in cfg["init_args"])
        init_kwargs = {k: decode(v) for k, v in cfg["init_kwargs"].items()}
        replicas[name] = Replica(cfg["serialized_callable"], init_args,
                                 init_kwargs, cfg.get("user_config"))
        return replicas[name]

    ingress = app.deployment.name
    return LocalDeploymentHandle(build(ingress), ingress)
