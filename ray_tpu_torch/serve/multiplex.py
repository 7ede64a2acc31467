"""Model multiplexing: many models behind one deployment.

Equivalent of the reference's ``python/ray/serve/multiplex.py:22``
(``@serve.multiplexed`` + ``get_multiplexed_model_id``): a replica hosts
up to ``max_num_models_per_replica`` models, loading on demand and
evicting least-recently-used. The target model id travels with the
request — the ``serve_multiplexed_model_id`` HTTP header, or
``handle.options(multiplexed_model_id=...)`` — and the router prefers
replicas that have served that model recently (cache affinity).
"""

from __future__ import annotations

import functools
import threading
from collections import OrderedDict
from typing import Any, Callable

_request_context = threading.local()

MULTIPLEXED_MODEL_ID_HEADER = "serve_multiplexed_model_id"
# Tenancy spelling of the same routing key (multi-tenant LoRA
# multiplexing): both headers — and an OpenAI-style JSON body ``model``
# field — resolve to ONE model id at the proxy, so a client using either
# lands on the same resident replica.
X_RAYTPU_MODEL_HEADER = "x-raytpu-model"
MULTIPLEXED_KWARG = "_serve_multiplexed_model_id"


def resolve_model_id(headers: dict, body: "dict | None" = None) -> str:
    """Unify the multiplex header spellings into one routing key:
    ``serve_multiplexed_model_id`` wins (backward compat), then
    ``x-raytpu-model``, then the request body's ``model`` field. Header
    lookup is case-insensitive (HTTP semantics)."""
    lowered = {str(k).lower(): v for k, v in (headers or {}).items()}
    mid = lowered.get(MULTIPLEXED_MODEL_ID_HEADER) \
        or lowered.get(X_RAYTPU_MODEL_HEADER)
    if not mid and isinstance(body, dict):
        mid = body.get("model")
    return str(mid) if mid else ""


def set_multiplexed_model_id(model_id: str) -> None:
    """Install the target model id for the current request thread
    (called by the replica before invoking the user callable)."""
    _request_context.model_id = model_id


def get_multiplexed_model_id() -> str:
    """Inside a request: the model id this request targets (reference
    ``serve.get_multiplexed_model_id``)."""
    return getattr(_request_context, "model_id", "")


class _ModelCache:
    """Per-instance LRU of loaded models with single-flight loading."""

    def __init__(self, loader: Callable, instance: Any, max_models: int):
        self._loader = loader
        self._instance = instance
        self._max = max_models
        self._models: OrderedDict[str, Any] = OrderedDict()
        self._loading: dict[str, threading.Event] = {}
        self._lock = threading.Lock()

    def get(self, model_id: str) -> Any:
        while True:
            with self._lock:
                if model_id in self._models:
                    self._models.move_to_end(model_id)
                    return self._models[model_id]
                ev = self._loading.get(model_id)
                if ev is None:
                    self._loading[model_id] = ev = threading.Event()
                    break
            ev.wait()  # another thread is loading the same model
        try:
            model = self._loader(self._instance, model_id) \
                if self._instance is not None else self._loader(model_id)
            import inspect

            if inspect.iscoroutine(model):
                import asyncio

                model = asyncio.run(model)
            evicted = None
            with self._lock:
                self._models[model_id] = model
                if len(self._models) > self._max:
                    _, evicted = self._models.popitem(last=False)
            if evicted is not None:
                # Reference calls __del__/cleanup hooks on evicted models.
                unload = getattr(evicted, "unload", None)
                if callable(unload):
                    try:
                        unload()
                    except Exception:
                        pass
            return model
        finally:
            with self._lock:
                self._loading.pop(model_id, None)
            ev.set()

    def loaded_ids(self) -> list[str]:
        with self._lock:
            return list(self._models)


# Deployment classes are cloudpickled to replicas: keep decorator closures
# lock-free (see batching.py) — caches live on instances / in this module.
_CREATE_LOCK = threading.Lock()
_FUNC_CACHES: dict[str, _ModelCache] = {}


def _cache_for(fn: Callable, instance: Any, max_models: int) -> _ModelCache:
    if instance is not None:
        attr = f"_serve_model_cache_{fn.__name__}"
        c = getattr(instance, attr, None)
        if c is None:
            with _CREATE_LOCK:
                c = getattr(instance, attr, None)
                if c is None:
                    c = _ModelCache(fn, instance, max_models)
                    setattr(instance, attr, c)
        return c
    key = f"{fn.__module__}.{fn.__qualname__}"
    with _CREATE_LOCK:
        c = _FUNC_CACHES.get(key)
        if c is None:
            c = _FUNC_CACHES[key] = _ModelCache(fn, None, max_models)
        return c


def multiplexed(_func: Callable | None = None, *,
                max_num_models_per_replica: int = 3):
    """Decorator for a model-loader method ``def get_model(self, model_id)``
    (reference ``@serve.multiplexed``). Calls return the loaded model,
    loading on first use and LRU-evicting beyond the cap."""

    def wrap(fn: Callable):
        import inspect

        params = list(inspect.signature(fn).parameters)
        is_method = bool(params) and params[0] == "self"

        @functools.wraps(fn)
        def method_wrapper(self, model_id: str | None = None):
            mid = model_id if model_id is not None else get_multiplexed_model_id()
            return _cache_for(fn, self, max_num_models_per_replica).get(mid)

        @functools.wraps(fn)
        def func_wrapper(model_id: str | None = None):
            mid = model_id if model_id is not None else get_multiplexed_model_id()
            return _cache_for(fn, None, max_num_models_per_replica).get(mid)

        wrapper = method_wrapper if is_method else func_wrapper
        wrapper.__wrapped__ = fn
        return wrapper

    if _func is not None:
        return wrap(_func)
    return wrap
