"""@serve.batch: transparent request batching inside a replica.

Equivalent of the reference's ``python/ray/serve/batching.py:80``
(``@serve.batch``): individual calls to the decorated method queue up;
the underlying function runs ONCE per batch with a list of inputs and
must return a list of outputs of the same length. A batch fires when
``max_batch_size`` items are waiting or ``batch_wait_timeout_s`` has
elapsed since the first item arrived.

Replica methods execute on worker threads here (not an asyncio loop), so
the batcher is thread-based: callers block on a per-item event while a
lazily-started batcher thread drains the queue. Exceptions from the
batch function propagate to every caller in that batch.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Any, Callable


class _Item:
    __slots__ = ("args", "kwargs", "result", "error", "done", "trace_ctx")

    def __init__(self, args, kwargs):
        self.args = args
        self.kwargs = kwargs
        self.result = None
        self.error: BaseException | None = None
        self.done = threading.Event()
        # Captured at submit: the batcher thread has no caller context, so
        # the batch span parents onto the first traced item of the batch.
        from ..observability import tracing

        self.trace_ctx = tracing.current()


class _Batcher:
    def __init__(self, fn: Callable, instance: Any, max_batch_size: int,
                 batch_wait_timeout_s: float):
        self._fn = fn
        self._instance = instance
        self.max_batch_size = max_batch_size
        self.batch_wait_timeout_s = batch_wait_timeout_s
        self._queue: list[_Item] = []
        self._cond = threading.Condition()
        self._thread: threading.Thread | None = None
        self.num_batches = 0  # observability / tests

    def submit(self, args, kwargs) -> Any:
        item = _Item(args, kwargs)
        with self._cond:
            self._queue.append(item)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._loop, daemon=True)
                self._thread.start()
            self._cond.notify_all()
        item.done.wait()
        if item.error is not None:
            raise item.error
        return item.result

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue:
                    # Idle exit after a grace period: replicas churn, and a
                    # parked thread per batched method would accumulate.
                    if not self._cond.wait(timeout=10.0):
                        if not self._queue:
                            self._thread = None
                            return
                deadline = time.monotonic() + self.batch_wait_timeout_s
                while (len(self._queue) < self.max_batch_size
                       and time.monotonic() < deadline):
                    self._cond.wait(timeout=max(0.0, deadline - time.monotonic()))
                batch, self._queue = (self._queue[:self.max_batch_size],
                                      self._queue[self.max_batch_size:])
            self._run_batch(batch)

    def _run_batch(self, batch: list[_Item]) -> None:
        from ..observability import tracing

        self.num_batches += 1
        inputs = [it.args[0] if it.args else None for it in batch]
        ctx = next((it.trace_ctx for it in batch if it.trace_ctx is not None), None)
        t0 = time.time()
        prev = tracing.set_current(ctx) if ctx is not None else None
        try:
            if self._instance is not None:
                outputs = self._fn(self._instance, inputs)
            else:
                outputs = self._fn(inputs)
            import inspect

            if inspect.iscoroutine(outputs):
                import asyncio

                outputs = asyncio.run(outputs)
            if len(outputs) != len(batch):
                raise ValueError(
                    f"@serve.batch function returned {len(outputs)} results "
                    f"for a batch of {len(batch)}")
            for it, out in zip(batch, outputs):
                it.result = out
                it.done.set()
        except BaseException as e:
            for it in batch:
                it.error = e
                it.done.set()
        finally:
            if ctx is not None:
                tracing.record_span(tracing.make_span(
                    f"serve.batch {getattr(self._fn, '__name__', 'fn')}",
                    "serve", t0, time.time(), ctx.trace_id, ctx.span_id,
                    attrs={"batch_size": len(batch)}))
                tracing.set_current(prev)


# Deployment classes are cloudpickled to replicas, so decorator closures
# must stay lock-free: per-instance batchers live ON the instance (created
# under this importable module-level lock, which pickles by reference),
# and free-function batchers in a module-level registry.
_CREATE_LOCK = threading.Lock()
_FUNC_BATCHERS: dict[str, _Batcher] = {}


def _batcher_for(fn: Callable, instance: Any, max_batch_size: int,
                 batch_wait_timeout_s: float) -> _Batcher:
    if instance is not None:
        attr = f"_serve_batcher_{fn.__name__}"
        b = getattr(instance, attr, None)
        if b is None:
            with _CREATE_LOCK:
                b = getattr(instance, attr, None)
                if b is None:
                    b = _Batcher(fn, instance, max_batch_size, batch_wait_timeout_s)
                    setattr(instance, attr, b)
        return b
    key = f"{fn.__module__}.{fn.__qualname__}"
    with _CREATE_LOCK:
        b = _FUNC_BATCHERS.get(key)
        if b is None:
            b = _FUNC_BATCHERS[key] = _Batcher(
                fn, None, max_batch_size, batch_wait_timeout_s)
        return b


def batch(_func: Callable | None = None, *, max_batch_size: int = 10,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: the wrapped function must accept a LIST of requests and
    return a LIST of results (reference ``serve.batch``). Works on both
    replica methods and free functions; each bound instance gets its own
    batcher (one engine per replica)."""

    def wrap(fn: Callable):
        import inspect

        params = list(inspect.signature(fn).parameters)
        is_method = bool(params) and params[0] == "self"

        @functools.wraps(fn)
        def method_wrapper(self, single, **kwargs):
            return _batcher_for(fn, self, max_batch_size,
                                batch_wait_timeout_s).submit((single,), kwargs)

        @functools.wraps(fn)
        def func_wrapper(single, **kwargs):
            return _batcher_for(fn, None, max_batch_size,
                                batch_wait_timeout_s).submit((single,), kwargs)

        wrapper = method_wrapper if is_method else func_wrapper
        wrapper.__wrapped__ = fn
        return wrapper

    if _func is not None:
        return wrap(_func)
    return wrap
