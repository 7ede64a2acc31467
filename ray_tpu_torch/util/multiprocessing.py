"""``multiprocessing.Pool``-compatible API over cluster actors.

Equivalent of the reference's ``python/ray/util/multiprocessing/pool.py``:
drop-in ``Pool`` with ``map``/``imap``/``imap_unordered``/``apply`` /
``apply_async`` + ``AsyncResult``, so stdlib-Pool code scales past one
machine without rewriting. Each pool worker is an actor executing
pickled callables.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable

from ..core import api as ray
from .actor_pool import ActorPool


class _PoolWorker:
    def run(self, fn, args, kwargs):
        return fn(*args, **(kwargs or {}))

    def run_batch(self, fn, chunk):
        return [fn(item) for item in chunk]


class AsyncResult:
    def __init__(self, ref):
        self._ref = ref

    def get(self, timeout: float | None = None):
        return ray.get(self._ref, timeout=timeout)

    def wait(self, timeout: float | None = None) -> None:
        ray.wait([self._ref], num_returns=1, timeout=timeout)

    def ready(self) -> bool:
        ready, _ = ray.wait([self._ref], num_returns=1, timeout=0)
        return bool(ready)

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("result is not ready")  # stdlib Pool semantics
        try:
            self.get(timeout=60)
            return True
        except Exception:
            return False


class Pool:
    def __init__(self, processes: int | None = None, *, actor_options: dict | None = None):
        if processes is None:
            total = ray.cluster_resources().get("CPU", 1)
            processes = max(1, int(total))
        opts = {"num_cpus": 1, **(actor_options or {})}
        cls = ray.remote(_PoolWorker)
        self._actors = [cls.options(**opts).remote() for _ in range(processes)]
        self._pool = ActorPool(self._actors)
        self._closed = False
        self._rr = itertools.count()

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True
        for a in self._actors:
            try:
                ray.kill(a)
            except Exception:
                pass

    def join(self) -> None:
        if not self._closed:
            raise ValueError("Pool is still open")

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc) -> None:
        self.terminate()

    def _check(self) -> None:
        if self._closed:
            raise ValueError("Pool not running")

    # ------------------------------------------------------------------ apply
    def apply(self, fn: Callable, args: tuple = (), kwargs: dict | None = None):
        return self.apply_async(fn, args, kwargs).get()

    def apply_async(self, fn: Callable, args: tuple = (), kwargs: dict | None = None) -> AsyncResult:
        self._check()
        # Round-robin over actors (no result ordering needed for applies).
        actor = self._actors[next(self._rr) % len(self._actors)]
        return AsyncResult(actor.run.remote(fn, args, kwargs))

    # -------------------------------------------------------------------- map
    def map(self, fn: Callable, iterable: Iterable, chunksize: int | None = None) -> list:
        return list(self.imap(fn, iterable, chunksize))

    def imap(self, fn: Callable, iterable: Iterable, chunksize: int | None = None):
        self._check()
        for chunk_result in self._pool.map(
            lambda actor, chunk: actor.run_batch.remote(fn, chunk),
            _chunks(iterable, chunksize or 1),
        ):
            yield from chunk_result

    def imap_unordered(self, fn: Callable, iterable: Iterable, chunksize: int | None = None):
        self._check()
        for chunk_result in self._pool.map_unordered(
            lambda actor, chunk: actor.run_batch.remote(fn, chunk),
            _chunks(iterable, chunksize or 1),
        ):
            yield from chunk_result

    def starmap(self, fn: Callable, iterable: Iterable) -> list:
        return self.map(lambda args: fn(*args), iterable)


def _chunks(iterable: Iterable, size: int) -> Iterable[list]:
    it = iter(iterable)
    while True:
        chunk = list(itertools.islice(it, size))
        if not chunk:
            return
        yield chunk
