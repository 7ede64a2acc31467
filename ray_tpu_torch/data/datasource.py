"""Datasources: read task factories.

Reference: ``python/ray/data/read_api.py:340`` + ``datasource/``. The
port has the in-memory sources (``range``, ``from_items``); the file
sources and writers are not ported yet (``block.FILE_IO_ITEM``).
"""

from __future__ import annotations

from typing import Callable


def range_tasks(n: int, parallelism: int) -> list[Callable]:
    parallelism = max(1, min(parallelism, n)) if n else 1
    bounds = [round(i * n / parallelism) for i in range(parallelism + 1)]

    def make(lo, hi):
        def read():
            import numpy as np

            return {"id": np.arange(lo, hi, dtype=np.int64)}

        return read

    return [make(bounds[i], bounds[i + 1]) for i in range(parallelism)]


def items_tasks(items: list, parallelism: int) -> list[Callable]:
    from .block import build_block

    parallelism = max(1, min(parallelism, len(items))) if items else 1
    bounds = [round(i * len(items) / parallelism) for i in range(parallelism + 1)]

    def make(chunk):
        return lambda: build_block(chunk)

    return [make(items[bounds[i]:bounds[i + 1]]) for i in range(parallelism)]
