"""Blocks: the unit of data movement. Numpy column dicts in the object store.

Reference: ``python/ray/data/block.py`` + ``_internal/arrow_block.py``.
A block is a dict of equal-length numpy columns: a tensor column keeps
its per-row shape as the trailing dimensions of its array, and values
numpy cannot hold in a typed array (strings, bytes, Python objects) sit
in an ``object`` column. ``BlockAccessor`` adapts blocks to the numpy
batch format (host staging before the copy to the card). The pandas and
Arrow formats need file I/O's libraries and raise.
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np

Block = dict

# Where the pandas/Arrow batch formats and the file datasources land.
FILE_IO_ITEM = "ROADMAP queue A item 11 (file datasources and writers on numpy)"


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: {FILE_IO_ITEM}")


def _object_column(values: list) -> np.ndarray:
    col = np.empty(len(values), dtype=object)
    col[:] = values
    return col


def _column(values: list) -> np.ndarray:
    """A list of row values -> one column."""
    if values and isinstance(values[0], np.ndarray) and values[0].ndim >= 1:
        return np.stack(values)
    if any(isinstance(v, (str, bytes)) or v is None for v in values):
        # Binary and text stay off fixed-width numpy dtypes: the S dtype
        # silently truncates values at NUL bytes.
        return _object_column(values)
    try:
        col = np.asarray(values)
    except ValueError:  # ragged nested lists
        return _object_column(values)
    return col if col.dtype != object or col.ndim == 1 else _object_column(values)


def build_block(rows: list) -> Block:
    """Build a block from a list of rows (dicts or scalars)."""
    if rows and not isinstance(rows[0], dict):
        rows = [{"item": r} for r in rows]
    if not rows:
        return {}
    cols: dict[str, list] = {k: [] for k in rows[0]}
    for r in rows:
        for k in cols:
            cols[k].append(r.get(k))
    return {k: _column(v) for k, v in cols.items()}


def batch_to_block(batch: Any) -> Block:
    """Normalize a user-returned batch (dict of arrays / list of rows)
    into a block."""
    if isinstance(batch, dict):
        out = {}
        for k, v in batch.items():
            if not isinstance(v, np.ndarray):
                v = _column(list(v))  # lists-of-lists -> 2D
            out[k] = v
        lengths = {len(v) for v in out.values()}
        if len(lengths) > 1:
            raise ValueError(f"batch columns differ in length: "
                             f"{ {k: len(v) for k, v in out.items()} }")
        return out
    if isinstance(batch, list):
        return build_block(batch)
    name = type(batch).__module__.split(".")[0]
    if name in ("pandas", "pyarrow"):
        raise _unported(f"a {name} batch")
    raise TypeError(f"unsupported batch type {type(batch)}")


def num_rows(block: Block) -> int:
    for col in block.values():
        return len(col)
    return 0


def slice_block(block: Block, start: int, end: int) -> Block:
    return {k: v[start:end] for k, v in block.items()}


def take_rows(block: Block, indices) -> Block:
    return {k: v[indices] for k, v in block.items()}


class BlockAccessor:
    """Reference: block.py BlockAccessor."""

    def __init__(self, block: Block):
        self._block = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    def num_rows(self) -> int:
        return num_rows(self._block)

    def size_bytes(self) -> int:
        return sum(v.nbytes for v in self._block.values())

    def schema(self) -> dict:
        """Column name -> (dtype, per-row shape)."""
        return {k: (v.dtype, v.shape[1:]) for k, v in self._block.items()}

    def slice(self, start: int, end: int) -> Block:
        return slice_block(self._block, start, end)

    def to_numpy(self) -> dict[str, np.ndarray]:
        return dict(self._block)

    def to_pandas(self):
        raise _unported('the "pandas" batch format')

    def to_arrow(self):
        raise _unported('the "pyarrow" batch format')

    def to_batch(self, batch_format: str):
        if batch_format in ("numpy", "default"):
            return self.to_numpy()
        if batch_format == "pandas":
            return self.to_pandas()
        if batch_format in ("pyarrow", "arrow"):
            return self.to_arrow()
        raise ValueError(f"unknown batch_format {batch_format!r}")

    def iter_rows(self) -> Iterable[dict]:
        for i in range(self.num_rows()):
            yield self._row(i)

    def _row(self, i: int) -> dict:
        out = {}
        for name, col in self._block.items():
            value = col[i]
            # 1-D typed columns give Python scalars, as Arrow's as_py does
            out[name] = value.item() if isinstance(value, np.generic) else value
        return out


def concat_blocks(blocks: list[Block]) -> Block:
    blocks = [b for b in blocks if num_rows(b)]
    if not blocks:
        return {}
    if len(blocks) == 1:
        return blocks[0]
    return {k: np.concatenate([b[k] for b in blocks]) for k in blocks[0]}
