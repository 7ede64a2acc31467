"""Dataset: the user-facing lazy, distributed data API.

Reference: ``python/ray/data/dataset.py`` (Dataset), ``read_api.py:340``.
Transforms build a logical chain; execution lowers it to physical ops and
streams blocks through the object store (SURVEY.md §3.6). Blocks are
numpy column dicts; the readers and writers of files, and the pandas and
Arrow conversions, are not ported yet and raise.
"""

from __future__ import annotations

import builtins
from typing import Any, Callable, Iterator

from ..core import api as ray
from . import datasource as ds
from . import logical as L
from .block import (BlockAccessor, _unported, batch_to_block, concat_blocks,
                    num_rows, slice_block)
from .executor import StreamingExecutor, plan
from .iterator import DataIterator, SplitCoordinator, batches_from_blocks


class ActorPoolStrategy:
    """Actor-pool compute for map_batches (reference
    ``ray.data.ActorPoolStrategy``): ``size`` stateful worker actors."""

    def __init__(self, size: int = 1, **_compat):
        self.size = max(1, int(_compat.get("max_size", size)))


class Dataset:
    def __init__(self, last_op: L.LogicalOp):
        self._last_op = last_op

    # ------------------------------------------------------------ transforms
    def _chain(self, op: L.LogicalOp) -> "Dataset":
        return Dataset(op)

    def map_batches(self, fn: Callable, *, batch_format: str = "numpy",
                    fn_kwargs: dict | None = None, compute=None,
                    fn_constructor_args: tuple = (),
                    fn_constructor_kwargs: dict | None = None,
                    ray_actor_options: dict | None = None,
                    **_ignored) -> "Dataset":
        """``compute=ActorPoolStrategy(size=n)`` runs the fn on a pool of
        stateful actors — pass a CLASS and it is constructed once per
        actor (the model-inference pattern). A class fn without an
        explicit compute defaults to a single-actor pool."""
        if compute is None and isinstance(fn, type):
            compute = ActorPoolStrategy(size=1)
        return self._chain(L.MapBatches(
            "map_batches", self._last_op, fn=fn, batch_format=batch_format,
            fn_kwargs=fn_kwargs or {}, compute=compute,
            fn_constructor_args=fn_constructor_args,
            fn_constructor_kwargs=fn_constructor_kwargs or {},
            ray_actor_options=ray_actor_options))

    def union(self, *others: "Dataset") -> "MaterializedDataset":
        """Concatenate datasets (materializes each input's blocks)."""
        refs = []
        for part in (self, *others):
            refs.extend(part.iter_internal_ref_bundles())
        return MaterializedDataset(refs)

    def map(self, fn: Callable) -> "Dataset":
        return self._chain(L.MapRows("map", self._last_op, fn=fn))

    def flat_map(self, fn: Callable) -> "Dataset":
        return self._chain(L.FlatMap("flat_map", self._last_op, fn=fn))

    def filter(self, fn: Callable) -> "Dataset":
        return self._chain(L.Filter("filter", self._last_op, fn=fn))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._chain(L.Repartition("repartition", self._last_op, num_blocks=num_blocks))

    def random_shuffle(self, *, seed: int | None = None) -> "Dataset":
        return self._chain(L.RandomShuffle("random_shuffle", self._last_op, seed=seed))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return self._chain(L.Sort("sort", self._last_op, key=key, descending=descending))

    def limit(self, n: int) -> "Dataset":
        return self._chain(L.Limit("limit", self._last_op, limit=n))

    def groupby(self, key: str) -> "GroupedData":
        """Group rows by a column (reference ``grouped_data.py:21``); the
        aggregation executes as a hash-partitioned map-reduce exchange."""
        return GroupedData(self, key)

    def join(self, other: "Dataset", on: str, *, how: str = "inner",
             num_partitions: int | None = None) -> "Dataset":
        """Hash join on column ``on`` (reference ``Dataset.join``). Both
        sides are hash-partitioned on the key; each reduce joins one
        partition pair with arrow's native join."""
        right_refs = list(other.iter_internal_ref_bundles())
        return self._chain(L.Join(
            "join", self._last_op, key=on, join_type=how,
            right_refs=right_refs, num_out=num_partitions))

    def zip(self, other: "Dataset") -> "Dataset":
        """Positionally merge columns of two datasets with equal row
        counts (reference ``Dataset.zip``). Blocks are re-aligned on row
        boundaries (a count pass, then one task per left block holding at
        most the overlapping right blocks); overlapping column names from
        ``other`` get a ``_1`` suffix."""
        left_refs = list(self.iter_internal_ref_bundles())
        right_refs = list(other.iter_internal_ref_bundles())
        count_remote = ray.remote(_count_task)
        left_counts = ray.get([count_remote.remote(r) for r in left_refs], timeout=300)
        right_counts = ray.get([count_remote.remote(r) for r in right_refs], timeout=300)
        if sum(left_counts) != sum(right_counts):
            raise ValueError(
                f"zip requires equal row counts: {sum(left_counts)} vs {sum(right_counts)}")
        right_starts = [0]
        for c in right_counts:
            right_starts.append(right_starts[-1] + c)
        zip_remote = ray.remote(_zip_task)
        out = []
        lo = 0
        for i, ref in enumerate(left_refs):
            hi = lo + left_counts[i]
            # right blocks overlapping [lo, hi) + their slice offsets
            overlaps = []
            blocks = []
            for j in builtins.range(len(right_refs)):
                s, e = right_starts[j], right_starts[j + 1]
                if e <= lo or s >= hi or s == e:
                    continue
                overlaps.append((max(lo, s) - s, min(hi, e) - s))
                blocks.append(right_refs[j])
            out.append(zip_remote.remote(ref, overlaps, *blocks))
            lo = hi
        return MaterializedDataset(out)

    # ------------------------------------------------------------ execution
    def iter_internal_ref_bundles(self) -> Iterator:
        executor = StreamingExecutor(plan(self._last_op))
        # retained so stats() can report the LAST execution's per-op
        # breakdown (reference data/_internal/stats.py)
        self._last_exec_ops = executor._ops
        return executor.run()

    def _iter_blocks(self) -> Iterator:
        for ref in self.iter_internal_ref_bundles():
            yield ray.get(ref, timeout=300)

    def materialize(self) -> "MaterializedDataset":
        refs = list(self.iter_internal_ref_bundles())
        return MaterializedDataset(refs)

    def iter_batches(self, *, batch_size: int | None = 256,
                     batch_format: str = "numpy", drop_last: bool = False):
        return batches_from_blocks(
            self._iter_blocks(), batch_size=batch_size,
            batch_format=batch_format, drop_last=drop_last)

    def iter_rows(self) -> Iterator[dict]:
        for block in self._iter_blocks():
            yield from BlockAccessor.for_block(block).iter_rows()

    def take(self, n: int = 20) -> list[dict]:
        out: list[dict] = []
        for row in self.limit(n).iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> list[dict]:
        return list(self.iter_rows())

    def count(self) -> int:
        return sum(num_rows(b) for b in self._iter_blocks())

    def schema(self):
        for block in self._iter_blocks():
            if num_rows(block):
                return BlockAccessor.for_block(block).schema()
        return None

    def show(self, n: int = 20) -> None:
        for row in self.take(n):
            print(row)

    def to_pandas(self):
        raise _unported("Dataset.to_pandas")

    def stats(self) -> str:
        """Per-operator execution summary of the most recent run
        (reference ``data/_internal/stats.py`` — surfaced on the dataset
        after iteration). Executes the pipeline if it never ran."""
        if getattr(self, "_last_exec_ops", None) is None:
            n = len(self.materialize()._refs)
        else:
            n = None
        lines = ["Dataset execution stats:"]
        total = 0.0
        for op in self._last_exec_ops:
            s = op.stats
            total += s["wall_s"]
            avg = s["wall_s"] / s["tasks"] * 1000 if s["tasks"] else 0.0
            lines.append(
                f"  {op.name}: {s['tasks']} tasks, "
                f"{s['blocks_out']} blocks, "
                f"wall {s['wall_s']:.3f}s (avg {avg:.1f}ms/task)")
        lines.append(f"  total task wall: {total:.3f}s")
        if n is not None:
            lines.append(f"  output blocks: {n}")
        return "\n".join(lines)

    # --------------------------------------------------------- train feeding
    def streaming_split(self, n: int, *, equal: bool = False) -> list[DataIterator]:
        """Reference: dataset.py:1598 — coordinator actor deals blocks to n
        consumers (one per train worker). num_cpus=0: the coordinator only
        shuffles refs and must never occupy a schedulable slot."""
        coord_cls = ray.remote(SplitCoordinator)
        # Unnamed: the handle-GC kills the coordinator when the last driver
        # handle drops, so repeated splits can't accumulate actors.
        coord = coord_cls.options(num_cpus=0).remote(self, n, equal)
        return [DataIterator(coord, i) for i in builtins.range(n)]

    def split(self, n: int) -> list["MaterializedDataset"]:
        mat = self.materialize()
        refs = mat._refs
        bounds = [round(i * len(refs) / n) for i in builtins.range(n + 1)]
        return [MaterializedDataset(refs[bounds[i]:bounds[i + 1]]) for i in builtins.range(n)]

    # ---------------------------------------------------------------- writes
    def write_parquet(self, path: str) -> None:
        raise _unported("Dataset.write_parquet")

    def write_json(self, path: str) -> None:
        raise _unported("Dataset.write_json")

    def write_csv(self, path: str) -> None:
        raise _unported("Dataset.write_csv")

    def write_tfrecords(self, path: str) -> None:
        raise _unported("Dataset.write_tfrecords")

    def write_avro(self, path: str) -> None:
        raise _unported("Dataset.write_avro")

    def write_webdataset(self, path: str) -> None:
        raise _unported("Dataset.write_webdataset")

    def __repr__(self):
        return f"Dataset(ops={[o.name for o in self._last_op.chain()]})"


def _count_task(block) -> int:
    return num_rows(block)


def _zip_task(left, slices: list, *right_blocks):
    """Concat the right-side slices aligned to this left block, then merge
    columns (suffixing duplicates with ``_1``, reference zip semantics)."""
    pieces = [slice_block(b, s, e) for b, (s, e) in zip(right_blocks, slices)]
    right = concat_blocks(pieces) if pieces else slice_block(left, 0, 0)
    cols = dict(left)
    for name, col in right.items():
        out_name = name if name not in cols else f"{name}_1"
        cols[out_name] = col
    return cols


class GroupedData:
    """Result of ``Dataset.groupby`` (reference ``grouped_data.py:21``):
    aggregations lower to a hash-partitioned exchange with map-side
    partial aggregation."""

    def __init__(self, dataset: Dataset, key: str):
        self._dataset = dataset
        self._key = key

    def _agg(self, aggs: list) -> Dataset:
        return self._dataset._chain(L.GroupByAggregate(
            "groupby", self._dataset._last_op, key=self._key, aggs=aggs))

    def count(self) -> Dataset:
        return self._agg([(self._key, "count")])

    def sum(self, on: str) -> Dataset:
        return self._agg([(on, "sum")])

    def min(self, on: str) -> Dataset:
        return self._agg([(on, "min")])

    def max(self, on: str) -> Dataset:
        return self._agg([(on, "max")])

    def mean(self, on: str) -> Dataset:
        return self._agg([(on, "mean")])

    def aggregate(self, *aggs: tuple) -> Dataset:
        """``aggregate((col, "sum"), (col2, "max"), ...)``"""
        return self._agg(list(aggs))

    def map_groups(self, fn) -> Dataset:
        """Apply ``fn(batch_dict) -> batch_dict | list[row]`` to each
        group (reference ``GroupedData.map_groups``)."""
        return self._dataset._chain(L.GroupByAggregate(
            "groupby", self._dataset._last_op, key=self._key, aggs=None,
            map_groups_fn=fn))


class MaterializedDataset(Dataset):
    """Blocks pinned in the object store. Reference: MaterializedDataset."""

    def __init__(self, refs: list):
        self._refs = refs

        def make(r):
            return lambda: ray.get(r, timeout=120)

        # chained transforms re-read the pinned blocks from the object store
        super().__init__(L.Read("materialized", read_tasks=[make(r) for r in refs]))

    def iter_internal_ref_bundles(self) -> Iterator:
        return iter(self._refs)

    def num_blocks(self) -> int:
        return len(self._refs)

    def __repr__(self):
        return f"MaterializedDataset({len(self._refs)} blocks)"


# ------------------------------------------------------------------ read api


def range(n: int, *, parallelism: int = 8) -> Dataset:  # noqa: A001
    return Dataset(L.Read("read_range", read_tasks=ds.range_tasks(n, parallelism)))


def from_items(items: list, *, parallelism: int = 8) -> Dataset:
    return Dataset(L.Read("read_items", read_tasks=ds.items_tasks(items, parallelism)))


def read_parquet(paths, *, row_groups_per_task: int | None = 4) -> Dataset:
    raise _unported("read_parquet")


def read_csv(paths) -> Dataset:
    raise _unported("read_csv")


def read_json(paths) -> Dataset:
    raise _unported("read_json")


def read_numpy(paths, *, column: str = "data") -> Dataset:
    raise _unported("read_numpy")


def from_numpy(arr, *, column: str = "data") -> MaterializedDataset:
    block = batch_to_block({column: arr})
    return MaterializedDataset([ray.put(block)])


def from_pandas(df) -> MaterializedDataset:
    raise _unported("from_pandas")


def from_arrow(table) -> MaterializedDataset:
    raise _unported("from_arrow")


def read_text(paths) -> Dataset:
    raise _unported("read_text")


def read_binary_files(paths) -> Dataset:
    raise _unported("read_binary_files")


def read_tfrecords(paths) -> Dataset:
    raise _unported("read_tfrecords")


def read_avro(paths) -> Dataset:
    raise _unported("read_avro")


def read_webdataset(paths) -> Dataset:
    raise _unported("read_webdataset")


def from_huggingface(hf_dataset, *, parallelism: int = 8) -> Dataset:
    raise _unported("from_huggingface")


def read_images(paths, *, size: tuple[int, int] | None = None,
                mode: str | None = None) -> Dataset:
    raise _unported("read_images")
