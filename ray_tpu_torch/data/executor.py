"""Physical plan + streaming executor.

Reference: ``python/ray/data/_internal/execution/streaming_executor.py:48``
(loop :233,285; ``select_operator_to_run`` in streaming_executor_state.py:531).
The shape is the same in miniature: physical operators with input/output
queues, a driver scheduling loop that moves completed blocks downstream
and launches new tasks under per-op concurrency and a global in-flight
cap (backpressure). Map chains are fused into one task per block
(the optimizer's operator-fusion rule).

All-to-all ops (shuffle/sort/repartition/groupby/join) run as a push-based
map-reduce partition exchange (reference ``_internal/planner/exchange/
push_based_shuffle_task_scheduler.py``): map tasks partition each upstream
block as it arrives (streaming — no barrier on the input side), reduce
tasks merge one partition each, so no single task ever holds the whole
dataset. Sort samples key ranges first (range partitioning); groupby and
join hash-partition on the key with a cross-process-stable hash. Blocks
are numpy column dicts (``block.py``): the partition hash, the
aggregates, the sort and the join run on numpy.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable, Iterator

import numpy as np

from ..core import api as ray
from . import logical as L
from .block import (BlockAccessor, _column, batch_to_block, build_block,
                    concat_blocks, num_rows, slice_block, take_rows)

# ---------------------------------------------------------------- map stages


@dataclasses.dataclass
class MapStage:
    kind: str  # "batches" | "rows" | "flat" | "filter"
    fn: Callable
    batch_format: str = "numpy"
    fn_kwargs: dict = dataclasses.field(default_factory=dict)


def _apply_stages(block, stages: list[MapStage]):
    for st in stages:
        acc = BlockAccessor.for_block(block)
        if st.kind == "batches":
            batch = acc.to_batch(st.batch_format)
            block = batch_to_block(st.fn(batch, **st.fn_kwargs))
        elif st.kind == "rows":
            block = build_block([st.fn(r) for r in acc.iter_rows()])
        elif st.kind == "flat":
            out = []
            for r in acc.iter_rows():
                out.extend(st.fn(r))
            block = build_block(out)
        elif st.kind == "filter":
            block = build_block([r for r in acc.iter_rows() if st.fn(r)])
        else:
            raise ValueError(st.kind)
    return block


def _read_task(fn):
    return batch_to_block(fn())


def _map_task(stages: list[MapStage], block):
    return _apply_stages(block, stages)


class _MapWorker:
    """Stateful map_batches worker (reference: actor-pool map operator —
    ``_internal/execution/operators/actor_pool_map_operator.py``). A class
    fn is constructed ONCE per actor (e.g. loads a model); plain callables
    pass through."""

    def __init__(self, fn, constructor_args: tuple, constructor_kwargs: dict):
        self.fn = fn(*constructor_args, **constructor_kwargs) if isinstance(fn, type) else fn

    def apply(self, batch_format: str, fn_kwargs: dict, block):
        return _apply_stages(
            block, [MapStage("batches", self.fn, batch_format, fn_kwargs)]
        )


# ------------------------------------------------------- exchange tasks


def _stable_hash(vals: np.ndarray) -> np.ndarray:
    """A 64-bit hash of each value that is STABLE across worker processes
    (Python's builtin hash is salted per process, which would scatter
    equal keys across partitions): integers and floats by their bits,
    anything else by the crc32 of its bytes, then splitmix64's mixer."""
    vals = np.asarray(vals)
    if vals.dtype.kind in "iub":
        x = vals.astype(np.int64).view(np.uint64)
    elif vals.dtype.kind == "f":
        x = (vals.astype(np.float64) + 0.0).view(np.uint64)  # -0.0 == 0.0
    else:
        def raw(v):
            if isinstance(v, bytes):
                return v
            return (v if isinstance(v, str) else repr(v)).encode()

        x = np.array([zlib.crc32(raw(v)) for v in vals.tolist()], np.uint64)
    x = x.copy()
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return x


def _stable_hash_partition(block, key: str, num_out: int) -> np.ndarray:
    """Partition assignment by ``_stable_hash`` of the key column."""
    return (_stable_hash(block[key]) % np.uint64(num_out)).astype(np.int64)


def _exchange_map_task(kind: str, num_out: int, spec: dict, map_index: int, block):
    """Partition one upstream block into ``num_out`` parts (the map half
    of the exchange; reference ``exchange/shuffle_task_spec.py``)."""
    n = num_rows(block)
    if n == 0:
        # A schema-less empty block (e.g. from_items([])) has no key
        # column to hash/range on — emit empty parts directly.
        assign = np.zeros(0, dtype=np.int64)
    elif kind == "shuffle":
        rng = np.random.default_rng((spec.get("seed") or 0) + map_index * 7919)
        assign = rng.integers(0, num_out, n)
    elif kind == "repartition":
        assign = (np.arange(n) + map_index) % num_out  # row round-robin
    elif kind == "sort":
        col = block[spec["sort_key"]]
        assign = np.searchsorted(np.asarray(spec["boundaries"]), col, side="right")
    elif kind in ("groupby", "join"):
        assign = _stable_hash_partition(block, spec["key"], num_out)
    else:
        raise ValueError(kind)
    parts = []
    for i in range(num_out):
        part = take_rows(block, np.nonzero(assign == i)[0])
        if kind == "groupby" and spec.get("aggs") and part:
            part = _partial_aggregate(part, spec)  # map-side combine
        parts.append(part)
    return tuple(parts) if num_out > 1 else parts[0]


# Aggregations decompose into (map-side partial, reduce-side merge) so the
# reduce only sees one partial row per key per map task (reference
# AggregateFn accumulate/merge/finalize).
_AGG_PARTIAL = {"count": "count", "sum": "sum", "min": "min", "max": "max"}


def _partial_aggregate(part, spec: dict):
    key = spec["key"]
    aggs = []
    for col, op in spec["aggs"]:
        if op == "mean":
            aggs.append((col, "sum"))
            aggs.append((col, "count"))
        else:
            aggs.append((col if op != "count" else key, _AGG_PARTIAL[op]))
    return _group_aggregate(part, key, _dedupe(aggs))


def _group_aggregate(block, key: str, aggs: list[tuple]) -> dict:
    """``(col, op)`` aggregates of ``block`` per distinct ``key``, named
    ``f"{col}_{op}"`` as Arrow's ``group_by().aggregate`` names them; one
    row per key, keys ascending."""
    keys = block[key]
    uniq, inv = np.unique(keys, return_inverse=True)
    inv = inv.reshape(-1)
    order = np.argsort(inv, kind="stable")
    starts = np.flatnonzero(np.r_[True, np.diff(inv[order]) != 0]) \
        if len(inv) else np.zeros(0, np.int64)
    out = {key: uniq}
    for col, op in aggs:
        if op == "count":
            out[f"{col}_count"] = np.bincount(
                inv, minlength=len(uniq)).astype(np.int64)
            continue
        vals = block[col][order]
        reduce = {"sum": np.add, "min": np.minimum, "max": np.maximum}[op]
        out[f"{col}_{op}"] = (reduce.reduceat(vals, starts) if len(vals)
                              else vals[:0])
    return out


def _dedupe(aggs: list[tuple]) -> list[tuple]:
    seen, out = set(), []
    for a in aggs:
        if a not in seen:
            seen.add(a)
            out.append(a)
    return out


def _exchange_reduce_task(kind: str, spec: dict, part_index: int, n_left: int, *parts):
    """Merge one partition's pieces from every map task (the reduce half).
    For joins, ``parts[:n_left]`` are the left side's pieces and the rest
    the right side's (same hash partition on both)."""
    left_parts = list(parts[:n_left])
    right_parts = list(parts[n_left:])
    if not left_parts:
        # Join whose left upstream produced zero blocks (n_left == 0): an
        # empty placeholder; the join branch below synthesizes the key-only
        # empty left table (left-only columns are unknowable and absent).
        left_parts = [{}]
    merged = _concat_keep_schema(left_parts)
    if num_rows(merged) == 0 and not merged and kind != "join":
        return merged  # schema-less empty partition: nothing to sort/merge
    if kind == "shuffle":
        rng = np.random.default_rng((spec.get("seed") or 0) ^ (part_index + 1))
        return take_rows(merged, rng.permutation(num_rows(merged)))
    if kind == "sort":
        return take_rows(merged, _sort_order(merged[spec["sort_key"]],
                                             spec.get("descending")))
    if kind == "groupby":
        return _final_aggregate(merged, spec)
    if kind == "join":
        right = _concat_keep_schema(right_parts or [slice_block(merged, 0, 0)])
        # A side fed only schema-less empty blocks lacks the key columns;
        # substitute a key-only empty table so the join stays executable.
        keys = spec["key"] if isinstance(spec["key"], list) else [spec["key"]]

        def _has_keys(t):
            return set(keys) <= set(t)

        if num_rows(merged) == 0 and not _has_keys(merged):
            if not _has_keys(right):
                return merged  # both sides schema-less empty
            merged = {k: right[k][:0] for k in keys}
        if num_rows(right) == 0 and not _has_keys(right):
            right = {k: merged[k][:0] for k in keys}
        return _join(merged, right, keys, spec.get("join_type", "inner"))
    return merged  # repartition


def _sort_order(col: np.ndarray, descending: bool) -> np.ndarray:
    """A stable ascending or descending order of ``col``."""
    if not descending:
        return np.argsort(col, kind="stable")
    n = len(col)
    return (n - 1 - np.argsort(col[::-1], kind="stable"))[::-1]


_JOIN_TYPES = ("inner", "left outer", "right outer", "full outer",
               "left semi", "left anti")


def _join(left: dict, right: dict, keys: list, join_type: str) -> dict:
    """A hash join of two blocks on ``keys`` with Arrow's join types
    (``_JOIN_TYPES``): the key columns, then the left side's other
    columns, then the right side's; a missing side's values are None."""
    if join_type not in _JOIN_TYPES:
        raise ValueError(f"join_type {join_type!r} is not one of {_JOIN_TYPES}")
    lrows = list(BlockAccessor.for_block(left).iter_rows())
    rrows = list(BlockAccessor.for_block(right).iter_rows())
    index: dict = {}
    for j, r in enumerate(rrows):
        index.setdefault(tuple(r[k] for k in keys), []).append(j)
    lcols = [c for c in left if c not in keys]
    rcols = [c for c in right if c not in keys]
    if join_type in ("left semi", "left anti"):
        want = join_type == "left semi"
        keep = [i for i, r in enumerate(lrows)
                if (tuple(r[k] for k in keys) in index) == want]
        return take_rows(left, np.asarray(keep, np.int64))
    pairs, matched = [], set()
    for i, r in enumerate(lrows):
        hits = index.get(tuple(r[k] for k in keys), [])
        matched.update(hits)
        if hits:
            pairs.extend((i, j) for j in hits)
        elif join_type in ("left outer", "full outer"):
            pairs.append((i, None))
    if join_type in ("right outer", "full outer"):
        pairs.extend((None, j) for j in range(len(rrows)) if j not in matched)
    out: dict[str, list] = {c: [] for c in [*keys, *lcols, *rcols]}
    for i, j in pairs:
        lr = lrows[i] if i is not None else {}
        rr = rrows[j] if j is not None else {}
        for k in keys:
            out[k].append(lr[k] if i is not None else rr[k])
        for c in lcols:
            out[c].append(lr.get(c))
        for c in rcols:
            out[c].append(rr.get(c))
    if not pairs:
        return {**{k: left[k][:0] for k in keys},
                **{c: left[c][:0] for c in lcols},
                **{c: right[c][:0] for c in rcols}}
    return {c: _column(v) for c, v in out.items()}


def _concat_keep_schema(parts: list):
    """concat that keeps the schema when every part is empty (an empty
    hash/range partition must stay sortable/groupable downstream)."""
    non_empty = [p for p in parts if num_rows(p)]
    if not non_empty:
        return parts[0]
    return concat_blocks(non_empty)


def _final_aggregate(merged, spec: dict):
    key = spec["key"]
    if spec.get("map_groups_fn") is not None:
        fn = spec["map_groups_fn"]
        acc = BlockAccessor.for_block(merged)
        groups: dict = {}
        for row in acc.iter_rows():
            groups.setdefault(row[key], []).append(row)
        out_rows = []
        for _, rows in sorted(groups.items(), key=lambda kv: str(kv[0])):
            result = fn(_rows_to_batch(rows))
            out_rows.extend(_batch_to_rows(result))
        return build_block(out_rows)
    # Merge map-side partials: count -> sum of counts, sum -> sum of sums,
    # min/max idempotent, mean -> sum/count finalize.
    merges = []
    for col, op in spec["aggs"]:
        if op == "count":
            merges.append((f"{key}_count", "sum"))
        elif op == "sum":
            merges.append((f"{col}_sum", "sum"))
        elif op == "min":
            merges.append((f"{col}_min", "min"))
        elif op == "max":
            merges.append((f"{col}_max", "max"))
        elif op == "mean":
            merges.append((f"{col}_sum", "sum"))
            merges.append((f"{col}_count", "sum"))
    table = _group_aggregate(merged, key, _dedupe(merges))
    # Rename/finalize to the reference's output names: op(col).
    cols = {key: table[key]}
    for col, op in spec["aggs"]:
        if op == "count":
            cols["count()"] = table[f"{key}_count_sum"]
        elif op == "mean":
            s = table[f"{col}_sum_sum"]
            c = table[f"{col}_count_sum"]
            cols[f"mean({col})"] = s / np.maximum(c, 1)
        else:
            cols[f"{op}({col})"] = table[f"{col}_{op}_{'sum' if op == 'sum' else op}"]
    return cols


def _rows_to_batch(rows: list[dict]) -> dict:
    keys = rows[0].keys()
    return {k: np.asarray([r[k] for r in rows]) for k in keys}


def _batch_to_rows(result) -> list[dict]:
    if isinstance(result, dict):
        keys = list(result)
        n = len(next(iter(result.values()))) if result else 0
        return [{k: result[k][i] for k in keys} for i in range(n)]
    if isinstance(result, list):
        return result
    raise TypeError(f"map_groups fn must return a dict batch or list of rows, got {type(result)}")


def _sample_task(key: str, block):
    """Sort pre-pass: sample up to 100 key values from a block."""
    col = block[key]
    if len(col) > 100:
        idx = np.random.default_rng(0).choice(len(col), 100, replace=False)
        col = col[idx]
    return np.asarray(col)


# ------------------------------------------------------------- physical ops


class PhysicalOp:
    """Blocks are emitted in input order (completion order is buffered
    through a per-op reorder window), so downstream semantics — take(),
    zip-like joins, batch determinism — match the logical plan order."""

    def __init__(self, name: str):
        self.name = name
        self.input_queue: list = []  # upstream block refs
        self.in_flight: dict = {}  # ref -> seq
        self.output_queue: list = []
        self.upstream_done = False
        self._next_seq = 0
        self._emit_seq = 0
        self._completed: dict[int, Any] = {}
        # per-op execution stats (reference data/_internal/stats.py):
        # wall = task submit->complete (includes queue + remote exec)
        self.stats = {"tasks": 0, "blocks_out": 0, "wall_s": 0.0}
        self._launched_at: dict = {}

    def done(self) -> bool:
        return self.upstream_done and not self.input_queue and not self.in_flight

    def can_launch(self) -> bool:
        return bool(self.input_queue)

    def launch_one(self) -> list:
        raise NotImplementedError

    def _track(self, refs: list) -> list:
        import time as _time

        now = _time.monotonic()
        for r in refs:
            self.in_flight[r] = self._next_seq
            self._next_seq += 1
            self._launched_at[r] = now
        return refs

    def on_complete(self, ref) -> None:
        import time as _time

        t0 = self._launched_at.pop(ref, None)
        if t0 is not None:
            self.stats["wall_s"] += _time.monotonic() - t0
            self.stats["tasks"] += 1
            self.stats["blocks_out"] += 1
        seq = self.in_flight.pop(ref)
        self._completed[seq] = ref
        while self._emit_seq in self._completed:
            self.output_queue.append(self._completed.pop(self._emit_seq))
            self._emit_seq += 1

    def close(self) -> None:
        """Release operator resources (actor pools) at stream end."""


class ReadPhysicalOp(PhysicalOp):
    def __init__(self, read_tasks):
        super().__init__("Read")
        self._remote = ray.remote(_read_task)
        self.input_queue = list(read_tasks)
        self.upstream_done = True

    def launch_one(self):
        fn = self.input_queue.pop(0)
        return self._track([self._remote.remote(fn)])


class MapPhysicalOp(PhysicalOp):
    def __init__(self, stages: list[MapStage]):
        names = "->".join(s.kind for s in stages)
        super().__init__(f"Map[{names}]")
        self._remote = ray.remote(_map_task)
        self._stages = stages

    def launch_one(self):
        block_ref = self.input_queue.pop(0)
        return self._track([self._remote.remote(self._stages, block_ref)])


class ActorPoolMapPhysicalOp(PhysicalOp):
    """map_batches over a pool of stateful actors: the fn (usually a
    class holding a model) is constructed once per actor; blocks route to
    the least-loaded actor. Reference:
    ``actor_pool_map_operator.py`` + ``ActorPoolStrategy``."""

    def __init__(self, fn, batch_format: str, fn_kwargs: dict, *,
                 pool_size: int, constructor_args: tuple = (),
                 constructor_kwargs: dict | None = None,
                 ray_actor_options: dict | None = None,
                 max_tasks_per_actor: int = 2):
        super().__init__(f"ActorPoolMap[{getattr(fn, '__name__', 'fn')}x{pool_size}]")
        self._fn = fn
        self._batch_format = batch_format
        self._fn_kwargs = fn_kwargs
        self._pool_size = pool_size
        self._actor_options = ray_actor_options or {}
        self._ctor = (constructor_args, constructor_kwargs or {})
        self._max_per_actor = max_tasks_per_actor
        self._actors: list = []
        self._actor_load: dict[int, int] = {}  # actor index -> in-flight
        self._ref_to_actor: dict = {}

    def _ensure_pool(self) -> None:
        if self._actors:
            return
        cls = ray.remote(_MapWorker)
        if self._actor_options:
            cls = cls.options(**self._actor_options)
        args, kwargs = self._ctor
        self._actors = [cls.remote(self._fn, args, kwargs) for _ in range(self._pool_size)]
        self._actor_load = {i: 0 for i in range(self._pool_size)}

    def can_launch(self) -> bool:
        if not self.input_queue:
            return False
        if not self._actors:
            return True  # pool created on first launch
        return min(self._actor_load.values()) < self._max_per_actor

    def launch_one(self):
        self._ensure_pool()
        idx = min(self._actor_load, key=self._actor_load.get)
        block_ref = self.input_queue.pop(0)
        ref = self._actors[idx].apply.remote(self._batch_format, self._fn_kwargs, block_ref)
        self._actor_load[idx] += 1
        self._ref_to_actor[ref] = idx
        return self._track([ref])

    def on_complete(self, ref) -> None:
        idx = self._ref_to_actor.pop(ref, None)
        if idx is not None:
            self._actor_load[idx] -= 1
        super().on_complete(ref)

    def close(self) -> None:
        for a in self._actors:
            try:
                ray.kill(a)
            except Exception:
                pass
        self._actors = []


class ExchangePhysicalOp(PhysicalOp):
    """Push-based map-reduce partition exchange behind every all-to-all op
    (reference ``push_based_shuffle_task_scheduler.py``).

    Map tasks launch as upstream blocks ARRIVE (no input barrier); each
    partitions its block into ``num_out`` pieces. Once the upstream and
    all maps finish, ``num_out`` reduce tasks each merge one partition —
    so peak per-task memory is one partition, not the dataset. Sort runs
    a sampling pre-pass to pick range boundaries; join hash-partitions
    the (pre-materialized) right side through the same maps."""

    def __init__(self, kind: str, *, num_out: int | None = None, seed=None,
                 sort_key: str = "", descending: bool = False, key: str = "",
                 aggs: list | None = None, map_groups_fn=None,
                 right_refs: list | None = None, join_type: str = "inner"):
        from ..core.config import get_config

        super().__init__(f"Exchange[{kind}]")
        self._kind = kind
        self._num_out = num_out or get_config().data_exchange_partitions
        self._spec = {
            "seed": seed, "sort_key": sort_key, "descending": descending,
            "key": key, "aggs": aggs, "map_groups_fn": map_groups_fn,
            "join_type": join_type,
        }
        self._map_remote = ray.remote(_exchange_map_task).options(num_returns=self._num_out) \
            if self._num_out > 1 else ray.remote(_exchange_map_task)
        self._reduce_remote = ray.remote(_exchange_reduce_task)
        self._sample_remote = ray.remote(_sample_task)
        self._internal: dict = {}           # ref -> ("sample"|"map", ...)
        self._pending_sample: list = []     # block refs awaiting boundaries (sort)
        self._samples: list = []
        self._boundaries_ready = kind != "sort"
        self._map_outputs: list[list] = []  # per map: [num_out refs]
        self._map_index = 0
        self._maps_in_flight = 0
        self._right_refs = list(right_refs or [])
        self._right_outputs: list[list] = []
        self._reduces_launched = 0

    # Upstream blocks stack in input_queue; right-side blocks are seeded
    # into the map queue too (tagged).
    def can_launch(self) -> bool:
        if self._kind == "sort" and not self._boundaries_ready:
            # Sampling phase: one sample task per arriving block.
            return bool(self.input_queue) or self._maybe_finish_sampling()
        if self.input_queue or self._right_refs:
            return True
        return self._can_reduce()

    def _maybe_finish_sampling(self) -> bool:
        if (self.upstream_done and not self.input_queue
                and not any(k[0] == "sample" for k in self._internal.values())
                and not self._boundaries_ready):
            # All samples in: compute range boundaries on the driver.
            # Order statistics (sort + index at quantile positions) rather
            # than np.quantile, so string and other non-numeric but
            # comparable sort keys partition correctly too.
            vals = np.concatenate(self._samples) if self._samples else np.array([0.0])
            if vals.size == 0:  # blocks existed but every one was empty
                vals = np.array([0.0])
            vals = np.sort(vals)
            last = len(vals) - 1
            self._spec["boundaries"] = [
                vals[min(last, int(round((i + 1) / self._num_out * last)))]
                for i in range(self._num_out - 1)
            ]
            self._boundaries_ready = True
            # blocks return to the map queue
            self.input_queue = self._pending_sample + self.input_queue
            self._pending_sample = []
            return bool(self.input_queue)
        return False

    def _can_reduce(self) -> bool:
        return (self.upstream_done and not self.input_queue and not self._right_refs
                and self._boundaries_ready and self._maps_in_flight == 0
                and self._reduces_launched < self._num_out
                and bool(self._map_outputs or self._right_outputs))

    def launch_one(self):
        if self._kind == "sort" and not self._boundaries_ready:
            if not self.input_queue:
                return []  # _maybe_finish_sampling flipped the phase
            block_ref = self.input_queue.pop(0)
            self._pending_sample.append(block_ref)
            ref = self._sample_remote.remote(self._spec["sort_key"], block_ref)
            self._internal[ref] = ("sample",)
            self.in_flight[ref] = None
            return [ref]
        if self.input_queue or self._right_refs:
            side = "left" if self.input_queue else "right"
            block_ref = (self.input_queue.pop(0) if side == "left"
                         else self._right_refs.pop(0))
            refs = self._map_remote.remote(
                self._kind, self._num_out, self._spec, self._map_index, block_ref)
            self._map_index += 1
            if self._num_out == 1:
                refs = [refs]
            refs = list(refs)
            out_list = self._map_outputs if side == "left" else self._right_outputs
            out_list.append(refs)
            self._maps_in_flight += 1
            # Track ONE ref per map for completion accounting (siblings of
            # a multi-return task complete together).
            self._internal[refs[0]] = ("map",)
            self.in_flight[refs[0]] = None
            return [refs[0]]
        if self._can_reduce():
            i = self._reduces_launched
            self._reduces_launched += 1
            # Descending sort: partition 0 holds the SMALLEST range — emit
            # partitions in reverse so the global stream is ordered.
            if self._kind == "sort" and self._spec.get("descending"):
                i = self._num_out - 1 - i
            left = [m[i] for m in self._map_outputs]
            right = [m[i] for m in self._right_outputs]
            spec = {k: v for k, v in self._spec.items() if k != "map_groups_fn"}
            spec["map_groups_fn"] = self._spec["map_groups_fn"]
            ref = self._reduce_remote.remote(
                self._kind, spec, i, len(left), *(left + right))
            return self._track([ref])
        return []

    def on_complete(self, ref) -> None:
        tag = self._internal.pop(ref, None)
        if tag is None:
            super().on_complete(ref)  # a reduce: ordered output emission
            return
        self.in_flight.pop(ref, None)
        if tag[0] == "sample":
            self._samples.append(ray.get(ref))
        else:  # map
            self._maps_in_flight -= 1

    def done(self) -> bool:
        if not (self.upstream_done and not self.input_queue and not self.in_flight
                and not self._right_refs):
            return False
        if not self._map_outputs and not self._right_outputs:
            return True  # empty upstream: nothing to exchange
        return self._reduces_launched >= self._num_out


class LimitPhysicalOp(PhysicalOp):
    """Driver-side streaming limit: truncates blocks until the row budget
    is spent, then drops the rest of the stream."""

    def __init__(self, limit: int):
        super().__init__(f"Limit[{limit}]")
        self._remaining = limit
        self._slice_remote = ray.remote(_slice_task)

    def can_launch(self) -> bool:
        # one in-flight slice at a time: each slice budget depends on the
        # rows consumed by the previous one
        return bool(self.input_queue) and not self.in_flight

    def launch_one(self):
        block_ref = self.input_queue.pop(0)
        if self._remaining <= 0:
            return []
        return self._track([self._slice_remote.remote(self._remaining, block_ref)])

    def on_complete(self, ref) -> None:
        block = ray.get(ref)
        self._remaining -= BlockAccessor.for_block(block).num_rows()
        super().on_complete(ref)
        if self._remaining <= 0:
            self.input_queue.clear()
            self.upstream_done = True


def _slice_task(limit: int, block):
    if num_rows(block) <= limit:
        return block
    return slice_block(block, 0, limit)


# ----------------------------------------------------------------- planning


def plan(last_op: L.LogicalOp) -> list[PhysicalOp]:
    """Lower the logical chain to physical ops, fusing adjacent maps."""
    ops: list[PhysicalOp] = []
    pending_stages: list[MapStage] = []

    def flush_maps():
        nonlocal pending_stages
        if pending_stages:
            ops.append(MapPhysicalOp(pending_stages))
            pending_stages = []

    for lop in last_op.chain():
        if isinstance(lop, L.Read):
            ops.append(ReadPhysicalOp(lop.read_tasks))
        elif isinstance(lop, L.MapBatches):
            if lop.compute is not None:
                # Actor-pool compute is a fusion barrier: the stateful fn
                # lives on dedicated actors, not fused into block tasks.
                flush_maps()
                ops.append(ActorPoolMapPhysicalOp(
                    lop.fn, lop.batch_format, lop.fn_kwargs,
                    pool_size=lop.compute.size,
                    constructor_args=lop.fn_constructor_args,
                    constructor_kwargs=lop.fn_constructor_kwargs,
                    ray_actor_options=lop.ray_actor_options,
                ))
            else:
                pending_stages.append(MapStage("batches", lop.fn, lop.batch_format, lop.fn_kwargs))
        elif isinstance(lop, L.MapRows):
            pending_stages.append(MapStage("rows", lop.fn))
        elif isinstance(lop, L.FlatMap):
            pending_stages.append(MapStage("flat", lop.fn))
        elif isinstance(lop, L.Filter):
            pending_stages.append(MapStage("filter", lop.fn))
        elif isinstance(lop, L.Repartition):
            flush_maps()
            ops.append(ExchangePhysicalOp("repartition", num_out=lop.num_blocks))
        elif isinstance(lop, L.RandomShuffle):
            flush_maps()
            ops.append(ExchangePhysicalOp("shuffle", seed=lop.seed))
        elif isinstance(lop, L.Sort):
            flush_maps()
            ops.append(ExchangePhysicalOp("sort", sort_key=lop.key, descending=lop.descending))
        elif isinstance(lop, L.GroupByAggregate):
            flush_maps()
            ops.append(ExchangePhysicalOp(
                "groupby", num_out=lop.num_out, key=lop.key, aggs=lop.aggs,
                map_groups_fn=lop.map_groups_fn))
        elif isinstance(lop, L.Join):
            flush_maps()
            ops.append(ExchangePhysicalOp(
                "join", num_out=lop.num_out, key=lop.key,
                right_refs=lop.right_refs, join_type=lop.join_type))
        elif isinstance(lop, L.Limit):
            flush_maps()
            ops.append(LimitPhysicalOp(lop.limit))
        elif isinstance(lop, L.Union):
            raise NotImplementedError("union is handled at the Dataset level")
        else:
            raise ValueError(f"unknown logical op {lop}")
    flush_maps()
    return ops


# ---------------------------------------------------------------- executor


class StreamingExecutor:
    """Drives the physical op pipeline; yields output block refs as ready.

    Backpressure: at most ``max_in_flight`` tasks cluster-wide and
    ``per_op_concurrency`` per operator (reference: backpressure_policy/).
    """

    def __init__(self, ops: list[PhysicalOp], *, max_in_flight: int | None = None,
                 per_op_concurrency: int | None = None):
        from ..core.config import get_config

        cfg = get_config()
        self._ops = ops
        self._max_in_flight = max_in_flight or cfg.data_max_in_flight_tasks
        self._per_op = per_op_concurrency or cfg.data_per_op_concurrency

    def run(self) -> Iterator[Any]:
        try:
            yield from self._run_inner()
        finally:
            for op in self._ops:
                op.close()

    def _run_inner(self) -> Iterator[Any]:
        ops = self._ops
        last = ops[-1]
        while True:
            # 1. propagate completion flags + move outputs downstream
            for i, op in enumerate(ops):
                if i > 0:
                    upstream = ops[i - 1]
                    op.input_queue.extend(upstream.output_queue)
                    upstream.output_queue.clear()
                    op.upstream_done = upstream.done()
            while last.output_queue:
                yield last.output_queue.pop(0)
            if last.done():
                return

            # 2. poll in-flight tasks (small timeout so the loop stays live)
            all_refs = [r for op in ops for r in op.in_flight]
            progressed = False
            if all_refs:
                ready, _ = ray.wait(all_refs, num_returns=1, timeout=0.5)
                for ref in ready:
                    for op in ops:
                        if ref in op.in_flight:
                            op.on_complete(ref)
                            progressed = True
                            break

            # 3. launch new work, downstream ops first (finish-what-you-
            #    started, the reference's select_operator_to_run bias)
            total_in_flight = sum(len(op.in_flight) for op in ops)
            for op in reversed(ops):
                while (
                    op.can_launch()
                    and len(op.in_flight) < self._per_op
                    and total_in_flight < self._max_in_flight
                ):
                    launched = op.launch_one()
                    total_in_flight += len(launched)
                    progressed = True
            if not progressed and not all_refs:
                # nothing running and nothing launched: avoid a hot spin
                import time

                time.sleep(0.01)
