"""Sharded control-plane stores (reference ``src/ray/gcs/store_client/``).

The GCS serialized every task-event, actor, and KV write through one
lock (and, worse, through its single event loop) — N raylets flushing
task events convoyed on each other and on every heartbeat. The split
here mirrors the reference's ``store_client/`` layering: a key-hashed
shard layout with ONE lock per shard, so concurrent writers touching
different keys never contend, while reads stay linearizable per key
(a key always lives in exactly one shard, guarded by that shard's lock).

Cross-shard ordering is preserved where consumers can observe it: every
record carries a global monotone sequence stamp, and merged listings
sort by it — so an N-shard store's ``list``/iteration output is
byte-identical to the 1-shard store's insertion order (the PR-6d
equivalence-test treatment, re-applied to sharding).
"""

from __future__ import annotations

import itertools
import threading
import zlib
from typing import Any, Iterator, MutableMapping


def shard_index(key: Any, num_shards: int) -> int:
    """Stable key -> shard routing (crc32: identical across processes
    and runs, unlike ``hash`` under PYTHONHASHSEED)."""
    if num_shards <= 1:
        return 0
    if isinstance(key, bytes):
        raw = key
    else:
        raw = str(key).encode()
    return zlib.crc32(raw) % num_shards


class _KvShard:
    __slots__ = ("lock", "items")

    def __init__(self):
        self.lock = threading.Lock()
        # key -> (seq, value); seq is the global insertion stamp used to
        # reconstruct 1-shard iteration order in merged views.
        self.items: dict[Any, tuple[int, Any]] = {}


class ShardedKv(MutableMapping):
    """A MutableMapping sharded by key hash with per-shard locks.

    Drop-in for the GCS ``_kv`` / ``_actors`` dict tables: point reads
    and writes take exactly one shard lock; iteration / ``keys(prefix)``
    merge across shards in global insertion order, so snapshot and
    restore see the same ordering a plain dict gave.
    """

    def __init__(self, num_shards: int = 8, initial: dict | None = None):
        self._n = max(1, int(num_shards))
        self._shards = [_KvShard() for _ in range(self._n)]
        self._seq = itertools.count(1)  # .__next__ is atomic in CPython
        if initial:
            for k, v in initial.items():
                self[k] = v

    # ------------------------------------------------------------ mapping
    def _shard(self, key: Any) -> _KvShard:
        return self._shards[shard_index(key, self._n)]

    def __getitem__(self, key: Any) -> Any:
        shard = self._shard(key)
        with shard.lock:
            return shard.items[key][1]

    def __setitem__(self, key: Any, value: Any) -> None:
        shard = self._shard(key)
        with shard.lock:
            prev = shard.items.get(key)
            # Overwrites keep their original position, like a dict.
            seq = prev[0] if prev is not None else next(self._seq)
            shard.items[key] = (seq, value)

    def __delitem__(self, key: Any) -> None:
        shard = self._shard(key)
        with shard.lock:
            del shard.items[key]

    def __contains__(self, key: Any) -> bool:
        shard = self._shard(key)
        with shard.lock:
            return key in shard.items

    def __len__(self) -> int:
        return sum(len(s.items) for s in self._shards)

    def __iter__(self) -> Iterator:
        return iter([k for k, _ in self._merged()])

    def _merged(self) -> list[tuple[Any, Any]]:
        rows: list[tuple[int, Any, Any]] = []
        for shard in self._shards:
            with shard.lock:
                rows.extend((seq, k, v) for k, (seq, v) in shard.items.items())
        rows.sort(key=lambda r: r[0])
        return [(k, v) for _, k, v in rows]

    # dict-parity conveniences used by the GCS tables
    def values(self):
        return [v for _, v in self._merged()]

    def items(self):
        return self._merged()

    def keys(self):
        return [k for k, _ in self._merged()]

    def to_dict(self) -> dict:
        """Plain-dict snapshot in insertion order (persistence path)."""
        return dict(self._merged())

    def keys_with_prefix(self, prefix: str) -> list:
        return [k for k, _ in self._merged()
                if isinstance(k, str) and k.startswith(prefix)]
