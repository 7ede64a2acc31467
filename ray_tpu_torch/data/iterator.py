"""DataIterator: batch iteration and train-worker stream splitting.

Reference: ``python/ray/data/iterator.py:94`` (iter_batches) and
``dataset.py:1598`` streaming_split via a SplitCoordinator actor feeding
one iterator per train worker.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from ..core import api as ray
from .block import BlockAccessor, concat_blocks, num_rows, slice_block


def batches_from_blocks(
    block_iter,
    *,
    batch_size: int | None,
    batch_format: str = "numpy",
    drop_last: bool = False,
) -> Iterator:
    """Re-slice a stream of blocks into fixed-size batches."""
    if batch_size is None:
        for block in block_iter:
            if num_rows(block):
                yield BlockAccessor.for_block(block).to_batch(batch_format)
        return
    carry = []
    carry_rows = 0
    for block in block_iter:
        carry.append(block)
        carry_rows += num_rows(block)
        while carry_rows >= batch_size:
            merged = concat_blocks(carry)
            batch = slice_block(merged, 0, batch_size)
            rest = slice_block(merged, batch_size, num_rows(merged))
            carry = [rest] if num_rows(rest) else []
            carry_rows = num_rows(rest)
            yield BlockAccessor.for_block(batch).to_batch(batch_format)
    if carry_rows and not drop_last:
        merged = concat_blocks(carry)
        yield BlockAccessor.for_block(merged).to_batch(batch_format)


class SplitCoordinator:
    """Actor that owns a dataset's output stream and deals blocks to n
    consumers (reference: StreamSplitDataIterator's coordinator).

    Blocks are dealt round-robin to per-split queues so every consumer gets
    a fair share regardless of polling order. Scheduled with num_cpus=0
    (it only shuffles refs) so it never starves the cluster."""

    def __init__(self, dataset, n: int, equal: bool = False):
        self._iter = dataset.iter_internal_ref_bundles()
        self._n = n
        self._equal = equal
        self._queues: list[list] = [[] for _ in range(n)]
        self._delivered = [0] * n
        self._next_split = 0
        self._exhausted = False
        self._finished: set[int] = set()

    def _pull_until(self, split_idx: int) -> None:
        while not self._queues[split_idx] and not self._exhausted:
            try:
                ref = next(self._iter)
            except StopIteration:
                self._exhausted = True
                if self._equal:
                    # equal=True: trim trailing imbalance so every split
                    # sees the same number of blocks (reference: equal
                    # splits drop the remainder).
                    floor = min(self._delivered[i] + len(self._queues[i]) for i in range(self._n))
                    for i in range(self._n):
                        excess = self._delivered[i] + len(self._queues[i]) - floor
                        if excess > 0:
                            del self._queues[i][-excess:]
                return
            self._queues[self._next_split].append(ref)
            self._next_split = (self._next_split + 1) % self._n

    def next_block_ref(self, split_idx: int):
        """Returns the next block ref for this split, or None when its
        share of the stream is exhausted."""
        self._pull_until(split_idx)
        if self._queues[split_idx]:
            self._delivered[split_idx] += 1
            return self._queues[split_idx].pop(0)
        return None

    def mark_finished(self, split_idx: int) -> bool:
        """Consumer i is done; returns True when ALL consumers are done
        (the last one kills this actor to release its slot)."""
        self._finished.add(split_idx)
        return len(self._finished) >= self._n


class DataIterator:
    """Per-worker view of a split stream."""

    def __init__(self, coordinator, split_idx: int):
        self._coord = coordinator
        self._idx = split_idx
        self._exhausted = False

    def _blocks(self):
        if self._exhausted:
            return  # second epoch over a drained one-shot stream is empty
        from ..core.status import ActorDiedError

        while True:
            try:
                ref = ray.get(self._coord.next_block_ref.remote(self._idx), timeout=120)
            except ActorDiedError:
                # coordinator reclaimed by another consumer's final kill
                self._exhausted = True
                return
            if ref is None:
                self._exhausted = True
                # Last finished consumer reclaims the coordinator actor so a
                # leaked slot can't starve later scheduling (advisor round 1).
                try:
                    all_done = ray.get(self._coord.mark_finished.remote(self._idx), timeout=30)
                    if all_done:
                        ray.kill(self._coord)
                except Exception:
                    pass
                return
            yield ray.get(ref, timeout=120)

    def iter_batches(self, *, batch_size: int | None = 256,
                     batch_format: str = "numpy", drop_last: bool = False):
        return batches_from_blocks(
            self._blocks(), batch_size=batch_size,
            batch_format=batch_format, drop_last=drop_last,
        )

    def iter_rows(self):
        for block in self._blocks():
            yield from BlockAccessor.for_block(block).iter_rows()

    def to_device_batches(self, *, batch_size: int, device=None, sharding=None,
                          batch_format: str = "numpy", drop_last: bool = True):
        """Batches as tensors on ``device`` (``None``: the card), with one
        batch of lookahead: each host batch is copied into pinned memory
        and sent with ``non_blocking=True`` while the caller still works
        on the batch before it. ``sharding`` (meshes) is not ported yet.

        On the card the copy runs on the current stream, so a later
        kernel on that stream sees the whole batch; PyTorch's pinned-memory
        allocator keeps each buffer until its copy is done."""
        if sharding is not None:
            raise NotImplementedError(
                "sharding= is not ported yet: ROADMAP queue A item 7 "
                "(meshes on DeviceMesh and DTensor)")
        import torch

        from .._device import resolve_device

        device = resolve_device(device)
        pin = device.type == "cuda"

        def send(batch):
            out = {}
            for k, v in batch.items():
                v = np.ascontiguousarray(v)
                if not v.flags.writeable:  # a block read from the store
                    v = v.copy()
                t = torch.from_numpy(v)
                if pin:
                    t = t.pin_memory()
                out[k] = t.to(device, non_blocking=pin)
            return out

        prev = None
        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format=batch_format,
                                       drop_last=drop_last):
            cur = send(batch)
            if prev is not None:
                yield prev
            prev = cur
        if prev is not None:
            yield prev
