"""The port's actor pools, distributed queue and ``multiprocessing.Pool``
(``ray_tpu_torch.util``) on a port cluster, on the CPU:
``tests/test_util.py``'s cases, and ``_chunks`` against the JAX
package's."""

import pytest

import ray_tpu_torch as rt
from ray_tpu.util.multiprocessing import _chunks as jax_chunks
from ray_tpu_torch.util import ActorPool
from ray_tpu_torch.util.multiprocessing import Pool, _chunks
from ray_tpu_torch.util.queue import Empty, Full, Queue


@pytest.fixture(scope="module")
def cluster():
    # tests/conftest.py shuts down only ray_tpu's cluster, so this module
    # shuts its own down.
    rt.init(num_cpus=4)
    try:
        yield
    finally:
        rt.shutdown()


@pytest.fixture
def actors(cluster):
    """Makes actors for one test and kills them after it."""
    made = []

    def make(cls, n):
        handles = [cls.remote() for _ in range(n)]
        made.extend(handles)
        return handles

    yield make
    for handle in made:
        try:
            rt.kill(handle)
        except Exception:
            pass


def _doubler():
    @rt.remote
    class Doubler:
        def double(self, x):
            return 2 * x

    return Doubler


def test_actor_pool_ordered(actors):
    pool = ActorPool(actors(_doubler(), 2))
    assert list(pool.map(lambda a, v: a.double.remote(v), range(8))) == \
        [2 * i for i in range(8)]


def test_actor_pool_unordered_and_backpressure(actors):
    pool = ActorPool(actors(_doubler(), 2))
    for i in range(6):  # more submits than actors: queued internally
        pool.submit(lambda a, v: a.double.remote(v), i)
    assert not pool.has_free()
    out = set()
    while pool.has_next():
        out.add(pool.get_next_unordered(timeout=60))
    assert out == {2 * i for i in range(6)}
    assert pool.has_free()


def test_actor_pool_survives_task_errors(actors):
    """A raising task surfaces its error and returns the actor to the
    pool; later submits still run."""
    @rt.remote
    class Worker:
        def run(self, x):
            if x == 1:
                raise ValueError("boom")
            return x

    pool = ActorPool(actors(Worker, 1))
    for i in range(3):
        pool.submit(lambda a, v: a.run.remote(v), i)
    results, errors = [], 0
    while pool.has_next():
        try:
            results.append(pool.get_next(timeout=60))
        except ValueError:
            errors += 1
    assert errors == 1 and results == [0, 2]


def test_queue_batch_ops_are_all_or_nothing(cluster):
    q = Queue(maxsize=3)
    try:
        q.put(0)
        with pytest.raises(Full):
            q.put_nowait_batch([1, 2, 3])  # would exceed maxsize
        assert q.qsize() == 1  # nothing partially inserted
        q.put_nowait_batch([1, 2])
        with pytest.raises(Empty):
            q.get_nowait_batch(4)  # only 3 available
        assert q.qsize() == 3  # nothing discarded
        assert q.get_nowait_batch(3) == [0, 1, 2]
    finally:
        q.shutdown()


def test_queue_fifo_and_batches(cluster):
    q = Queue()
    try:
        for i in range(5):
            q.put(i)
        assert q.qsize() == 5
        assert [q.get(timeout=10) for _ in range(5)] == [0, 1, 2, 3, 4]
        with pytest.raises(Empty):
            q.get_nowait()
        q.put_nowait_batch([1, 2, 3])
        assert q.get_nowait_batch(3) == [1, 2, 3]
    finally:
        q.shutdown()


def test_queue_maxsize(cluster):
    q = Queue(maxsize=2)
    try:
        q.put(1)
        q.put(2)
        assert q.full()
        with pytest.raises(Full):
            q.put(3, block=False)
        assert q.get(timeout=10) == 1
        q.put(3, timeout=10)  # space freed
    finally:
        q.shutdown()


def test_queue_cross_task(cluster):
    """The queue handle pickles into a task; producer and consumer see one
    FIFO order."""
    q = Queue()

    @rt.remote
    def producer(q, n):
        for i in range(n):
            q.put(i)
        return True

    try:
        assert rt.get(producer.remote(q, 4), timeout=60)
        assert [q.get(timeout=10) for _ in range(4)] == [0, 1, 2, 3]
    finally:
        q.shutdown()


def test_mp_pool_map_and_imap(cluster):
    def sq(x):
        return x * x

    with Pool(2) as p:
        assert p.map(sq, range(6)) == [0, 1, 4, 9, 16, 25]
        assert list(p.imap(sq, range(5), chunksize=2)) == [0, 1, 4, 9, 16]
        assert sorted(p.imap_unordered(sq, range(6), chunksize=2)) == \
            [0, 1, 4, 9, 16, 25]
        r = p.apply_async(sq, (7,))
        assert r.get(timeout=60) == 49 and r.ready() and r.successful()
        assert p.apply(sq, (3,)) == 9
        assert p.starmap(lambda a, b: a - b, [(5, 2), (1, 1)]) == [3, 0]


@pytest.mark.parametrize("n,size", [(0, 1), (1, 1), (7, 2), (8, 4), (5, 9)])
def test_chunks_equal_jax(n, size):
    assert list(_chunks(range(n), size)) == list(jax_chunks(range(n), size))
    assert list(_chunks(iter(range(n)), size)) == \
        list(jax_chunks(iter(range(n)), size))


def test_ordered_map_after_unordered(actors):
    """An ordered ``map`` after an unordered one on the same pool returns
    its own results (the reference's ``get_next_unordered`` moves the
    ordered cursor past what it returned; the JAX package's does not, and
    its next ``get_next`` raises ``KeyError``)."""
    pool = ActorPool(actors(_doubler(), 2))
    assert sorted(pool.map_unordered(lambda a, v: a.double.remote(v),
                                     range(4))) == [0, 2, 4, 6]
    assert list(pool.map(lambda a, v: a.double.remote(v), range(3))) == \
        [0, 2, 4]
