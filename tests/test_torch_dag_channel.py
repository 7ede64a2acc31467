"""The port's channels and stall recorder against the JAX package's, with
no cluster: a ``Channel`` or ``RingChannel`` written by one package reads
in the other (the byte layouts are one), with credits, a full ring
blocking its writer, occupancy and close after drain; ``StallRing`` and
the classify functions give the JAX package's results on the same seeded
ticks."""

import threading

import numpy as np
import pytest

from ray_tpu.dag import channel as jax_channel
from ray_tpu.observability import loop_recorder as jax_recorder
from ray_tpu_torch.dag import channel as port_channel
from ray_tpu_torch.observability import loop_recorder as port_recorder

PAIRS = [(jax_channel, port_channel), (port_channel, jax_channel)]
IDS = ["jax_writes", "port_writes"]


@pytest.mark.parametrize("writer,reader", PAIRS, ids=IDS)
def test_ring_written_by_one_package_reads_in_the_other(tmp_path, writer,
                                                        reader):
    path = str(tmp_path / "ring")
    w = writer.RingChannel(path, 256, n_slots=4, n_readers=2, create=True)
    r0 = reader.RingChannel(path, 256, n_slots=4, reader_index=0)
    r1 = reader.RingChannel(path, 256, n_slots=4, reader_index=1)
    assert r0.n_readers == r1.n_readers == 2  # read from the creator's head
    for i in range(4):
        w.write(bytes([i]) * (i + 1))
    assert w.occupancy() == r0.occupancy() == 4
    with pytest.raises(TimeoutError):
        w.write(b"x", timeout=0.2)  # ring full: no credit
    assert [r0.read(timeout=5) for _ in range(4)] == \
        [bytes([i]) * (i + 1) for i in range(4)]
    with pytest.raises(TimeoutError):
        w.write(b"x", timeout=0.2)  # r1 is the slowest reader: still full
    assert [r1.read(timeout=5)[0] for _ in range(3)] == [0, 1, 2]
    assert w.occupancy() == 1
    w.write(b"\xff")  # the credit r1 released
    with pytest.raises(ValueError, match="exceeds ring slot size"):
        w.write(b"x" * 257)
    w.close_writer()
    assert r1.read(timeout=5) == b"\x03\x03\x03\x03"  # queue first
    assert r0.read(timeout=5) == r1.read(timeout=5) == b"\xff"
    for r in (r0, r1):
        with pytest.raises(reader.ChannelClosed):
            r.read(timeout=5)  # then STOP
        with pytest.raises(reader.ChannelClosed):
            r.read(timeout=5)  # and it is sticky
    for ch in (w, r0, r1):
        ch.close()


@pytest.mark.parametrize("writer,reader", PAIRS, ids=IDS)
def test_blocked_ring_writer_resumes_on_a_read_from_the_other_package(
        tmp_path, writer, reader):
    path = str(tmp_path / "ring")
    w = writer.RingChannel(path, 64, n_slots=2, create=True)
    r = reader.RingChannel(path, 64, n_slots=2, reader_index=0)
    w.write(b"a")
    w.write(b"b")
    done = threading.Event()

    def blocked_write():
        w.write(b"c", timeout=10)
        done.set()

    t = threading.Thread(target=blocked_write)
    t.start()
    assert not done.wait(0.2)  # full: the writer waits for credit
    assert r.read(timeout=5) == b"a"
    assert done.wait(5)
    t.join()
    assert [r.read(timeout=5) for _ in range(2)] == [b"b", b"c"]
    w.force_close()  # a dead writer's teardown: the reader stops at once
    with pytest.raises(reader.ChannelClosed):
        r.read(timeout=5)
    w.close()
    r.close()


@pytest.mark.parametrize("writer,reader", PAIRS, ids=IDS)
def test_channel_written_by_one_package_reads_in_the_other(tmp_path, writer,
                                                           reader):
    path = str(tmp_path / "ch")
    w = writer.Channel(path, 1024, create=True)
    r = reader.Channel(path, 1024)
    w.write(b"one")
    payload, seq = r.read(0, timeout=5)
    assert payload == b"one"
    with pytest.raises(TimeoutError):
        r.read(seq, timeout=0.1)  # nothing newer yet
    w.write(b"two")
    w.write(b"three")  # latest wins
    payload, seq = r.read(seq, timeout=5)
    assert payload == b"three" and seq == 6
    with pytest.raises(ValueError, match="exceeds channel capacity"):
        w.write(b"x" * 2048)
    w.close_writer()
    with pytest.raises(reader.ChannelClosed):
        r.read(seq, timeout=5)
    w.close()
    r.close()


def _ticks(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.01, 5.0, 3)
    return [tuple(float(x) for x in rng.exponential(scale))
            for _ in range(n)]


@pytest.mark.parametrize("n,capacity", [(0, 8), (5, 8), (8, 8), (37, 16)])
def test_stall_ring_drains_and_snapshots_as_jax(n, capacity):
    ticks = _ticks(n, n)
    rings = [jax_recorder.StallRing(capacity), port_recorder.StallRing(capacity)]
    drained = [[], []]
    for k, tick in enumerate(ticks):
        for j, ring in enumerate(rings):
            ring.record(*tick)
            if k % 5 == 4:
                drained[j].append(ring.drain())
    for j, ring in enumerate(rings):
        drained[j].append(ring.drain())
        drained[j].append(ring.drain())  # nothing new: empty
    assert drained[0] == drained[1]
    assert drained[1][-1] == []
    assert rings[0].snapshot() == rings[1].snapshot()
    assert rings[1].overflowed == (n > capacity)


def test_classify_stage_and_loop_as_jax():
    rng = np.random.default_rng(7)
    stages = {}
    for i in range(40):
        w = rng.dirichlet(np.ones(3))
        frac = dict(zip(port_recorder.STALL_BUCKETS, map(float, w)))
        ticks = int(rng.integers(0, 3))
        assert port_recorder.classify_stage(frac, ticks) == \
            jax_recorder.classify_stage(frac, ticks)
        stages[f"s{i}"] = {"frac": frac, "ticks": ticks}
    for frac in (None, {}, {"compute": 0.5}, {"wait_up": 0.3, "wait_down": 0.3}):
        assert port_recorder.classify_stage(frac, 1) == \
            jax_recorder.classify_stage(frac, 1)
    assert port_recorder.classify_loop(stages) == \
        jax_recorder.classify_loop(stages) is not None
    assert port_recorder.classify_loop({}) is None
    assert port_recorder.STALL_BUCKETS == jax_recorder.STALL_BUCKETS
    assert port_recorder.TICK_MS_BOUNDARIES == jax_recorder.TICK_MS_BOUNDARIES


def test_stall_ring_registry_is_bounded_and_keyed_by_loop():
    first = port_recorder.get_stall_ring("loop-a", "step", 4)
    assert port_recorder.get_stall_ring("loop-a", "step") is first
    first.record(1.0, 2.0, 3.0)
    snaps = port_recorder.stall_snapshots("loop-a")
    assert list(snaps) == ["step"] and snaps["step"]["ticks"] == 1
    for i in range(port_recorder._RINGS_MAX):
        port_recorder.get_stall_ring(f"loop-{i}", "x")
    assert len(port_recorder._rings) == port_recorder._RINGS_MAX
    assert port_recorder.stall_snapshots("loop-a") == {}  # evicted first


@pytest.mark.parametrize("writer,reader", PAIRS, ids=IDS)
def test_tcp_channel_speaks_the_other_package_s_frames(writer, reader):
    """The one-shot DAG's cross-node edge: latest wins and STOP overrides
    the slot. (A read that times out leaves its request answered later,
    so the DAG tears down after one; no case here times out.)"""
    server = writer.TcpChannelServer(host="127.0.0.1")
    r = reader.TcpChannelReader(server.address)
    try:
        server.write(b"one")
        payload, seq = r.read(0, timeout=5)
        assert bytes(payload) == b"one" and seq == 1
        server.write(b"two")
        server.write(b"three")
        payload, seq = r.read(seq, timeout=5)
        assert bytes(payload) == b"three" and seq == 3
        server.close_writer()
        with pytest.raises(reader.ChannelClosed):
            r.read(seq, timeout=5)
    finally:
        r.close()
        server.close()
