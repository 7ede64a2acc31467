"""The port's compiled graphs (``ray_tpu_torch.dag``) on a port cluster,
on the CPU, mirroring ``tests/test_dag.py``: one-shot ``CompiledDAG``
rounds (linear, fan-out, an error, the timeout teardown, the
``collective.allreduce`` node) and ``compile_loop`` (streaming in order,
errors per iteration, backpressure bounding ``in_flight``, pinned stage
workers, the cascade after a stage death, stall attribution, the tick
metrics and spans); and a chaos plan installed, registered and
uninstalled on that cluster."""

import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.core import api as core_api
from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.dag import (InputNode, MultiOutputNode, collective,
                               compile_loop)
from ray_tpu_torch.dag.channel import ChannelClosed
from ray_tpu_torch.dag.loop import live_loop_stats


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
    """Makes actors for one test and kills them after it, so that no
    test's leases outlive it."""
    made = []

    def make(cls, *args):
        handle = cls.remote(*args)
        made.append(handle)
        return handle

    yield make
    for handle in made:
        try:
            rt.kill(handle)
        except Exception:
            pass


@rt.remote
class Adder:
    def __init__(self, k):
        self.k = k
        self.calls = 0

    def add(self, x):
        self.calls += 1
        return x + self.k

    def boom(self, x):
        if x == 13:
            raise ValueError("unlucky")
        return x * 2

    def call_count(self):
        return self.calls


@rt.remote
class Sleeper:
    def work(self, x):
        if x == "slow":
            time.sleep(5.0)
        return x


@rt.remote
class Shard:
    def __init__(self, scale):
        self.scale = scale

    def grad(self, x):
        return np.asarray(x, dtype=np.float64) * self.scale


def _chain(actors, k1=1, k2=10):
    a, b = actors(Adder, k1), actors(Adder, k2)
    with InputNode() as inp:
        dag = b.add.bind(a.add.bind(inp))
    return a, b, dag


def test_linear_pipeline_repeated_execute(actors):
    a, _, dag = _chain(actors)
    compiled = dag.experimental_compile()
    try:
        for i in range(10):
            assert compiled.execute(i) == i + 11
    finally:
        compiled.teardown()
    # After teardown the actor serves normal calls again, and its loop
    # ran as ONE task: 10 executes submitted no task each.
    assert rt.get(a.call_count.remote(), timeout=60) == 10


def test_fan_out_error_and_compile_checks(actors):
    a, b, c = actors(Adder, 0), actors(Adder, 100), actors(Adder, 1000)
    with InputNode() as inp:
        mid = a.boom.bind(inp)
        dag = MultiOutputNode([b.add.bind(mid), c.add.bind(mid)])
    compiled = dag.experimental_compile()
    try:
        assert compiled.execute(5) == (110, 1010)
        with pytest.raises(ValueError, match="unlucky"):
            compiled.execute(13)
        # the error drained both outputs: the next round is fresh
        assert compiled.execute(7) == (114, 1014)
    finally:
        compiled.teardown()
    with pytest.raises(ValueError, match="upstream"):
        a.add.bind(41).experimental_compile()  # no InputNode anywhere
    with InputNode() as inp:
        reused = a.add.bind(a.add.bind(inp))
    with pytest.raises(ValueError, match="one node per actor"):
        reused.experimental_compile()
    with pytest.raises(ValueError, match="one node per actor"):
        compile_loop(reused)


def test_execute_timeout_tears_down_instead_of_wedging(actors):
    s = actors(Sleeper)
    with InputNode() as inp:
        dag = s.work.bind(inp)
    compiled = dag.experimental_compile()
    try:
        assert compiled.execute("fast") == "fast"
        with pytest.raises(TimeoutError):
            compiled.execute("slow", timeout=0.5)
        t0 = time.monotonic()
        with pytest.raises(ChannelClosed):
            compiled.execute("after", timeout=10.0)
        assert time.monotonic() - t0 < 5.0, "post-timeout execute hung"
    finally:
        compiled.teardown()


def test_allreduce_collective_node(actors):
    shards = [actors(Shard, s) for s in (1.0, 2.0, 3.0)]
    with InputNode() as inp:
        dag = collective.allreduce.bind([s.grad.bind(inp) for s in shards],
                                        op="mean")
    compiled = dag.experimental_compile()
    try:
        np.testing.assert_allclose(compiled.execute([1.0, 2.0]), [2.0, 4.0])
        np.testing.assert_allclose(compiled.execute([3.0, 0.0]), [6.0, 0.0])
    finally:
        compiled.teardown()
    with pytest.raises(ValueError, match="unknown allreduce op"):
        collective.allreduce.bind([1, 2], op="median")


def test_compiled_loop_streams_in_order_with_errors_per_iteration(actors):
    """One submit per stage parks the tick executors; put()/get() then
    stream iterations with no task per tick, in order, and a stage error
    surfaces on ITS iteration's get() while fan-out outputs stay aligned."""
    a, b, c = actors(Adder, 0), actors(Adder, 5), actors(Adder, 100)
    with InputNode() as inp:
        mid = a.boom.bind(inp)
        dag = MultiOutputNode([b.add.bind(mid), c.add.bind(mid)])
    loop = compile_loop(dag, credits=3)
    try:
        for i in range(3):  # pipelined: puts ahead of gets
            loop.put(i)
        assert [loop.get() for _ in range(3)] == \
            [(5, 100), (7, 102), (9, 104)]
        loop.put(13)
        loop.put(3)
        with pytest.raises(ValueError, match="unlucky"):
            loop.get()
        assert loop.get() == (11, 106)  # the round after the error, aligned
        assert loop.run(1) == (7, 102)
        assert loop.in_flight == 0 and loop.credits == 3
    finally:
        loop.teardown()
    assert rt.get(b.call_count.remote(), timeout=60) == 5
    with pytest.raises(ChannelClosed):
        loop.put(0)


def test_compiled_loop_backpressure_bounds_in_flight(actors):
    """Nobody consumes the outputs: put() stops accepting after a bounded
    number of iterations (credits per hop) instead of queueing."""
    _, _, dag = _chain(actors, 1, 1)
    loop = compile_loop(dag, credits=2)
    try:
        accepted = 0
        with pytest.raises(TimeoutError):
            for _ in range(50):
                loop.put(0, timeout=1.0)
                accepted += 1
        # 3 channels x 2 credits + one in flight per stage = 8 at most
        assert 2 <= accepted <= 10, accepted
        assert loop.in_flight == accepted
        for _ in range(accepted):
            assert loop.get() == 2
    finally:
        loop.teardown()


def test_compiled_loop_pins_and_unpins_stage_workers(actors):
    """The raylet knows the stage workers park a loop (loop_pinned), so its
    orphan-lease scan never reclaims one; teardown unpins."""
    raylet = core_api._node.raylet
    base = sum(1 for w in raylet._workers.values() if w.loop_pinned)
    _, _, dag = _chain(actors, 1, 2)
    loop = compile_loop(dag)
    try:
        assert loop.run(0) == 3
        pinned = [w for w in raylet._workers.values() if w.loop_pinned]
        assert len(pinned) - base == 2
        victim = pinned[0]
        victim.lease_acked = False
        victim.lease_granted_at = 1.0  # ancient
        saved_addr, victim.address = victim.address, ""  # no probe possible
        orphans_before = raylet._orphan_leases_total
        try:
            core_api._node.services_loop.run_sync(
                raylet._scan_orphan_leases(get_config()), timeout=30)
            assert victim.state != "dead"
            assert raylet._orphan_leases_total == orphans_before
        finally:
            victim.address = saved_addr
            victim.lease_acked = True
    finally:
        loop.teardown()
    assert sum(1 for w in raylet._workers.values() if w.loop_pinned) == base
    assert loop.torn_down_in_s < 30.0


def test_compiled_loop_stage_death_cascades_teardown(actors):
    a, _, dag = _chain(actors)
    loop = compile_loop(dag, credits=2)
    try:
        assert loop.run(1) == 12
        rt.kill(a)  # lands through the GCS and the raylet, asynchronously
        t0 = time.monotonic()
        with pytest.raises(Exception):
            while time.monotonic() - t0 < 60.0:
                loop.put(3, timeout=10.0)
                loop.get(timeout=10.0)
                time.sleep(0.05)
            raise AssertionError("stage death never surfaced")
        assert time.monotonic() - t0 < 60.0
        assert loop.stats()["broken"]
    finally:
        loop.teardown()
    assert loop.torn_down_in_s < 30.0


def test_compiled_loop_stall_attribution_metrics_and_spans(actors):
    """Every stage records its per-tick wait_up/compute/wait_down split
    and flushes a node-local snapshot on the span cadence; stats() reads
    them with no actor RPC, names the bottleneck, and survives teardown
    as final_stats. The tick counter and the sampled dag.loop.tick spans
    reach the GCS."""
    cfg = get_config()
    saved = cfg.dag_loop_span_every
    cfg.dag_loop_span_every = 4  # shipped to the stage executors at compile
    try:
        _, _, dag = _chain(actors)
        loop = compile_loop(dag)
        try:
            for i in range(12):
                assert loop.run(i) == i + 11
            stats = loop.stats(fallback_gcs=False)
            assert stats["recording"] and set(stats["stages"]) == \
                {"add", "add#1"}
            for snap in stats["stages"].values():
                assert snap["ticks"] >= 4
                assert abs(sum(snap["frac"].values()) - 1.0) < 0.02
                assert snap["state"] in ("compute_bound", "starved",
                                         "backpressured")
            assert stats["bottleneck"] in stats["stages"]
            assert stats["puts"] == stats["gets"] == 12
            assert any(row["loop_id"] == loop.loop_id
                       for row in live_loop_stats())
        finally:
            loop.teardown()
    finally:
        cfg.dag_loop_span_every = saved
    final = loop.final_stats
    assert final is not None and final["bottleneck"] in final["stages"]
    assert all(s["ticks"] == 12 for s in final["stages"].values())
    assert not any(row["loop_id"] == loop.loop_id
                   for row in live_loop_stats())
    from ray_tpu_torch.core.worker import global_worker
    from ray_tpu_torch.util.metrics import get_metrics

    deadline = time.monotonic() + 20.0
    ticks, spans = 0, []
    while time.monotonic() < deadline and (ticks < 24 or not spans):
        ticks = sum(m["value"] for m in get_metrics()
                    if m["name"] == "ray_tpu_dag_loop_ticks_total"
                    and m["tags"].get("loop") == loop.loop_id)
        spans = [s for s in global_worker()._gcs_call(
            "ListSpans", {"trace_id": loop.loop_id, "limit": 1000})["spans"]
            if s.get("name") == "dag.loop.tick"]
        time.sleep(0.5)
    assert ticks == 24, ticks  # 12 iterations x 2 stages
    assert spans and {s["attrs"]["stage"] for s in spans} <= {"add", "add#1"}


def test_compiled_loop_stall_recording_disabled(actors):
    cfg = get_config()
    saved = cfg.dag_loop_stall_recording
    cfg.dag_loop_stall_recording = False
    try:
        _, _, dag = _chain(actors)
        loop = compile_loop(dag)
        try:
            for i in range(4):
                assert loop.run(i) == i + 11
            stats = loop.stats(fallback_gcs=False)
            assert stats["recording"] is False
            assert all(s["ticks"] == 0 for s in stats["stages"].values())
        finally:
            loop.teardown()
    finally:
        cfg.dag_loop_stall_recording = saved


def test_fault_plan_installs_registers_and_resolves_targets(cluster):
    """``chaos.install`` makes a compiled plan this process's chaos engine,
    resolves its abstract targets against the live cluster and registers
    it on the GCS; ``uninstall`` reverts both. The schedule is the JAX
    package's, byte for byte."""
    from ray_tpu.chaos import FaultPlan as JaxFaultPlan
    from ray_tpu_torch import chaos
    from ray_tpu_torch.core.rpc import get_chaos
    from ray_tpu_torch.core.worker import global_worker

    plan = {"name": "far-windows", "faults": [
        {"kind": "gcs_blackout", "start_s": 3600.0, "duration_s": 1.0},
        {"kind": "partition", "target": "node:0", "start_s": 3600.0,
         "duration_s": 1.0},
        {"kind": "kill_loop_stage", "prob": 0.25, "max_injections": 2}]}
    assert chaos.FaultPlan.from_dict(plan).compile(5).canonical_bytes() == \
        JaxFaultPlan.from_dict(plan).compile(5).canonical_bytes()
    engine = chaos.install(chaos.FaultPlan.from_dict(plan), 5, publish=False)
    try:
        assert get_chaos() is engine
        node = rt.nodes()[0]
        assert engine._partition_peers == {
            0: [global_worker().gcs_address], 1: [node["address"]]}
        assert not engine.peer_blocked(node["address"])  # window not open
        registered = chaos.active_plan()
        assert registered["name"] == "far-windows" and registered["seed"] == 5
        assert registered["digest"] == engine.schedule.digest()
    finally:
        chaos.uninstall()
    assert chaos.active_plan() is None
    assert get_chaos() is not engine
