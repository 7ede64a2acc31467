"""Ray Client (``ray://``) on the port: ``tests/test_client.py``'s five
cases on a port cluster, each with the ``ray://`` driver in a separate
process: tasks, puts, waits, actors and a named actor; streaming
generators; an actor's concurrency group; a crashed client's session
reaped; an expired session failing fast."""

import os
import subprocess
import sys
import textwrap
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.worker import global_worker
from ray_tpu_torch.util.client import ClientServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def cluster():
    # tests/conftest.py shuts down only ray_tpu's cluster.
    rt.init(num_cpus=4)
    try:
        yield
    finally:
        rt.shutdown()


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO)


def test_client_mode_end_to_end():
    """A SEPARATE python process connects via ray:// and uses the normal
    API: tasks, puts/gets, ref args, actors, named actors, wait."""
    server = ClientServer(port=0)
    reg = None
    try:
        @rt.remote
        class Registry:
            def __init__(self):
                self.items = []

            def add(self, x):
                self.items.append(x)
                return len(self.items)

        reg = Registry.options(name="client_registry",
                               lifetime="detached").remote()
        assert rt.get(reg.add.remote("seed"), timeout=60) == 1

        proc = _run(f"""
            import ray_tpu_torch as rt
            info = rt.init(address="ray://{server.address}")
            assert info["node_id"] == "client", info

            @rt.remote
            def double(x):
                return x * 2

            a = double.remote(21)
            b = double.remote(a)
            assert rt.get(b, timeout=120) == 84

            ref = rt.put({{"k": [1, 2, 3]}})
            assert rt.get(ref, timeout=60) == {{"k": [1, 2, 3]}}
            ready, not_ready = rt.wait([a, b], num_returns=2, timeout=60)
            assert len(ready) == 2 and not not_ready

            @rt.remote
            class Counter:
                def __init__(self):
                    self.n = 0
                def inc(self, k):
                    self.n += k
                    return self.n
            c = Counter.remote()
            assert rt.get(c.inc.remote(5), timeout=120) == 5
            assert rt.get(c.inc.remote(2), timeout=60) == 7

            reg = rt.get_actor("client_registry")
            assert rt.get(reg.add.remote("from-client"), timeout=60) == 2

            @rt.remote(max_retries=0)
            def boom():
                raise ValueError("client boom")
            try:
                rt.get(boom.remote(), timeout=60)
                raise SystemExit("no error raised")
            except ValueError as e:
                assert "client boom" in str(e)

            rt.shutdown()
            print("CLIENT_OK")
        """)
        assert "CLIENT_OK" in proc.stdout, proc.stderr[-2000:]
        # cluster-side state mutated by the client is visible here
        assert rt.get(reg.add.remote("post"), timeout=60) == 3
    finally:
        server.stop()
        if reg is not None:
            rt.kill(reg)


def test_client_streaming_generator():
    """num_returns="streaming" over ray://: the proxy holds the real
    ObjectRefGenerator, the client iterates refs one round trip at a time,
    and close() cancels the producer."""
    server = ClientServer(port=0)
    try:
        proc = _run(f"""
            import ray_tpu_torch as rt
            rt.init(address="ray://{server.address}")

            @rt.remote(num_returns="streaming")
            def counter(n):
                for i in range(n):
                    yield i * 10

            gen = counter.remote(5)
            values = [rt.get(ref, timeout=60) for ref in gen]
            assert values == [0, 10, 20, 30, 40], values

            gen2 = counter.remote(1000)
            assert rt.get(next(gen2), timeout=60) == 0
            gen2.close()

            @rt.remote
            class Streamer:
                def gen(self, n):
                    for i in range(n):
                        yield i + 100
            st = Streamer.remote()
            g = st.gen.options(num_returns="streaming").remote(3)
            vals = [rt.get(r, timeout=60) for r in g]
            assert vals == [100, 101, 102], vals

            rt.shutdown()
            print("STREAM_OK")
        """)
        assert "STREAM_OK" in proc.stdout, proc.stderr[-2000:]
    finally:
        server.stop()


def test_client_actor_method_concurrency_group():
    """``ActorMethod.remote`` always passes ``concurrency_group=``: the
    client worker accepts and forwards it, including a group chosen with
    ``.options(concurrency_group=...)``."""
    server = ClientServer(port=0)
    try:
        proc = _run(f"""
            import ray_tpu_torch as rt
            rt.init(address="ray://{server.address}")

            @rt.remote(concurrency_groups={{"io": 2}})
            class Grouped:
                def plain(self):
                    return "ok"
                def fetch(self):
                    return "io-ok"

            g = Grouped.remote()
            assert rt.get(g.plain.remote(), timeout=120) == "ok"
            assert rt.get(g.fetch.options(concurrency_group="io").remote(),
                          timeout=60) == "io-ok"
            rt.shutdown()
            print("CG_OK")
        """)
        assert "CG_OK" in proc.stdout, proc.stderr[-2000:]
    finally:
        server.stop()


def _client_jobs(worker) -> list:
    return [j for j in worker._gcs_call("GetAllJobs", {})["jobs"]
            if str(j.get("driver_address", "")).startswith("ray-client:")]


def test_client_crash_reaps_session():
    """A client that dies WITHOUT disconnecting stops pinging; the proxy
    reaps the session: its actors are killed and its job finishes."""
    cfg = get_config()
    old = cfg.client_session_timeout_s
    cfg.client_session_timeout_s = 3.0
    server = ClientServer(port=0)
    try:
        proc = _run(f"""
            import os
            import ray_tpu_torch as rt
            rt.init(address="ray://{server.address}")

            @rt.remote
            class Held:
                def ping(self):
                    return "alive"

            h = Held.remote()
            assert rt.get(h.ping.remote(), timeout=120) == "alive"
            print("ACTOR_UP")
            os._exit(1)  # crash: no disconnect, no more pings
        """)
        assert "ACTOR_UP" in proc.stdout, proc.stderr[-2000:]
        worker = global_worker()
        assert _client_jobs(worker)

        deadline = time.time() + 30
        while time.time() < deadline:
            actors = worker._gcs_call("ListActors", {}).get("actors", [])
            held = [a for a in actors if a.get("class_name") == "Held"
                    and a.get("state") == "ALIVE"]
            cj = _client_jobs(worker)
            if not held and all(j.get("state") == "FINISHED" for j in cj):
                break
            time.sleep(0.5)
        assert not held, f"session actor survived the reap: {held}"
        assert all(j.get("state") == "FINISHED" for j in cj), cj
    finally:
        cfg.client_session_timeout_s = old
        server.stop()


def test_client_session_expiry_fails_fast():
    """A client partitioned past the session timeout is NOT silently
    resurrected: its next call fails with 'session expired'."""
    cfg = get_config()
    old_t, old_p = cfg.client_session_timeout_s, cfg.client_ping_interval_s
    cfg.client_session_timeout_s = 2.0
    cfg.client_ping_interval_s = 30.0  # the client will not ping in time
    server = ClientServer(port=0)
    try:
        proc = _run(f"""
            import time
            import ray_tpu_torch as rt
            rt.init(address="ray://{server.address}")
            rt.put(1)
            time.sleep(7)  # reaped server-side meanwhile
            try:
                rt.put(2)
                raise SystemExit("no error raised")
            except Exception as e:
                assert "session expired" in str(e), str(e)
            print("EXPIRED_OK")
        """)
        assert "EXPIRED_OK" in proc.stdout, proc.stderr[-2000:]
    finally:
        cfg.client_session_timeout_s = old_t
        cfg.client_ping_interval_s = old_p
        server.stop()


def test_client_server_listens_on_loopback():
    """The port's ClientServer binds loopback unless told otherwise."""
    server = ClientServer(port=0)
    try:
        assert server.address.startswith("127.0.0.1:"), server.address
    finally:
        server.stop()
