"""The always-warm fleet's promotion ladder in the port
(``LLMDeployment.fleet_promote``, ``open_weight_stream``): a donor's
broadcast stream, the host-RAM copy when the donor dies mid-stream, and
the cold re-init from the deployment's seed when the donor is
unreachable and the host copy is gone, each proved by
``params_fingerprint`` (JAX ``tests/test_fleet.py:250-305``); then the
serve-level park and wake on a port cluster (JAX ``:330-373``), read
through the port's ``util.state.serve_fleet``.
"""

import json
import time
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.llm import LLMDeployment, build_llm_app
from ray_tpu_torch.llm.weights import params_fingerprint
from ray_tpu_torch.util import state

GEOMETRY = dict(max_slots=2, max_len=64, page_size=8, prefill_chunk_size=32)


@pytest.fixture(scope="module")
def replica():
    dep = LLMDeployment("debug-128", seed=3, device="cpu", **GEOMETRY)
    try:
        yield dep
    finally:
        dep.close()


def test_fleet_stats_and_the_host_rung(replica):
    assert replica.generate("hi", max_new_tokens=4)["num_generated"] == 4
    row = replica.fleet_stats()
    assert row["residency_capable"] and not row["weights_on_host"]
    assert replica.fleet_demote()["ok"]
    assert replica.fleet_stats()["weights_on_host"]
    out = replica.fleet_promote()
    assert out["ok"] and out["path"] == "host"
    assert replica.fleet_promote()["path"] == "resident"


def test_promote_via_broadcast_stream(replica):
    want = params_fingerprint(replica.engine.executor.params)
    donor = replica.open_weight_stream(n_readers=1)
    assert donor["fingerprint"] == want
    assert replica.fleet_demote()["ok"]
    out = replica.fleet_promote(donor["weight_address"])
    assert out["ok"] and out["path"] == "stream"
    assert params_fingerprint(replica.engine.executor.params) == want


def test_donor_death_falls_back_to_the_host_copy(replica):
    want = params_fingerprint(replica.engine.executor.params)
    donor = replica.open_weight_stream(n_readers=1, _die_after_chunks=1)
    assert replica.fleet_demote()["ok"]
    out = replica.fleet_promote(donor["weight_address"])
    assert out["ok"] and out["path"] == "host"
    assert out["ladder"][0].startswith("stream:")
    assert params_fingerprint(replica.engine.executor.params) == want
    assert replica.generate("ok", max_new_tokens=4)["num_generated"] == 4


def test_cold_init_reproduces_the_seeded_weights(replica):
    """A dead donor and a lost host copy: the last rung re-inits from the
    seed, bit for bit, and serves the same tokens."""
    want = params_fingerprint(replica.engine.executor.params)
    tokens = replica.generate("cold", max_new_tokens=6)["tokens"]
    assert replica.fleet_demote()["ok"]
    replica.engine._host_params = None  # the host tier is lost
    out = replica.fleet_promote("127.0.0.1:1")
    assert out["ok"] and out["path"] == "cold_init", out
    assert [r.split(":")[0] for r in out["ladder"]] == ["stream", "host"]
    assert params_fingerprint(replica.engine.executor.params) == want
    assert replica.generate("cold", max_new_tokens=6)["tokens"] == tokens
    other = LLMDeployment("debug-128", seed=4, device="cpu", **GEOMETRY)
    try:
        assert params_fingerprint(other.engine.executor.params) != want
    finally:
        other.close()


def test_serve_fleet_is_empty_without_serve():
    assert state.serve_fleet() == {}


def _get(addr: str, path: str) -> dict:
    with urllib.request.urlopen(addr + path, timeout=120) as f:
        return json.loads(f.read())


def _wait_for(pred, timeout: float = 60.0) -> dict | None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        row = state.serve_fleet().get("fleet#LLMDeployment") or {}
        if pred(row):
            return row
        time.sleep(0.25)
    return None


def test_scale_to_zero_and_wake_through_the_state_api():
    rt.init(num_cpus=4)
    try:
        serve.run(build_llm_app(
            "debug-128", device="cpu", num_replicas=1,
            max_ongoing_requests=2, attention_impl="dense",
            autoscaling_config={"min_replicas": 1, "max_replicas": 2,
                                "scale_to_zero_idle_s": 2.0}, **GEOMETRY),
            name="fleet", route_prefix="/fleet")
        addr = serve.http_address()
        assert _get(addr, "/fleet?prompt=hi&max_new_tokens=4")[
            "num_generated"] == 4
        parked = _wait_for(lambda r: r.get("scaled_to_zero")
                           and r.get("running") == 0
                           and r.get("standby", 0) >= 1
                           and r["fleet"].get("host_resident", 0) >= 1)
        assert parked is not None, state.serve_fleet()
        assert _get(addr, "/fleet?prompt=again&max_new_tokens=4")[
            "num_generated"] == 4
        woke = _wait_for(lambda r: not r.get("scaled_to_zero")
                         and r.get("running", 0) >= 1)
        assert woke is not None, state.serve_fleet()
        assert (woke["last_promote"] or {}).get("path") in (
            "host", "stream", "resident"), woke
        events = serve.status()["fleet"]["LLMDeployment"]["autoscale_events"]
        triggers = [e["trigger"] for e in events]
        assert "scale_to_zero" in triggers and "wake" in triggers
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
