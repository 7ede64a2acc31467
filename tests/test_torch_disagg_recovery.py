"""Spill migration and the prefill replica's death in the port's Serve
(``ray_tpu_torch.llm.serving``), on a port cluster at ``debug-128``: an
affinity spill between two unified replicas imports the group's pages
from the previous replica instead of prefilling them, and killing the
prefill replica of a disaggregated app mid-migration heals, with
retries answering the healthy text and the ``RecoveryVerifier`` green.
(The JAX package's cases: ``tests/test_llm_migration.py:415,457``.)
"""

import json
import threading
import time
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.llm import build_llm_app

PRESET = "debug-128"
GEOMETRY = dict(max_slots=4, max_len=256, page_size=16, prefill_chunk_size=64,
                decode_steps_per_dispatch=4)


def _sse_text(raw: bytes) -> str:
    text = ""
    events = raw.decode().split("\n\n")
    for event in events:
        if event.startswith("data: ") and event != "data: [DONE]":
            text += json.loads(event[len("data: "):])["choices"][0]["text"]
    assert "data: [DONE]" in events
    return text


def _post(addr: str, path: str, body: dict, timeout: float = 120.0) -> bytes:
    req = urllib.request.Request(
        addr + path, data=json.dumps(body).encode(),
        headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as f:
        return f.read()


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=6)
    try:
        yield
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()


def test_spill_migration_imports_the_group_pages(cluster):
    """With disaggregation off, an affinity spill's target imports the
    group's pages from the previous replica instead of prefilling."""
    from ray_tpu_torch.core.config import get_config

    cfg = get_config()
    serve.run(build_llm_app(PRESET, device="cpu", num_replicas=2,
                            **GEOMETRY),
              name="llm-spill", route_prefix="/spill")
    try:
        h = serve.get_app_handle("llm-spill").options(
            method_name="completions", prefix_group="grp-mig")
        body = {"prompt": "You are a helpful assistant. " * 4 + " tail",
                "max_tokens": 6}
        out1 = h.remote(dict(body)).result(timeout=120)
        router = h._get_router()
        affine = router._group_affinity["grp-mig"]
        bump = cfg.serve_affinity_spill_margin + 1
        with router._cond:
            router._inflight[affine] += bump
        try:
            out2 = h.remote(dict(body)).result(timeout=120)
        finally:
            with router._cond:
                router._inflight[affine] -= bump
        assert out2["choices"][0]["text"] == out1["choices"][0]["text"]
        assert router.spill_migrations == 1
        assert router._group_affinity["grp-mig"] != affine
        m = h.options(method_name="engine_metrics",
                      prefix_group="grp-mig").remote().result(timeout=60)
        assert m["kv_migrations_in"] >= 1 and m["kv_pages_imported"] >= 1
    finally:
        serve.delete("llm-spill")


def test_prefill_replica_death_mid_migration_heals(cluster):
    """Kill the prefill replica while a handoff's stream is in flight:
    retries finish with the healthy text once the controller replaces
    it, and the RecoveryVerifier comes back green."""
    from ray_tpu_torch.chaos import RecoveryVerifier
    from ray_tpu_torch.core import api
    from ray_tpu_torch.core.api import ActorHandle
    from ray_tpu_torch.core.config import get_config

    cfg = get_config()
    saved_chunk = cfg.kv_migration_chunk_pages
    cfg.kv_migration_chunk_pages = 1  # widen the mid-migration window
    verifier = RecoveryVerifier(timeout_s=30)
    baseline = verifier.snapshot_baseline()
    try:
        serve.run(build_llm_app(PRESET, device="cpu",
                                serve_disaggregation="prefill_decode",
                                **GEOMETRY),
                  name="llm-chaos", route_prefix="/chaos")
        addr = serve.http_address()
        body = {"prompt": "c" * 180, "max_tokens": 6, "stream": True}

        def run_once(timeout=60.0):
            return _sse_text(_post(addr, "/chaos/v1/completions", body,
                                   timeout))

        expected = run_once()
        controller = api.get_actor("SERVE_CONTROLLER")
        table = api.get(controller.get_snapshot.remote(
            "replicas::llm-chaos::llm-prefill"), timeout=30)
        prefill_actor = ActorHandle(bytes.fromhex(table[0]["actor_id"]))
        result: dict = {}

        def client():
            try:
                result["text"] = run_once()
            except Exception as e:
                result["error"] = f"{type(e).__name__}: {e}"

        t = threading.Thread(target=client)
        t.start()
        time.sleep(0.15)  # admission and the migration stream begin
        api.kill(prefill_actor)
        t.join(timeout=90)
        assert not t.is_alive()
        deadline = time.monotonic() + 60
        text, last_err = result.get("text"), result.get("error")
        while text != expected and time.monotonic() < deadline:
            try:
                text = run_once(timeout=30.0)
            except Exception as e:
                last_err = f"{type(e).__name__}: {e}"
                time.sleep(0.5)
        assert text == expected, (text, last_err)
        result = verifier.verify(baseline)
        assert result.ok, result.violations
    finally:
        cfg.kv_migration_chunk_pages = saved_chunk
        serve.delete("llm-chaos")
