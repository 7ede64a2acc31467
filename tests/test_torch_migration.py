"""KV migration and the host-RAM KV tier of the port, against the JAX
package on the CPU.

``write_pages`` and the export plan are held against the JAX package's; a
page payload exported by the JAX engine serves the JAX engine's greedy
tokens from the port's engine, and the port's payload does the same in the
JAX engine (``debug`` preset, f32, one numpy tree handed to both; the JAX
engines use ``attention_impl="dense"``). The rest mirrors
``tests/test_llm_migration.py``: prefill-only requests, the round trip,
import under pressure, the live and static streams over the loop wire,
source death, and the host tier; then concurrent streams, a malformed
chunk, and a dropped engine freed without the cycle collector. Every
migrated request's tokens must equal a cold dense engine's, and no page
may stay pinned or leak.
"""

import dataclasses
import gc
import os
import pickle
import sys
import threading
import time
import weakref

import ml_dtypes
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from _torch_parity import model_pair
from ray_tpu.llm import model as jm
from ray_tpu.llm.engine import InferenceEngine as JaxEngine
from ray_tpu.llm.engine import Request as JaxRequest
from ray_tpu_torch.dag.channel import TcpLoopServer
from ray_tpu_torch.llm import (InferenceEngine, KVMigrationSource, Request,
                               receive_kv_stream, write_pages)
from ray_tpu_torch.llm.weights import host_to_tensor, tensor_to_host

PROMPT = list(range(1, 20))     # 2 full pages of 8 + a 3-row tail
LONG = list(range(1, 40))       # 4 full pages + a 7-row tail
GEOMETRY = dict(max_slots=2, max_len=64, page_size=8)


@pytest.fixture(scope="module")
def model():
    return model_pair("debug")


def _engine(model, impl="paged", **kw):
    _, (tcfg, tparams) = model
    return InferenceEngine(tcfg, tparams, device="cpu", attention_impl=impl,
                           **{**GEOMETRY, **kw})


def _jax_engine(model):
    (jcfg, jparams), _ = model
    return JaxEngine(jcfg, jparams, attention_impl="dense", **GEOMETRY)


def _drain(eng, req):
    while not req.done:
        eng.step()


def _prefill_only(eng, prompt, Req=Request):
    r = Req("p", list(prompt), max_new_tokens=1, prefill_only=True,
            pin_for_export=True)
    eng.add_request(r)
    _drain(eng, r)
    return r


@pytest.fixture(scope="module")
def cold(model):
    """Greedy tokens of a cold dense port engine, per prompt."""
    eng = _engine(model, "dense")
    memo = {}

    def tokens(prompt, n):
        key = (tuple(prompt), n)
        if key not in memo:
            memo[key] = eng.generate(list(prompt), n)
        return memo[key]
    return tokens


@pytest.fixture(scope="module")
def jax_side(model):
    """One JAX engine: a prefill-only request, its payload and export
    plan, then its greedy tokens for the prompt."""
    eng = _jax_engine(model)
    r = _prefill_only(eng, PROMPT, JaxRequest)
    plan = eng.pin_prefix_for_export(PROMPT)
    eng.release_export_pages(plan["page_ids"])
    payload = eng.export_prefix_kv(PROMPT)
    eng.release_export_pins(r)
    return {"engine": eng, "plan": plan, "payload": payload,
            "tokens": eng.generate(PROMPT, 6)}


def _held(eng) -> dict:
    """Every page the engine's allocator holds a ref on."""
    return {p: c for p, c in eng.allocator.refcount.items() if c}


def _reusable(eng) -> int:
    a = eng.allocator
    return len(a.free) + sum(1 for p in a.page_hash
                             if not a.refcount.get(p, 0))


# ------------------------------------------------------------ against JAX
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_write_pages_matches_jax(dtype):
    rng = np.random.default_rng(0)
    shape = (2, 6, 2, 4, 8)       # [L, P, KH, page, D]
    pool = rng.standard_normal(shape).astype(np.float32)
    rows_k = rng.standard_normal((2, 2, 2, 4, 8)).astype(np.float32)
    rows_v = rng.standard_normal((2, 2, 2, 4, 8)).astype(np.float32)
    dst = np.array([4, 1], np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jm.write_pages({"k": jnp.asarray(pool, jdt),
                           "v": jnp.asarray(pool, jdt)},
                          jnp.asarray(dst), jnp.asarray(rows_k),
                          jnp.asarray(rows_v))
    tdt = getattr(torch, dtype)
    pages = {"k": torch.tensor(pool).to(tdt), "v": torch.tensor(pool).to(tdt)}
    got = write_pages(pages, torch.tensor(dst), torch.tensor(rows_k),
                      torch.tensor(rows_v))
    for name in ("k", "v"):
        bits, _ = tensor_to_host(got[name])
        want_bits = np.asarray(want[name])
        if dtype == "bfloat16":
            want_bits = want_bits.view(np.int16)
        np.testing.assert_array_equal(bits, want_bits)


def test_chain_hashes_and_export_plan_match_jax(model, jax_side):
    eng = _engine(model)
    r = _prefill_only(eng, PROMPT)
    assert eng._chain_hashes(PROMPT) == \
        jax_side["engine"]._chain_hashes(PROMPT)
    assert eng._chain_hashes(LONG, "a1") == \
        jax_side["engine"]._chain_hashes(LONG, "a1")
    plan = eng.pin_prefix_for_export(PROMPT)
    eng.release_export_pages(plan["page_ids"])
    want = jax_side["plan"]
    for key in ("tokens", "full_pages", "partial_len", "model"):
        assert plan[key] == want[key], key
    payload = eng.export_prefix_kv(PROMPT)
    eng.release_export_pins(r)
    np.testing.assert_allclose(payload["k"], jax_side["payload"]["k"],
                               atol=1e-5)
    np.testing.assert_allclose(payload["v"], jax_side["payload"]["v"],
                               atol=1e-5)


def test_jax_payload_serves_jax_tokens_in_the_port(model, jax_side):
    eng = _engine(model)
    assert eng.import_prefix_kv(jax_side["payload"]) == 18
    assert eng.metrics["kv_migrations_in"] == 1
    r = Request("b", list(PROMPT), max_new_tokens=6)
    eng.add_request(r)
    _drain(eng, r)
    assert r.cached_prefix_tokens == 18
    assert r.generated == jax_side["tokens"]


def test_port_payload_serves_port_tokens_in_jax(model, cold):
    a = _engine(model)
    r = _prefill_only(a, PROMPT)
    payload = a.export_prefix_kv(PROMPT)
    a.release_export_pins(r)
    assert payload["k"].dtype == np.float32
    jeng = _jax_engine(model)
    assert jeng.import_prefix_kv(payload) == 18
    jr = JaxRequest("b", list(PROMPT), max_new_tokens=6)
    jeng.add_request(jr)
    _drain(jeng, jr)
    assert jr.cached_prefix_tokens == 18
    assert jr.generated == a.generate(PROMPT, 6) == cold(PROMPT, 6)


def test_bf16_jax_payload_imports_bit_exactly(model, jax_side):
    _, (tcfg, _) = model
    cfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    eng = InferenceEngine(cfg, None, device="cpu", **GEOMETRY)
    payload = dict(jax_side["payload"])
    for name in ("k", "v"):
        payload[name] = np.asarray(payload[name]).astype(ml_dtypes.bfloat16)
    assert eng.import_prefix_kv(payload) == 18
    plan = eng.pin_prefix_for_export(PROMPT)
    try:
        ids = torch.tensor(plan["page_ids"])
        for name in ("k", "v"):
            got, tag = tensor_to_host(eng.executor.pages[name][:, ids])
            assert tag == "bfloat16" and got.dtype == np.int16
            np.testing.assert_array_equal(got, payload[name].view(np.int16))
        # the port's own bf16 export: raw 16-bit integers and a tag,
        # through pickle, back to the same bits
        out = pickle.loads(pickle.dumps(eng.executor.export_pages(
            plan["page_ids"])))
        assert out["dtype"] == "bfloat16" and out["k"].dtype == np.int16
        assert torch.equal(host_to_tensor(out["k"], out["dtype"]),
                           eng.executor.pages["k"][:, ids])
    finally:
        eng.release_export_pages(plan["page_ids"])


# ------------------------------------------------- the JAX package's cases
def test_prefill_only_retires_without_sampling(model, cold):
    eng = _engine(model)
    r = _prefill_only(eng, PROMPT)
    assert r.finish_reason == "prefilled" and not r.generated
    assert r.export_pinned, "the retire must pin pages for the exporter"
    b = Request("b", list(PROMPT), max_new_tokens=4)
    eng.add_request(b)
    _drain(eng, b)
    assert b.cached_prefix_tokens == 18
    assert b.generated == cold(PROMPT, 4)
    eng.release_export_pins(r)
    assert not r.export_pinned and not _held(eng)


def test_prefill_only_in_mixed_dispatch(model, cold):
    """A prefill-only prompt whose last chunk rides a decode burst retires
    with its 'prefilled' event and samples nothing."""
    eng = _engine(model)
    d = Request("d", [5, 4, 3], max_new_tokens=12)
    eng.add_request(d)
    while d.first_token_at is None:
        eng.step()
    r = Request("p", list(PROMPT), max_new_tokens=1, prefill_only=True,
                pin_for_export=True)
    eng.add_request(r)
    events = []
    while not r.done:
        events += eng.step()
    assert eng.metrics["engine_step_mix"]["mixed"] > 0
    assert {"request_id": "p", "token": -1, "done": True,
            "finish_reason": "prefilled"} in events
    assert not r.generated and r.export_pinned
    _drain(eng, d)
    assert d.generated == cold([5, 4, 3], 12)
    eng.release_export_pins(r)
    assert not _held(eng)


def test_export_import_round_trip(model, cold):
    a = _engine(model)
    r = _prefill_only(a, PROMPT)
    payload = a.export_prefix_kv(PROMPT)
    a.release_export_pins(r)
    assert payload["full_pages"] == 2 and payload["partial_len"] == 2
    assert payload["k"].shape[1] == 3
    b = _engine(model)
    assert b.import_prefix_kv(payload) == 18
    rb = Request("b", list(PROMPT), max_new_tokens=4)
    b.add_request(rb)
    _drain(b, rb)
    assert rb.cached_prefix_tokens == 18
    assert rb.generated == cold(PROMPT, 4)
    # a mid-tail divergence COW-forks the imported partial page
    div = PROMPT[:17] + [99, 98]
    rc = Request("c", list(div), max_new_tokens=4)
    b.add_request(rc)
    _drain(b, rc)
    assert rc.cached_prefix_tokens == 17 and b.metrics["cow_forks"] >= 1
    assert rc.generated == cold(div, 4)
    # a duplicate import frees its pages straight back
    before = _reusable(b)
    assert b.import_prefix_kv(a.export_prefix_kv(PROMPT)) == 18
    assert _reusable(b) == before
    assert not _held(a) and not _held(b)


def test_import_under_pressure_falls_back_cold(model, cold):
    a = _engine(model)
    r = _prefill_only(a, PROMPT)
    payload = a.export_prefix_kv(PROMPT)
    a.release_export_pins(r)
    tiny = _engine(model, num_pages=2)
    assert tiny.import_prefix_kv(payload) == 0
    assert tiny.metrics["kv_import_failures"] == 1
    assert tiny.metrics["kv_pages_imported"] == 0
    short = PROMPT[:12]
    rc = Request("c", list(short), max_new_tokens=3)
    tiny.add_request(rc)
    _drain(tiny, rc)
    assert rc.cached_prefix_tokens == 0
    assert rc.generated == cold(short, 3)


def test_streamed_migration_overlaps_prefill(model, cold):
    a = _engine(model, prefill_chunk_size=8)
    r = Request("p", list(LONG), max_new_tokens=1, prefill_only=True,
                pin_for_export=True)
    a.add_request(r)
    src = KVMigrationSource(a, r, chunk_pages=1)
    stepper = threading.Thread(target=_drain, args=(a, r))
    stepper.start()
    b = _engine(model)
    stats = receive_kv_stream(b, src.address, timeout_s=30)
    stepper.join(timeout=30)
    src.close()
    assert not stepper.is_alive()
    assert stats["complete"] and stats["status"] == "ok", stats
    assert stats["cached_tokens"] == 39 and stats["pages"] == 5
    assert b.metrics["kv_import_bytes"] == stats["bytes"] > 0
    rb = Request("b", list(LONG), max_new_tokens=4)
    b.add_request(rb)
    _drain(b, rb)
    assert rb.cached_prefix_tokens == 38  # a match caps at len - 1
    assert rb.generated == cold(LONG, 4)
    assert not r.export_pinned and not _held(a)
    assert a.metrics["kv_migrations_out"] == 1
    assert a.metrics["kv_pages_exported"] == 5


def _wait_for_reader(src, timeout=10.0):
    """Until the source has sent its meta message and the reader has
    connected and consumed it."""
    def ready():
        return src.stats["bytes"] and not src._server.occupancy()
    deadline = time.monotonic() + timeout
    while not ready() and time.monotonic() < deadline:
        time.sleep(0.005)
    assert ready(), "the reader never connected"


def test_source_death_mid_prefill_releases_every_pin(model, cold):
    """The source dies after 2 chunks while its request is still
    prefilling (this thread steps the engine, so the order is fixed): the
    importer keeps a strict prefix, the request prefills the rest, and
    the retire that comes after the death pins nothing."""
    a = _engine(model, prefill_chunk_size=8)
    r = Request("p", list(LONG), max_new_tokens=1, prefill_only=True,
                pin_for_export=True)
    a.add_request(r)
    src = KVMigrationSource(a, r, chunk_pages=1, _die_after_chunks=2)
    c = _engine(model)
    got = {}
    reader = threading.Thread(target=lambda: got.update(
        receive_kv_stream(c, src.address, timeout_s=10)))
    reader.start()
    _wait_for_reader(src)
    while r.prefill_pos < 2 * 8:   # two pages ready: the source sends both
        a.step()
    src.join(timeout=10)
    reader.join(timeout=10)
    assert not src._thread.is_alive() and not reader.is_alive()
    assert not r.done and not r.export_pinned  # died mid-prefill
    _drain(a, r)
    assert r.finish_reason == "prefilled"
    assert not r.export_pinned and not _held(a)
    assert all(a.allocator.refcount.get(p, 0) == 0
               for p in a.allocator.page_hash)
    assert not got["complete"] and got["status"] == "ChannelClosed", got
    assert got["cached_tokens"] == 16 and got["pages"] == 2
    rc = Request("c", list(LONG), max_new_tokens=4)
    c.add_request(rc)
    _drain(c, rc)
    assert rc.cached_prefix_tokens == 16
    assert rc.generated == cold(LONG, 4)


def test_static_stream_exports_cached_prefix(model, cold):
    a = _engine(model)
    a.generate(LONG, 1)  # the retire registers the chain
    src = KVMigrationSource.for_cached_prefix(a, LONG, chunk_pages=1)
    assert src is not None
    b = _engine(model)
    stats = receive_kv_stream(b, src.address, timeout_s=30)
    src.close()
    assert stats["complete"] and stats["status"] == "ok", stats
    assert stats["cached_tokens"] == 38  # 4 full pages + a 6-row tail
    rb = Request("b", list(LONG), max_new_tokens=4)
    b.add_request(rb)
    _drain(b, rb)
    assert rb.cached_prefix_tokens == 38
    assert rb.generated == cold(LONG, 4)
    assert not _held(a)
    assert KVMigrationSource.for_cached_prefix(a, [99, 98, 97]) is None


def test_static_source_death_keeps_prefix_and_releases_pins(model, cold):
    a = _engine(model)
    a.generate(LONG, 1)
    src = KVMigrationSource.for_cached_prefix(a, LONG, chunk_pages=1,
                                              _die_after_chunks=2)
    c = _engine(model)
    stats = receive_kv_stream(c, src.address, timeout_s=10)
    src.join(timeout=10)
    assert not src._thread.is_alive()
    assert not stats["complete"]
    assert 0 < stats["cached_tokens"] < 38, stats
    rc = Request("c", list(LONG), max_new_tokens=4)
    c.add_request(rc)
    _drain(c, rc)
    assert rc.cached_prefix_tokens == stats["cached_tokens"]
    assert rc.generated == cold(LONG, 4)
    assert not _held(a)


def test_host_tier_spills_and_restores(model, cold):
    eng = _engine(model, num_pages=4, host_kv_cache_pages=8)
    first = list(range(1, 18))
    eng.generate(first, 1)
    ids = eng.allocator.match_prefix(eng._chain_hashes(first)[1][:2])
    before = eng.executor.export_pages(ids)
    eng.generate([50 + i for i in range(17)], 1)  # evicts first's pages
    assert eng.metrics["host_kv_spilled_pages"] > 0
    r = Request("x2", list(first), max_new_tokens=3)
    eng.add_request(r)
    _drain(eng, r)
    assert eng.metrics["host_kv_restored_pages"] > 0
    assert r.cached_prefix_tokens == 16
    assert r.generated == cold(first, 3)
    restored = eng.allocator.match_prefix(eng._chain_hashes(first)[1][:2])
    after = eng.executor.export_pages(restored)
    np.testing.assert_array_equal(after["k"], before["k"])
    np.testing.assert_array_equal(after["v"], before["v"])
    # without the tier nothing spills
    off = _engine(model, num_pages=4)
    assert off.allocator.on_evict is None


def test_concurrent_streams_leave_no_pins_and_no_leaks(model, cold):
    """More streams than cores, with a short switch interval: static
    sources pin and export A's cached pages while A's own thread serves
    other prompts, and every stream imports into one engine B, whose
    duplicate links must free straight back. Afterwards neither engine
    holds a ref, B's whole pool is reusable, and both serve the cold
    tokens."""
    n = (os.cpu_count() or 4) + 1
    a = _engine(model, num_pages=24)
    a.generate(LONG, 1)
    b = _engine(model, num_pages=5 * n + 8)
    others = [[7, 3, 9] * 5, list(range(60, 90))]
    served = {}
    stats = [None] * n
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        sources = [KVMigrationSource.for_cached_prefix(a, LONG, chunk_pages=1)
                   for _ in range(n)]

        def read(i):
            stats[i] = receive_kv_stream(b, sources[i].address, timeout_s=60)

        readers = [threading.Thread(target=read, args=(i,))
                   for i in range(n)]
        for t in readers:
            t.start()
        for p in others:
            served[tuple(p)] = a.generate(p, 4)
        for t in readers:
            t.join(timeout=60)
        for src in sources:
            src.close()
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in readers)
    for st in stats:
        assert st["complete"] and st["status"] == "ok", st
        assert st["cached_tokens"] == 38
    assert not _held(a) and not _held(b)
    assert b.allocator.available() == b.num_pages - b.max_slots
    assert b.metrics["kv_pages_imported"] == 5  # one copy kept, the rest freed
    for p in others:
        assert served[tuple(p)] == cold(p, 4)
    rb = Request("b", list(LONG), max_new_tokens=4)
    b.add_request(rb)
    _drain(b, rb)
    assert rb.cached_prefix_tokens == 38 and rb.generated == cold(LONG, 4)


def test_dropped_engine_frees_without_the_cycle_collector(model):
    """An engine that spilled to its host tier, streamed a prefix out and
    cycled its weights frees its executor (pool and weights) as soon as
    the last reference goes: no reference cycle through its hooks."""
    eng = _engine(model, num_pages=4, host_kv_cache_pages=8)
    eng.generate(list(range(1, 18)), 1)
    eng.generate([50 + i for i in range(17)], 1)
    eng.generate(list(range(1, 18)), 1)
    assert eng.metrics["host_kv_restored_pages"] > 0
    src = KVMigrationSource.for_cached_prefix(eng, list(range(1, 18)))
    stats = receive_kv_stream(_engine(model), src.address, timeout_s=30)
    src.close()
    assert stats["complete"]
    assert eng.demote_weights_to_host()["ok"]
    assert eng.promote_weights_from_host()["ok"]
    ref = weakref.ref(eng.executor)
    gc.disable()
    try:
        del eng, src
        assert ref() is None
    finally:
        gc.enable()


def test_loop_server_listens_on_loopback():
    """The wire has no authentication: its server takes connections on
    loopback only unless the caller names another interface."""
    server = TcpLoopServer(n_slots=8)
    try:
        assert server._sock.getsockname()[0] == "127.0.0.1"
        assert server.address.startswith("127.0.0.1:")
    finally:
        server.close()


def test_malformed_chunk_keeps_the_prefix_and_leaks_nothing(model, cold):
    """A chunk whose rows do not fit the pool (another page size) ends the
    stream with what came before it, and its reserved pages go back."""
    a = _engine(model)
    a.generate(LONG, 1)
    data = a.executor.export_pages(
        a.allocator.match_prefix(a._chain_hashes(LONG)[1][:2]))
    server = TcpLoopServer(n_slots=8)
    for msg in ({"kind": "meta", "page_size": 8, "model": "",
                 "prompt_len": len(LONG)},
                {"kind": "pages", "tokens": LONG[:8], "k": data["k"][:, :1],
                 "v": data["v"][:, :1], "dtype": data["dtype"]},
                {"kind": "pages", "tokens": LONG[8:16],
                 "k": data["k"][:, 1:, :, :4], "v": data["v"][:, 1:, :, :4],
                 "dtype": data["dtype"]},
                {"kind": "end"}):
        server.write(pickle.dumps(msg))
    server.close_writer()
    b = _engine(model)
    stats = receive_kv_stream(b, server.address, timeout_s=10)
    server.close()
    assert stats["status"] == "import_failed" and not stats["complete"]
    assert stats["cached_tokens"] == 8
    assert b.metrics["kv_import_failures"] == 1
    assert not _held(b)
    assert b.allocator.available() == b.num_pages - b.max_slots
    rb = Request("b", list(LONG), max_new_tokens=4)
    b.add_request(rb)
    _drain(b, rb)
    assert rb.cached_prefix_tokens == 8 and rb.generated == cold(LONG, 4)
