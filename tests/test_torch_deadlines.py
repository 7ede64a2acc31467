"""Request deadlines, the flight recorder and the engine's spans: the port's
``InferenceEngine`` against the JAX package's, on the CPU.

The same traffic goes through both engines (``debug`` preset, f32,
greedy, one numpy tree handed to both; the port's paged side runs the
kernel's plain version, the JAX side its Pallas kernel in interpret
mode), with deadlines set between ``step`` calls as
``tests/test_overload.py`` does. Finish reasons, events, metrics, pool
stats, the recorder's ``(event, value)`` timelines, span names, parents
and attrs must be equal; tokens too. Times and span ids are left out.
Mirrors ``tests/test_overload.py``'s engine deadline tests and
``tests/test_loop_recorder.py``'s engine tests.
"""

import time

import numpy as np
import pytest

from _torch_parity import model_pair
from ray_tpu.llm import lora as jlora
from ray_tpu.llm.engine import InferenceEngine as JaxEngine
from ray_tpu.llm.engine import QueueFullError as JaxQueueFullError
from ray_tpu.llm.engine import Request as JaxRequest
from ray_tpu.observability import tracing as jtr
from ray_tpu_torch.llm import (InferenceEngine, LoRAServingConfig,
                               QueueFullError, Request)
from ray_tpu_torch.llm import lora as tlora
from ray_tpu_torch.observability import tracing as ttr

SIDES = ("jax", "torch")
PROMPT = list(range(1, 20))


@pytest.fixture(scope="module")
def model():
    (jcfg, jparams), (tcfg, tparams) = model_pair("debug")
    return {"jax": (jcfg, jparams), "torch": (tcfg, tparams)}


@pytest.fixture
def sinks(monkeypatch):
    """Fresh local span buffers for both packages (the JAX package's with
    no core worker connected in this process)."""
    import ray_tpu.core.worker

    monkeypatch.setattr(ray_tpu.core.worker, "_global_worker", None)
    for mod in (jtr, ttr):
        monkeypatch.setattr(mod, "_local_spans", [])


def _engine(model, side, impl="dense", **kw):
    cfg, params = model[side]
    kw = dict(dict(max_slots=2, max_len=64, page_size=8,
                   attention_impl=impl), **kw)
    if side == "jax":
        lora = kw.pop("lora_config", None)
        if lora is not None:
            lora = jlora.LoRAServingConfig(**lora)
        return JaxEngine(cfg, params, lora_config=lora, **kw), JaxRequest
    lora = kw.pop("lora_config", None)
    if lora is not None:
        lora = LoRAServingConfig(**lora)
    return (InferenceEngine(cfg, params, device="cpu", lora_config=lora,
                            **kw), Request)


def _drain(eng, reqs) -> list:
    events = []
    while any(not r.done for r in reqs):
        events += eng.step()
    return events


def _timeline(r) -> list:
    return [(e["ev"], e["v"]) for e in r.timeline.events()]


def _metrics(eng, other) -> dict:
    """The metrics both packages keep, times aside."""
    return {k: v for k, v in eng.metrics.items()
            if k in other.metrics and k != "weight_promote_ms"}


def _both(model, script, **kw):
    """``script(engine, Request)`` on each package; returns the two
    results and engines."""
    out = {}
    for side in SIDES:
        eng, Req = _engine(model, side, **kw)
        out[side] = (script(eng, Req), eng)
    (want, jeng), (got, teng) = out["jax"], out["torch"]
    assert _metrics(teng, jeng) == _metrics(jeng, teng)
    assert teng.pool_stats() == jeng.pool_stats()
    return want, got, teng


def _spans(mod, trace_ids) -> list:
    """Recorded spans of those traces without times and ids: a timeline
    dump keeps each event's name, value and pin."""
    out = []
    for s in mod.local_spans():
        if s["trace_id"] not in trace_ids:
            continue
        attrs = {k: v for k, v in s["attrs"].items()
                 if k not in ("load_ms", "start", "end")}
        if "events" in attrs:
            attrs["events"] = [(e["ev"], e["v"], e.get("pinned", False))
                               for e in attrs["events"]]
        out.append((s["name"], s["kind"], s["trace_id"], s["parent_id"],
                    attrs))
    return out


# ---------------------------------------------------------------- deadlines

def test_queued_expiry_never_reaches_the_engine(model):
    def script(eng, Req):
        free_before = len(eng.allocator.free)
        r = Req("dead", list(PROMPT), max_new_tokens=4,
                deadline=time.time() - 0.1)
        eng.add_request(r)
        events = eng.step()
        out = {"events": events, "finish": r.finish_reason,
               "timeline": _timeline(r), "slot": r.slot,
               "free_kept": len(eng.allocator.free) == free_before,
               "chunks": eng.metrics["prefill_chunks"]}
        ok = Req("ok", list(PROMPT), max_new_tokens=4)
        eng.add_request(ok)
        _drain(eng, [ok])
        out["ok"] = ok.generated
        return out

    want, got, eng = _both(model, script, page_size=8)
    assert got == want
    assert got["events"] == [{"request_id": "dead", "token": -1,
                              "done": True, "finish_reason": "deadline"}]
    assert got["timeline"] == [("admit", len(PROMPT)),
                               ("deadline_expired", 0)]
    assert got["free_kept"] and got["chunks"] == 0 and got["slot"] == -1
    m = eng.metrics
    assert (m["deadline_expired_queued"], m["deadline_expired_running"],
            m["timeline_dumps"]) == (1, 0, 1)
    assert eng.pool_stats()["pinned"] == 0


@pytest.mark.parametrize("impl", ["dense", "paged"])
@pytest.mark.parametrize("K", [1, 4])
def test_mid_decode_expiry_frees_pages_the_same_tick(model, K, impl):
    def script(eng, Req):
        baseline = eng.pool_stats()
        r = Req("mid", list(PROMPT), max_new_tokens=40)
        eng.add_request(r)
        while r.slot < 0 or len(r.generated) < 2:
            eng.step()
        assert not r.done and eng.pool_stats()["pinned"] > 0
        r.deadline = time.time() - 0.01
        events = eng.step()
        stats = eng.pool_stats()
        out = {"events": events, "finish": r.finish_reason,
               "generated": list(r.generated), "timeline": _timeline(r),
               "stats": stats,
               "conserved": stats["free"] + stats["cached"]
               == baseline["free"] + baseline["cached"]}
        after = Req("after", list(PROMPT), max_new_tokens=4)
        eng.add_request(after)
        _drain(eng, [after])
        out["after"] = after.generated
        out["after_cached"] = after.cached_prefix_tokens
        return out

    want, got, eng = _both(model, script, impl=impl,
                           decode_steps_per_dispatch=K)
    assert got == want
    assert eng.attention_impl == impl
    assert got["finish"] == "deadline"
    assert {"request_id": "mid", "token": -1, "done": True,
            "finish_reason": "deadline"} in got["events"]
    assert got["stats"]["pinned"] == 0 and got["stats"]["active_slots"] == 0
    assert got["conserved"] and got["after_cached"] > 0
    names = [e for e, _ in got["timeline"]]
    assert names[:2] == ["admit", "prefill_chunk"] and "first_token" in names
    assert names[-2:] == ["deadline_expired", "retire"]
    assert names.count("token") == len(got["generated"])
    assert eng.metrics["deadline_expired_running"] == 1


def test_mid_prefill_and_pending_first_expiry(model):
    """A request expiring between prefill chunks, and one whose prompt is
    prefilled but whose first sample waits for the other's last chunk:
    both retire that tick, and the pending one's hidden-state handle is
    dropped."""
    def script(eng, Req):
        long = Req("pf", list(range(1, 30)), max_new_tokens=4)
        short = Req("pending", [7, 3, 5], max_new_tokens=4)
        eng.add_request(short)
        eng.add_request(long)
        eng.step()            # short's only chunk: pending its sample
        eng.step()            # long's first chunk
        assert [r for r, _ in eng._pending_first] == [short]
        assert long.prefill_pos == 8 and not long.done
        short.deadline = long.deadline = time.time() - 0.01
        events = eng.step()
        out = {"events": events, "timelines": [_timeline(short),
                                               _timeline(long)],
               "stats": eng.pool_stats()}
        eng.step()            # the flush drops the expired handle
        out["handles"] = len(eng.executor._hidden)
        out["pending"] = len(eng._pending_first)
        return out

    want, got, eng = _both(model, script, prefill_chunk_size=8)
    assert got == want
    assert [e["request_id"] for e in got["events"]] == ["pf", "pending"]
    assert all(e["finish_reason"] == "deadline" for e in got["events"])
    assert got["stats"]["pinned"] == 0 and got["stats"]["active_slots"] == 0
    assert got["handles"] == 0 and got["pending"] == 0
    assert eng.metrics["deadline_expired_running"] == 2
    assert eng.metrics["timeline_dumps"] == 2
    assert got["timelines"][1] == [("admit", 29), ("prefill_chunk", 8),
                                   ("deadline_expired", 0), ("retire", 0)]


def test_expired_export_pins_are_released(model):
    """A ``pin_for_export`` request that expires mid-decode pins its
    block table for the exporter at the retire; ``release_export_pins``
    returns every page."""
    def script(eng, Req):
        baseline = eng.pool_stats()
        r = Req("src", list(PROMPT), max_new_tokens=40, pin_for_export=True)
        eng.add_request(r)
        while len(r.generated) < 2:
            eng.step()
        r.deadline = time.time() - 0.01
        eng.step()
        held = (eng.pool_stats()["pinned"], len(r.export_pinned))
        eng.release_export_pins(r)
        stats = eng.pool_stats()
        return {"finish": r.finish_reason, "held": held, "stats": stats,
                "conserved": stats["free"] + stats["cached"]
                == baseline["free"] + baseline["cached"],
                "timeline": _timeline(r)}

    want, got, _ = _both(model, script, impl="paged",
                         decode_steps_per_dispatch=4)
    assert got == want
    assert got["finish"] == "deadline"
    assert got["held"][0] == got["held"][1] > 0
    assert got["stats"]["pinned"] == 0 and got["conserved"]


# -------------------------------------------------------- shed and the dump

def test_shed_dumps_its_timeline_and_carries_the_http_shape(model, sinks):
    errors = {}

    def script(eng, Req):
        eng.add_request(Req("q0", [1, 2, 3], max_new_tokens=4))
        with pytest.raises((QueueFullError, JaxQueueFullError)) as ei:
            eng.add_request(Req("shed-me", [1, 2, 3], max_new_tokens=4))
        errors[type(eng).__module__] = ei.value
        rows = [{k: v for k, v in row.items() if k not in ("ts", "events")}
                for row in eng.breach_samples()]
        return rows

    want, got, eng = _both(model, script, max_slots=1,
                           max_queued_requests=1)
    assert got == want
    assert got == [{"request_id": "shed-me", "reason": "shed_queue_full",
                    "model": "", "n_events": 1, "overflowed": False}]
    assert eng.metrics["timeline_dumps"] == 1
    port, ref = errors["ray_tpu_torch.llm.engine"], \
        errors["ray_tpu.llm.engine"]
    assert isinstance(port, QueueFullError)
    assert (port.http_status, port.reason, port.retry_after, str(port)) == \
        (ref.http_status, ref.reason, ref.retry_after, str(ref))
    assert QueueFullError.http_status == "503 Service Unavailable"
    assert QueueFullError.reason == "replica_queue_full"
    dumps = [s for s in ttr.local_spans()
             if s["name"] == "llm.request_timeline"]
    assert len(dumps) == 1 and dumps[0]["attrs"]["reason"] == \
        "shed_queue_full"
    assert [e["ev"] for e in dumps[0]["attrs"]["events"]] == ["shed"]


def test_dump_once_per_request(model):
    def script(eng, Req):
        r = Req("dump-once", [1, 5, 9], max_new_tokens=4)
        eng.add_request(r)
        _drain(eng, [r])
        first = eng.dump_timeline(r, "test_breach")
        again = eng.dump_timeline(r, "test_breach")
        rows = [dict(row, events=[(e["ev"], e["v"]) for e in row["events"]],
                     ts=None) for row in eng.breach_samples()]
        return first, again, rows, r.generated

    want, got, eng = _both(model, script)
    assert got == want
    assert got[:2] == (True, False)
    assert eng.metrics["timeline_dumps"] == 1
    (row,) = got[2]
    assert row["request_id"] == "dump-once" and row["reason"] == "test_breach"
    assert row["events"][0] == ("admit", 3) and row["events"][-1] == \
        ("retire", 4)


# ------------------------------------------------- the recorder's events

def _mix_script(eng, Req):
    """Chunked prefill beside decoding (mixed dispatch), speculation
    rounds, then a request that maps the first one's pages: a prefix hit
    and a COW fork of its partial tail. Each request traced."""
    tr = ttr if isinstance(eng, InferenceEngine) else jtr

    def traced(rid, prompt, n, k):
        with tr.use_context(tr.TraceContext(f"{k:032x}", f"{k:016x}")):
            r = Req(rid, prompt, max_new_tokens=n)
            eng.add_request(r)
        return r

    a = traced("a", [5, 4, 3, 2, 1] * 3, 8, 1)
    while a.first_token_at is None:
        eng.step()
    b = traced("b", list(range(30, 50)), 6, 2)
    _drain(eng, [a, b])
    seq = a.prompt + a.generated
    c = traced("c", seq[:19] + [99, 98], 12, 3)
    _drain(eng, [c])
    return {r.request_id: (r.finish_reason, r.generated, _timeline(r))
            for r in (a, b, c)}


def test_mix_timelines_and_spans_match_jax(model, sinks):
    want, got, eng = _both(model, _mix_script, prefill_chunk_size=8,
                           decode_steps_per_dispatch=4,
                           speculation_config={"num_draft_tokens": 3})
    assert got == want
    m = eng.metrics
    assert m["engine_step_mix"]["mixed"] > 0 and m["spec_dispatches"] > 0
    assert m["cow_forks"] == 1 and m["prefix_hit_pages"] == 2
    names = {rid: [e for e, _ in tl] for rid, (_, _, tl) in got.items()}
    assert any("spec_round" in n for n in names.values())
    assert names["b"].count("prefill_chunk") == 3
    assert ("prefix_hit", 19) in got["c"][2]
    assert "cow_fork" in names["c"]
    assert all(n[-1] == "retire" for n in names.values())
    traces = {f"{k:032x}" for k in (1, 2, 3)}
    spans = _spans(ttr, traces)
    assert spans == _spans(jtr, traces)
    kinds = [s[0] for s in spans]
    assert kinds.count("llm.prefix_match") == 3
    assert kinds.count("llm.prefill") == 3
    assert kinds.count("llm.decode") == 3
    assert "llm.speculate" in kinds
    assert all(s[3] == f"{int(s[2], 16):016x}" for s in spans)


@pytest.fixture(scope="module")
def lora_dir(model, tmp_path_factory):
    cfg, _ = model["jax"]
    rng = np.random.default_rng(1)
    arrays = {}
    for p, (ein, eout) in tlora.proj_dims(cfg).items():
        arrays[f"{p}.A"] = (rng.standard_normal((cfg.n_layers, ein, 2))
                            * 0.5 / ein ** 0.5).astype(np.float32)
        arrays[f"{p}.B"] = (rng.standard_normal((cfg.n_layers, 2, eout))
                            * 0.5).astype(np.float32)
    d = tmp_path_factory.mktemp("adapters")
    jlora.save_adapter(str(d / "t1.npz"), arrays)
    return str(d)


def test_adapter_load_and_deadline_spans_match_jax(model, lora_dir, sinks):
    """A cold adapter's ``llm.adapter_load`` under the stepping thread's
    context, and the spans and dump of an adapter request that expires
    mid-decode beside a base request that finishes."""
    def script(eng, Req):
        tr = ttr if isinstance(eng, InferenceEngine) else jtr
        reqs = []
        for k, (rid, m) in enumerate((("base", None), ("ad", "t1")), 7):
            with tr.use_context(tr.TraceContext(f"{k:032x}", f"{k:016x}")):
                reqs.append(Req(rid, list(PROMPT), max_new_tokens=12,
                                model=m))
                eng.add_request(reqs[-1])
        step_ctx = tr.TraceContext(f"{9:032x}", f"{9:016x}")
        with tr.use_context(step_ctx):
            while len(reqs[1].generated) < 2:
                eng.step()
            reqs[1].deadline = time.time() - 0.01
            _drain(eng, reqs)
        return {r.request_id: (r.finish_reason, r.generated, _timeline(r))
                for r in reqs}

    want, got, eng = _both(model, script,
                           lora_config=dict(max_loras=2, max_rank=4,
                                            dynamic_lora_loading_path=lora_dir),
                           decode_steps_per_dispatch=4)
    assert got == want
    assert got["ad"][0] == "deadline" and got["base"][0] == "length"
    traces = {f"{k:032x}" for k in (7, 8, 9)}
    spans = _spans(ttr, traces)
    assert spans == _spans(jtr, traces)
    load = [s for s in spans if s[0] == "llm.adapter_load"]
    assert load == [("llm.adapter_load", "llm", f"{9:032x}", f"{9:016x}",
                     {"adapter": "t1", "slot": 2})]
    ad = [s[0] for s in spans if s[4].get("request_id") == "ad"]
    assert ad == ["llm.prefix_match", "llm.prefill", "llm.decode",
                  "llm.request_timeline"]
    dump = next(s for s in spans if s[0] == "llm.request_timeline")
    assert dump[4]["reason"] == "deadline" and dump[4]["model"] == "t1"
    assert dump[4]["events"][0][0] == "admit"
    assert ("deadline_expired", 0, False) in dump[4]["events"]
    assert eng.lora_manager.stats()["loads"] == 1
    assert eng.pool_stats()["pinned"] == 0
