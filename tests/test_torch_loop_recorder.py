"""The port's flight recorder and tracing against the JAX package's, on the
CPU.

``ray_tpu_torch.observability.loop_recorder.RequestTimeline`` runs the
scripts of ``tests/test_loop_recorder.py`` (overflow and pins, the value
clamp and pin cap, the byte budget at 1k requests) beside the JAX
package's, with times injected through ``now=``, and the payloads must be
equal. ``ray_tpu_torch.observability.tracing`` must give the JAX
package's spans and contexts (``make_span``, ``record_span`` into
``local_spans``, ``span`` nesting, ``use_context``, ``bind``,
``context_from_headers``), ids aside.
"""

import subprocess
import sys
import threading

import pytest

from ray_tpu.observability import loop_recorder as jrec
from ray_tpu.observability import tracing as jtr
from ray_tpu_torch.observability import loop_recorder as trec
from ray_tpu_torch.observability import tracing as ttr


@pytest.fixture
def local_sinks(monkeypatch):
    """Both packages record into fresh local buffers (the JAX package's
    also with no core worker connected in this process)."""
    import ray_tpu.core.worker

    monkeypatch.setattr(ray_tpu.core.worker, "_global_worker", None)
    for mod in (jtr, ttr):
        monkeypatch.setattr(mod, "_local_spans", [])


def _both(script):
    """Run ``script(RequestTimeline, codes)`` for each package."""
    return [script(mod.RequestTimeline, mod) for mod in (jrec, trec)]


def test_event_codes_match_jax():
    codes = {n: getattr(jrec, n) for n in dir(jrec) if n.startswith("EV_")}
    assert codes == {n: getattr(trec, n) for n in dir(trec)
                     if n.startswith("EV_")}
    assert trec.EVENT_NAMES == jrec.EVENT_NAMES
    assert trec.RequestTimeline.PIN == jrec.RequestTimeline.PIN


def test_timeline_overflow_keeps_newest_and_pins():
    def script(cls, ev):
        tl = cls(capacity=16)
        tl.add(ev.EV_ADMIT, 5, now=1.0)
        tl.add(ev.EV_PREFIX_HIT, 3, now=1.1)
        tl.add(ev.EV_FIRST_TOKEN, 5, now=1.2)
        for i in range(40):  # lap the ring with per-token events
            tl.add(ev.EV_TOKEN, i + 1, now=2.0 + i * 0.01)
        tl.add(ev.EV_RETIRE, 40, now=3.0)
        return tl.overflowed, tl.to_payload()

    (j_over, want), (t_over, got) = _both(script)
    assert got == want and t_over == j_over
    assert got["overflowed"] and got["n_events"] == 44
    assert got["dropped"] == 44 - 16
    names = [e["ev"] for e in got["events"]]
    assert names[0] == "admit" and got["events"][0]["pinned"]
    assert "prefix_hit" in names[:3] and "first_token" in names[:3]
    assert names[-1] == "retire"
    assert any(e["ev"] == "token" and e["v"] == 40 for e in got["events"])
    assert got["start"] == 1.0 and got["end"] == 3.0


def test_timeline_short_payload_and_empty():
    def script(cls, ev):
        empty = cls().to_payload()
        tl = cls(capacity=8)
        for k, code in enumerate((ev.EV_ADMIT, ev.EV_PREFILL_CHUNK,
                                  ev.EV_COW_FORK, ev.EV_SPEC_ROUND,
                                  ev.EV_DEADLINE, ev.EV_SHED)):
            tl.add(code, 7 * k, now=10.0 + k)
        return empty, tl.to_payload(), tl.events()

    want, got = _both(script)
    assert got == want
    empty, payload, _ = got
    assert empty["events"] == [] and empty["start"] == 0.0
    assert not payload["overflowed"] and payload["dropped"] == 0
    assert [e["ev"] for e in payload["events"]] == [
        "admit", "prefill_chunk", "cow_fork", "spec_round",
        "deadline_expired", "shed"]


def test_timeline_value_clamp_and_pin_cap():
    def script(cls, ev):
        tl = cls(capacity=8)
        tl.add(ev.EV_ADMIT, 2**40, now=0.5)  # out of int32: stored as 0
        first = tl.events()[0]["v"]
        for i in range(20):  # the pinned mirror is capped
            tl.add(ev.EV_PREFIX_HIT, 1, now=1.0 + i)
        return first, len(tl._pinned), tl._pinned, tl.to_payload()

    want, got = _both(script)
    assert got == want
    assert got[0] == 0 and got[1] <= 8


def test_timeline_byte_budget_at_1k_requests():
    """1k always-on recorders stay within ~1 MiB of array storage."""
    for mod in (jrec, trec):
        timelines = [mod.RequestTimeline() for _ in range(1000)]
        assert timelines[0].nbytes() <= 1024
        assert sum(t.nbytes() for t in timelines) <= 1 << 20
    assert trec.RequestTimeline().nbytes() == jrec.RequestTimeline().nbytes()
    assert trec.RequestTimeline(16).nbytes() == \
        jrec.RequestTimeline(16).nbytes()


def test_timeline_add_never_raises():
    tl = trec.RequestTimeline(capacity=4)
    tl.add(trec.EV_TOKEN, "not a number", now=1.0)
    tl.add(trec.EV_TOKEN, None, now=2.0)
    tl.add(999, 1, now=3.0)               # no such code: dropped
    tl.add(trec.EV_TOKEN, 3.7, now=4.0)
    assert [(e["ev"], e["v"]) for e in tl.events()] == [
        ("token", 0), ("token", 0), ("token", 3)]


# ------------------------------------------------------------------ tracing

def _strip(span: dict) -> dict:
    """A span without its times and random ids."""
    return {k: v for k, v in span.items()
            if k not in ("span_id", "start", "end")}


def test_make_span_matches_jax():
    args = ("llm.decode", "llm", 1.0, 2.0, "t" * 32, "p" * 16)
    kw = dict(span_id="s" * 16, attrs={"request_id": "r", "n": 3})
    assert ttr.make_span(*args, **kw) == jtr.make_span(*args, **kw)
    got, want = ttr.make_span(*args), jtr.make_span(*args)
    assert _strip(got) == _strip(want) and got.keys() == want.keys()
    assert len(got["span_id"]) == 16 and got["attrs"] == {}
    assert len(ttr.new_trace_id()) == len(jtr.new_trace_id()) == 32
    assert ttr.new_span_id() != ttr.new_span_id()


def test_record_span_and_local_spans_match_jax(local_sinks):
    for mod in (jtr, ttr):
        mod.record_span(mod.make_span("a", "llm", 1.0, 2.0, "t1", "p",
                                      span_id="x"))
        mod.record_span(mod.make_span("b", "llm", 2.0, 3.0, "t2"))
        mod.record_span(mod.make_span("dropped", "llm", 0.0, 1.0, ""))
    assert ttr.local_spans("t1") == jtr.local_spans("t1")
    assert [_strip(s) for s in ttr.local_spans()] == \
        [_strip(s) for s in jtr.local_spans()]
    assert [s["name"] for s in ttr.local_spans()] == ["a", "b"]


def test_local_sink_is_bounded(local_sinks, monkeypatch):
    monkeypatch.setattr(ttr, "_LOCAL_MAX", 8)
    monkeypatch.setattr(jtr, "_LOCAL_MAX", 8)
    for mod in (jtr, ttr):
        for i in range(11):
            mod.record_span(mod.make_span(f"s{i}", "llm", 0.0, 1.0, "t"))
    names = [s["name"] for s in ttr.local_spans()]
    assert names == [s["name"] for s in jtr.local_spans()]
    assert len(names) <= 8 and names[-1] == "s10"


def _nested(mod):
    """Spans of a nested block, a root block inside it, and what the
    context reads at each level."""
    seen = {}
    with mod.span("outer", kind="app", attrs={"k": 1}) as outer:
        seen["outer_current"] = mod.current() == outer
        with mod.span("inner", kind="llm") as inner:
            seen["inner_parent"] = inner.parent_id == outer.span_id
            seen["same_trace"] = inner.trace_id == outer.trace_id
            seen["wire"] = mod.current_wire() == inner.to_wire()
        with mod.span("fresh", root=True) as fresh:
            seen["fresh_trace"] = fresh.trace_id != outer.trace_id
        seen["restored"] = mod.current() == outer
    seen["cleared"] = mod.current() is None
    spans = {s["name"]: s for s in mod.local_spans()}
    seen["linked"] = (spans["inner"]["parent_id"] == spans["outer"]["span_id"]
                      and spans["outer"]["parent_id"] == ""
                      and spans["fresh"]["parent_id"] == "")
    seen["order"] = [s["name"] for s in mod.local_spans()]
    seen["shapes"] = {n: {"kind": s["kind"], "attrs": s["attrs"]}
                      for n, s in spans.items()}
    return seen


def test_span_nesting_matches_jax(local_sinks):
    got, want = _nested(ttr), _nested(jtr)
    assert got == want
    assert all(v for k, v in got.items() if k not in ("order", "shapes"))
    assert got["order"] == ["inner", "fresh", "outer"]


def _contexts(mod):
    ctx = mod.TraceContext("t" * 32, "s" * 16)
    out = {"child_parent": ctx.child().parent_id,
           "child_trace": ctx.child().trace_id, "wire": ctx.to_wire()}
    with mod.use_context(ctx) as got:
        out["use"] = got == ctx and mod.current() is ctx
    out["after_use"] = mod.current() is None
    ran = {}

    def work(x):
        ran["ctx"] = mod.current()
        return x + 1

    fn = mod.bind(ctx, work, 41)
    t = threading.Thread(target=lambda: ran.update(result=fn()))
    t.start()
    t.join(timeout=10)
    out["bound"] = (not t.is_alive(), ran.get("result"), ran.get("ctx") == ctx)
    out["prev"] = mod.set_current(ctx) is None and \
        mod.set_current(None) is ctx
    cont = mod.context_from_headers({"x-raytpu-trace": "abc:def"})
    out["header"] = (cont.trace_id, cont.parent_id, len(cont.span_id))
    out["no_header"] = [
        (len(c.trace_id), c.parent_id) for c in (
            mod.context_from_headers(None),
            mod.context_from_headers({"x-raytpu-trace": ":def"}),
            mod.context_from_headers({"x-raytpu-trace": "nocolon"}))]
    out["header_name"] = mod.TRACE_HEADER
    return out


def test_contexts_bind_and_headers_match_jax():
    got, want = _contexts(ttr), _contexts(jtr)
    assert got == want
    assert got["bound"] == (True, 42, True)
    assert got["header"] == ("abc", "def", 16)
    assert got["no_header"] == [(32, "")] * 3


def test_import_loads_no_jax_and_no_ray_tpu():
    code = ("import sys; import ray_tpu_torch.observability.tracing, "
            "ray_tpu_torch.observability.loop_recorder, "
            "ray_tpu_torch.llm.engine; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ray_tpu', 'ml_dtypes')); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
