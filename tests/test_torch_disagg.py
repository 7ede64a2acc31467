"""Disaggregated prefill/decode serving and spill migration in the port
(``ray_tpu_torch.llm.serving``), against the JAX package's deployment
and the port's own unified deployment.

In process, on ``debug-128`` at f32 and one numpy tree: a prefill-only
request's ``KVMigrationSource`` on one port deployment feeds a second
port deployment's ``migrated_completions``, whose body must equal the
JAX ``LLMDeployment.completions`` exactly (text, usage, finish reason);
a ``role="prefill"`` deployment relays a decode deployment's blocking
and streamed answers, and falls back to local serving when the decode
pool is unreachable. On a port cluster: the disaggregated app over HTTP
answers what an in-process unified deployment with the same seed does,
the pools show in ``serve.status()``, and each handoff leaves an
``llm.kv_migrate`` span readable through ``util.state.list_spans``.
``tests/test_torch_disagg_recovery.py`` holds the spill migration and
the prefill replica's death.
"""

import dataclasses
import json
import time
import urllib.request

import jax.numpy as jnp
import pytest
import torch

from _torch_parity import numpy_params
from ray_tpu.llm.serving import LLMDeployment as JaxLLMDeployment
from ray_tpu.models.llama import PRESETS as JAX_PRESETS
import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.llm import LLMDeployment, build_llm_app
from ray_tpu_torch.llm.engine import Request
from ray_tpu_torch.llm.migration import KVMigrationSource
from ray_tpu_torch.llm.weights import params_from_numpy
from ray_tpu_torch.models.llama import PRESETS

PRESET = "debug-128"
GEOMETRY = dict(max_slots=4, max_len=256, page_size=16, prefill_chunk_size=64,
                decode_steps_per_dispatch=4)
PROMPT = "hello disaggregated world, " * 3


def _strip(body: dict) -> dict:
    return {k: v for k, v in body.items() if k not in ("id", "created")}


def _sse_text(items) -> str:
    """The token text of an SSE completion, from the generator's items
    (str or bytes events; the response head dict is skipped)."""
    raw = "".join(i.decode() if isinstance(i, bytes) else i
                  for i in items if not isinstance(i, dict))
    text = ""
    for event in raw.split("\n\n"):
        if event.startswith("data: ") and event != "data: [DONE]":
            text += json.loads(event[len("data: "):])["choices"][0]["text"]
    assert raw.rstrip().endswith("data: [DONE]")
    return text


@pytest.fixture(scope="module")
def deployments():
    """(JAX, port source, port decode) deployments on one numpy tree."""
    jcfg = dataclasses.replace(JAX_PRESETS[PRESET], dtype=jnp.float32)
    tcfg = dataclasses.replace(PRESETS[PRESET], dtype=torch.float32)
    tree = numpy_params(tcfg, seed=0)
    jax_dep = JaxLLMDeployment(jcfg, model_id=PRESET,
                               attention_impl="dense", **GEOMETRY)
    assert jax_dep.engine.demote_weights_to_host()["ok"]
    assert jax_dep.engine.install_weights(tree)["ok"]
    port = []
    for role in ("unified", "decode"):
        dep = LLMDeployment(tcfg, model_id=PRESET, role=role, device="cpu",
                            **GEOMETRY)
        assert dep.engine.demote_weights_to_host()["ok"]
        assert dep.engine.install_weights(
            params_from_numpy(tree, "cpu", torch.float32))["ok"]
        port.append(dep)
    try:
        yield jax_dep, port[0], port[1]
    finally:
        for dep in (jax_dep, *port):
            dep.close()


def test_migrated_completion_equals_the_jax_deployment(deployments):
    jax_dep, src_dep, dst_dep = deployments
    body = {"prompt": PROMPT, "max_tokens": 10, "temperature": 0.0}
    ids = src_dep.tokenizer.encode(PROMPT)
    req = Request("handoff", list(ids), max_new_tokens=1, prefill_only=True,
                  pin_for_export=True)
    before = dst_dep.engine.metrics["kv_migrations_in"]
    src_dep.engine.add_request(req)
    src = KVMigrationSource(src_dep.engine, req)
    try:
        got = dst_dep.migrated_completions(
            {"kv_address": src.address, "prompt_len": len(ids)}, dict(body))
    finally:
        src.close()
    assert _strip(got) == _strip(jax_dep.completions(dict(body)))
    assert got["usage"]["completion_tokens"] == 10
    assert dst_dep.engine.metrics["kv_migrations_in"] == before + 1
    assert dst_dep.engine.metrics["kv_pages_imported"] >= 1
    assert req.finish_reason == "prefilled" and not req.generated
    assert src_dep.engine.pool_stats()["pinned"] == 0
    with pytest.raises(ValueError, match="decode_handle"):
        LLMDeployment(PRESET, role="prefill", device="cpu")
    with pytest.raises(ValueError, match="unknown role"):
        LLMDeployment(PRESET, role="mixed", device="cpu")


class _Handle:
    """A decode-pool handle in one process: ``migrated_completions`` of
    ``dep`` for ``.remote``, and the replica's streaming messages
    (``start`` / ``chunk`` / ``full``) for ``.remote_streaming``."""

    def __init__(self, dep, reachable: bool = True):
        self.dep, self.reachable, self.calls = dep, reachable, []

    def options(self, **kw):
        self.calls.append(kw)
        return self

    def _call(self, migration, body):
        if not self.reachable:
            raise ConnectionError("decode pool unreachable")
        return self.dep.migrated_completions(migration, body)

    def remote(self, migration, body):
        out = self._call(migration, body)
        return type("R", (), {"result": lambda self, timeout=None: out})()

    def remote_streaming(self, migration, body):
        out = self._call(migration, body)
        if isinstance(out, dict):
            return iter([{"kind": "full", "data": out}])

        def msgs():
            for item in out:
                if isinstance(item, dict):
                    yield {"kind": "start",
                           "content_type": item["content_type"]}
                else:
                    yield {"kind": "chunk", "data": item.encode()}
        return msgs()


def test_prefill_role_relays_the_decode_replica(deployments):
    """A prefill-role deployment prefills, hands the pages to the decode
    deployment and relays its answer: plain, streamed and chat equal the
    unified deployment's; an unreachable decode pool serves locally."""
    _, uni, dst_dep = deployments
    handle = _Handle(dst_dep)
    pre = LLMDeployment(uni.engine.config, model_id=PRESET, role="prefill",
                        decode_handle=handle, device="cpu", **GEOMETRY)
    try:
        assert pre.engine.demote_weights_to_host()["ok"]
        assert pre.engine.install_weights(uni.engine._host_params)["ok"]
        body = {"prompt": PROMPT + "again", "max_tokens": 8}
        want = _strip(uni.completions(dict(body)))
        want_streamed = _sse_text(uni.completions({**body, "stream": True}))
        before = dst_dep.engine.metrics["kv_migrations_in"]
        assert _strip(pre.completions(dict(body))) == want
        assert _sse_text(pre.completions({**body, "stream": True})) == \
            want_streamed
        # the streamed handoff took its flight-recorder mark: none is left
        # on this thread for a later request
        assert getattr(LLMDeployment._migrate_tls, "tokens", None) is None
        chat = {"messages": [{"role": "user", "content": PROMPT}],
                "max_tokens": 6}
        assert _strip(pre.chat_completions(dict(chat))) == \
            _strip(uni.chat_completions(dict(chat)))
        assert dst_dep.engine.metrics["kv_migrations_in"] == before + 3
        assert dst_dep.engine.metrics["kv_pages_imported"] > 0
        assert all(c["method_name"] == "migrated_completions"
                   for c in handle.calls)
        assert pre.engine_metrics()["role"] == "prefill"
        assert pre.engine.metrics["decode_steps"] == 0  # no local decode
        handle.reachable = False
        assert _strip(pre.completions(dict(body))) == want
        assert _sse_text(pre.completions({**body, "stream": True})) == \
            want_streamed
        assert pre.engine.pool_stats()["pinned"] == 0
    finally:
        pre.close()


# --------------------------------------------------------------- cluster
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


def test_disaggregated_app_equals_the_unified_deployment(cluster):
    from ray_tpu_torch.util.state import list_spans

    serve.run(build_llm_app(PRESET, device="cpu",
                            serve_disaggregation="prefill_decode",
                            num_replicas=1, prefill_replicas=1, **GEOMETRY),
              name="llm-disagg", route_prefix="/dis")
    try:
        pools = {name: d.get("pool")
                 for name, d in serve.status()["llm-disagg"].items()}
        assert pools == {"llm-decode": "decode", "llm-prefill": "prefill"}
        addr = serve.http_address()
        local = LLMDeployment(PRESET, device="cpu", **GEOMETRY)
        try:
            body = {"prompt": PROMPT, "max_tokens": 8}
            want = _strip(local.completions(dict(body)))
            want_streamed = _sse_text(local.completions({**body,
                                                         "stream": True}))
        finally:
            local.close()
        got = _strip(json.loads(_post(addr, "/dis/v1/completions", body)))
        assert got == want
        raw = _post(addr, "/dis/v1/completions", {**body, "stream": True})
        assert _sse_text([raw.decode()]) == want_streamed
        deadline = time.monotonic() + 20
        spans = []
        while time.monotonic() < deadline and len(spans) < 2:
            spans = [s for s in list_spans()
                     if s.get("name") == "llm.kv_migrate"
                     and s["attrs"].get("kind") == "disagg_handoff"]
            time.sleep(0.5)
        assert len(spans) == 2, spans
        assert all(s["attrs"]["complete"] and s["attrs"]["cached_tokens"] > 0
                   for s in spans)
        decode = serve.get_app_handle("llm-disagg")  # the ingress: prefill
        m = decode.options(method_name="engine_metrics").remote().result(
            timeout=60)
        assert m["role"] == "prefill" and m["decode_steps"] == 0
        assert m["kv_migrations_out"] >= 2
    finally:
        serve.delete("llm-disagg")
