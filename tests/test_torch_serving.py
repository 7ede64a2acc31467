"""The port's LLM app (``ray_tpu_torch.llm.serving``) against the JAX
package's, and behind the port's Serve over HTTP.

In process: the JAX ``LLMDeployment`` and the port's, on ``debug-128``
(the smallest preset whose vocabulary holds the byte tokenizer's 258 ids)
at f32, both given one numpy tree through each engine's own
``demote_weights_to_host`` then ``install_weights``, must return equal
bodies for ``completions`` (text, usage, finish reason; plain and
streamed), ``chat_completions`` and ``models`` at temperature 0 (ids and
timestamps aside). On the port's cluster: ``serve.run(build_llm_app(...,
device="cpu"))`` must answer over HTTP what an in-process port deployment
with the same seed answers.
"""

import dataclasses
import json
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
from ray_tpu_torch.llm.weights import params_from_numpy
from ray_tpu_torch.models.llama import PRESETS

PRESET = "debug-128"
GEOMETRY = dict(max_slots=4, max_len=256, page_size=16, prefill_chunk_size=64,
                decode_steps_per_dispatch=4)
PROMPTS = ["The quick brown fox", "a", "0123456789" * 9]


def _strip(body: dict) -> dict:
    return {k: v for k, v in body.items() if k not in ("id", "created")}


def _stream_text(gen) -> tuple[str, str, list]:
    """(text, finish reason, events) of an SSE completion generator."""
    events = []
    for item in gen:
        if isinstance(item, dict):  # the response head
            continue
        events.append(item)
    assert events[-1] == "data: [DONE]\n\n"
    chunks = [json.loads(e[len("data: "):]) for e in events[:-1]]
    text = "".join(c["choices"][0]["text"] for c in chunks)
    return text, chunks[-1]["choices"][0]["finish_reason"], events


@pytest.fixture(scope="module")
def deployments():
    jcfg = dataclasses.replace(JAX_PRESETS[PRESET], dtype=jnp.float32)
    tcfg = dataclasses.replace(PRESETS[PRESET], dtype=torch.float32)
    tree = numpy_params(tcfg, seed=0)
    jax_dep = JaxLLMDeployment(jcfg, model_id=PRESET,
                               attention_impl="dense", **GEOMETRY)
    port_dep = LLMDeployment(tcfg, model_id=PRESET, device="cpu", **GEOMETRY)
    assert jax_dep.engine.demote_weights_to_host()["ok"]
    assert jax_dep.engine.install_weights(tree)["ok"]
    assert port_dep.engine.demote_weights_to_host()["ok"]
    assert port_dep.engine.install_weights(
        params_from_numpy(tree, "cpu", torch.float32))["ok"]
    try:
        yield jax_dep, port_dep
    finally:
        jax_dep.close()
        port_dep.close()


def test_completion_bodies_equal_the_jax_deployment(deployments):
    jax_dep, port_dep = deployments
    for prompt in PROMPTS:
        body = {"prompt": prompt, "max_tokens": 12, "temperature": 0.0}
        want = _strip(jax_dep.completions(dict(body)))
        got = _strip(port_dep.completions(dict(body)))
        assert got == want
        assert got["usage"]["completion_tokens"] == 12
        assert port_dep.generate(prompt, 12)["tokens"] == \
            jax_dep.generate(prompt, 12)["tokens"]


def test_streamed_completion_equals_the_jax_deployment(deployments):
    jax_dep, port_dep = deployments
    body = {"prompt": PROMPTS[0], "max_tokens": 10, "stream": True}
    want_text, want_finish, want_events = _stream_text(
        jax_dep.completions(dict(body)))
    got_text, got_finish, got_events = _stream_text(
        port_dep.completions(dict(body)))
    assert (got_text, got_finish) == (want_text, want_finish)
    assert len(got_events) == len(want_events)
    plain = port_dep.completions({"prompt": PROMPTS[0], "max_tokens": 10})
    assert got_text == plain["choices"][0]["text"]


def test_chat_and_models_equal_the_jax_deployment(deployments):
    jax_dep, port_dep = deployments
    body = {"messages": [{"role": "system", "content": "be brief"},
                         {"role": "user", "content": "hello there"}],
            "max_tokens": 8}
    assert _strip(port_dep.chat_completions(dict(body))) == \
        _strip(jax_dep.chat_completions(dict(body)))
    assert port_dep.models() == jax_dep.models()


def _post(addr: str, path: str, body: dict) -> bytes:
    req = urllib.request.Request(
        addr + path, data=json.dumps(body).encode(),
        headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as f:
        return f.read()


def test_http_app_answers_what_the_in_process_deployment_does():
    rt.init(num_cpus=4)
    try:
        serve.run(build_llm_app(PRESET, device="cpu", **GEOMETRY), name="llm")
        addr = serve.http_address()
        local = LLMDeployment(PRESET, device="cpu", **GEOMETRY)
        try:
            body = {"prompt": PROMPTS[0], "max_tokens": 12}
            want = _strip(local.completions(dict(body)))
            got = _strip(json.loads(_post(addr, "/v1/completions", body)))
            assert got == want
            raw = _post(addr, "/v1/completions", {**body, "stream": True})
            events = [e + "\n\n" for e in raw.decode().split("\n\n") if e]
            text, finish, _ = _stream_text(events)
            assert (text, finish) == (want["choices"][0]["text"],
                                      want["choices"][0]["finish_reason"])
            with urllib.request.urlopen(addr + "/v1/models",
                                        timeout=60) as f:
                assert json.loads(f.read()) == local.models()
        finally:
            local.close()
            serve.shutdown()
    finally:
        rt.shutdown()


@pytest.mark.skipif("torch.cuda.is_available()",
                    reason="checks the behaviour without a CUDA device")
def test_deployment_defaults_to_the_card_and_raises_without_one():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LLMDeployment(PRESET, **GEOMETRY)
