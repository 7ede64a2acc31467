"""The weight tiers of the port (``ray_tpu_torch/llm/weights.py`` and the
engine's residency), against the JAX package on the CPU.

``params_fingerprint`` must equal the JAX package's on the same numpy
tree, bf16 and f32; host copies and the broadcast wire must keep every
bit (bf16 as raw 16-bit integers); a dead donor leaves its readers with
nothing; and the engine demotes, promotes and installs weights as
``tests/test_fleet.py`` requires of the JAX engine, decoding the same
greedy tokens before and after.
"""

import dataclasses
import pickle
import threading

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from _torch_parity import numpy_params
from ray_tpu.llm import weights as jweights
from ray_tpu_torch.llm import (InferenceEngine, Request,
                               WeightBroadcastSource, host_to_device,
                               params_fingerprint, params_from_numpy,
                               receive_weight_stream, tree_bytes,
                               tree_to_host)
from ray_tpu_torch.llm.weights import host_to_tensor, tensor_to_host
from ray_tpu_torch.models.llama import PRESETS

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _numpy_tree(dtype: str) -> dict:
    """The ``debug`` tree made with numpy from a seed, in ``dtype``
    (bf16 as ``ml_dtypes`` arrays, as the JAX package holds them)."""
    tree = numpy_params(PRESETS["debug"], seed=0)
    jdt, _ = DTYPES[dtype]
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jdt)), tree)


def _leaves(tree) -> list:
    return jax.tree_util.tree_leaves(tree)


@pytest.fixture(scope="module")
def engine_params():
    cfg = dataclasses.replace(PRESETS["debug"], dtype=torch.float32)
    return cfg, params_from_numpy(_numpy_tree("float32"), "cpu")


def _engine(engine_params):
    cfg, params = engine_params
    return InferenceEngine(cfg, params, max_slots=2, max_len=64,
                           enable_prefix_cache=False, device="cpu")


def _generate(eng, prompt, n=6):
    r = Request(f"r{len(prompt)}-{n}", list(prompt), max_new_tokens=n)
    eng.add_request(r)
    while not r.done:
        eng.step()
    return list(r.generated)


# ------------------------------------------------------------- host tier
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fingerprint_equals_jax(dtype):
    tree = _numpy_tree(dtype)
    want = jweights.params_fingerprint(jax.tree.map(jnp.asarray, tree))
    assert jweights.params_fingerprint(tree) == want
    assert params_fingerprint(tree) == want
    _, tdt = DTYPES[dtype]
    assert params_fingerprint(params_from_numpy(tree, "cpu", tdt)) == want
    assert tree_bytes(tree) == jweights.tree_bytes(tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_host_round_trip_is_bit_exact(dtype):
    _, tdt = DTYPES[dtype]
    params = params_from_numpy(_numpy_tree(dtype), "cpu", tdt)
    want = params_fingerprint(params)
    host = tree_to_host(params)
    back = host_to_device(host, "cpu")
    assert params_fingerprint(host) == params_fingerprint(back) == want
    assert tree_bytes(host) == tree_bytes(params)


def test_bf16_travels_as_raw_16_bit_integers():
    t = params_from_numpy(_numpy_tree("bfloat16"), "cpu")["layers"]["wq"]
    assert t.dtype == torch.bfloat16
    arr, tag = tensor_to_host(t)
    assert tag == "bfloat16" and arr.dtype == np.int16
    assert arr.nbytes == t.numel() * 2
    arr, tag = pickle.loads(pickle.dumps((arr, tag)))
    back = host_to_tensor(arr, tag)
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)
    # a JAX payload's ml_dtypes array reads through its bits as well
    jarr = _numpy_tree("bfloat16")["layers"]["wq"]
    assert torch.equal(host_to_tensor(jarr), t)
    with pytest.raises(ValueError):
        host_to_tensor(np.zeros(3, np.float32), "bfloat16")


@pytest.mark.skipif("torch.cuda.is_available()",
                    reason="checks the behaviour without a CUDA device")
def test_promotion_defaults_to_the_card_and_raises_without_one():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        host_to_device({"w": torch.ones(3)})


# -------------------------------------------------------- broadcast wire
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_broadcast_to_two_readers(dtype):
    _, tdt = DTYPES[dtype]
    params = params_from_numpy(_numpy_tree(dtype), "cpu", tdt)
    want = params_fingerprint(params)
    src = WeightBroadcastSource(params, model="m", n_readers=2,
                                chunk_bytes=64 << 10)
    got = [None, None]

    def read(i):
        got[i] = receive_weight_stream(src.address, timeout_s=60.0)

    readers = [threading.Thread(target=read, args=(i,)) for i in range(2)]
    for t in readers:
        t.start()
    for t in readers:
        t.join(timeout=90)
    src.join(timeout=10)
    src.close()
    assert not any(t.is_alive() for t in readers)
    assert src.fingerprint == want
    for res in got:
        assert res["complete"] and res["status"] == "ok", res["status"]
        assert res["fingerprint"] == want and res["model"] == "m"
        assert params_fingerprint(res["params"]) == want
        assert res["params"].keys() == params.keys()
        for a, b in zip(_leaves(params), _leaves(res["params"])):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_source_death_mid_stream_reports_incomplete():
    params = params_from_numpy(_numpy_tree("float32"), "cpu")
    src = WeightBroadcastSource(params, model="m", n_readers=1,
                                chunk_bytes=64 << 10, _die_after_chunks=2)
    res = receive_weight_stream(src.address, timeout_s=30.0)
    src.join(timeout=10)
    assert res["params"] is None
    assert not res["complete"]
    assert res["status"] != "ok"


# ------------------------------------------------------- engine residency
def test_engine_demote_promote_round_trip(engine_params):
    eng = _engine(engine_params)
    prompt = [3, 1, 4, 1, 5, 9]
    before = _generate(eng, prompt)
    fingerprint = params_fingerprint(eng.executor.params)
    res = eng.demote_weights_to_host()
    assert res["ok"] and res["bytes"] == tree_bytes(engine_params[1]) > 0
    assert not eng.weights_resident() and eng.executor.params is None
    assert eng.metrics["weights_demoted"] == 1
    assert eng.demote_weights_to_host()["already"]
    out = eng.promote_weights_from_host()
    assert out["ok"] and not out.get("already")
    assert eng.weights_resident()
    assert eng.metrics["weights_promoted"] == 1
    assert eng.metrics["weight_promote_ms"] > 0
    assert params_fingerprint(eng.executor.params) == fingerprint
    assert _generate(eng, prompt) == before


def test_engine_demote_refused_while_busy(engine_params):
    eng = _engine(engine_params)
    r = Request("busy", [1, 2, 3], max_new_tokens=4)
    eng.add_request(r)
    res = eng.demote_weights_to_host()
    assert not res["ok"] and res["reason"] == "busy"
    while not r.done:
        eng.step()
    assert eng.demote_weights_to_host()["ok"]
    assert eng.promote_weights_from_host()["ok"]


def test_first_request_auto_promotes(engine_params):
    eng = _engine(engine_params)
    prompt = [2, 7, 1, 8]
    before = _generate(eng, prompt)
    assert eng.demote_weights_to_host()["ok"]
    assert not eng.weights_resident()
    assert _generate(eng, prompt) == before
    assert eng.weights_resident()
    assert eng.metrics["weights_promoted"] == 1


def test_install_weights_into_a_demoted_engine(engine_params):
    _, params = engine_params
    eng = _engine(engine_params)
    prompt = [5, 3, 5]
    before = _generate(eng, prompt)
    assert eng.demote_weights_to_host()["ok"]
    src = WeightBroadcastSource(params, n_readers=1)
    res = receive_weight_stream(src.address, timeout_s=60.0)
    src.close()
    assert res["complete"], res["status"]
    out = eng.install_weights(res["params"])
    assert out["ok"] and eng.weights_resident()
    assert params_fingerprint(eng.executor.params) == \
        params_fingerprint(params)
    assert _generate(eng, prompt) == before
