"""The operator plane's decode path on the CPU: a ``ray://`` driver in
another process starts an actor on a port cluster that builds the port's
``InferenceEngine`` (``debug``, f32, ``device="cpu"``) from one numpy
tree and streams its greedy tokens back over ``num_returns="streaming"``;
they must equal the JAX package's ``InferenceEngine`` on the same tree
(its paged kernel in interpret mode)."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import ray_tpu_torch as rt
from _torch_parity import model_pair, numpy_params
from ray_tpu.llm.engine import InferenceEngine as JaxEngine
from ray_tpu.llm.engine import Request as JaxRequest
from ray_tpu_torch.util.client import ClientServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRY = dict(max_slots=4, max_len=64, page_size=8,
                decode_steps_per_dispatch=8, attention_impl="paged")
PROMPTS = {"a": [1, 5, 9, 2], "b": list(range(10, 31)), "c": [7, 3, 2]}
NEW = 8

DRIVER = '''
import json
import sys

import ray_tpu_torch as rt

args = json.loads(sys.argv[1])
rt.init(address="ray://" + args["address"])


@rt.remote
class Decoder:
    """Builds the engine from the numpy tree and streams each step's new
    tokens."""

    def __init__(self, tree_path, geometry):
        import dataclasses

        import numpy as np
        import torch

        from ray_tpu_torch.llm import InferenceEngine, params_from_numpy
        from ray_tpu_torch.models.llama import PRESETS

        with np.load(tree_path) as z:
            flat = {k: z[k] for k in z.files}
        tree = {}
        for key, value in flat.items():
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = value
        cfg = dataclasses.replace(PRESETS["debug"], dtype=torch.float32)
        self.eng = InferenceEngine(
            cfg, params_from_numpy(tree, "cpu", torch.float32),
            device="cpu", **geometry)

    def stream(self, prompts, new):
        from ray_tpu_torch.llm import Request

        reqs = [Request(rid, p, max_new_tokens=new)
                for rid, p in prompts.items()]
        for r in reqs:
            self.eng.add_request(r)
        sent = {r.request_id: 0 for r in reqs}
        while any(not r.done for r in reqs):
            self.eng.step()
            out = {}
            for r in reqs:
                if len(r.generated) > sent[r.request_id]:
                    out[r.request_id] = list(r.generated[sent[r.request_id]:])
                    sent[r.request_id] = len(r.generated)
            if out:
                yield out


dec = Decoder.remote(args["tree"], args["geometry"])
tokens = {rid: [] for rid in args["prompts"]}
chunks = 0
for ref in dec.stream.options(num_returns="streaming").remote(
        args["prompts"], args["new"]):
    for rid, toks in rt.get(ref, timeout=300).items():
        tokens[rid].extend(toks)
    chunks += 1
rt.shutdown()
print("TOKENS " + json.dumps({"tokens": tokens, "chunks": chunks}))
'''


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=2)
    try:
        yield
    finally:
        rt.shutdown()


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _jax_tokens() -> dict:
    (jcfg, jparams), _ = model_pair("debug")
    eng = JaxEngine(jcfg, jparams, **GEOMETRY)
    reqs = [JaxRequest(rid, list(p), max_new_tokens=NEW)
            for rid, p in PROMPTS.items()]
    for r in reqs:
        eng.add_request(r)
    while any(not r.done for r in reqs):
        eng.step()
    return {r.request_id: list(r.generated) for r in reqs}


def test_client_driver_decode_equals_jax_engine(cluster, tmp_path):
    (_, _), (tcfg, _) = model_pair("debug")
    tree_path = str(tmp_path / "tree.npz")
    np.savez(tree_path, **_flatten(numpy_params(tcfg, 0)))
    server = ClientServer(port=0)
    try:
        args = {"address": server.address, "tree": tree_path,
                "geometry": GEOMETRY, "prompts": PROMPTS, "new": NEW}
        proc = subprocess.run(
            [sys.executable, "-c", textwrap.dedent(DRIVER), json.dumps(args)],
            capture_output=True, text=True, timeout=300, cwd=REPO)
    finally:
        server.stop()
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith("TOKENS ")), None)
    assert line is not None, proc.stderr[-3000:]
    got = json.loads(line[len("TOKENS "):])
    assert got["chunks"] >= 2  # streamed, not returned at once
    want = _jax_tokens()
    assert got["tokens"] == want
    assert all(len(t) == NEW for t in want.values())
