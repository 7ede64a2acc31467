"""The port's ``InferenceEngine`` against the JAX package's, on the CPU, and
the guards that keep the port free of JAX.

Greedy tokens of ``ray_tpu_torch.llm.InferenceEngine(device="cpu")`` must
equal those of ``ray_tpu.llm.engine.InferenceEngine`` on the same params
(``debug`` preset, f32, one numpy tree handed to both), on both decode
paths: "dense" and "paged" (the JAX kernel in interpret mode, the port's
kernel through its plain version). ``PageAllocator`` runs the same
operation script on both sides.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import model_pair
from ray_tpu.llm.engine import InferenceEngine as JaxEngine
from ray_tpu.llm.engine import PageAllocator as JaxPageAllocator
from ray_tpu.llm.engine import Request as JaxRequest
from ray_tpu_torch.llm import (ByteTokenizer, InferenceEngine, PageAllocator,
                               QueueFullError, Request, pages_from_numpy,
                               params_from_numpy, resolve_attention_impl)
from ray_tpu_torch.llm.model import init_pages

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def model():
    (jcfg, jparams), (tcfg, tparams) = model_pair("debug")
    return ("jax", jcfg, jparams), ("torch", tcfg, tparams)


def _engine(side, impl, *, K=8, slots=4):
    """An engine of either package; ``side`` is (name, config, params)."""
    name, cfg, params = side
    kw = dict(max_slots=slots, max_len=64, page_size=8,
              decode_steps_per_dispatch=K, attention_impl=impl)
    if name == "jax":
        return JaxEngine(cfg, params, **kw), JaxRequest
    return InferenceEngine(cfg, params, device="cpu", **kw), Request


def _serve(side, impl, waves, *, K=8, max_new_tokens=8, steps_between=2):
    """Submit each wave of prompts, stepping ``steps_between`` times
    between waves (so later prompts prefill while earlier ones decode),
    then step until every request is done. Returns (tokens, engine)."""
    eng, Req = _engine(side, impl, K=K)
    reqs = []
    for w, wave in enumerate(waves):
        for p in wave:
            reqs.append(Req(f"r{len(reqs)}", list(p),
                            max_new_tokens=max_new_tokens))
            eng.add_request(reqs[-1])
        if w + 1 < len(waves):
            for _ in range(steps_between):
                eng.step()
    while any(not r.done for r in reqs):
        eng.step()
    return [r.generated for r in reqs], eng


# The prompt sets of tests/test_paged_attention.py, plus a staggered set
# that runs mixed dispatch.
PROMPT_SETS = {
    "uniform": ([[[1, 5, 9, 2], [2, 4, 6, 8], [3, 1, 4, 1], [9, 9, 9, 9]]],
                dict(max_new_tokens=6)),
    "skewed": ([[list(range(1, 49)), [7, 3], [2, 4, 6], [11, 13, 17, 19]]],
               dict(max_new_tokens=8)),
    "stage_wraparound": ([[[1, 2, 3, 4, 5], [8, 6, 7]]],
                         dict(max_new_tokens=12)),
    "staggered_mixed": ([[[5, 4, 3, 2, 1], [9, 8]],
                         [list(range(30, 50)), [3, 3, 3]]],
                        dict(max_new_tokens=10)),
}

_JAX_TOKENS: dict = {}


def _jax_tokens(model, name, impl):
    key = (name, impl)
    if key not in _JAX_TOKENS:
        waves, kw = PROMPT_SETS[name]
        _JAX_TOKENS[key] = _serve(model[0], impl, waves, **kw)[0]
    return _JAX_TOKENS[key]


@pytest.mark.parametrize("impl", ["dense", "paged"])
@pytest.mark.parametrize("name", list(PROMPT_SETS))
def test_engine_greedy_parity_with_jax(model, name, impl):
    waves, kw = PROMPT_SETS[name]
    got, eng = _serve(model[1], impl, waves, **kw)
    assert eng.attention_impl == impl
    assert got == _jax_tokens(model, name, impl)
    if name == "staggered_mixed":
        assert eng.metrics["engine_step_mix"]["mixed"] > 0
    stats = eng.pool_stats()
    assert stats["pinned"] == 0 and stats["active_slots"] == 0


@pytest.mark.parametrize("impl", ["dense", "paged"])
def test_shared_prefix_cow_fork_parity(model, impl):
    """A second request sharing two full pages and three rows of a partial
    tail page with a retired one maps the full pages read-only and
    COW-forks the tail page before writing past the shared rows."""
    # 21 prompt tokens + 2 fed-back generated ones: 2 full pages and a
    # 7-row tail page, cached at retire
    first = (list(range(10, 31)), 3)
    second = (list(range(10, 29)) + [99, 98, 97], 6)   # shares 19 tokens
    out = {}
    for side in model:
        eng, Req = _engine(side, impl)
        toks = []
        for i, (p, n) in enumerate((first, second)):
            r = Req(f"p{i}", p, max_new_tokens=n)
            eng.add_request(r)
            while not r.done:
                eng.step()
            toks.append(r.generated)
        out[side[0]] = (toks, eng.metrics["cow_forks"],
                          eng.metrics["prefix_hit_pages"])
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == 1 and out["torch"][2] == 2


# -------------------------------------------------------------- allocator

def _allocator_script(alloc_cls):
    """One operation sequence; returns the observable state after each op."""
    a = alloc_cls(12)
    trace = []

    def snap(tag, value=None):
        trace.append((tag, value, sorted(a.free), a.available(),
                      dict(sorted(a.refcount.items()))))

    pages = a.alloc(5)
    snap("alloc5", pages)
    h = [bytes([i]) * 20 for i in range(4)]
    a.register_prefix(pages[0], h[0], b"")
    a.register_prefix(pages[1], h[1], h[0])
    a.register_prefix(pages[2], h[2], h[1])
    a.register_partial(h[2], (7, 8, 9), pages[3])
    snap("registered")
    for p in pages:
        a.release(p)
    snap("released")
    snap("match", a.match_prefix([h[0], h[1], h[3]]))
    snap("partial", a.match_partial(h[2], (7, 8, 5, 5), cap=3))
    snap("partial_cap", a.match_partial(h[2], (7, 8, 9, 1), cap=2))
    a.share(pages[0])
    snap("alloc_all_but_pinned", a.alloc(a.available()))
    snap("alloc_more", a.alloc(1))
    return trace


def test_page_allocator_matches_jax_script():
    got = _allocator_script(PageAllocator)
    want = _allocator_script(JaxPageAllocator)
    assert got == want


def test_page_allocator_refcounts_and_free_list():
    a = PageAllocator(6)
    got = a.alloc(4)
    assert len(set(got)) == 4 and a.available() == 2
    a.share(got[0])
    a.release(got[0])
    assert a.refcount[got[0]] == 1          # still held once
    a.release(got[0])
    assert got[0] in a.free and got[0] not in a.refcount
    assert a.alloc(4) is None               # only 3 available
    assert len(a.alloc(3)) == 3 and a.available() == 0


def test_page_allocator_evicts_leaf_first_lru():
    """Refcount-0 cached leaves go first, least recently used first; a
    parent becomes a leaf once its child is gone."""
    a = PageAllocator(3)
    p = a.alloc(3)
    a.register_prefix(p[0], b"a", b"")
    a.register_prefix(p[1], b"b", b"a")
    a.register_prefix(p[2], b"c", b"")
    for pid in p:
        a.release(pid)
    assert a.available() == 3 and not a.free
    assert a.alloc(1) == [p[1]]     # leaf, released before the other leaf
    assert a.alloc(1) == [p[0]]     # now a leaf, and the oldest
    assert a.match_prefix([b"c"]) == [p[2]]


def test_page_allocator_interior_eviction_frees_descendants():
    a = PageAllocator(3)
    p = a.alloc(3)
    a.register_prefix(p[0], b"root", b"")
    a.register_prefix(p[1], b"child", b"root")
    a.register_partial(b"child", (1, 2), p[2])
    for pid in p:
        a.release(pid)
    a.share(p[1])
    a.share(p[2])
    # Only the interior root is evictable: taking it strands the chain.
    (victim,) = a.alloc(1)
    assert victim == p[0]
    assert a.match_prefix([b"root", b"child"]) == []
    assert a.match_partial(b"child", (1, 2), cap=2) is None
    a.release(p[1])
    a.release(p[2])
    assert sorted(a.free) == sorted([p[1], p[2]])


# ----------------------------------------------------------------- engine

def test_engine_admission_queue_cancel_and_metrics(model):
    _, (_, tcfg, tparams) = model
    eng = InferenceEngine(tcfg, tparams, max_slots=2, max_len=64, page_size=8,
                          device="cpu", max_queued_requests=2)
    with pytest.raises(ValueError, match="max_len"):
        eng.add_request(Request("long", list(range(64))))
    with pytest.raises(ValueError, match="empty"):
        eng.add_request(Request("empty", []))
    reqs = [Request(f"q{i}", [1, 2, 3 + i], max_new_tokens=4)
            for i in range(2)]
    for r in reqs:
        eng.add_request(r)
    with pytest.raises(QueueFullError) as err:
        eng.add_request(Request("q2", [4, 5]))
    assert err.value.retry_after >= 1
    assert eng.metrics["queue_rejects"] == 1
    eng.cancel("q1")
    assert reqs[1].done and reqs[1].finish_reason == "cancelled"
    while not reqs[0].done:
        eng.step()
    assert len(reqs[0].generated) == 4 and reqs[0].finish_reason == "length"
    assert not eng.has_work
    stats = eng.pool_stats()
    assert stats["pinned"] == 0 and stats["waiting"] == 0
    assert eng.generate([1, 2, 3], max_new_tokens=4) == reqs[0].generated


def test_engine_eos_and_stop_ids(model):
    _, (_, tcfg, tparams) = model
    eng = InferenceEngine(tcfg, tparams, max_slots=2, max_len=64, page_size=8,
                          device="cpu")
    free = eng.generate([4, 5, 6], max_new_tokens=8)
    stop = free[2]
    r = Request("s", [4, 5, 6], max_new_tokens=8, eos_id=stop)
    eng.add_request(r)
    while not r.done:
        eng.step()
    assert r.finish_reason == "stop" and r.generated == free[:free.index(stop) + 1]


def test_tokenizer_round_trip():
    tok = ByteTokenizer()
    ids = tok.encode("héllo")
    assert ids[0] == tok.bos_id and tok.decode(ids) == "héllo"


# ----------------------------------------------------------------- guards

def test_resolve_attention_impl_and_device():
    assert resolve_attention_impl("auto", "cuda") == "paged"
    assert resolve_attention_impl("auto", "cpu") == "dense"
    assert resolve_attention_impl("paged", "cpu") == "paged"
    assert resolve_attention_impl("dense", "cuda") == "dense"
    with pytest.raises(ValueError, match="attention_impl"):
        resolve_attention_impl("fused")


@pytest.mark.skipif("torch.cuda.is_available()",
                    reason="checks the behaviour without a CUDA device")
def test_default_device_raises_without_cuda(model):
    _, (_, tcfg, tparams) = model
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(tcfg, tparams, max_slots=2, max_len=64, page_size=8)


def _device_default_calls(tcfg):
    """Each entry point that places tensors, called with ``device``
    (``None``: the default)."""
    np_pages = {k: np.zeros((1, 2, 1, 4, 8), np.float32) for k in "kv"}
    return {
        "init_pages": lambda device: init_pages(tcfg, 4, 8, device)["k"],
        "params_from_numpy": lambda device: params_from_numpy(
            {"w": np.ones(3, np.float32)}, device)["w"],
        "pages_from_numpy": lambda device: pages_from_numpy(
            np_pages, device)["k"],
    }


@pytest.mark.skipif("torch.cuda.is_available()",
                    reason="checks the behaviour without a CUDA device")
@pytest.mark.parametrize("name", ["init_pages", "params_from_numpy",
                                  "pages_from_numpy"])
def test_entry_points_default_to_the_card_and_raise_without_one(model,
                                                                 name):
    _, (_, tcfg, _) = model
    call = _device_default_calls(tcfg)[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call(None)
    assert call("cpu").device.type == "cpu"


def test_import_loads_no_jax_and_no_ray_tpu():
    code = ("import sys, ray_tpu_torch, ray_tpu_torch.llm.engine, "
            "ray_tpu_torch.llm.lora, ray_tpu_torch.llm.tenancy, "
            "ray_tpu_torch.ops.paged_attention, ray_tpu_torch._cuda, "
            "ray_tpu_torch._device, "
            "ray_tpu_torch.ops.attention, ray_tpu_torch.models.llama, "
            "ray_tpu_torch.serve, ray_tpu_torch.llm.serving, "
            "ray_tpu_torch.tune, ray_tpu_torch.workflow, ray_tpu_torch.job, "
            "ray_tpu_torch.util.actor_pool, ray_tpu_torch.util.queue, "
            "ray_tpu_torch.util.multiprocessing, ray_tpu_torch.cluster_utils, "
            "ray_tpu_torch.chaos.runner\n"
            "from ray_tpu_torch.ops.attention import (flash_route, "
            "flash_forward_sm90_cuda, flash_dq_sm90_cuda, "
            "flash_dkdv_sm90_cuda)\n"
            "from ray_tpu_torch.ops.paged_attention import (paged_route, "
            "paged_split_plan, paged_decode_split_cuda)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ray_tpu'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # The compiled graphs, the chaos plans, runner and verifier, the state
    # API, workflows, jobs and the queue run in CPU workers and job
    # drivers: they load neither torch nor yaml at import.
    code = ("import sys, ray_tpu_torch.dag, ray_tpu_torch.chaos, "
            "ray_tpu_torch.chaos.plan, ray_tpu_torch.dag.loop, "
            "ray_tpu_torch.chaos.verifier, ray_tpu_torch.util.state, "
            "ray_tpu_torch.workflow, ray_tpu_torch.job, "
            "ray_tpu_torch.util.queue, ray_tpu_torch.chaos.runner\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ray_tpu', 'torch', 'yaml'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_import_no_jax():
    files = sorted((REPO / "ray_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "ray_tpu", "flax",
                                    "ml_dtypes"}
        assert not bad, f"{f.relative_to(REPO)} imports {sorted(bad)}"
