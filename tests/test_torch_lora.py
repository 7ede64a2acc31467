"""The port's multi-LoRA serving (``ray_tpu_torch.llm.lora``, ``tenancy``
and the LoRA terms of the model programs, executor and engine) against
the JAX package's, on the CPU.

``debug`` preset at f32, one numpy parameter tree for both sides
(``tests/_torch_parity.py``), and seeded numpy adapters (scale 0.5, as
``ray_tpu/_tenancy_bench.py::_rand_adapter``, large enough to change
greedy tokens) written with the JAX package's ``save_adapter``. Tokens,
slots and stats must be equal; float outputs agree to 1e-5 (f32 sums
taken in another order). The JAX paged path runs its Pallas kernel in
interpret mode; the port's runs the kernel's plain version.
"""

import pathlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from _torch_parity import model_pair, tree_to_numpy
from ray_tpu.llm import lora as jlora
from ray_tpu.llm import model as jm
from ray_tpu.llm import tenancy as jtenancy
from ray_tpu.llm.engine import InferenceEngine as JaxEngine
from ray_tpu.llm.engine import Request as JaxRequest
from ray_tpu_torch.llm import (AdapterCapacityError, InferenceEngine,
                               LoRAManager, LoRAServingConfig, Request)
from ray_tpu_torch.llm import lora as tlora
from ray_tpu_torch.llm import model as tm
from ray_tpu_torch.llm import tenancy as ttenancy
from ray_tpu_torch.llm.weights import pages_from_numpy

TOL = 1e-5
PAGE, RANK, MAX_RANK = 8, 2, 4


@pytest.fixture(scope="module")
def model():
    (jcfg, jparams), (tcfg, tparams) = model_pair("debug")
    return jcfg, jparams, tcfg, tparams


def _adapter(cfg, seed: int, rank: int = RANK, scale: float = 0.5) -> dict:
    """``_tenancy_bench._rand_adapter``'s arrays from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = {}
    for p, (ein, eout) in tlora.proj_dims(cfg).items():
        out[f"{p}.A"] = (rng.standard_normal((cfg.n_layers, ein, rank))
                         * scale / ein ** 0.5).astype(np.float32)
        out[f"{p}.B"] = (rng.standard_normal((cfg.n_layers, rank, eout))
                         * scale).astype(np.float32)
    return out


def _np_stack(cfg, n_adapters: int = 3) -> dict:
    """A [L, 1 + n_adapters, ...] stack: slot 0 zeros, slot i adapter i
    padded to MAX_RANK."""
    stack = {}
    for p, (ein, eout) in tlora.proj_dims(cfg).items():
        a = np.zeros((cfg.n_layers, n_adapters + 1, ein, MAX_RANK), np.float32)
        b = np.zeros((cfg.n_layers, n_adapters + 1, MAX_RANK, eout),
                     np.float32)
        for i in range(1, n_adapters + 1):
            ad = _adapter(cfg, seed=i)
            a[:, i, :, :RANK] = ad[f"{p}.A"]
            b[:, i, :RANK] = ad[f"{p}.B"]
        stack[f"{p}.A"], stack[f"{p}.B"] = a, b
    return stack


def _both(np_stack):
    return ({k: jnp.asarray(v) for k, v in np_stack.items()},
            {k: torch.from_numpy(v.copy()) for k, v in np_stack.items()})


def _pools(cfg, num_pages, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, num_pages, cfg.n_kv_heads, PAGE, cfg.head_dim)
    return {k: rng.standard_normal(shape).astype(np.float32) for k in "kv"}


def _close(got: dict, want: dict, first_page: int = 0):
    for name in ("k", "v"):
        np.testing.assert_allclose(tree_to_numpy(got[name])[:, first_page:],
                                   np.asarray(want[name])[:, first_page:],
                                   atol=TOL, rtol=TOL)


# ---------------------------------------------------------------- the math

def test_lora_delta_and_single_match_jax(model):
    jcfg, *_ = model
    jstack, tstack = _both(_np_stack(jcfg))
    rng = np.random.default_rng(0)
    h = rng.standard_normal((4, 3, jcfg.hidden)).astype(np.float32)
    idx = np.array([0, 2, 1, 3], np.int32)
    for p in ("wq", "wk", "wv"):
        want = jlora.lora_delta(jnp.asarray(h), jstack[f"{p}.A"],
                                jstack[f"{p}.B"], 1, jnp.asarray(idx))
        got = tlora.lora_delta(torch.from_numpy(h), tstack[f"{p}.A"],
                               tstack[f"{p}.B"], 1, torch.from_numpy(idx))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)
    h1 = rng.standard_normal((1, 5, jcfg.n_heads * jcfg.head_dim)).astype(
        np.float32)
    for slot in (0, 2):
        want = jlora.lora_delta_single(jnp.asarray(h1), jstack["wo.A"],
                                       jstack["wo.B"], 0, jnp.int32(slot))
        got = tlora.lora_delta_single(torch.from_numpy(h1), tstack["wo.A"],
                                      tstack["wo.B"], 0, slot)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)
    assert np.abs(np.asarray(want)).max() > 0.1


def test_decode_deltas_equal_lora_delta(model):
    """The decode path's folded form (rows gathered once, one product for
    q/k/v, ``baddbmm_``) adds exactly ``lora_delta`` per slot."""
    jcfg, *_ = model
    _, tstack = _both(_np_stack(jcfg))
    n, c = 4, jcfg
    rng = np.random.default_rng(1)
    idx = torch.tensor([3, 0, 1, 2], dtype=torch.int32)
    h = torch.from_numpy(rng.standard_normal((n, 1, c.hidden)).astype(
        np.float32))
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (n, heads, 1, c.head_dim)).astype(np.float32))
        for heads in (c.n_heads, c.n_kv_heads, c.n_kv_heads))
    rows = tlora.slot_rows(tstack, idx)
    got = tlora.add_qkv_deltas(q.clone(), k.clone(), v.clone(), h, rows, 1)
    for t, g, p in zip((q, k, v), got, ("wq", "wk", "wv")):
        d = tlora.lora_delta(h, tstack[f"{p}.A"], tstack[f"{p}.B"], 1, idx)
        want = t + d.reshape(n, 1, t.shape[1], c.head_dim).transpose(1, 2)
        torch.testing.assert_close(g, want, atol=TOL, rtol=TOL)
    attn = torch.from_numpy(rng.standard_normal(
        (n, 1, c.n_heads * c.head_dim)).astype(np.float32))
    out = torch.zeros(n, 1, c.hidden)
    tlora.add_wo_delta_(out, attn, rows, 0)
    torch.testing.assert_close(out, tlora.lora_delta(
        attn, tstack["wo.A"], tstack["wo.B"], 0, idx), atol=TOL, rtol=TOL)


# ----------------------------------------------------------- model programs

@pytest.mark.parametrize("start_pos,slot", [(0, 2), (13, 1)])
def test_prefill_chunk_with_adapter_matches_jax(model, start_pos, slot):
    jcfg, jparams, tcfg, tparams = model
    jstack, tstack = _both(_np_stack(jcfg))
    np_pages = _pools(jcfg, 12, seed=start_pos)
    bt = np.array([7, 3, 9, 4, 11, 5], np.int32)
    tokens = np.random.default_rng(2).integers(0, 256, 16).astype(np.int32)
    jpages, jh = jm.prefill_chunk(
        jparams, {k: jnp.asarray(v) for k, v in np_pages.items()},
        jnp.asarray(bt), jnp.asarray(tokens), jnp.int32(start_pos),
        config=jcfg, page_size=PAGE, live_pages=2, lora=jstack,
        lora_slot=jnp.int32(slot))
    tpages, th = tm.prefill_chunk(
        tparams, pages_from_numpy(np_pages, "cpu"), torch.from_numpy(bt),
        torch.from_numpy(tokens), start_pos, config=tcfg, page_size=PAGE,
        live_pages=2, lora=tstack, lora_slot=slot)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL, rtol=TOL)
    _close(tpages, jpages)
    # the adapter moved the hidden state: the base model's differs
    _, base = tm.prefill_chunk(
        tparams, pages_from_numpy(np_pages, "cpu"), torch.from_numpy(bt),
        torch.from_numpy(tokens), start_pos, config=tcfg, page_size=PAGE,
        live_pages=2)
    assert (base - th).abs().max() > 0.1


def _decode_host(slots=4, max_pages=6):
    num_pages = slots + slots * max_pages
    bt = np.arange(slots, num_pages, dtype=np.int32).reshape(slots, max_pages)
    return num_pages, bt


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_loop_with_mixed_adapters_matches_jax(model, paged):
    """Four slots on the base model and three adapters, K steps across a
    page edge, one slot finishing mid-dispatch."""
    jcfg, jparams, tcfg, tparams = model
    jstack, tstack = _both(_np_stack(jcfg))
    K, slots = 6, 4
    num_pages, bt = _decode_host(slots)
    np_pages = _pools(jcfg, num_pages, seed=3)
    host = (bt, np.array([3, 7, 11, 5], np.int32),
            np.array([5, 8, 12, 3], np.int32), np.zeros(slots, np.float32),
            np.full(slots, -1, np.int32), np.array([100, 3, 100, 100],
                                                   np.int32))
    idx = np.array([0, 2, 1, 3], np.int32)
    jt, _, jpages = jm.decode_loop(
        jparams, {k: jnp.asarray(v) for k, v in np_pages.items()},
        *[jnp.asarray(a) for a in host], jax.random.PRNGKey(0), config=jcfg,
        page_size=PAGE, n_steps=K, paged=paged, live_pages=4, lora=jstack,
        lora_idx=jnp.asarray(idx))
    tt, tpages = tm.decode_loop(
        tparams, pages_from_numpy(np_pages, "cpu"),
        *[torch.from_numpy(a) for a in host], torch.Generator(), config=tcfg,
        page_size=PAGE, n_steps=K, paged=paged, live_pages=4, lora=tstack,
        lora_idx=torch.from_numpy(idx))
    jt = np.asarray(jt)
    np.testing.assert_array_equal(tt.numpy()[:, [0, 2, 3]], jt[:, [0, 2, 3]])
    np.testing.assert_array_equal(tt.numpy()[:3, 1], jt[:3, 1])
    _close(tpages, jpages, first_page=slots)   # trash pages unspecified
    # the adapters change tokens: the base model's differ
    tb, _ = tm.decode_loop(
        tparams, pages_from_numpy(np_pages, "cpu"),
        *[torch.from_numpy(a) for a in host], torch.Generator(), config=tcfg,
        page_size=PAGE, n_steps=K, paged=paged, live_pages=4)
    assert (tb.numpy()[:, 0] == tt.numpy()[:, 0]).all()
    assert not (tb.numpy()[:, [2, 3]] == tt.numpy()[:, [2, 3]]).all()


def test_decode_step_with_adapters_matches_jax(model):
    jcfg, jparams, tcfg, tparams = model
    jstack, tstack = _both(_np_stack(jcfg))
    num_pages, bt = _decode_host()
    np_pages = _pools(jcfg, num_pages, seed=4)
    tokens, pos = np.array([1, 2, 3, 4], np.int32), np.array([9, 2, 15, 7],
                                                             np.int32)
    idx = np.array([1, 1, 3, 0], np.int32)
    jl, jpages = jm.decode_step(
        jparams, {k: jnp.asarray(v) for k, v in np_pages.items()},
        jnp.asarray(bt), jnp.asarray(tokens), jnp.asarray(pos), config=jcfg,
        page_size=PAGE, live_pages=4, lora=jstack, lora_idx=jnp.asarray(idx))
    tl, tpages = tm.decode_step(
        tparams, pages_from_numpy(np_pages, "cpu"), torch.from_numpy(bt),
        torch.from_numpy(tokens), torch.from_numpy(pos), config=tcfg,
        page_size=PAGE, live_pages=4, lora=tstack,
        lora_idx=torch.from_numpy(idx))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=TOL)
    _close(tpages, jpages)


def test_mixed_dispatch_with_adapters_matches_jax(model):
    """A base prompt's chunk rides the decode burst of slots holding two
    adapters and the base model."""
    jcfg, jparams, tcfg, tparams = model
    jstack, tstack = _both(_np_stack(jcfg))
    K, slots = 4, 4
    num_pages, bt = _decode_host(slots)
    np_pages = _pools(jcfg, num_pages, seed=5)
    rng = np.random.default_rng(6)
    ops = [(bt[3], rng.integers(0, 256, 16).astype(np.int32), 8)]
    dec_bt = bt.copy()
    dec_bt[3] = 3                            # the prefilling slot: trash
    host = (dec_bt, np.array([5, 6, 7, 0], np.int32),
            np.array([9, 14, 3, 0], np.int32), np.zeros(slots, np.float32),
            np.full(slots, -1, np.int32), np.array([20, 20, 20, 0], np.int32))
    idx = np.array([2, 0, 3, 0], np.int32)
    jt, _, jpages, jh = jm.mixed_dispatch(
        jparams, {k: jnp.asarray(v) for k, v in np_pages.items()},
        tuple((jnp.asarray(b), jnp.asarray(t), jnp.int32(s))
              for b, t, s in ops),
        *[jnp.asarray(a) for a in host], jax.random.PRNGKey(0), config=jcfg,
        page_size=PAGE, n_steps=K, paged=False, live_pages=4,
        prefill_live_pages=(1,), lora=jstack, lora_idx=jnp.asarray(idx))
    tt, tpages, th = tm.mixed_dispatch(
        tparams, pages_from_numpy(np_pages, "cpu"),
        tuple((torch.from_numpy(b), torch.from_numpy(t), s)
              for b, t, s in ops),
        *[torch.from_numpy(a) for a in host], torch.Generator(), config=tcfg,
        page_size=PAGE, n_steps=K, paged=False, live_pages=4,
        prefill_live_pages=(1,), lora=tstack, lora_idx=torch.from_numpy(idx))
    np.testing.assert_array_equal(tt.numpy()[:, :3], np.asarray(jt)[:, :3])
    np.testing.assert_allclose(th[0].numpy(), np.asarray(jh[0]), atol=TOL,
                               rtol=TOL)
    _close(tpages, jpages, first_page=slots)


# --------------------------------------------------------- host bookkeeping

def _pool_script(pool_cls, err_cls):
    """One operation sequence over a 2-slot pool; returns what each step
    observes."""
    p = pool_cls(capacity=2)
    evicted = []
    p.on_evict = lambda aid, slot: evicted.append((aid, slot))
    trace = []
    trace.append(("load_a", p.begin_load("a")))
    p.commit_load("a", 2.0)
    trace.append(("load_b", p.begin_load("b")))
    p.commit_load("b", 4.0)
    try:
        p.begin_load("c")
    except err_cls:
        trace.append(("c_deferred",))
    p.unpin_slot(trace[0][1])
    trace.append(("load_c_evicts_a", p.begin_load("c"), p.resident()))
    p.commit_load("c", 6.0)
    trace.append(("lookup_b", p.lookup("b"), p.lookup("a"), p.stats()))
    p.unpin_slot(trace[1][1])
    p.unpin_slot(trace[1][1])
    trace.append(("evict_pinned_c", p.evict("c")))
    p.unpin_slot(trace[3][1])
    trace.append(("evict_c", p.evict("c"), list(evicted)))
    trace.append(("load_d", p.begin_load("d")))
    p.abort_load("d")
    trace.append(("evict_idle", p.evict_idle(), list(evicted)))
    trace.append(("stats", p.stats()))
    return trace


def test_adapter_pool_matches_jax_script():
    assert _pool_script(ttenancy.AdapterPool,
                        ttenancy.AdapterCapacityError) == _pool_script(
        jtenancy.AdapterPool, jtenancy.AdapterCapacityError)


def _manager_script(mgr_cls, cfg_cls, err_cls, cfg, path, install):
    """Loads, a hit, LRU eviction, a deferral when both slots are pinned,
    explicit and idle eviction; returns slots, stats and the installs'
    slots (arrays checked by the caller)."""
    m = mgr_cls(cfg, cfg_cls(max_loras=2, max_rank=MAX_RANK,
                             dynamic_lora_loading_path=path), install)
    out = [m.acquire(None), m.acquire("t1"), m.acquire("t2"), m.acquire("t1")]
    try:
        m.acquire("t3")
    except err_cls:
        out.append("deferred")
    m.release(out[1])
    m.release(out[3])
    out.append(m.acquire("t3"))       # evicts t1, the LRU unpinned one
    out.append(m.resident())
    m.release(out[2])
    out += [m.evict("t2"), m.evict("t3"), m.resident()]
    m.release(out[5])
    out += [m.unload_idle(), m.resident()]
    stats = m.stats()
    stats.pop("avg_load_ms")
    out.append(stats)
    return out


def test_lora_manager_matches_jax_script(model, tmp_path):
    jcfg, *_ = model
    for i in (1, 2, 3):
        jlora.save_adapter(str(tmp_path / f"t{i}.npz"), _adapter(jcfg, i))
    installs = {"jax": [], "torch": []}

    def recorder(side):
        def install(slot, arrays):
            installs[side].append(
                (slot, {k: np.asarray(v) for k, v in arrays.items()}))
        return install
    got = _manager_script(LoRAManager, LoRAServingConfig,
                          AdapterCapacityError, jcfg, str(tmp_path),
                          recorder("torch"))
    want = _manager_script(jlora.LoRAManager, jlora.LoRAServingConfig,
                           jtenancy.AdapterCapacityError, jcfg,
                           str(tmp_path), recorder("jax"))
    assert got == want
    assert "deferred" in got and got[0] == 0
    assert len(installs["torch"]) == len(installs["jax"])
    for (ts, ta), (js, ja) in zip(installs["torch"], installs["jax"]):
        assert ts == js and ta.keys() == ja.keys()
        for k in ta:
            np.testing.assert_array_equal(ta[k], ja[k])
    # unload_idle zeroed the slot it freed
    assert not any(a.any() for a in installs["torch"][-1][1].values())


def test_pad_rejects_high_rank_and_wrong_shapes(model):
    jcfg, *_ = model
    m = LoRAManager(jcfg, LoRAServingConfig(max_rank=MAX_RANK), None)
    jmgr = jlora.LoRAManager(jcfg, jlora.LoRAServingConfig(max_rank=MAX_RANK),
                             None)
    padded = m._pad(_adapter(jcfg, 1))
    for k, v in jmgr._pad(_adapter(jcfg, 1)).items():
        np.testing.assert_array_equal(padded[k], v)
    assert padded["wq.A"].shape[-1] == MAX_RANK
    bad = {"rank": _adapter(jcfg, 1, rank=MAX_RANK + 1),
           "layers": {**_adapter(jcfg, 1),
                      "wk.A": np.zeros((3, jcfg.hidden, RANK), np.float32)},
           "B": {**_adapter(jcfg, 1),
                 "wo.B": np.zeros((2, RANK, 7), np.float32)}}
    for arrays in bad.values():
        for mgr in (m, jmgr):
            with pytest.raises(ValueError):
                mgr._pad(arrays)


def test_npz_round_trips_both_ways(model, tmp_path):
    jcfg, *_ = model
    arrays = _adapter(jcfg, 7)
    tlora.save_adapter(str(tmp_path / "port.npz"), arrays)
    jlora.save_adapter(str(tmp_path / "jax.npz"), arrays)
    for got in (jlora.load_adapter_arrays(str(tmp_path / "port.npz")),
                tlora.load_adapter_arrays(str(tmp_path / "jax.npz"))):
        assert got.keys() == arrays.keys()
        for k in arrays:
            np.testing.assert_array_equal(got[k], arrays[k])
    for fn in (tlora.load_adapter_arrays,
               lambda p: tlora.save_adapter(p, arrays)):
        with pytest.raises(ValueError, match="scheme"):
            fn("gs://bucket/adapter.npz")


def test_file_uris_round_trip_both_ways(model, tmp_path):
    """``file://`` URIs (a directory with a space, percent-encoded) read
    and write the same files as plain paths, in both packages; a remote
    scheme raises ``ValueError`` naming it."""
    jcfg, *_ = model
    arrays = _adapter(jcfg, 9)
    d = tmp_path / "adapter dir"
    d.mkdir()
    jlora.save_adapter(str(d / "jax.npz"), arrays)
    tlora.save_adapter((d / "port.npz").as_uri(), arrays)
    assert "%20" in (d / "port.npz").as_uri()
    for got in (tlora.load_adapter_arrays((d / "jax.npz").as_uri()),
                tlora.load_adapter_arrays(str(d / "port.npz")),
                jlora.load_adapter_arrays((d / "port.npz").as_uri())):
        assert got.keys() == arrays.keys()
        for k in arrays:
            np.testing.assert_array_equal(got[k], arrays[k])
    for uri in ("s3://bucket/adapter.npz", "hdfs://nn/adapter.npz"):
        scheme = uri.split(":")[0]
        with pytest.raises(ValueError, match=f"scheme '{scheme}'"):
            tlora.load_adapter_arrays(uri)
        with pytest.raises(ValueError, match=f"scheme '{scheme}'"):
            tlora.save_adapter(uri, arrays)
    with pytest.raises(ValueError, match="names no host"):
        tlora.load_adapter_arrays("file://otherhost/adapter.npz")


@pytest.mark.skipif("torch.cuda.is_available()",
                    reason="checks the behaviour without a CUDA device")
def test_init_lora_stack_defaults_to_the_card(model):
    jcfg, _, tcfg, _ = model
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlora.init_lora_stack(tcfg, 2, MAX_RANK)
    stack = tlora.init_lora_stack(tcfg, 2, MAX_RANK, "cpu")
    want = {k: v.shape for k, v in jlora.init_lora_stack(
        jcfg, 2, MAX_RANK).items()}
    assert {k: tuple(v.shape) for k, v in stack.items()} == want
    assert all(v.dtype == tcfg.dtype and not v.any() for v in stack.values())


# ------------------------------------------------------------------ engine

PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8],
           [1, 6, 1, 8, 0, 3, 3, 9, 8, 8], [5, 5, 5, 9, 7]]


@pytest.fixture(scope="module")
def lora_dir(model, tmp_path_factory):
    jcfg, *_ = model
    d = tmp_path_factory.mktemp("adapters")
    for i in (1, 2, 3, 4, 5):
        jlora.save_adapter(str(d / f"t{i}.npz"), _adapter(jcfg, i))
    return str(d)


def _engine(side, model, lora_dir, impl="dense", *, lora=True, slots=4,
            max_loras=4, prefix_cache=False, **kw):
    jcfg, jparams, tcfg, tparams = model
    common = dict(max_slots=slots, max_len=64, page_size=PAGE,
                  attention_impl=impl, enable_prefix_cache=prefix_cache, **kw)
    if side == "jax":
        cfg = (jlora.LoRAServingConfig(max_loras=max_loras, max_rank=MAX_RANK,
                                       dynamic_lora_loading_path=lora_dir)
               if lora else None)
        return JaxEngine(jcfg, jparams, lora_config=cfg, **common), JaxRequest
    cfg = (LoRAServingConfig(max_loras=max_loras, max_rank=MAX_RANK,
                             dynamic_lora_loading_path=lora_dir)
           if lora else None)
    return (InferenceEngine(tcfg, tparams, lora_config=cfg, device="cpu",
                            **common), Request)


def _serve(eng, Req, models, concurrent=True, max_new_tokens=8,
           prompts=PROMPTS):
    reqs = [Req(f"r{i}", list(p), max_new_tokens=max_new_tokens, model=m)
            for i, (p, m) in enumerate(zip(prompts, models))]
    if concurrent:
        for r in reqs:
            eng.add_request(r)
        while any(not r.done for r in reqs):
            eng.step()
    else:
        for r in reqs:
            eng.add_request(r)
            while not r.done:
                eng.step()
    return [r.generated for r in reqs]


MIX = [None, "t1", "t2", "t3"]
# Two late arrivals while the first four decode: a base prompt, whose
# chunk rides a mixed dispatch, and an adapter prompt, which prefills on
# its own while the others wait.
LATE = ([list(range(20, 40)), [9, 8, 7]], [None, "t2"])


def _serve_waves(eng, Req, steps_between=5):
    reqs = []
    for prompts, models in ((PROMPTS, MIX), LATE):
        for p, m in zip(prompts, models):
            reqs.append(Req(f"r{len(reqs)}", list(p), max_new_tokens=8,
                            model=m))
            eng.add_request(reqs[-1])
        for _ in range(steps_between):
            eng.step()
    while any(not r.done for r in reqs):
        eng.step()
    return [r.generated for r in reqs]


@pytest.mark.parametrize("impl", ["dense", "paged"])
def test_engine_mixed_adapters_match_jax(model, lora_dir, impl):
    """Base plus three adapters decoding in one batch, then a base and an
    adapter prompt arriving mid-decode: the JAX engine's greedy tokens, on
    either route."""
    kw = dict(slots=6, decode_steps_per_dispatch=4)
    got_eng, Req = _engine("torch", model, lora_dir, impl, **kw)
    got = _serve_waves(got_eng, Req)
    want = _serve_waves(*_engine("jax", model, lora_dir, impl, **kw))
    assert got == want
    mix = got_eng.metrics["engine_step_mix"]
    assert mix["mixed"] > 0 and mix["prefill"] > 0
    base = _serve(*_engine("torch", model, lora_dir, impl), [None] * 4)
    assert base[0] == got[0] and base[1:] != got[1:4]
    assert got_eng.lora_manager.stats()["loads"] == 3
    assert got_eng.pool_stats()["active_slots"] == 0
    assert got_eng.lora_manager.unload_idle() == 3   # no pin is left
    assert not got_eng._lora_idx.any()


def test_dynamic_loading_path_takes_a_file_uri(model, lora_dir):
    """An engine whose ``dynamic_lora_loading_path`` is a ``file://`` URI
    loads and serves the adapters as one given the plain directory."""
    uri = pathlib.Path(lora_dir).as_uri()
    eng, Req = _engine("torch", model, uri)
    got = _serve(eng, Req, MIX)
    assert got == _serve(*_engine("torch", model, lora_dir), MIX)
    assert eng.lora_manager.stats()["loads"] == 3
    assert got[1:] != _serve(*_engine("torch", model, lora_dir),
                             [None] * 4)[1:]


def test_adapter_prefill_keeps_the_starvation_guard(model, lora_dir):
    """A long adapter prompt prefills one chunk a step (mixed dispatch
    cannot take it); decoders still get a burst every
    ``decode_starvation_limit`` steps, and tokens equal a cold run's."""
    eng, Req = _engine("torch", model, lora_dir, prefill_chunk_size=8,
                       decode_starvation_limit=2)
    first = Req("a", PROMPTS[0], max_new_tokens=16, model="t1")
    eng.add_request(first)
    while first.first_token_at is None:
        eng.step()
    late = Req("b", list(range(30, 70)), max_new_tokens=4, model="t2")
    eng.add_request(late)
    before = eng.metrics["decode_dispatches"]
    while late.prefill_pos < len(late.prompt):
        eng.step()
    m = eng.metrics
    assert m["decode_dispatches"] - before == 2      # 5 chunks, limit 2
    assert m["decode_stall_steps"] == 4 and m["engine_step_mix"]["mixed"] == 0
    while not (first.done and late.done):
        eng.step()
    cold = _serve(*_engine("torch", model, lora_dir), ["t2"],
                  prompts=[late.prompt], max_new_tokens=4)[0]
    assert late.generated == cold


def test_base_batches_skip_the_lora_terms(model, lora_dir, monkeypatch):
    """A decode batch with no adapter slot and a base prompt's prefill run
    the programs without the LoRA terms, with the tokens of an engine
    with no stack; an adapter request then runs them."""
    calls = {"rows": 0, "prefill": 0}
    real_rows, real_single = tm.slot_rows, tm.lora_delta_single

    def rows(*a):
        calls["rows"] += 1
        return real_rows(*a)

    def single(*a):
        calls["prefill"] += 1
        return real_single(*a)
    monkeypatch.setattr(tm, "slot_rows", rows)
    monkeypatch.setattr(tm, "lora_delta_single", single)
    eng, Req = _engine("torch", model, lora_dir)
    got = _serve(eng, Req, [None] * 4)
    assert calls == {"rows": 0, "prefill": 0}
    plain, _ = _engine("torch", model, lora_dir, lora=False)
    assert got == _serve(plain, Req, [None] * 4)
    _serve(eng, Req, MIX)
    assert calls["rows"] > 0 and calls["prefill"] > 0


def test_engine_concurrent_equals_one_by_one(model, lora_dir):
    concurrent = _serve(*_engine("torch", model, lora_dir), MIX)
    one_by_one = _serve(*_engine("torch", model, lora_dir), MIX,
                        concurrent=False)
    assert concurrent == one_by_one


def test_decode_dispatches_do_not_grow_with_adapters(model, lora_dir):
    counts = {}
    for name, models in (("mixed", ["t1", "t2", "t3", "t1"]),
                         ("single", ["t1"] * 4)):
        eng, Req = _engine("torch", model, lora_dir)
        _serve(eng, Req, models)
        counts[name] = eng.metrics["decode_dispatches"]
    assert counts["mixed"] == counts["single"] > 0


def test_prefix_space_isolated_per_adapter(model, lora_dir):
    """Pages computed under one adapter are reused under it alone."""
    eng, Req = _engine("torch", model, lora_dir, prefix_cache=True)
    prompt = list(range(20, 45))
    runs = []
    for m in (None, "t1", "t1", "t2", None):
        before = eng.metrics["prefix_hit_pages"]
        runs.append((_serve(eng, Req, [m], prompts=[prompt])[0],
                     eng.metrics["prefix_hit_pages"] - before))
    hits = [h for _, h in runs]
    assert hits == [0, 0, 3, 0, 3]
    assert runs[1][0] == runs[2][0] and runs[0][0] == runs[4][0]
    assert runs[0][0] != runs[1][0]
    # the cached adapter run equals a cold one
    cold = _serve(*_engine("torch", model, lora_dir), ["t1"],
                  prompts=[prompt])[0]
    assert runs[2][0] == cold


def test_admission_defers_while_every_adapter_is_pinned(model, lora_dir):
    """Two adapter slots, both pinned: the third adapter's request waits at
    the head of the queue (counted once a step, reuse metrics backed out)
    and is admitted when a pinned request retires."""
    eng, Req = _engine("torch", model, lora_dir, max_loras=2,
                       prefix_cache=True)
    first = [Req("a", PROMPTS[0], max_new_tokens=12, model="t1"),
             Req("b", PROMPTS[1], max_new_tokens=4, model="t2")]
    for r in first:
        eng.add_request(r)
    eng.step()
    late = [Req("c", PROMPTS[2], max_new_tokens=4, model="t3"),
            Req("d", PROMPTS[3], max_new_tokens=4)]
    for r in late:
        eng.add_request(r)
    eng.step()
    assert eng.metrics["adapter_defers"] == 1
    assert list(eng._waiting) == late           # kept its place, d waits
    assert eng.metrics["prompt_tokens"] == len(PROMPTS[0]) + len(PROMPTS[1])
    while not all(r.done for r in first + late):
        eng.step()
    assert late[0].generated and late[0].finish_reason == "length"
    assert eng.metrics["prompt_tokens"] == sum(len(p) for p in PROMPTS)
    assert eng.lora_manager.resident().keys() >= {"t3"}
    assert eng.pool_stats()["pinned"] == 0
    # the deferred request's tokens equal a cold engine's
    cold = _serve(*_engine("torch", model, lora_dir), ["t3"],
                  prompts=[PROMPTS[2]], max_new_tokens=4)[0]
    assert late[0].generated == cold


def test_admission_failed_for_missing_adapter_or_no_stack(model, lora_dir):
    for lora, model_id in ((True, "missing"), (False, "t1")):
        eng, Req = _engine("torch", model, lora_dir, lora=lora,
                           prefix_cache=True)
        free = len(eng.allocator.free)
        bad = Req("bad", PROMPTS[0], max_new_tokens=4, model=model_id)
        ok = Req("ok", PROMPTS[1], max_new_tokens=4)
        eng.add_request(bad)
        eng.add_request(ok)
        while not ok.done:
            eng.step()
        assert bad.done and bad.finish_reason == "admission_failed"
        assert not bad.generated and bad.slot == -1
        assert ok.finish_reason == "length"
        assert eng.pool_stats()["pinned"] == 0
        assert eng.allocator.available() == free
        if lora:
            assert eng.lora_manager.stats()["free_slots"] == 4


def test_dropped_engine_frees_its_executor_without_the_collector(
        model, lora_dir):
    """No reference cycle holds a LoRA engine's executor (weights, pool and
    stack): dropping the engine frees them at once."""
    import gc
    import weakref
    eng, Req = _engine("torch", model, lora_dir)
    _serve(eng, Req, MIX)
    assert eng.lora_manager.evict("t1")
    ref = weakref.ref(eng.executor)
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        gc.enable()


def test_speculation_off_under_lora(model, lora_dir):
    eng, Req = _engine("torch", model, lora_dir,
                       speculation_config={"num_draft_tokens": 3})
    assert not eng.speculation_enabled
    assert not eng.executor.supports_speculation
    plain, _ = _engine("torch", model, lora_dir, lora=False,
                       speculation_config={"num_draft_tokens": 3})
    assert plain.speculation_enabled
    _serve(eng, Req, MIX)
    assert eng.metrics["spec_dispatches"] == 0
