"""Parity of the port's paged-KV model programs (``ray_tpu_torch.llm.model``)
with the JAX package's ``ray_tpu.llm.model``, on the CPU.

The ``debug`` and ``debug-128`` presets at f32, with one numpy parameter
tree handed to both sides (the port's through ``params_from_numpy``);
pools and inputs come from a numpy seed. Greedy tokens must be equal and pools/hiddens agree to 1e-5
(f32 sums taken in another order). The JAX paged path runs its Pallas
kernel in interpret mode; the port's runs the kernel's plain version.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from _torch_parity import model_pair, tree_to_numpy
from ray_tpu.llm import model as jm
from ray_tpu_torch.llm import model as tm
from ray_tpu_torch.llm.weights import pages_from_numpy, params_from_numpy

ATOL = 1e-5


@pytest.fixture(scope="module")
def model():
    (jcfg, jparams), (tcfg, tparams) = model_pair("debug")
    return jcfg, jparams, tcfg, tparams


def _pools(cfg, num_pages, page, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, num_pages, cfg.n_kv_heads, page, cfg.head_dim)
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("k", "v")}


def _jpages(np_pages):
    return {k: jnp.asarray(v) for k, v in np_pages.items()}


def _close(got: dict, want: dict):
    for name in ("k", "v"):
        np.testing.assert_allclose(tree_to_numpy(got[name]),
                                   np.asarray(want[name]),
                                   atol=ATOL, rtol=ATOL)


def test_params_carry_over_layouts(model):
    jcfg, jparams, tcfg, tparams = model
    assert tparams["layers"]["wq"].shape == (2, 64, 4, 16)   # [L, E, H, D]
    assert tparams["layers"]["wo"].shape == (2, 4, 16, 64)   # [L, H, D, E]
    np.testing.assert_array_equal(tree_to_numpy(tparams["layers"]["wo"]),
                                  np.asarray(jparams["layers"]["wo"]))
    # bf16 rides through f32 exactly
    bf = np.asarray(jnp.asarray(np.linspace(-3, 3, 11), jnp.bfloat16))
    t = params_from_numpy({"w": bf}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), bf.astype(np.float32))


@pytest.mark.parametrize("preset,start_pos,chunk,live_pages", [
    ("debug", 0, 16, None),      # first chunk, page-aligned
    ("debug", 16, 16, 8),        # context of two full pages, capped gather
    ("debug", 13, 8, 2),         # mid-page start (after a COW fork), capped
    ("debug-128", 21, 16, 4),    # wider model, mid-page start
])
def test_prefill_chunk_parity(model, preset, start_pos, chunk, live_pages):
    if preset == "debug":
        jcfg, jparams, tcfg, tparams = model
    else:
        (jcfg, jparams), (tcfg, tparams) = model_pair(preset, seed=1)
    page, max_pages, num_pages = 8, 6, 12
    np_pages = _pools(jcfg, num_pages, page, seed=start_pos)
    bt = np.array([7, 3, 9, 4, 11, 5], np.int32)
    tokens = np.random.default_rng(1).integers(0, 256, chunk).astype(np.int32)
    jpages, jh = jm.prefill_chunk(
        jparams, _jpages(np_pages), jnp.asarray(bt), jnp.asarray(tokens),
        jnp.int32(start_pos), config=jcfg, page_size=page,
        live_pages=live_pages)
    tpages, th = tm.prefill_chunk(
        tparams, pages_from_numpy(np_pages, "cpu"), torch.from_numpy(bt),
        torch.from_numpy(tokens), start_pos, config=tcfg, page_size=page,
        live_pages=live_pages)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL,
                               rtol=ATOL)
    _close(tpages, jpages)


def _decode_inputs(slots=3, page=8, max_pages=6, seed=0):
    num_pages = slots + slots * max_pages
    bt = np.arange(slots, num_pages, dtype=np.int32).reshape(slots, max_pages)
    return num_pages, bt


@pytest.mark.parametrize("finish", ["remaining", "eos"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_loop_parity(model, paged, finish):
    """K fused steps crossing a page edge for every slot, a slot that
    finishes mid-dispatch (its ``remaining`` bound, or its EOS token) so
    its rows go to its trash page, then a second dispatch decoding from the
    committed pool."""
    jcfg, jparams, tcfg, tparams = model
    page, slots, K = 8, 3, 8
    num_pages, bt = _decode_inputs(slots, page)
    np_pages = _pools(jcfg, num_pages, page, seed=3)
    pos = np.array([5, 8, 12], np.int32)
    tokens = np.array([3, 7, 11], np.int32)
    temps = np.zeros(slots, np.float32)
    eos = np.full(slots, -1, np.int32)
    remaining = np.array([100, 3, 100], np.int32)
    gen = torch.Generator().manual_seed(0)

    def targs():
        return [torch.from_numpy(a) for a in (bt, tokens, pos, temps, eos,
                                              remaining)]
    if finish == "eos":
        # slot 1's third token, from an unbounded run, becomes its EOS id
        remaining[1] = 100
        free, _ = tm.decode_loop(
            tparams, pages_from_numpy(np_pages, "cpu"), *targs(), gen,
            config=tcfg, page_size=page, n_steps=K, paged=paged,
            live_pages=6)
        eos[1] = int(free[2, 1])
    jargs = [jnp.asarray(a) for a in (bt, tokens, pos, temps, eos, remaining)]
    jt, _, jpages = jm.decode_loop(
        jparams, _jpages(np_pages), *jargs, jax.random.PRNGKey(1),
        config=jcfg, page_size=page, n_steps=K, paged=paged, live_pages=6)
    tt, tpages = tm.decode_loop(
        tparams, pages_from_numpy(np_pages, "cpu"), *targs(), gen,
        config=tcfg, page_size=page, n_steps=K, paged=paged, live_pages=6)
    jt = np.asarray(jt)
    np.testing.assert_array_equal(tt.numpy()[:, [0, 2]], jt[:, [0, 2]])
    np.testing.assert_array_equal(tt.numpy()[:3, 1], jt[:3, 1])
    if finish == "eos":
        assert eos[1] in tt.numpy()[:3, 1]
    # real (non-trash) pages agree; the finished slot's trash page holds
    # unspecified rows on both sides
    for name in ("k", "v"):
        np.testing.assert_allclose(tree_to_numpy(tpages[name])[:, slots:],
                                   np.asarray(jpages[name])[:, slots:],
                                   atol=ATOL, rtol=ATOL)
    # dispatch 2 reads what dispatch 1 committed
    pos2, rem2 = pos + K, np.array([50, 0, 50], np.int32)
    jt2, _, _ = jm.decode_loop(
        jparams, jpages, jargs[0], jnp.asarray(jt[-1]), jnp.asarray(pos2),
        *jargs[3:5], jnp.asarray(rem2), jax.random.PRNGKey(2), config=jcfg,
        page_size=page, n_steps=K, paged=paged, live_pages=6)
    t_bt, _, _, t_temps, t_eos, _ = targs()
    tt2, _ = tm.decode_loop(
        tparams, tpages, t_bt, tt[-1], torch.from_numpy(pos2), t_temps, t_eos,
        torch.from_numpy(rem2), gen, config=tcfg, page_size=page, n_steps=K,
        paged=paged, live_pages=6)
    np.testing.assert_array_equal(tt2.numpy()[:, [0, 2]],
                                  np.asarray(jt2)[:, [0, 2]])


def test_paged_decode_loop_matches_port_dense(model):
    """Within the port: the staging schedule and the dense gather write
    the same pool and emit the same tokens."""
    _, _, tcfg, tparams = model
    page, slots = 8, 3
    num_pages, bt = _decode_inputs(slots, page)
    np_pages = _pools(tcfg, num_pages, page, seed=4)
    args = [torch.from_numpy(a) for a in (
        bt, np.array([1, 2, 3], np.int32), np.array([7, 15, 22], np.int32),
        np.zeros(slots, np.float32), np.full(slots, -1, np.int32),
        np.full(slots, 50, np.int32))]
    out = {}
    for paged in (False, True):
        out[paged] = tm.decode_loop(
            tparams, pages_from_numpy(np_pages, "cpu"), *args,
            torch.Generator().manual_seed(0), config=tcfg, page_size=page,
            n_steps=12, paged=paged, live_pages=6)
    np.testing.assert_array_equal(out[False][0].numpy(), out[True][0].numpy())
    _close(out[True][1], tree_to_numpy(out[False][1]))


def test_commit_staging_parity(model):
    jcfg, *_ = model
    rng = np.random.default_rng(5)
    page, slots, K, L = 8, 3, 5, jcfg.n_layers
    num_pages = 12
    np_pages = _pools(jcfg, num_pages, page, seed=6)
    shape = (L, slots, jcfg.n_kv_heads, 16, jcfg.head_dim)
    ks = rng.standard_normal(shape).astype(np.float32)
    vs = rng.standard_normal(shape).astype(np.float32)
    pos0 = np.array([3, 6, 13], np.int32)
    # slot 1 crosses into its next page; slot 2 finished after 2 steps
    widx = np.array([[4, 5, 9]] * 2 + [[4, 10, 2]] * 3, np.int32)
    want = jm.commit_staging(_jpages(np_pages), (jnp.asarray(ks),
                                                 jnp.asarray(vs)),
                             jnp.asarray(widx), jnp.asarray(pos0), K, page)
    got = tm.commit_staging(pages_from_numpy(np_pages, "cpu"),
                            (torch.from_numpy(ks), torch.from_numpy(vs)),
                            torch.from_numpy(widx), torch.from_numpy(pos0),
                            K, page)
    for name in ("k", "v"):   # exact: a pure scatter; trash page 2 excluded
        keep = [p for p in range(num_pages) if p != 2]
        np.testing.assert_array_equal(tree_to_numpy(got[name])[:, keep],
                                      np.asarray(want[name])[:, keep])


def test_copy_pages_parity(model):
    jcfg, *_ = model
    np_pages = _pools(jcfg, 10, 8, seed=7)
    src, dst = np.array([4, 6], np.int32), np.array([8, 1], np.int32)
    want = jm.copy_pages(_jpages(np_pages), jnp.asarray(src), jnp.asarray(dst))
    got = tm.copy_pages(pages_from_numpy(np_pages, "cpu"),
                        torch.from_numpy(src), torch.from_numpy(dst))
    for name in ("k", "v"):
        np.testing.assert_array_equal(tree_to_numpy(got[name]),
                                      np.asarray(want[name]))


def test_mixed_dispatch_parity(model):
    """Two prompt chunks (one mid-prompt with context) plus the decode
    burst of the other slots, in one call."""
    jcfg, jparams, tcfg, tparams = model
    page, slots, K = 8, 4, 4
    num_pages, bt = _decode_inputs(slots, page, max_pages=6)
    np_pages = _pools(jcfg, num_pages, page, seed=8)
    rng = np.random.default_rng(9)
    ops = [(bt[2], rng.integers(0, 256, 16).astype(np.int32), 0),
           (bt[3], rng.integers(0, 256, 8).astype(np.int32), 8)]
    dec_bt = bt.copy()
    dec_bt[2:] = np.arange(2, 4)[:, None]   # prefilling slots decode to trash
    pos = np.array([9, 14, 0, 0], np.int32)
    tokens = np.array([5, 6, 0, 0], np.int32)
    temps = np.zeros(slots, np.float32)
    eos = np.full(slots, -1, np.int32)
    remaining = np.array([20, 20, 0, 0], np.int32)
    host = (dec_bt, tokens, pos, temps, eos, remaining)
    jt, _, jpages, jh = jm.mixed_dispatch(
        jparams, _jpages(np_pages),
        tuple((jnp.asarray(b), jnp.asarray(t), jnp.int32(s))
              for b, t, s in ops),
        *[jnp.asarray(a) for a in host], jax.random.PRNGKey(0), config=jcfg,
        page_size=page, n_steps=K, paged=False, live_pages=4,
        prefill_live_pages=(8, 1))
    tt, tpages, th = tm.mixed_dispatch(
        tparams, pages_from_numpy(np_pages, "cpu"),
        tuple((torch.from_numpy(b), torch.from_numpy(t), s)
              for b, t, s in ops),
        *[torch.from_numpy(a) for a in host], torch.Generator(),
        config=tcfg, page_size=page, n_steps=K, paged=False, live_pages=4,
        prefill_live_pages=(8, 1))
    np.testing.assert_array_equal(tt.numpy()[:, :2], np.asarray(jt)[:, :2])
    for a, b in zip(th, jh):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tree_to_numpy(tpages[name])[:, slots:],
                                   np.asarray(jpages[name])[:, slots:],
                                   atol=ATOL, rtol=ATOL)


def test_sample_first_batch_greedy_parity(model):
    jcfg, jparams, tcfg, tparams = model
    h = np.random.default_rng(10).standard_normal((5, 64)).astype(np.float32)
    temps = np.zeros(5, np.float32)
    jt, _ = jm.sample_first_batch(jnp.asarray(h), jparams["lm_head"],
                                  jnp.asarray(temps), jax.random.PRNGKey(0))
    tt = tm.sample_first_batch(torch.from_numpy(h), tparams["lm_head"],
                               torch.from_numpy(temps), torch.Generator())
    assert tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_sampling_uses_the_generator(model):
    """temp > 0 draws from the generator: one seed, one stream."""
    _, _, _, tparams = model
    h = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (6, 64)).astype(np.float32))
    temps = torch.full((6,), 1.0)

    def draw(seed):
        return tm.sample_first_batch(h, tparams["lm_head"], temps,
                                     torch.Generator().manual_seed(seed))
    assert torch.equal(draw(3), draw(3))
    assert 0 <= int(draw(4).min()) and int(draw(4).max()) < 256
