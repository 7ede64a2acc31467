"""Speculative decoding in the port (``ray_tpu_torch.llm.speculative``,
``model.verify_block``, the executor's ``verify`` and the engine's
speculation round) and the rest of ``llm/model.py``'s serve programs
(``decode_step``, ``decode_and_sample``, ``sample_first_token``), on the
CPU.

Against the JAX package: the drafter and config on seeded histories, and
the model programs on one numpy tree (``debug`` preset, f32, temperature
0), dense and paged (the JAX Pallas kernel in interpret mode, the port's
kernel through its plain version). Tokens and ``live`` must be equal and
the committed pool pages agree to 1e-5 (f32 sums in another order).

Against the port itself: the speculative engine's greedy output must equal
the plain engine's, token for token, whatever the drafter proposes.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from _torch_parity import model_pair, tree_to_numpy
from ray_tpu.llm import model as jm
from ray_tpu.llm.speculative import NgramDrafter as JaxNgramDrafter
from ray_tpu.llm.speculative import SpeculationConfig as JaxSpeculationConfig
from ray_tpu_torch.llm import (Drafter, InferenceEngine, NgramDrafter,
                               Request, SpeculationConfig)
from ray_tpu_torch.llm import model as tm
from ray_tpu_torch.llm.weights import pages_from_numpy

ATOL = 1e-5
PAGE, SLOTS = 8, 4


@pytest.fixture(scope="module")
def model():
    (jcfg, jparams), (tcfg, tparams) = model_pair("debug")
    return jcfg, jparams, tcfg, tparams


# ------------------------------------------------------------ drafter
@pytest.mark.parametrize("ngram_max,ngram_min", [(3, 1), (2, 2), (5, 1),
                                                 (1, 1), (0, 4)])
def test_ngram_drafter_matches_jax(ngram_max, ngram_min):
    rng = np.random.default_rng(ngram_max * 7 + ngram_min)
    got = NgramDrafter(ngram_max, ngram_min)
    want = JaxNgramDrafter(ngram_max, ngram_min)
    assert (got.ngram_max, got.ngram_min) == (want.ngram_max, want.ngram_min)
    for _ in range(60):
        n = int(rng.integers(0, 40))
        hist = rng.integers(0, int(rng.integers(2, 8)), n).tolist()
        for k in (0, 1, 4, 9):
            assert got.draft(hist, k) == want.draft(hist, k), (hist, k)


def test_speculation_config_normalize_matches_jax():
    for value in (None, {}, {"num_draft_tokens": 0},
                  {"num_draft_tokens": 6, "ngram_max": 4, "ngram_min": 2}):
        got = SpeculationConfig.normalize(value)
        want = JaxSpeculationConfig.normalize(value)
        if value is None:
            assert got is None and want is None
            continue
        assert (got.num_draft_tokens, got.drafter, got.ngram_max,
                got.ngram_min) == (want.num_draft_tokens, want.drafter,
                                   want.ngram_max, want.ngram_min)
        d = got.build_drafter()
        assert isinstance(d, NgramDrafter)
        assert (d.ngram_max, d.ngram_min) == (got.ngram_max, got.ngram_min)
    cfg = SpeculationConfig(num_draft_tokens=2)
    assert SpeculationConfig.normalize(cfg) is cfg
    with pytest.raises(TypeError):
        SpeculationConfig.normalize(3)
    with pytest.raises(TypeError):
        JaxSpeculationConfig.normalize(3)
    with pytest.raises(ValueError, match="drafter"):
        SpeculationConfig(drafter="model").build_drafter()
    mine = NgramDrafter()
    assert SpeculationConfig(drafter=mine).build_drafter() is mine


# ------------------------------------------------------- model programs
def _pools(cfg, num_pages, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, num_pages, cfg.n_kv_heads, PAGE, cfg.head_dim)
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("k", "v")}


def _tables(max_pages=6):
    num_pages = SLOTS + SLOTS * max_pages
    return num_pages, np.arange(SLOTS, num_pages, dtype=np.int32).reshape(
        SLOTS, max_pages)


def _greedy_continuation(tparams, tcfg, np_pages, bt, tokens, pos, n):
    """The next ``n`` greedy tokens of every slot, by the port's dense
    decode loop on a copy of the pool."""
    toks, _ = tm.decode_loop(
        tparams, pages_from_numpy(np_pages, "cpu"),
        *[torch.from_numpy(a) for a in (
            bt, tokens, pos, np.zeros(SLOTS, np.float32),
            np.full(SLOTS, -1, np.int32), np.full(SLOTS, 50, np.int32))],
        torch.Generator(), config=tcfg, page_size=PAGE, n_steps=n,
        live_pages=6)
    return toks.numpy().T                                  # [slots, n]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_verify_block_matches_jax(model, paged):
    """K = 3 drafts per slot: slot 0's is the true greedy continuation,
    crossing a page edge, with its EOS as the second token; slot 1's is
    right once, then wrong; slot 2's is one token and -1 pads; slot 3 is
    inactive (remaining 0)."""
    jcfg, jparams, tcfg, tparams = model
    K = 3
    num_pages, bt = _tables()
    np_pages = _pools(jcfg, num_pages, seed=11)
    pos = np.array([6, 9, 17, 0], np.int32)
    cur = np.array([3, 7, 11, 2], np.int32)
    cont = _greedy_continuation(tparams, tcfg, np_pages, bt, cur, pos, K + 1)
    tokens_mat = np.full((SLOTS, K + 1), -1, np.int32)
    tokens_mat[:, 0] = cur
    tokens_mat[0, 1:] = cont[0, :K]
    tokens_mat[1, 1:] = [cont[1, 0], (cont[1, 1] + 1) % 256, cont[1, 2]]
    tokens_mat[2, 1] = cont[2, 0]
    tokens_mat[3, 1:] = [5, 6, 7]
    temps = np.zeros(SLOTS, np.float32)
    eos = np.array([cont[0, 1], -1, -1, -1], np.int32)
    remaining = np.array([20, 20, 20, 0], np.int32)
    host = (bt, tokens_mat, pos, temps, eos, remaining)
    jt, jlive, _, jpages = jm.verify_block(
        jparams, {k: jnp.asarray(v) for k, v in np_pages.items()},
        *[jnp.asarray(a) for a in host], jax.random.PRNGKey(0), config=jcfg,
        page_size=PAGE, n_draft=K, paged=paged, live_pages=4)
    tt, tlive, tpages = tm.verify_block(
        tparams, pages_from_numpy(np_pages, "cpu"),
        *[torch.from_numpy(a) for a in host], torch.Generator(),
        config=tcfg, page_size=PAGE, n_draft=K, paged=paged, live_pages=4,
        sample=False)
    assert tt.dtype == torch.int32 and tt.shape == (K + 1, SLOTS)
    np.testing.assert_array_equal(tlive.numpy(), np.asarray(jlive))
    np.testing.assert_array_equal(tt.numpy()[:, :3], np.asarray(jt)[:, :3])
    # slot 0 emits its two drafts (the second its EOS); slot 1 one draft
    # and the correction; slot 2 its draft and the bonus; slot 3 nothing
    np.testing.assert_array_equal(
        tlive.numpy().T, [[1, 1, 0, 0], [1, 1, 0, 0], [1, 1, 0, 0],
                          [0, 0, 0, 0]])
    np.testing.assert_array_equal(tt.numpy()[:2, 0], cont[0, :2])
    np.testing.assert_array_equal(tt.numpy()[:2, 1], cont[1, :2])
    np.testing.assert_array_equal(tt.numpy()[:2, 2], cont[2, :2])
    # only accepted rows reach real pages; trash pages hold unspecified rows
    for name in ("k", "v"):
        got = tree_to_numpy(tpages[name])[:, SLOTS:]
        np.testing.assert_allclose(got, np.asarray(jpages[name])[:, SLOTS:],
                                   atol=ATOL, rtol=ATOL)
        moved = np.abs(got - np_pages[name][:, SLOTS:]).max(axis=(0, 2, 4))
        assert (moved > 0).sum() == 6    # 2 rows for each active slot


def test_verify_block_paged_matches_dense_in_the_port(model):
    """The per-position kernel schedule and the dense chunk agree."""
    _, _, tcfg, tparams = model
    num_pages, bt = _tables()
    np_pages = _pools(tcfg, num_pages, seed=12)
    rng = np.random.default_rng(13)
    host = [torch.from_numpy(a) for a in (
        bt, rng.integers(0, 256, (SLOTS, 5)).astype(np.int32),
        np.array([15, 1, 23, 8], np.int32), np.zeros(SLOTS, np.float32),
        np.full(SLOTS, -1, np.int32), np.full(SLOTS, 9, np.int32))]
    out = {}
    for paged in (False, True):
        out[paged] = tm.verify_block(
            tparams, pages_from_numpy(np_pages, "cpu"), *host,
            torch.Generator(), config=tcfg, page_size=PAGE, n_draft=4,
            paged=paged, live_pages=4)
    assert torch.equal(out[False][0], out[True][0])
    assert torch.equal(out[False][1], out[True][1])
    for name in ("k", "v"):
        np.testing.assert_allclose(tree_to_numpy(out[True][2][name]),
                                   tree_to_numpy(out[False][2][name]),
                                   atol=ATOL, rtol=ATOL)


def test_verify_block_sampling_is_sane(model):
    """temp > 0 on some slots: emitted ids in range, live a prefix, the
    greedy slot's tokens the argmax ones, one generator seed one result."""
    _, _, tcfg, tparams = model
    num_pages, bt = _tables()
    np_pages = _pools(tcfg, num_pages, seed=14)
    rng = np.random.default_rng(15)
    host = [torch.from_numpy(a) for a in (
        bt, rng.integers(0, 256, (SLOTS, 4)).astype(np.int32),
        np.array([5, 12, 3, 30], np.int32),
        np.array([0.0, 0.7, 1.0, 2.0], np.float32),
        np.full(SLOTS, -1, np.int32), np.full(SLOTS, 9, np.int32))]

    def run(seed, sample=True):
        return tm.verify_block(
            tparams, pages_from_numpy(np_pages, "cpu"), *host,
            torch.Generator().manual_seed(seed), config=tcfg, page_size=PAGE,
            n_draft=3, live_pages=4, sample=sample)[:2]
    toks, live = run(3)
    assert torch.equal(toks, run(3)[0]) and torch.equal(live, run(3)[1])
    assert int(toks.min()) >= 0 and int(toks.max()) < tcfg.vocab_size
    assert bool(live[0].all())
    assert bool((live[1:] <= live[:-1]).all())           # a prefix per slot
    greedy_toks, greedy_live = run(0, sample=False)
    assert torch.equal(toks[:, 0], greedy_toks[:, 0])
    assert torch.equal(live[:, 0], greedy_live[:, 0])


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_step_and_decode_and_sample_match_jax(model, paged):
    jcfg, jparams, tcfg, tparams = model
    num_pages, bt = _tables()
    np_pages = _pools(jcfg, num_pages, seed=16)
    tokens = np.array([4, 8, 15, 16], np.int32)
    pos = np.array([0, 7, 8, 30], np.int32)
    jargs = [jnp.asarray(a) for a in (bt, tokens, pos)]
    targs = [torch.from_numpy(a) for a in (bt, tokens, pos)]
    jl, jpages = jm.decode_step(
        jparams, {k: jnp.asarray(v) for k, v in np_pages.items()}, *jargs,
        config=jcfg, page_size=PAGE, paged=paged, live_pages=4)
    tl, tpages = tm.decode_step(
        tparams, pages_from_numpy(np_pages, "cpu"), *targs, config=tcfg,
        page_size=PAGE, paged=paged, live_pages=4)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tree_to_numpy(tpages[name]),
                                   np.asarray(jpages[name]), atol=ATOL,
                                   rtol=ATOL)
    temps = np.zeros(SLOTS, np.float32)
    jt, _, _ = jm.decode_and_sample(
        jparams, {k: jnp.asarray(v) for k, v in np_pages.items()}, *jargs,
        jnp.asarray(temps), jax.random.PRNGKey(0), config=jcfg,
        page_size=PAGE, paged=paged, live_pages=4)
    tt, _ = tm.decode_and_sample(
        tparams, pages_from_numpy(np_pages, "cpu"), *targs,
        torch.from_numpy(temps), torch.Generator(), config=tcfg,
        page_size=PAGE, paged=paged, live_pages=4)
    assert tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_sample_first_token_matches_jax(model):
    jcfg, jparams, tcfg, tparams = model
    h = np.random.default_rng(17).standard_normal(64).astype(np.float32)
    jt, _ = jm.sample_first_token(jnp.asarray(h), jparams["lm_head"],
                                  jnp.float32(0.0), jax.random.PRNGKey(0))
    tt = tm.sample_first_token(torch.from_numpy(h), tparams["lm_head"], 0.0,
                               torch.Generator())
    assert tt.dtype == torch.int32 and tt.shape == ()
    assert int(tt) == int(jt)
    hot = tm.sample_first_token(torch.from_numpy(h), tparams["lm_head"], 1.0,
                                torch.Generator().manual_seed(1))
    assert 0 <= int(hot) < tcfg.vocab_size


# --------------------------------------------------------- the engine
class OracleDrafter(Drafter):
    """Drafts from known full sequences (prompt + plain output): right for
    the first ``right`` tokens of each draft, then wrong (``right=None``:
    always right)."""

    def __init__(self, sequences, right=None):
        self.sequences = [list(s) for s in sequences]
        self.right = right

    def draft(self, tokens, k):
        for seq in self.sequences:
            if seq[:len(tokens)] == tokens:
                d = seq[len(tokens):len(tokens) + k]
                if self.right is not None:
                    d = [t if i < self.right else (t + 1) % 256
                         for i, t in enumerate(d)]
                return d
        return []


class WrongDrafter(Drafter):
    """Drafts the known continuation with every token shifted by one, so
    the first draft token is never the argmax and every round accepts 0."""

    def __init__(self, sequences):
        self.sequences = [list(s) for s in sequences]

    def draft(self, tokens, k):
        for seq in self.sequences:
            if seq[:len(tokens)] == tokens:
                nxt = seq[len(tokens):len(tokens) + k]
                return [(t + 1) % 256 for t in nxt] or [0] * k
        return [0] * k


def _run(tparams, tcfg, waves, *, impl="paged", spec=None, max_new=10,
         eos_id=None, temperature=0.0, seed=0, steps_between=2, K=4):
    eng = InferenceEngine(tcfg, tparams, max_slots=SLOTS, max_len=64,
                          page_size=PAGE, decode_steps_per_dispatch=K,
                          attention_impl=impl, device="cpu", seed=seed,
                          speculation_config=spec)
    reqs = []
    for w, wave in enumerate(waves):
        for p in wave:
            reqs.append(Request(f"r{len(reqs)}", list(p),
                                max_new_tokens=max_new, eos_id=eos_id,
                                temperature=temperature))
            eng.add_request(reqs[-1])
        if w + 1 < len(waves):
            for _ in range(steps_between):
                eng.step()
    while any(not r.done for r in reqs):
        eng.step()
    return [r.generated for r in reqs], eng


BATCHES = {
    "uniform": [[[1, 5, 9, 2], [2, 4, 6, 8], [3, 1, 4, 1], [9, 9, 9, 9]]],
    "skewed": [[list(range(1, 41)), [7, 3], [2, 4, 6], [11, 13, 17, 19]]],
    "mixed": [[[5, 4, 3, 2, 1] * 3, [9, 8]],
              [list(range(30, 50)), [3, 3, 3, 3, 3, 3]]],
}


@pytest.mark.parametrize("impl", ["dense", "paged"])
@pytest.mark.parametrize("batch", list(BATCHES))
def test_speculative_engine_equals_plain(model, batch, impl):
    """The n-gram drafter, and an oracle drafter whose drafts are right for
    two tokens and then wrong, so rejections land mid-run and mid-page."""
    _, _, tcfg, tparams = model
    waves = BATCHES[batch]
    plain, _ = _run(tparams, tcfg, waves, impl=impl, max_new=14)
    prompts = [p for wave in waves for p in wave]
    seqs = [p + out for p, out in zip(prompts, plain)]
    for spec in ({"num_draft_tokens": 3},
                 {"num_draft_tokens": 5,
                  "drafter": OracleDrafter(seqs, right=2)}):
        got, eng = _run(tparams, tcfg, waves, impl=impl, spec=spec,
                        max_new=14)
        assert got == plain
        assert eng.speculation_enabled and eng.metrics["spec_dispatches"] > 0
        if batch == "mixed":
            assert eng.metrics["engine_step_mix"]["mixed"] > 0
        stats = eng.pool_stats()
        assert stats["pinned"] == 0 and stats["active_slots"] == 0
    # the oracle's third draft token is always wrong: rollbacks every round
    m = eng.metrics
    assert m["spec_rollbacks"] > 0 and m["spec_accepted_tokens"] > 0
    assert 1.0 < eng.spec_tokens_per_dispatch <= 3.0


def test_oracle_drafts_cross_pages_and_stop_at_eos(model):
    """Always-right drafts of K = 6 cross page edges; an EOS inside an
    accepted run ends the request there, as in plain decode."""
    _, _, tcfg, tparams = model
    waves = [[[1, 2, 3], [4, 5, 6, 7, 8, 9, 10]]]
    plain, _ = _run(tparams, tcfg, waves, max_new=20)
    seqs = [p + out for p, out in zip(waves[0], plain)]
    spec = {"num_draft_tokens": 6, "drafter": OracleDrafter(seqs)}
    got, eng = _run(tparams, tcfg, waves, spec=spec, max_new=20)
    assert got == plain
    # drafts past a request's last token count as rejected
    assert eng.spec_accept_rate > 0.8
    assert eng.spec_tokens_per_dispatch > 4.0
    eos = plain[0][9]
    want, _ = _run(tparams, tcfg, waves, max_new=20, eos_id=eos)
    got, eng = _run(tparams, tcfg, waves, spec=spec, max_new=20, eos_id=eos)
    assert got == want and got[0][-1] == eos and len(got[0]) <= 10


@pytest.mark.parametrize("impl", ["dense", "paged"])
def test_accept_zero_still_advances(model, impl):
    _, _, tcfg, tparams = model
    waves = BATCHES["uniform"]
    plain, _ = _run(tparams, tcfg, waves, impl=impl)
    seqs = [p + out for p, out in zip(waves[0], plain)]
    spec = {"num_draft_tokens": 3, "drafter": WrongDrafter(seqs)}
    got, eng = _run(tparams, tcfg, waves, impl=impl, spec=spec)
    assert got == plain
    m = eng.metrics
    assert m["spec_accepted_tokens"] == 0 and eng.spec_accept_rate == 0.0
    assert eng.spec_tokens_per_dispatch == 1.0
    assert m["spec_rollbacks"] == m["spec_slot_rounds"] > 0


@pytest.mark.parametrize("impl", ["dense", "paged"])
def test_cow_shared_prefix_with_speculation(model, impl):
    """A second request shares two full pages and three rows of a cached
    partial tail page: it COW-forks the tail page, and its drafts (right
    for one token, then wrong) are rejected mid-page."""
    _, _, tcfg, tparams = model
    first = (list(range(10, 31)), 3)
    second = (list(range(10, 29)) + [99, 98, 97], 9)
    out = {}
    for name in ("plain", "spec"):
        spec = None
        if name == "spec":
            seqs = [p + t for p, t in zip((first[0], second[0]),
                                          out["plain"][0])]
            spec = {"num_draft_tokens": 4,
                    "drafter": OracleDrafter(seqs, right=1)}
        eng = InferenceEngine(tcfg, tparams, max_slots=SLOTS, max_len=64,
                              page_size=PAGE, attention_impl=impl,
                              device="cpu", speculation_config=spec)
        toks = []
        for i, (p, n) in enumerate((first, second)):
            r = Request(f"p{i}", p, max_new_tokens=n)
            eng.add_request(r)
            while not r.done:
                eng.step()
            toks.append(r.generated)
        out[name] = (toks, eng.metrics["cow_forks"],
                     eng.metrics["prefix_hit_pages"])
        if name == "spec":
            assert eng.metrics["spec_rollbacks"] > 0
    assert out["spec"] == out["plain"]
    assert out["spec"][1] == 1 and out["spec"][2] == 2


def test_sampled_speculation_is_sane(model):
    _, _, tcfg, tparams = model
    waves = [[[1, 2, 3] * 4, [7, 7, 7, 7], [5, 6] * 5]]
    spec = {"num_draft_tokens": 3}
    runs = [_run(tparams, tcfg, waves, spec=spec, temperature=0.8, seed=5,
                 max_new=12) for _ in range(2)]
    (got, eng), (again, _) = runs
    assert got == again                      # one seed, one stream
    assert all(len(t) == 12 for t in got)
    assert all(0 <= x < tcfg.vocab_size for t in got for x in t)
    assert eng.metrics["spec_dispatches"] > 0
    assert 0.0 <= eng.spec_accept_rate <= 1.0
    assert 1.0 <= eng.spec_tokens_per_dispatch <= 4.0


def test_plain_path_untouched_without_a_config(model, monkeypatch):
    _, _, tcfg, tparams = model
    plain, eng = _run(tparams, tcfg, BATCHES["skewed"])
    assert eng.speculation is None and not eng.speculation_enabled
    assert eng.executor.supports_speculation

    def no_verify(*args, **kwargs):
        raise AssertionError("verify called without a speculation config")
    monkeypatch.setattr(type(eng.executor), "verify", no_verify)
    again, eng = _run(tparams, tcfg, BATCHES["skewed"])
    assert again == plain
    assert all(v == 0 for k, v in eng.metrics.items()
               if k.startswith("spec_"))
    assert eng.spec_accept_rate == 0.0 and eng.spec_tokens_per_dispatch == 0.0


@pytest.mark.skipif("torch.cuda.is_available()",
                    reason="checks the behaviour without a CUDA device")
def test_speculative_engine_default_device_raises_without_cuda(model):
    _, _, tcfg, tparams = model
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(tcfg, tparams, max_slots=2, max_len=64, page_size=8,
                        speculation_config={"num_draft_tokens": 3})
