"""The two-branch ESCA sampler (``core/esca.py::sample_two_branch``) and
``LDAConfig(sampler="two_branch")`` against the reference.

The draw on the same uniforms: S and Q allclose, topics equal but for
rare tokens on a CDF boundary (``tests/_torch_parity.py``); ``step()``
bitwise the same under both impls; the LLPT trajectory of ``fit`` in
distribution (the mean of 4 seeds within 0.08 of the reference's, as
``tests/test_torch_engine.py`` holds the exact sampler); the two samplers
reaching the same LLPT (the reference's
``test_two_and_three_branch_converge_to_same_llpt``). Every path on which
the reference runs the three-branch sampler under the baseline's name
raises a ValueError here; the last test pins that reference fault.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import esca as jesca
from repro.lda.api import LDAEngine as JaxEngine
from repro.lda.corpus import relabel_by_frequency, synthetic_lda_corpus
from repro.lda.model import LDAConfig as JaxConfig
from repro.lda.trainer import LDATrainer as JaxTrainer
from repro_torch.core import esca
from repro_torch.lda import LDAEngine, LDATrainer
from repro_torch.lda.model import DistConfig, LDAConfig
from _torch_parity import (assert_masses_close, assert_two_branch_agree,
                           port_corpus)

SEEDS = 4
LLPT_TOL = 0.08


def _state(seed, n_docs=30, n_words=40, K=12, n=4000):
    rng = np.random.default_rng(seed)
    word_ids = np.sort(rng.integers(0, n_words, n)).astype(np.int32)
    doc_ids = rng.integers(0, n_docs, n).astype(np.int32)
    topics = rng.integers(0, K, n).astype(np.int32)
    D = np.zeros((n_docs, K), np.int32)
    W = np.zeros((n_words, K), np.int32)
    np.add.at(D, (doc_ids, topics), 1)
    np.add.at(W, (word_ids, topics), 1)
    return word_ids, doc_ids, topics, D, W


@pytest.mark.parametrize("seed,K", [(0, 12), (1, 64), (2, 257)])
def test_draw_matches_reference_on_the_same_u(seed, K):
    word_ids, doc_ids, topics, D, W = _state(seed, K=K)
    alpha = 50.0 / K
    W_hat = np.asarray(jesca.compute_w_hat(jnp.asarray(W), 0.01))
    key = jax.random.PRNGKey(seed)
    n = word_ids.shape[0]
    u = np.array(jax.random.uniform(key, (n,), dtype=jnp.float32))
    want, want_stats = jesca.sample_two_branch(
        key, jnp.asarray(word_ids), jnp.asarray(doc_ids),
        jnp.asarray(topics), jnp.asarray(D), jnp.asarray(W_hat),
        alpha=alpha, tile_size=512)
    got, got_stats = esca.sample_two_branch(
        torch.from_numpy(u), torch.from_numpy(word_ids),
        torch.from_numpy(doc_ids), torch.from_numpy(topics),
        torch.from_numpy(D), torch.from_numpy(W_hat), alpha=alpha,
        tile_size=512)
    d_rows, w_rows = D[doc_ids], W_hat[word_ids]
    n_off = assert_two_branch_agree(u, d_rows, w_rows, alpha, got.numpy(),
                                    np.asarray(want))
    for name in want_stats._fields:     # SampleStats, the same fractions
        assert abs(float(getattr(got_stats, name))
                   - float(getattr(want_stats, name))) <= n_off / n + 1e-6
    # the branch masses: the last entries of the float32 cumsums
    _, in_s, s, q = esca.two_branch_rows(
        torch.from_numpy(u), torch.from_numpy(d_rows),
        torch.from_numpy(w_rows), alpha)
    s_ref = jnp.cumsum(jnp.asarray(d_rows, jnp.float32)
                       * jnp.asarray(w_rows), axis=1)[:, -1]
    q_ref = jnp.cumsum(jnp.float32(alpha) * jnp.asarray(w_rows),
                       axis=1)[:, -1]
    assert_masses_close(s.numpy(), np.asarray(s_ref), None)
    assert_masses_close(q.numpy(), np.asarray(q_ref), None)
    ref_in_s = jax.vmap(lambda uu, d, w: jesca._sample_token(
        uu, d, w, jnp.float32(alpha))[1])(jnp.asarray(u), jnp.asarray(d_rows),
                                          jnp.asarray(w_rows))
    assert (in_s.numpy() != np.asarray(ref_in_s)).sum() <= n_off


def test_step_is_bitwise_across_impls():
    corpus = synthetic_lda_corpus(3, n_docs=80, n_words=120, n_topics=8,
                                  mean_doc_len=40)
    corpus = port_corpus(relabel_by_frequency(corpus)[0])
    trainers = [LDATrainer(corpus, LDAConfig(n_topics=16, tile_size=256,
                                             sampler="two_branch", impl=impl),
                           device="cpu") for impl in ("torch", "kernel")]
    states = [tr.init_state() for tr in trainers]
    for _ in range(3):
        out = [tr.step(s) for tr, s in zip(trainers, states)]
        states = [s for s, _ in out]
        a, b = states
        assert torch.equal(a.topics, b.topics) and torch.equal(a.D, b.D) \
            and torch.equal(a.W, b.W)
        assert out[0][1] == out[1][1]
        assert set(out[0][1]) == {"frac_unchanged", "frac_at_max",
                                  "frac_s_branch"}


@pytest.fixture(scope="module")
def planted():
    """benchmarks/_common.planted_corpus: 300 docs, 500 words, 16 topics."""
    c = synthetic_lda_corpus(0, n_docs=300, n_words=500, n_topics=16,
                             mean_doc_len=80)
    return relabel_by_frequency(c)[0]


def test_fit_llpt_trajectory_matches_reference(planted):
    kw = dict(n_topics=16, tile_size=512, eval_every=5, sampler="two_branch")
    ref, got = [], []
    for seed in range(SEEDS):
        ref.append(JaxEngine(planted, JaxConfig(seed=seed, **kw)).fit(20))
        got.append(LDAEngine(port_corpus(planted), LDAConfig(seed=seed, **kw),
                             device="cpu").fit(20))
    assert all(h["iteration"] == [1, 5, 10, 15, 20] for h in ref + got)
    ref_llpt = np.mean([h["llpt"] for h in ref], axis=0)
    got_llpt = np.mean([h["llpt"] for h in got], axis=0)
    assert np.all(np.abs(got_llpt - ref_llpt) <= LLPT_TOL), (got_llpt,
                                                            ref_llpt)
    assert np.all(np.diff(got_llpt) > 0)                  # LLPT rises
    frac = lambda hs, k: np.mean([h["stats"][-1][k] for h in hs])  # noqa
    for k in ("frac_unchanged", "frac_s_branch"):
        assert abs(frac(got, k) - frac(ref, k)) <= 0.05, k


def test_two_and_three_branch_converge_to_same_llpt(small_corpus):
    """The samplers share one stationary distribution: final LLPT agrees
    (the reference's test, on the port)."""
    corpus = port_corpus(small_corpus)
    res = {}
    for sampler in ("two_branch", "three_branch"):
        cfg = LDAConfig(n_topics=16, tile_size=512, sampler=sampler, seed=4)
        tr = LDATrainer(corpus, cfg, device="cpu")
        state = tr.init_state()
        for _ in range(25):
            state, _ = tr.step(state)
        res[sampler] = tr.evaluate(state)
    assert abs(res["two_branch"] - res["three_branch"]) < 0.15, res


def test_trained_model_exports_and_folds_in(small_corpus):
    engine = LDAEngine(port_corpus(small_corpus),
                       LDAConfig(n_topics=8, tile_size=256,
                                 sampler="two_branch"), device="cpu")
    engine.fit(3)
    model = engine.export()
    assert np.array_equal(model.W, engine.state.W.numpy())
    docs = [small_corpus.word_ids[:20].tolist(), [1, 2, 3]]
    res = model.fold_in(docs, n_sweeps=5, seed=0)
    assert res.theta.shape == (2, 8) and np.all(np.isfinite(res.theta))
    assert np.isfinite(res.llpt)


REFUSED = {
    "fused": (dict(fused=True), {}, "fused=True"),
    "hybrid": (dict(format="hybrid"), {}, "format='hybrid'"),
    "streamed": (dict(corpus_residency="streamed", stream_shards=2), {},
                 "corpus_residency='streamed'"),
    "auto": (dict(corpus_residency="auto"), {}, "corpus_residency='auto'"),
    "disk": (dict(corpus_residency="disk", corpus_path="/nonexistent"), {},
             "corpus_residency='disk'"),
    "distributed": ({}, dict(backend="distributed"),
                    "backend='distributed'"),
    "ps": (dict(dist=DistConfig(w_sync="ps", mesh_shape=(("data", 2),
                                                         ("model", 1)))),
           {}, "w_sync='ps'"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_paths_that_would_run_three_branch_raise(small_corpus, name):
    knobs, engine_kw, path = REFUSED[name]
    corpus = None if name == "disk" else port_corpus(small_corpus)
    cfg = LDAConfig(n_topics=8, tile_size=256, sampler="two_branch", **knobs)
    with pytest.raises(ValueError, match="two_branch") as err:
        LDAEngine(corpus, cfg, device="cpu", **engine_kw)
    assert path in str(err.value)


def test_run_fused_raises(small_corpus):
    engine = LDAEngine(port_corpus(small_corpus),
                       LDAConfig(n_topics=8, tile_size=256,
                                 sampler="two_branch"), device="cpu")
    with pytest.raises(ValueError, match="run_fused"):
        engine.trainer.run_fused(1)
    engine.fit(1)                          # the stepwise path still runs
    assert engine.iteration == 1


def test_reference_runs_three_branch_under_the_baselines_name(small_corpus):
    """The reference fault the port leaves out: with sampler="two_branch",
    the reference's impl="pallas" step and its fused pipeline return the
    three-branch sampler's draws and stats (``LDATrainer._make_sampler``
    tests impl before sampler; the fused pipeline only asks for warp)."""
    kw = dict(n_topics=8, tile_size=256)
    out = {}
    for sampler in ("two_branch", "three_branch"):
        cfg = JaxConfig(sampler=sampler, impl="pallas", **kw)
        tr = JaxTrainer(small_corpus, cfg, _from_engine=True)
        state, stats = tr.step(tr.init_state())
        fused = JaxTrainer(small_corpus, JaxConfig(sampler=sampler, **kw),
                           _from_engine=True)
        fstate, hist = fused.run_fused(2)
        out[sampler] = (np.asarray(state.topics), set(stats),
                        np.asarray(fstate.topics), set(hist["stats"][-1]))
    two, three = out["two_branch"], out["three_branch"]
    assert np.array_equal(two[0], three[0])           # pallas step draws
    assert two[1] == three[1] and "frac_skipped" in two[1] \
        and "frac_s_branch" not in two[1]
    assert np.array_equal(two[2], three[2])           # fused pipeline draws
    assert two[3] == three[3] and "frac_s_branch" not in two[3]
    # the reference's stepwise impl="xla" path is the baseline
    tr = JaxTrainer(small_corpus, JaxConfig(sampler="two_branch", **kw),
                    _from_engine=True)
    assert "frac_s_branch" in tr.step(tr.init_state())[1]
