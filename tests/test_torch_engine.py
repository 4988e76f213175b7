"""The port's front door against the reference engine: corpus prep, the
LLPT trajectory of ``fit``, and carrying a reference state across.

The two packages draw different random numbers (``torch.Generator`` vs
JAX keys), so trajectories are compared in distribution: the mean LLPT
over ``SEEDS`` seeds at each eval must agree within ``LLPT_TOL`` bits.
Measured on this corpus over 24 seeds, one run's LLPT at iterations
10-30 spreads with a standard deviation of about 0.025 bits, so the
difference of two 4-seed means has one of about 0.02; 0.08 is four of
those.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import llpt as jllpt
from repro.lda.api import LDAEngine as JaxEngine
from repro.lda.corpus import relabel_by_frequency, synthetic_lda_corpus
from repro.lda.model import LDAConfig as JaxConfig
from repro_torch.lda import LDAEngine, LDATrainer
from repro_torch.lda.model import LDAConfig
from _torch_parity import port_corpus

SEEDS = 4
LLPT_TOL = 0.08


@pytest.fixture(scope="module")
def planted():
    """benchmarks/_common.planted_corpus: 300 docs, 500 words, 16 topics."""
    c = synthetic_lda_corpus(0, n_docs=300, n_words=500, n_topics=16,
                             mean_doc_len=80)
    return relabel_by_frequency(c)[0]


def test_fit_llpt_trajectory_matches_reference(planted):
    kw = dict(n_topics=16, tile_size=512, eval_every=5)
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
    frac = lambda hs: np.mean([h["stats"][-1]["frac_unchanged"] for h in hs])
    assert abs(frac(got) - frac(ref)) <= 0.05


def test_fused_engine_runs_the_same_trajectory(planted):
    kw = dict(n_topics=16, tile_size=512, eval_every=5)
    a = LDAEngine(port_corpus(planted), LDAConfig(**kw), device="cpu")
    b = LDAEngine(port_corpus(planted), LDAConfig(fused=True, **kw),
                  device="cpu")
    ha, hb = a.fit(7), b.fit(7)
    assert ha["llpt"] == hb["llpt"]
    assert (a.state.topics == b.state.topics).all()
    b.fit(3)
    # every fit call records its first iteration, then the boundaries
    assert b.iteration == 10 and b.history["iteration"] == [1, 5, 8, 10]
    assert b.score() == b.history["llpt"][-1]


def test_state_from_reference_rebuilds_jax_counts():
    # an unrelabeled corpus: both engines must prep it the same way
    c = synthetic_lda_corpus(2, n_docs=50, n_words=90, n_topics=6,
                             mean_doc_len=30)
    jcfg = JaxConfig(n_topics=8, tile_size=256)
    jeng = JaxEngine(c, jcfg)
    jeng.fit(3)
    payload = jeng.host_payload()
    cfg = LDAConfig(n_topics=8, tile_size=256)
    teng = LDAEngine(port_corpus(c), cfg, device="cpu")
    assert np.array_equal(teng.word_map, jeng.word_map)
    assert np.array_equal(teng.corpus.word_ids, jeng.corpus.word_ids)
    trainer = LDATrainer(teng.corpus, cfg, device="cpu")
    state = trainer.state_from_payload(payload)
    assert state.iteration == 3
    assert np.array_equal(state.D.numpy(), np.asarray(jeng.state.D))
    assert np.array_equal(state.W.numpy(), np.asarray(jeng.state.W))
    n = teng.corpus.n_tokens
    assert np.array_equal(state.topics.numpy()[:n], payload["topics_global"])
    # the engine adopts it, scores it like the reference, and trains on
    teng.restore(payload)
    assert teng.iteration == 3
    assert teng.score() == pytest.approx(jeng.score(), abs=1e-4)
    teng.fit(2)
    assert teng.iteration == 5
    with pytest.raises(ValueError, match="different corpus"):
        trainer.state_from_payload(
            {"topics_global": payload["topics_global"][1:], "iteration": 3})


def test_documents_input_scores_like_reference():
    """Document lists go through the same prep, and score() is the
    reference's LLPT of the same counts."""
    docs = [[0, 1, 1, 4], [2, 2, 3], [4, 0, 0, 0, 1]]
    eng = LDAEngine(docs, LDAConfig(n_topics=3, tile_size=8, eval_every=1),
                    device="cpu")
    jeng = JaxEngine(docs, JaxConfig(n_topics=3, tile_size=8))
    assert np.array_equal(eng.corpus.word_ids, jeng.corpus.word_ids)
    hist = eng.fit(2)
    assert eng.corpus.n_words == 5 and len(hist["llpt"]) == 2
    tr = eng.trainer
    ref = float(jllpt.llpt(tr.word_ids.numpy(), tr.doc_ids.numpy(),
                           tr.mask.numpy(), jnp.asarray(eng.state.D.numpy()),
                           jnp.asarray(eng.state.W.numpy()),
                           alpha=eng.config.alpha_, beta=eng.config.beta))
    assert eng.score() == pytest.approx(ref, rel=1e-5)
