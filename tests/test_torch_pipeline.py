"""The port's fused iteration against the reference's, and its own
invariants: one FusedPipeline step vs the JAX pipeline's
(``impl="pallas"``, Pallas in interpret mode) on the JAX step's own
uniforms; fused == stepwise bitwise; delta updates == rebuild; capacity
is a pure performance knob.
"""

import jax
import numpy as np
import pytest
import torch

from repro.lda.model import LDAConfig as JaxConfig
from repro.lda.trainer import LDATrainer as JaxTrainer
from repro.lda.trainer import chunk_to_boundary as jax_chunk_to_boundary
from repro.train.lda_step import plan_capacity as jax_plan_capacity
from repro_torch.core import esca
from repro_torch.lda.model import LDAConfig
from repro_torch.lda.trainer import LDATrainer, chunk_to_boundary
from repro_torch.train.lda_step import plan_capacity
from _torch_parity import assert_topics_agree, port_corpus


@pytest.fixture(scope="module")
def corpora(small_corpus):
    return small_corpus, port_corpus(small_corpus)


def _trainer(corpus, **kw):
    return LDATrainer(corpus, LDAConfig(n_topics=16, tile_size=512, **kw),
                      device="cpu")


def test_one_step_matches_jax_pallas_pipeline(corpora):
    jc, tc = corpora
    jt = JaxTrainer(jc, JaxConfig(n_topics=16, tile_size=512, impl="pallas"),
                    _from_engine=True)
    jpipe = jt.fused_pipeline()
    tt = _trainer(tc)
    tpipe = tt.fused_pipeline()
    alpha = tt.config.alpha_
    fs = jpipe.from_lda_state(jt.init_state())
    n_mismatch = 0
    for it in range(4):
        # the uniforms the JAX step draws: split once, uniform(sub)
        key = jax.random.wrap_key_data(jax.random.key_data(fs.key).copy())
        u = np.array(jax.random.uniform(jax.random.split(key)[1],
                                        (jpipe.n_tokens,)))
        topics = np.asarray(fs.topics).copy()
        state = tt.state_from_topics(topics, it)
        assert np.array_equal(state.D.numpy(), np.asarray(fs.D))
        assert np.array_equal(state.W.numpy(), np.asarray(fs.W))
        W_hat = esca.compute_w_hat(state.W, tt.config.beta).numpy()
        t_fs, t_st, t_ns = tpipe._iteration(
            tpipe.from_lda_state(state), torch.from_numpy(u),
            capacity=tpipe.capacity)
        fs, j_st, j_ns = jpipe.step(fs)
        d, v = tt.doc_ids.numpy(), tt.word_ids.numpy()
        n_mismatch += assert_topics_agree(
            u, state.D.numpy()[d], W_hat[v], alpha, t_fs.topics.numpy(),
            np.asarray(fs.topics))
        assert abs(int(t_ns) - int(j_ns)) <= 2     # skips flip only at margins
        assert float(t_st.frac_skipped) == pytest.approx(
            float(j_st.frac_skipped), abs=1e-3)
        # counts stay consistent with the port's own topics, exactly
        D_ref, W_ref = esca.update_counts(
            tt.word_ids, tt.doc_ids, t_fs.topics, tt.mask, n_docs=tt.n_docs,
            n_words=tt.n_words, n_topics=16)
        assert torch.equal(t_fs.D, D_ref) and torch.equal(t_fs.W, W_ref)
        assert torch.equal(t_fs.colsum, W_ref.sum(dim=0, dtype=torch.int32))
        if np.array_equal(t_fs.topics.numpy(), np.asarray(fs.topics)):
            assert np.array_equal(t_fs.D.numpy(), np.asarray(fs.D))
            assert np.array_equal(t_fs.W.numpy(), np.asarray(fs.W))
    assert n_mismatch <= 2


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_fused_equals_stepwise_bitwise(corpora, impl):
    tt = _trainer(corpora[1], impl=impl)
    state = tt.init_state()
    pipe = tt.fused_pipeline()
    fs = pipe.from_lda_state(state)
    for i in range(5):
        state, _ = tt.step(state)
        fs, _, n_surv = pipe.step(fs)
        assert torch.equal(fs.topics, state.topics), (impl, i)
        assert torch.equal(fs.D, state.D) and torch.equal(fs.W, state.W)
        assert torch.equal(fs.colsum, state.W.sum(dim=0, dtype=torch.int32))
        assert 0 < int(n_surv) <= pipe.n_tokens
    assert fs.iteration == state.iteration == 5


def test_run_fused_equals_steps_and_capacity_is_a_knob(corpora):
    tc = corpora[1]
    outs = []
    for cap in (64, 300, 10 ** 6):
        tt = _trainer(tc, survivor_capacity=cap)
        pipe = tt.fused_pipeline()
        fs, stats, n_surv = pipe.run_fused(pipe.from_lda_state(
            tt.init_state()), 3)
        assert tuple(n_surv.shape) == (3,) and stats.frac_skipped.shape == (3,)
        assert pipe.capacity == min(cap, pipe.n_tokens)   # pinned
        outs.append(fs.topics)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])
    tt = _trainer(tc)
    pipe = tt.fused_pipeline()
    fs = pipe.from_lda_state(tt.init_state())
    for _ in range(3):
        fs, _, _ = pipe.step(fs)
    assert torch.equal(fs.topics, outs[0])


def test_from_lda_state_leaves_the_caller_state_alone(corpora):
    tt = _trainer(corpora[1])
    state = tt.init_state()
    D0 = state.D.clone()
    pipe = tt.fused_pipeline()
    pipe.step(pipe.from_lda_state(state))
    assert torch.equal(state.D, D0)


def test_trainer_run_hits_absolute_boundaries_and_resumes(corpora):
    tc = corpora[1]
    tt = _trainer(tc, eval_every=5, fused=True)
    state = tt.init_state()
    for _ in range(3):
        state, _ = tt.step(state)
    state, hist = tt.run(9, state=state)            # iterations 4..12
    assert state.iteration == 12
    assert hist["iteration"] == [4, 5, 10]
    # {topics, iteration} alone resumes deterministically
    tt2 = _trainer(tc, eval_every=5, fused=True)
    s_a, _ = tt2.run(3, state=tt2.state_from_topics(state.topics, 12))
    s_b, _ = tt.run(3, state=state)
    assert torch.equal(s_a.topics, s_b.topics)
    assert hist["llpt"][-1] > hist["llpt"][0] - 0.05


def test_planning_helpers_match_reference():
    for ema in (0, 1, 100, 5000, 100_000, 10 ** 9):
        for n in (100, 4096, 10 ** 6):
            assert plan_capacity(ema, n) == jax_plan_capacity(ema, n)
    for args in [(0, 0, 10, 5), (3, 1, 9, 5), (7, 4, 20, 10, 3),
                 (12, 2, 1, 4), (5, 5, 0, 5)]:
        assert chunk_to_boundary(*args) == jax_chunk_to_boundary(*args)
