"""The warp MH engine (``sampler="warp"``) through the port's pipeline,
trainer and engine: its own bitwise invariants, the reference engine's
LLPT trajectory, the config surface, and a reference warp run carried
across.

Tolerances: inside the port everything is bitwise (fused ``step`` ==
stepwise, tiled == untiled, hybrid == dense, kernel route == plain
route on the CPU). Against the JAX warp engine the two packages draw
different random numbers, so the trajectories are compared in
distribution: the mean LLPT over ``SEEDS`` seeds at each eval must agree
within ``LLPT_TOL``. Measured on this corpus with the stepwise engines
over 16 seeds per package, one run's LLPT at iteration 20 spreads with a
standard deviation of about 0.02, so the difference of two 4-seed means
has one of about 0.014 (the largest of four such gaps was 0.021, the
16-seed means 0.004 apart); 0.06 is four of those. The fused engines
hold their tables for a stretch between evals; that staleness lowered
the 16-seed mean at iteration 20 by ~0.015 in both packages.
"""

import numpy as np
import pytest
import torch

from repro.lda.api import LDAEngine as JaxEngine
from repro.lda.corpus import relabel_by_frequency, synthetic_lda_corpus, \
    zipf_corpus
from repro.lda.model import LDAConfig as JaxConfig
from repro_torch.lda import LDAEngine, LDATrainer
from repro_torch.lda.model import DistConfig, LDAConfig
from repro_torch.train import lda_step
from _torch_dist import world1
from _torch_parity import port_corpus

SEEDS = 4
LLPT_TOL = 0.06
BASE = dict(n_topics=16, tile_size=512, sampler="warp", seed=1)


@pytest.fixture(scope="module")
def small(small_corpus):
    return port_corpus(small_corpus)


@pytest.fixture(scope="module")
def wide():
    """V large enough that a 64-128 word window satisfies win·4 <= V, so
    the tiled route engages (the reference's ``wide_corpus``)."""
    c = zipf_corpus(seed=7, n_docs=100, n_words=600, mean_doc_len=50)
    return port_corpus(relabel_by_frequency(c)[0])


def _run(corpus, n_iters=5, **over):
    cfg = LDAConfig(**{**BASE, "fused": True, **over})
    tr = LDATrainer(corpus, cfg, device="cpu")
    pipe = tr.fused_pipeline()
    fs = pipe.from_lda_state(tr.init_state())
    fs, stats, _ = pipe.run_fused(fs, n_iters)
    return pipe, pipe.to_lda_state(fs), stats


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_fused_step_equals_stepwise_bitwise(small, impl):
    """One-iteration calls (``pipe.step``) build fresh tables, as the
    stepwise trainer does every step: bitwise equal."""
    tr_s = LDATrainer(small, LDAConfig(**BASE, impl=impl), device="cpu")
    tr_f = LDATrainer(small, LDAConfig(**BASE, impl=impl, fused=True),
                      device="cpu")
    pipe = tr_f.fused_pipeline()
    fs = pipe.from_lda_state(tr_f.init_state())
    st = tr_s.init_state()
    for _ in range(3):
        fs, fstats, _ = pipe.step(fs)
        st, stats = tr_s.step(st)
    assert torch.equal(fs.topics, st.topics)
    assert torch.equal(fs.D, st.D) and torch.equal(fs.W, st.W)
    assert torch.equal(fs.colsum, st.W.sum(dim=0, dtype=torch.int32))
    assert float(fstats.frac_accepted) == stats["frac_accepted"]


def test_kernel_route_equals_plain_route(small):
    _, a, _ = _run(small)
    _, b, _ = _run(small, impl="torch")
    assert torch.equal(a.topics, b.topics) and torch.equal(a.D, b.D)


def test_tables_are_held_for_a_call_and_rebuilt_per_call(small):
    """``run_fused`` builds the proposal once, from the counts at its
    start; the engine's eval boundaries decide the calls."""
    tr = LDATrainer(small, LDAConfig(**BASE, fused=True), device="cpu")
    pipe = tr.fused_pipeline()
    fs0 = pipe.from_lda_state(tr.init_state())
    tables = pipe.build_proposal(fs0)
    manual = pipe.from_lda_state(tr.init_state())
    for _ in range(3):
        manual, _, _ = pipe.step(manual, tables)
    fused, _, _ = pipe.run_fused(fs0, 3)
    assert torch.equal(fused.topics, manual.topics)
    fresh = pipe.from_lda_state(tr.init_state())
    for _ in range(3):
        fresh, _, _ = pipe.step(fresh)
    assert not torch.equal(fresh.topics, fused.topics)   # stale != fresh

    builds = []
    real = pipe.build_proposal
    pipe.build_proposal = lambda fs: builds.append(1) or real(fs)
    eng = LDAEngine(small, LDAConfig(**BASE, fused=True, eval_every=5),
                    device="cpu")
    eng.trainer._fused_pipeline = pipe
    eng.fit(12)                            # chunks 1, 4, 5, 2
    assert len(builds) == 4 and eng.history["iteration"] == [1, 5, 10]


def test_tiled_equals_untiled_bitwise(wide):
    _, a, _ = _run(wide, survivor_capacity=64)
    pipe, b, _ = _run(wide, survivor_capacity=64, balance="tiles")
    assert pipe._use_tiles(pipe.win_words)         # the window engaged
    assert pipe.tile_routes["tiled"] > 0
    assert torch.equal(a.topics, b.topics) and torch.equal(a.W, b.W)


def test_window_fallback_equals_untiled(small):
    """V = 80 forces win == V: every tile takes the untiled route, with
    the same bits (the reference's ``test_pallas_warp_window_fallback``)."""
    _, a, _ = _run(small)
    pipe, b, _ = _run(small, balance="tiles")
    assert not pipe._use_tiles(pipe.win_words)
    assert pipe.tile_routes["tiled"] == 0 and pipe.tile_routes["untiled"] > 0
    assert torch.equal(a.topics, b.topics)


@pytest.mark.parametrize("balance", ["none", "tiles"])
def test_hybrid_equals_dense_bitwise(wide, balance):
    _, a, _ = _run(wide, balance=balance)
    pipe, b, _ = _run(wide, balance=balance, format="hybrid",
                      tail_sampler="sparse")
    assert torch.equal(a.topics, b.topics)
    assert torch.equal(a.D, b.D) and torch.equal(a.W, b.W)
    hs = pipe.from_lda_state(b)
    assert int(hs.overflow) == 0


def test_stats_surface(small):
    tr = LDATrainer(small, LDAConfig(**BASE, mh_cycles=3), device="cpu")
    state, stats = tr.step(tr.init_state())
    assert stats["n_proposals"] == pytest.approx(6.0)
    assert 0.0 < stats["frac_accepted"] < 1.0
    assert 0.0 <= stats["frac_unchanged"] <= 1.0
    _, _, st = _run(small, n_iters=2)
    assert st.frac_accepted.shape == (2,)


def test_fit_llpt_trajectory_matches_reference():
    """The stepwise engines of both packages (tables rebuilt from the live
    Ŵ every iteration; the reference compiles its stepwise sampler once
    for every seed), and the port's fused engine with a chunk per
    iteration, which is the same chain bitwise."""
    c = relabel_by_frequency(synthetic_lda_corpus(
        0, n_docs=300, n_words=500, n_topics=16, mean_doc_len=80))[0]
    kw = dict(n_topics=16, tile_size=512, eval_every=5, sampler="warp")
    ref, got = [], []
    for seed in range(SEEDS):
        ref.append(JaxEngine(c, JaxConfig(seed=seed, **kw)).fit(20))
        got.append(LDAEngine(port_corpus(c), LDAConfig(seed=seed, **kw),
                             device="cpu").fit(20))
    assert all(h["iteration"] == [1, 5, 10, 15, 20] for h in ref + got)
    ref_llpt = np.mean([h["llpt"] for h in ref], axis=0)
    got_llpt = np.mean([h["llpt"] for h in got], axis=0)
    assert np.all(np.abs(got_llpt - ref_llpt) <= LLPT_TOL), (got_llpt,
                                                            ref_llpt)
    assert np.all(np.diff(got_llpt) > 0)                   # LLPT rises
    acc = lambda hs: np.mean([h["stats"][-1]["frac_accepted"] for h in hs])
    assert abs(acc(got) - acc(ref)) <= 0.05
    fused = LDAEngine(port_corpus(c), LDAConfig(**{**kw, "eval_every": 1},
                                                seed=SEEDS - 1, fused=True),
                      device="cpu").fit(20)
    assert [fused["llpt"][i - 1] for i in (1, 5, 10, 15, 20)] \
        == got[-1]["llpt"]


def test_reference_warp_payload_restores(small_corpus, small):
    """A JAX warp run's ``{topics, iteration}`` restores in the port, its
    counts rebuilt through the histogram route, and trains on."""
    jeng = JaxEngine(small_corpus, JaxConfig(**BASE))
    jeng.fit(3)
    payload = jeng.host_payload()
    eng = LDAEngine(small, LDAConfig(**BASE, fused=True), device="cpu")
    eng.restore(payload)
    assert eng.iteration == 3
    assert np.array_equal(eng.state.D.numpy(), np.asarray(jeng.state.D))
    assert np.array_equal(eng.state.W.numpy(), np.asarray(jeng.state.W))
    assert eng.score() == pytest.approx(jeng.score(), abs=1e-4)
    eng.fit(2)
    assert eng.iteration == 5


@pytest.mark.parametrize("over", [
    dict(corpus_residency="streamed"), dict(corpus_residency="disk"),
    dict(dist="DistConfig")])
def test_config_rejects_warp_where_the_reference_does(over, small, tmp_path):
    if over.get("dist") == "DistConfig":
        # as in the reference, the config takes a DistConfig and the
        # distributed trainer refuses the warp engine
        cfg = LDAConfig(**BASE, dist=DistConfig())
        with world1(tmp_path), pytest.raises(
                ValueError, match="sampler='warp' is single-backend only"):
            LDAEngine(small, cfg, device="cpu", backend="distributed")
        return
    with pytest.raises(ValueError, match="warp"):
        LDAConfig(**BASE, **over)
    LDAConfig(**BASE)                                      # builds


def test_draw_warp_uniforms_order():
    """Doc (C, 3, N), word (C, 2, N), accept (C, 2, N), drawn in that
    order from iteration i's generator."""
    from repro_torch.lda.model import uniforms_generator
    u = lda_step.draw_warp_uniforms(3, 4, 10, 2, torch.device("cpu"))
    assert [tuple(x.shape) for x in u] == [(2, 3, 10), (2, 2, 10),
                                           (2, 2, 10)]
    g = uniforms_generator(3, 5, torch.device("cpu"))
    flat = torch.rand(140, generator=g)
    assert torch.equal(torch.cat([x.flatten() for x in u]), flat)
