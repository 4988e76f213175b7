"""Tile balancing in the port: the tile plan and its planners against the
reference, the tiled exact branch and the sample_fused_tiled twin
against theirs, and, inside the port, tiled == untiled bitwise.

Tolerances: plans and planners are integers (equal); the tiled exact
branch is bitwise the reference's arithmetic on the same rows (topics
equal except rare CDF-boundary tokens, ``_torch_parity``); the twin
against Pallas in interpret mode as in ``test_torch_sample_fused.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import balance as jbal
from repro.core import three_branch as jtb
from repro.kernels.sample_fused import sample_fused_tiled as pallas_tiled
from repro.train import lda_step as jstep
from repro_torch.core import balance as tbal
from repro_torch.core import three_branch as ttb
from repro_torch.kernels import sample_fused as sf
from repro_torch.lda.model import LDAConfig
from repro_torch.lda.trainer import LDATrainer
from repro_torch.train import lda_step as tstep
from _torch_parity import (assert_masses_close, assert_topics_agree,
                           port_corpus, row_total)

T = torch.from_numpy


def _assert_same_plan(a, b):
    for f in ("tile_size", "n_tiles", "max_words_per_tile",
              "max_tiles_per_word"):
        assert getattr(a, f) == getattr(b, f), f
    assert np.array_equal(a.tile_first_word, b.tile_first_word)
    assert np.array_equal(a.tile_last_word, b.tile_last_word)
    assert a.tile_first_word.dtype == b.tile_first_word.dtype


@pytest.mark.parametrize("tile", [1, 7, 128, 5000])
def test_tile_plans_match_reference(skewed_corpus, tile):
    jc, tc = skewed_corpus, port_corpus(skewed_corpus)
    _assert_same_plan(tbal.build_tiles(tc, tile), jbal.build_tiles(jc, tile))
    ids = jc.word_ids
    for n in (None, 0, 1, len(ids) // 3):
        _assert_same_plan(tbal.build_tiles_from_word_ids(ids, tile, n),
                          jbal.build_tiles_from_word_ids(ids, tile, n))
    counts = jc.word_token_counts
    assert np.array_equal(
        tbal.tiles_spanned(jc.word_offsets[:-1], counts, tile),
        jbal.tiles_spanned(jc.word_offsets[:-1], counts, tile))
    with pytest.raises(ValueError, match="sorted"):
        tbal.build_tiles_from_word_ids(ids[::-1], tile)


def test_planners_match_reference():
    for ema in (0, 100, 3000, 1e6):
        for n in (500, 10**5, 10**8):
            for k in (16, 1000, 1025):
                assert tstep.plan_tile_capacity(ema, n, k) == \
                    jstep.plan_tile_capacity(ema, n, k)
    for span in (0, 1, 63, 64, 65, 700):
        for v in (80, 500, 101636):
            assert tstep.plan_window(span, v) == jstep.plan_window(span, v)
    assert tstep.plan_tile_capacity(10**8, 10**8, 1000) == 128
    assert tstep.TILE_WORKING_SET_BYTES == jstep.TILE_WORKING_SET_BYTES


def _rows(seed, M=40, V=60, K=30):
    rng = np.random.default_rng(seed)
    D = (rng.integers(0, 9, (M, K)) * (rng.random((M, K)) < 0.3)
         ).astype(np.int32)
    W_hat = (rng.random((V, K)) * 0.01).astype(np.float32)
    return rng, D, W_hat


def test_exact_three_branch_tiled_matches_reference():
    rng, D, W_hat = _rows(1)
    n, win, first = 300, 16, 20
    word = np.sort(rng.integers(first, first + win, n)).astype(np.int32)
    doc = rng.integers(0, D.shape[0], n).astype(np.int32)
    u = rng.random(n).astype(np.float32)
    k1 = np.argmax(W_hat, axis=1).astype(np.int32)
    local = (word - first).astype(np.int32)
    w_win, k1_win = W_hat[first:first + win], k1[first:first + win]
    got = ttb.exact_three_branch_tiled(T(u), T(local), T(doc), T(k1_win),
                                       T(D), T(w_win), alpha=0.3)
    want = jtb.exact_three_branch_tiled(
        jnp.asarray(u), jnp.asarray(local), jnp.asarray(doc),
        jnp.asarray(k1_win), jnp.asarray(D), jnp.asarray(w_win), alpha=0.3)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert_topics_agree(u, D[doc], W_hat[word], 0.3, got[0].numpy(),
                        np.asarray(want[0]))
    untiled = ttb.exact_three_branch(T(u), T(word), T(doc), T(k1), T(D),
                                     T(W_hat), alpha=0.3)
    for a, b in zip(got, untiled):
        assert torch.equal(a, b)


@pytest.mark.parametrize("K,win,first", [(30, 16, 20), (37, 8, 55),
                                         (130, 64, 0)])
def test_tiled_twin_matches_pallas_and_untiled(K, win, first):
    rng, D, W_hat = _rows(K + win, V=64, K=K)
    n = 160
    first = min(first, 64 - win)
    word = np.sort(rng.integers(first, first + win, n)).astype(np.int32)
    doc = rng.integers(0, D.shape[0], n).astype(np.int32)
    u = rng.random(n).astype(np.float32)
    alpha = 50.0 / K
    got = [x.numpy() for x in sf.sample_fused_tiled(
        T(u), T(D[doc]), T(W_hat), T(word), int(word[0]), alpha=alpha,
        win_words=win)]
    want = [np.asarray(x) for x in pallas_tiled(
        jnp.asarray(u), jnp.asarray(D[doc]), jnp.asarray(W_hat),
        jnp.asarray(word), jnp.int32(word[0]), alpha=alpha, win_words=win,
        interpret=True)]
    d_rows, w_rows = D[doc], W_hat[word]
    total = row_total(d_rows, w_rows, alpha)
    assert_masses_close(got[1], want[1], total)
    assert_masses_close(got[2], want[2], total, cancels=True)
    assert_masses_close(got[3], want[3], total)
    assert_topics_agree(u, d_rows, w_rows, alpha, got[0], want[0])
    untiled = sf.sample_fused(T(u), T(d_rows), T(w_rows), alpha=alpha)
    for a, b in zip(got, untiled):
        assert np.array_equal(a, b.numpy())


def test_tiled_rows_entry_reads_through_each_window():
    """Several tiles in one call: a tile whose run fits its window reads
    its own words' rows (== untiled); one that does not reads clipped
    rows, as the Pallas kernel does."""
    rng, D, W_hat = _rows(3, V=200)
    n, size, win = 300, 100, 16
    word = np.sort(rng.integers(0, 200, n)).astype(np.int32)
    word[:100] = np.sort(rng.integers(10, 20, 100))      # tile 0 fits
    doc = rng.integers(0, D.shape[0], n).astype(np.int32)
    u = rng.random(n).astype(np.float32)
    first = torch.tensor(word[::size], dtype=torch.int32)
    stats = sf.word_stats_arrays(T(W_hat), alpha=0.2)
    got = sf.sample_fused_tiled_rows(T(u), T(doc), T(word), first, size,
                                     T(D), T(W_hat), *stats, win_words=win,
                                     alpha=0.2)
    untiled = sf.sample_fused_rows(T(u), T(doc), T(word), T(D), T(W_hat),
                                   *stats, alpha=0.2)
    for a, b in zip(got, untiled):
        assert torch.equal(a[:size], b[:size])
    rows = sf.window_rows(T(word).long(), first.long(), size, win, 200)
    assert torch.equal(rows[:size], T(word[:size]).long())
    base = np.clip(word[size], 0, 200 - win)
    assert rows[size:2 * size].max() <= base + win - 1
    clipped = sf.sample_fused_rows(T(u), T(doc), rows.int(), T(D), T(W_hat),
                                   *stats, alpha=0.2)
    for a, b in zip(got, clipped):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="tile starts"):
        sf.sample_fused_tiled_rows(T(u), T(doc), T(word), first[:2], size,
                                   T(D), T(W_hat), *stats, win_words=win,
                                   alpha=0.2)


def _trajectory(corpus, cfg, force_window=None, n_iters=6):
    tr = LDATrainer(corpus, cfg, device="cpu")
    pipe = tr.fused_pipeline()
    if force_window is not None:
        # engage the word window even on a tiny test vocabulary
        pipe.WINDOW_VOCAB_FRACTION = 1
        pipe.win_words = force_window
    fs = pipe.from_lda_state(tr.init_state())
    for _ in range(n_iters // 2):
        fs, _, _ = pipe.run_fused(fs, 2)         # re-plans between stretches
        if force_window is not None:
            pipe.win_words = force_window
    st = pipe.to_lda_state(fs)
    return (st.topics, st.D, st.W), pipe


@pytest.mark.parametrize("impl", ["torch", "kernel"])
@pytest.mark.parametrize("cap", [None, 128])
def test_tiled_pipeline_bit_equal_dense(small_corpus, impl, cap):
    c = port_corpus(small_corpus)
    kw = dict(n_topics=16, tile_size=512, impl=impl, survivor_capacity=cap)
    ref, _ = _trajectory(c, LDAConfig(**kw))
    for force in (None, 24):                     # tile size only / + window
        got, pipe = _trajectory(c, LDAConfig(balance="tiles", **kw),
                                force_window=force)
        for a, b in zip(ref, got):
            assert torch.equal(a, b), (impl, cap, force)
        if force and cap:
            assert pipe.tile_routes["tiled"] > 0


@pytest.mark.parametrize("tail_sampler", ["exact", "sparse"])
def test_tiled_pipeline_bit_equal_hybrid(small_corpus, tail_sampler):
    c = port_corpus(small_corpus)
    kw = dict(n_topics=16, tile_size=512, format="hybrid",
              tail_sampler=tail_sampler, survivor_capacity=128)
    ref, _ = _trajectory(c, LDAConfig(**kw))
    got, pipe = _trajectory(c, LDAConfig(balance="tiles", **kw),
                            force_window=24)
    for a, b in zip(ref, got):
        assert torch.equal(a, b), tail_sampler
    assert pipe.tile_routes["tiled"] > 0


def test_tiny_window_forces_untiled_route_still_bit_equal(small_corpus):
    """A one-word window sends every tile that spans two words or more
    down the untiled route: results never depend on the plan."""
    c = port_corpus(small_corpus)
    kw = dict(n_topics=16, tile_size=512, survivor_capacity=128)
    ref, _ = _trajectory(c, LDAConfig(**kw))
    got, pipe = _trajectory(c, LDAConfig(balance="tiles", **kw),
                            force_window=1)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
    assert pipe.tile_routes["untiled"] > pipe.tile_routes["tiled"]


def test_tiles_need_at_most_two_launches_a_segment(small_corpus):
    """Every fitting tile goes in one call of the tiled sampler, the rest
    in one call of the untiled one, however many tiles there are."""
    c = port_corpus(small_corpus)
    tr = LDATrainer(c, LDAConfig(n_topics=16, tile_size=512,
                                 balance="tiles", survivor_capacity=16),
                    device="cpu")
    pipe = tr.fused_pipeline()
    pipe.WINDOW_VOCAB_FRACTION = 1
    calls = []
    make = pipe._dense_chunk_sampler

    def counting(*args):
        fn = make(*args)

        def sample_chunk(idx, window=None):
            calls.append(window is not None)
            return fn(idx, window)
        return sample_chunk

    pipe._dense_chunk_sampler = counting
    fs = pipe.from_lda_state(tr.init_state())
    u = torch.rand(pipe.n_tokens, generator=torch.Generator().manual_seed(0))
    pipe._iteration(fs, u, capacity=16, win_words=4)
    n_tiles = sum(pipe.tile_routes.values())
    assert n_tiles > 100 and sorted(calls) == [False, True]
