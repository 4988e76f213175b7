"""Tests that need an NVIDIA card: the CUDA kernels against their
plain-PyTorch twins, on the same card tensors, and each tiled kernel
bitwise against its untiled one. The warp kernels (``vose_build`` with
its queues built or read, ``warp_chain`` on the main path's streams or on
compact ones) and ``histogram`` are held to their twins bitwise. The
distributed trainer runs on a one-rank NCCL group and on two gloo ranks
sharing the card, bitwise the single-device engine on the card, and
streamed bitwise resident; the parameter server's four workers on the
card are bitwise the single-device engine. Two gloo ranks on the card run
a supervised fit with a fault on one rank, bitwise the single run; the
serving tier's cached replica is bitwise a full-table one on the card.

They skip without a card. This file imports neither JAX nor the
reference package, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import esca, mh
from repro_torch.core.sparse import EMPTY_IDX, pack_pairs
from repro_torch.kernels import histogram as hist
from repro_torch.kernels import sample_fused as sf
from repro_torch.kernels import sample_sparse as ss
from repro_torch.kernels import sample_warp as sw
from repro_torch.lda import LDAConfig, LDATrainer
from repro_torch.lda.corpus import planted_corpus, relabel_by_frequency
import _torch_dist as td
from _torch_parity import (assert_masses_close, assert_sparse_draws_agree,
                           assert_topics_agree, row_total)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _rows(n, K, seed, ties=False):
    rng = np.random.default_rng(n * 1000 + K + seed)
    d = (rng.integers(0, 50, (n, K)) * (rng.random((n, K)) < 0.1)
         ).astype(np.int32)
    w = (rng.random((n, K)) * 0.01).astype(np.float32)
    if ties:                       # several maxima per row, and flat rows
        w[::2, K // 3] = w[::2, K - 1] = w[::2, 0] = 0.02
        w[1::5] = 0.003
    return rng.random(n).astype(np.float32), d, w


@pytest.mark.cuda
@pytest.mark.parametrize("n,K,ties", [(1, 3, False), (129, 37, True),
                                      (4096, 1000, False), (129, 1025, True),
                                      (64, 1, False), (300, 5000, False),
                                      (16, 8000, True)])
def test_kernel_matches_twin(card, n, K, ties):
    u, d, w = _rows(n, K, 4, ties)
    alpha = 50.0 / K
    args = [torch.from_numpy(x).to(card) for x in (u, d, w)]
    before = sf.sample_fused_rows.launches
    got = [x.cpu().numpy() for x in sf.sample_fused(*args, alpha=alpha)]
    torch.cuda.synchronize()
    assert sf.sample_fused_rows.launches == before + 1
    ids = torch.arange(n, dtype=torch.int32, device=card)
    want = [x.cpu().numpy() for x in sf.sample_fused_rows_plain(
        args[0], ids, ids, args[1], args[2],
        *sf.word_stats_arrays(args[2], alpha=alpha), alpha=alpha)]
    total = row_total(d, w, alpha)
    assert_masses_close(got[1], want[1], total)
    assert_masses_close(got[2], want[2], total, cancels=True)
    assert_masses_close(got[3], want[3], total)
    assert_topics_agree(u, d, w, alpha, got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("K", [37, 1000, 1025])
def test_draws_near_one_stay_in_range(card, K):
    """u just below 1 lands at the end of the CDF, where the kernel's warp
    scan rounds differently on every lane: no draw may land past K−1."""
    n = 8192
    u, d, w = _rows(n, K, 5)
    u = np.minimum(1 - u * 2.0**-16, np.float32(1 - 2.0**-24)).astype(
        np.float32)
    alpha = 50.0 / K
    args = [torch.from_numpy(x).to(card) for x in (u, d, w)]
    got = [x.cpu().numpy() for x in sf.sample_fused(*args, alpha=alpha)]
    assert got[0].min() >= 0 and got[0].max() < K
    ids = torch.arange(n, dtype=torch.int32, device=card)
    want = [x.cpu().numpy() for x in sf.sample_fused_rows_plain(
        args[0], ids, ids, args[1], args[2],
        *sf.word_stats_arrays(args[2], alpha=alpha), alpha=alpha)]
    assert_topics_agree(u, d, w, alpha, got[0], want[0], max_mismatch_frac=1)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 2, 33, 1000, 1024])
@pytest.mark.parametrize("near_one", [False, True])
def test_sample_fused_edge_rows_match_twin(card, K, near_one):
    """Per-word stats fed in, lane blocks of ceil(K/32) topics: K1 at the
    last topic, at a lane block's first and last topic, alone in its lane
    block (K = 33), one live topic (K = 2), u near 1."""
    n = 4096
    u, d, w = _rows(n, K, 8, ties=True)
    chunk = -(-K // 32)
    for i, k1 in enumerate((K - 1, 0, chunk, 2 * chunk - 1, K // 2)):
        w[i::5, min(k1, K - 1)] = 0.05
    if near_one:
        u = np.minimum(1 - u * 2.0**-16, np.float32(1 - 2.0**-24)).astype(
            np.float32)
    alpha = 50.0 / K
    D, W_hat = torch.from_numpy(d).to(card), torch.from_numpy(w).to(card)
    ut = torch.from_numpy(u).to(card)
    ids = torch.arange(n, dtype=torch.int32, device=card)
    stats = sf.word_stats_arrays(W_hat, alpha=alpha)
    got = [x.cpu().numpy() for x in sf.sample_fused_rows(
        ut, ids, ids, D, W_hat, *stats, alpha=alpha)]
    want = [x.cpu().numpy() for x in sf.sample_fused_rows_plain(
        ut, ids, ids, D, W_hat, *stats, alpha=alpha)]
    assert got[0].min() >= 0 and got[0].max() < K
    total = row_total(d, w, alpha)
    assert_masses_close(got[1], want[1], total)
    assert_masses_close(got[2], want[2], total, cancels=True)
    assert np.array_equal(got[3], want[3])          # Q' is handed in
    assert_topics_agree(u, d, w, alpha, got[0], want[0],
                        max_mismatch_frac=1 if near_one else 0.01)
    k1 = stats[0].cpu().numpy()
    in_m = u * (got[1] + got[2] + got[3]) < got[1]
    assert np.all((got[0] == k1) == in_m | ((got[0] == K - 1) & (k1 == K - 1)
                                           & ~in_m))


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(card):
    u, d, w = (torch.from_numpy(x).to(card) for x in _rows(8, 4, 0))
    with pytest.raises(ValueError, match="outside"):
        ids = torch.full((8,), 9, dtype=torch.int32, device=card)
        sf.sample_fused_rows(u, ids, ids, d, w,
                             *sf.word_stats_arrays(w, alpha=1.0), alpha=1.0)
    with pytest.raises(ValueError):
        sf.sample_fused(u.cpu(), d, w, alpha=1.0)      # mixed devices


@pytest.mark.cuda
def test_fused_iteration_on_card_matches_cpu(card):
    corpus = planted_corpus(1, n_docs=200, n_words=400, n_tokens=20_000,
                            n_planted=20, words_per_topic=30)
    cfg = LDAConfig(n_topics=32, tile_size=512)
    cpu = LDATrainer(corpus, cfg, device="cpu")
    gpu = LDATrainer(corpus, cfg, device=card)
    state = cpu.init_state()
    u = torch.rand(cpu.n_padded_tokens,
                   generator=torch.Generator().manual_seed(0))
    p_cpu, p_gpu = cpu.fused_pipeline(), gpu.fused_pipeline()
    before = sf.sample_fused_rows.launches
    fs_c, _, _ = p_cpu._iteration(p_cpu.from_lda_state(state), u,
                                  capacity=1024)
    fs_g, _, _ = p_gpu._iteration(
        p_gpu.from_lda_state(gpu.state_from_topics(state.topics, 0)),
        u.to(card), capacity=1024)
    assert sf.sample_fused_rows.launches > before
    n_diff = int((fs_c.topics != fs_g.topics.cpu()).sum())
    assert n_diff <= 0.001 * fs_c.topics.numel() + 1
    D, W = gpu.state_from_topics(fs_g.topics, 1)[1:3]
    assert torch.equal(fs_g.D, D) and torch.equal(fs_g.W, W)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [37, 1000, 1024, 1025])
def test_fused_tiled_kernel_equals_untiled(card, K):
    """Tiles of 128 sorted tokens whose runs fit the window: the tiled
    kernel reads the same rows and returns the same bits."""
    rng = np.random.default_rng(K)
    n, V, size = 128 * 40 + 17, 3000, 128
    word = np.sort(rng.integers(0, V, n)).astype(np.int32)
    span = (word[np.minimum(np.arange(0, n, size) + size - 1, n - 1)]
            - word[::size]).max()
    win = int(1 << int(span).bit_length())
    u, d, w = _rows(V, K, 7)
    D = torch.from_numpy(d[:400]).to(card)
    W_hat = torch.from_numpy(w).to(card)
    doc = torch.from_numpy(rng.integers(0, 400, n).astype(np.int32)).to(card)
    word_t = torch.from_numpy(word).to(card)
    u = torch.rand(n, generator=torch.Generator().manual_seed(K)).to(card)
    first = word_t[::size].contiguous()
    stats = sf.word_stats_arrays(W_hat, alpha=50.0 / K)
    before = sf.sample_fused_tiled_rows.launches
    tiled = sf.sample_fused_tiled_rows(u, doc, word_t, first, size, D, W_hat,
                                       *stats, win_words=win, alpha=50.0 / K)
    untiled = sf.sample_fused_rows(u, doc, word_t, D, W_hat, *stats,
                                   alpha=50.0 / K)
    torch.cuda.synchronize()
    assert sf.sample_fused_tiled_rows.launches == before + 1
    for a, b in zip(tiled, untiled):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [25_824, 25_825])
@pytest.mark.parametrize("near_one", [False, True])
def test_sample_fused_at_the_staged_cap(card, K, near_one):
    """K = 25,824 is the widest row pair a warp stages in shared memory;
    at 25,825 the kernel reads its rows in place. Both routes agree with
    the twin, and the tiled launch is bitwise the untiled one."""
    rng = np.random.default_rng(K + near_one)
    n, M, V = 512, 40, 60
    _, d, w = _rows(V, K, 9, ties=True)
    D = torch.from_numpy(d[:M]).to(card)
    W_hat = torch.from_numpy(w).to(card)
    doc = torch.from_numpy(rng.integers(0, M, n).astype(np.int32)).to(card)
    word = torch.from_numpy(np.sort(rng.integers(0, V, n)).astype(
        np.int32)).to(card)
    u = rng.random(n).astype(np.float32)
    if near_one:
        u = np.minimum(1 - u * 2.0**-16, np.float32(1 - 2.0**-24)).astype(
            np.float32)
    ut = torch.from_numpy(u).to(card)
    alpha = 50.0 / K
    stats = sf.word_stats_arrays(W_hat, alpha=alpha)
    before = sf.sample_fused_rows.launches
    got = [x.cpu().numpy() for x in sf.sample_fused_rows(
        ut, doc, word, D, W_hat, *stats, alpha=alpha)]
    torch.cuda.synchronize()
    assert sf.sample_fused_rows.launches == before + 1
    want = [x.cpu().numpy() for x in sf.sample_fused_rows_plain(
        ut, doc, word, D, W_hat, *stats, alpha=alpha)]
    d_rows, w_rows = d[:M][doc.cpu().numpy()], w[word.cpu().numpy()]
    total = row_total(d_rows, w_rows, alpha)
    assert got[0].min() >= 0 and got[0].max() < K
    assert_masses_close(got[1], want[1], total)
    assert_masses_close(got[2], want[2], total, cancels=True)
    assert np.array_equal(got[3], want[3])
    assert_topics_agree(u, d_rows, w_rows, alpha, got[0], want[0],
                        max_mismatch_frac=1 if near_one else 0.01)
    first = word[::128].contiguous()
    tiled = sf.sample_fused_tiled_rows(ut, doc, word, first, 128, D, W_hat,
                                       *stats, win_words=V, alpha=alpha)
    for a, b in zip(tiled, got):
        assert np.array_equal(a.cpu().numpy(), b)


def _sparse_tokens(K, L, seed, n=4096, M=300, V=500, near_one=False,
                   nnz=None):
    """Packed sorted D rows (empty slots; K1 in the row or not), Ŵ, word
    stats, and n tokens, on the CPU; row r holds ``nnz[r % len(nnz)]``
    live slots when ``nnz`` is given, else a random count."""
    rng = np.random.default_rng(seed * 1009 + K + L)
    idx = np.full((M, L), EMPTY_IDX, np.int32)
    val = np.zeros((M, L), np.int32)
    for r in range(M):
        nnz_r = int(rng.integers(0, min(L, K) + 1)) if nnz is None \
            else min(nnz[r % len(nnz)], L, K)
        idx[r, :nnz_r] = np.sort(rng.choice(K, nnz_r, replace=False))
        val[r, :nnz_r] = rng.integers(1, 40, nnz_r)
    W_hat = (rng.random((V, K)) * 0.01 + 1e-4).astype(np.float32)
    k1_w = np.argmax(W_hat, axis=1).astype(np.int32)
    a1_w = W_hat.max(axis=1)
    qp_w = ((50.0 / K) * (W_hat.sum(1) - a1_w)).astype(np.float32)
    doc = rng.integers(0, M, n).astype(np.int32)
    word = np.sort(rng.integers(0, V, n)).astype(np.int32)
    hit = idx[doc] == k1_w[word][:, None]
    b1 = np.where(hit, val[doc], 0).sum(1).astype(np.float32)
    u = rng.random(n).astype(np.float32)
    if near_one:
        u = np.minimum(1 - u * 2.0**-16, np.float32(1 - 2.0**-24)).astype(
            np.float32)
    packed = pack_pairs(torch.from_numpy(idx), torch.from_numpy(val)).numpy()
    return dict(idx=idx, val=val, packed=packed, W_hat=W_hat, k1_w=k1_w,
                a1_w=a1_w, qp_w=qp_w, doc=doc, word=word, b1=b1, u=u)


@pytest.mark.cuda
@pytest.mark.parametrize("K,L", [(37, 1), (37, 37), (1000, 1), (1000, 421),
                                 (1025, 37), (1025, 421)])
@pytest.mark.parametrize("near_one", [False, True])
def test_sparse_kernels_match_twin(card, K, L, near_one):
    """The main path's entry finishes the Q' branch: its draws (Q' ones
    included) agree with its twin's; the reference's entry on the rows it
    gathers flags the Q' tokens with -1 and is bitwise the same elsewhere;
    the tiled launch is bitwise the untiled one."""
    t = _sparse_tokens(K, L, 3, near_one=near_one)
    g = {k: torch.from_numpy(v).to(card) for k, v in t.items()
         if k not in ("idx", "val")}
    args = (g["u"], g["doc"], g["word"], g["packed"], g["W_hat"], g["k1_w"],
            g["a1_w"], g["qp_w"], g["b1"])
    alpha = 50.0 / K
    before = ss.sample_sparse_rows.launches
    got = [x.cpu().numpy() for x in ss.sample_sparse_rows(*args,
                                                          alpha=alpha)]
    torch.cuda.synchronize()
    assert ss.sample_sparse_rows.launches == before + 1
    want = [x.cpu().numpy() for x in ss.sample_sparse_rows_plain(
        *args, alpha=alpha)]
    nq = got[1]
    assert got[0].min() >= 0 and got[0].max() < K
    live = (t["val"] > 0) & (t["idx"] < K)
    assert np.all(np.isfinite(got[2]))
    assert_masses_close(got[2], want[2], 0.0)
    idx, val = t["idx"][t["doc"]], t["val"][t["doc"]]
    w_at = np.where(idx < K, np.take_along_axis(
        t["W_hat"][t["word"]], np.minimum(idx, K - 1), axis=1), 0)
    k1 = t["k1_w"][t["word"]]
    assert_sparse_draws_agree(
        t["u"], idx, val, w_at, k1, t["a1_w"][t["word"]], t["b1"],
        t["qp_w"][t["word"]], alpha, got[:2], want[:2],
        w_rows=t["W_hat"][t["word"]],
        max_mismatch_frac=1 if near_one else 0.001)
    # a drawn slot is live: its topic is in the token's D row, never K1
    # unless drawn from the M branch
    in_row = (idx == got[0][:, None]) & live[t["doc"]]
    s_branch = (~nq) & (got[0] != k1)
    assert in_row[s_branch].any(axis=1).all()
    # the reference's entry: the same body, the Q' branch left flagged
    ref = [x.cpu().numpy() for x in ss.sample_sparse(
        g["u"], g["packed"][g["doc"].long()].contiguous(),
        torch.from_numpy(w_at.astype(np.float32)).to(card), g["k1_w"][
            g["word"].long()].contiguous(), g["a1_w"][g["word"].long()]
        .contiguous(), g["b1"], g["qp_w"][g["word"].long()].contiguous(),
        alpha=alpha)]
    assert np.array_equal(ref[1], nq) and np.all(ref[0][nq] == -1)
    assert np.array_equal(ref[0][~nq], got[0][~nq])
    assert np.array_equal(ref[2], got[2])
    # the tiled kernel, tiles of 128 with a window that fits: same bits
    size = 128
    first = g["word"][::size].contiguous()
    before = ss.sample_sparse_tiled_rows.launches
    tiled = ss.sample_sparse_tiled_rows(
        g["u"], g["doc"], g["word"], first, size, *args[3:8], g["b1"],
        win_words=g["k1_w"].shape[0], alpha=alpha)
    torch.cuda.synchronize()
    assert ss.sample_sparse_tiled_rows.launches == before + 1
    for a, b in zip(tiled, got):
        assert np.array_equal(a.cpu().numpy(), b)


def _q_share_draws(t, share, seed):
    """Move a ``share`` of the tokens' draws into their Q' branch (x
    between M + S' and the total, from float64 masses)."""
    idx, val = t["idx"][t["doc"]], t["val"][t["doc"]]
    K = t["W_hat"].shape[1]
    v = t["word"]
    k1 = t["k1_w"][v]
    live = (val > 0) & (idx < K) & (idx != k1[:, None])
    w = t["W_hat"][v[:, None], np.minimum(idx, K - 1)].astype(np.float64)
    s = np.where(live, val * w, 0.0).sum(1)
    alpha = 50.0 / K
    m = t["a1_w"][v] * (t["b1"] + alpha)
    total = m + s + t["qp_w"][v]
    rng = np.random.default_rng(seed)
    pick = rng.random(len(s)) < share
    u_q = (m + s + rng.uniform(0.01, 0.99, len(s)) * t["qp_w"][v]) / total
    t["u"] = np.where(pick, u_q, t["u"]).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("K,L", [(37, 37), (1000, 130)])
@pytest.mark.parametrize("near_one", [False, True])
def test_finished_tail_draws_match_the_cpu_tail_draw(card, K, L, near_one):
    """``ops.sparse_tail_draw_rows`` on the card (one kernel launch, the
    Q' branch finished inside) against the same call on the CPU (the
    twin, ``ref.q_fallback_ref``), on the same inputs: rows whose live
    prefix ends just before, exactly on and just past a 32-slot step,
    empty and full rows, a third of the draws forced into the Q' branch,
    K1 the last topic for some words; tiled == untiled bitwise."""
    from repro_torch.kernels import ops
    t = _sparse_tokens(K, L, 11, near_one=near_one,
                       nnz=[0, 1, 31, 32, 33, 63, 64, 65, 96, 97, L])
    t["W_hat"][::7, K - 1] = 0.02                  # K1 = K-1
    t["k1_w"] = np.argmax(t["W_hat"], axis=1).astype(np.int32)
    t["a1_w"] = t["W_hat"].max(axis=1)
    t["qp_w"] = ((50.0 / K) * (t["W_hat"].sum(1) - t["a1_w"])).astype(
        np.float32)
    hit = t["idx"][t["doc"]] == t["k1_w"][t["word"]][:, None]
    t["b1"] = np.where(hit, t["val"][t["doc"]], 0).sum(1).astype(np.float32)
    if not near_one:
        _q_share_draws(t, 1 / 3, K)
    alpha = 50.0 / K
    keys = ("u", "doc", "word", "packed", "W_hat", "k1_w", "a1_w", "qp_w",
            "b1")
    cpu = [torch.from_numpy(t[k]) for k in keys]
    gpu = [x.to(card) for x in cpu]
    got = [x.cpu().numpy() for x in ops.sparse_tail_draw_rows(
        *gpu, alpha=alpha)]
    want = [x.numpy() for x in ops.sparse_tail_draw_rows(*cpu, alpha=alpha)]
    assert got[0].min() >= 0 and got[0].max() < K
    assert got[1].mean() > (0.25 if not near_one else 0.0)
    idx, val = t["idx"][t["doc"]], t["val"][t["doc"]]
    w_at = np.where(idx < K, np.take_along_axis(
        t["W_hat"][t["word"]], np.minimum(idx, K - 1), axis=1), 0)
    v = t["word"]
    assert_sparse_draws_agree(
        t["u"], idx, val, w_at, t["k1_w"][v], t["a1_w"][v], t["b1"],
        t["qp_w"][v], alpha, got[:2], want[:2], w_rows=t["W_hat"][v],
        max_mismatch_frac=1 if near_one else 0.001)
    size = 128
    first = gpu[2][::size].contiguous()
    tiled = ops.sparse_tail_draw_rows(*gpu, alpha=alpha,
                                      tiles=(first, size),
                                      win_words=t["k1_w"].shape[0])
    for a, b in zip(tiled, got):
        assert np.array_equal(a.cpu().numpy(), b)


@pytest.mark.cuda
def test_sample_sparse_past_the_old_slot_cap(card):
    """L = 58,113 slots (one past what a block's shared memory held) at
    K = 60,000, a few rows, empty and full: both entries against their
    twins, tiled == untiled."""
    K, L = 60_000, 58_113
    t = _sparse_tokens(K, L, 5, n=96, M=6, V=8,
                       nnz=[0, 33, 1000, L - 1, L, 31_000])
    _q_share_draws(t, 0.25, 3)
    g = {k: torch.from_numpy(v).to(card) for k, v in t.items()
         if k not in ("idx", "val")}
    args = (g["u"], g["doc"], g["word"], g["packed"], g["W_hat"], g["k1_w"],
            g["a1_w"], g["qp_w"], g["b1"])
    alpha = 50.0 / K
    got = [x.cpu().numpy() for x in ss.sample_sparse_rows(*args,
                                                          alpha=alpha)]
    want = [x.cpu().numpy() for x in ss.sample_sparse_rows_plain(
        *args, alpha=alpha)]
    assert got[1].any() and got[0].min() >= 0 and got[0].max() < K
    assert_masses_close(got[2], want[2], 0.0)
    idx, val = t["idx"][t["doc"]], t["val"][t["doc"]]
    w_at = np.where(idx < K, np.take_along_axis(
        t["W_hat"][t["word"]], np.minimum(idx, K - 1), axis=1),
        0).astype(np.float32)
    v = t["word"]
    assert_sparse_draws_agree(
        t["u"], idx, val, w_at, t["k1_w"][v], t["a1_w"][v], t["b1"],
        t["qp_w"][v], alpha, got[:2], want[:2], w_rows=t["W_hat"][v],
        max_mismatch_frac=0.05)
    pre = (g["u"], g["packed"][g["doc"].long()].contiguous(),
           torch.from_numpy(w_at).to(card),
           *(x[g["word"].long()].contiguous() for x in (g["k1_w"],
                                                        g["a1_w"])),
           g["b1"], g["qp_w"][g["word"].long()].contiguous())
    ref = [x.cpu().numpy() for x in ss.sample_sparse(*pre, alpha=alpha)]
    ref_twin = [x.cpu().numpy() for x in ss.sample_sparse(
        *(x.cpu() for x in pre), alpha=alpha)]
    assert np.array_equal(ref[1], got[1]) and np.all(ref[0][ref[1]] == -1)
    assert_masses_close(ref[2], ref_twin[2], 0.0)
    assert_sparse_draws_agree(
        t["u"], idx, val, w_at, t["k1_w"][v], t["a1_w"][v], t["b1"],
        t["qp_w"][v], alpha, ref[:2], ref_twin[:2], max_mismatch_frac=0.05)
    first = g["word"][::32].contiguous()
    tiled = ss.sample_sparse_tiled_rows(
        g["u"], g["doc"], g["word"], first, 32, *args[3:8], g["b1"],
        win_words=8, alpha=alpha)
    for a, b in zip(tiled, got):
        assert np.array_equal(a.cpu().numpy(), b)


@pytest.mark.cuda
def test_hybrid_paper_iteration_on_card_matches_cpu(card):
    """One iteration of the paper's configuration on the card and on the
    CPU with the same uniforms; counts on the card equal the rebuild."""
    corpus = relabel_by_frequency(planted_corpus(
        2, n_docs=300, n_words=2000, n_tokens=60_000, n_planted=40,
        words_per_topic=40))[0]
    cfg = LDAConfig(n_topics=64, tile_size=1024, format="hybrid",
                    tail_sampler="sparse", balance="tiles")
    cpu = LDATrainer(corpus, cfg, device="cpu")
    gpu = LDATrainer(corpus, cfg, device=card)
    state = cpu.init_state()
    u = torch.rand(cpu.n_padded_tokens,
                   generator=torch.Generator().manual_seed(1))
    p_cpu, p_gpu = cpu.fused_pipeline(), gpu.fused_pipeline()
    assert p_gpu.n_tail > 0
    launches = (ss.sample_sparse_rows.launches
                + ss.sample_sparse_tiled_rows.launches)
    hs_c, _, _ = p_cpu._iteration(p_cpu.from_lda_state(state), u,
                                  capacity=128)
    hs_g, _, _ = p_gpu._iteration(
        p_gpu.from_lda_state(gpu.state_from_topics(state.topics, 0)),
        u.to(card), capacity=128)
    assert ss.sample_sparse_rows.launches + \
        ss.sample_sparse_tiled_rows.launches > launches
    n_diff = int((hs_c.topics != hs_g.topics.cpu()).sum())
    assert n_diff <= 0.001 * hs_c.topics.numel() + 1
    st = p_gpu.to_lda_state(hs_g)
    D, W = esca.update_counts(gpu.word_ids, gpu.doc_ids, st.topics, gpu.mask,
                              n_docs=gpu.n_docs, n_words=gpu.n_words,
                              n_topics=64)
    assert torch.equal(st.D, D) and torch.equal(st.W, W)
    assert int(hs_g.overflow) == 0


def _warp_weights(rng, V, K, edge):
    w = rng.integers(0, 40, (V, K)).astype(np.float32)
    w[rng.random((V, K)) < 0.6] = 0.0
    w += 0.1
    if edge:           # all equal, one dominant weight, one tiny weight
        w[0] = 1.0
        w[1] = 1e-3
        w[1, K // 2] = 1e3
        w[2] = 1.0
        w[2, 0] = 1e-6
    return w


@pytest.mark.cuda
@pytest.mark.parametrize("V,K", [(64, 1), (300, 37), (500, 1000),
                                 (40, 1025), (7, 4096)])
def test_vose_build_matches_twin_bitwise(card, V, K):
    rng = np.random.default_rng(V + K)
    w = torch.from_numpy(_warp_weights(rng, V, K, edge=V > 2)).to(card)
    q, scaled = mh.proposal_weights(w)
    queues = mh.alias_queues(scaled)
    before = sw.vose_build.launches
    got = sw.vose_build(scaled, *queues)
    torch.cuda.synchronize()
    assert sw.vose_build.launches == before + 1
    want = mh.run_vose(scaled, *queues)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("V,K", [(40, 11_622), (40, 11_623), (2_200, 11_623),
                                 (40, 29_056), (40, 29_057),
                                 (2_200, 29_057)])
def test_vose_build_at_the_shared_memory_cap(card, V, K):
    """K = 29,056 is the widest row (8 bytes a slot) one block holds in
    shared memory; past it the kernel works in global memory (on more
    rows than it has warps: V = 2,200). K = 11,622 and 11,623 were the
    cap of the earlier five-array layout. Bitwise its twin either way."""
    rng = np.random.default_rng(V + K)
    w = torch.from_numpy(_warp_weights(rng, V, K, edge=True)).to(card)
    q, scaled = mh.proposal_weights(w)
    queues = mh.alias_queues(scaled)
    before = sw.vose_build.launches
    got = sw.vose_build(scaled, *queues)
    torch.cuda.synchronize()
    assert sw.vose_build.launches == before + 1
    want = mh.run_vose(scaled, *queues)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("V,K", [(64, 1), (300, 37), (500, 1000),
                                 (40, 1025), (7, 4096), (40, 29_056),
                                 (40, 29_057), (2_200, 29_057)])
def test_vose_tables_matches_twin_bitwise(card, V, K):
    """The main path's table build, queues built in the kernel, bitwise
    ``mh.run_vose(mh.alias_queues(...))`` on edge rows, on both sides of
    the shared-memory cap (K = 29,056)."""
    rng = np.random.default_rng(V + K + 1)
    w = torch.from_numpy(_warp_weights(rng, V, K, edge=V > 2)).to(card)
    q, scaled = mh.proposal_weights(w)
    before = sw.vose_tables.launches
    got = sw.vose_tables(scaled)
    torch.cuda.synchronize()
    assert sw.vose_tables.launches == before + 1
    want = mh.run_vose(scaled, *mh.alias_queues(scaled))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _warp_case(card, K, n, seed, *, near_one=False, V=500, M=300, C=2):
    rng = np.random.default_rng(seed)
    w_til = torch.from_numpy(_warp_weights(rng, V, K, edge=False)).to(card)
    tables = sw.alias_tables(w_til)
    w_hat = (w_til * 1.01).contiguous()
    D = torch.from_numpy(rng.integers(0, 20, (M, K)).astype(np.int32)).to(
        card)
    word = torch.from_numpy(np.sort(rng.integers(0, V, n)).astype(
        np.int32)).to(card)
    doc = torch.from_numpy(rng.integers(0, M, n).astype(np.int32)).to(card)
    s0 = torch.from_numpy(rng.integers(0, K, n).astype(np.int32)).to(card)
    t_doc = torch.from_numpy(rng.integers(0, K, (C, n)).astype(
        np.int32)).to(card)
    u = rng.random((C, 4, n)).astype(np.float32)
    if near_one:
        u = np.minimum(1 - u * 2.0**-16, np.float32(1 - 2.0**-24)).astype(
            np.float32)
    u = torch.from_numpy(u).to(card)
    return (s0, doc, word), (t_doc, u[:, :2].contiguous(),
                             u[:, 2:].contiguous(), D, w_hat, tables)


@pytest.mark.cuda
@pytest.mark.parametrize("K,n", [(1, 64), (37, 129), (1000, 4096),
                                 (1025, 129), (11_623, 257)])
@pytest.mark.parametrize("near_one", [False, True])
def test_warp_chain_matches_twin_bitwise(card, K, n, near_one):
    """Topics and accepted counts bitwise, u within 2^-16 of 1 included
    (⌊u·K⌋ may round up to K); the tiled launch bitwise the untiled one.
    The chain has no cap on K (K = 11,623: its tables from vose_build's
    global-memory route)."""
    ids, rest = _warp_case(card, K, n, K + n, near_one=near_one)
    before = sw.warp_chain_rows.launches
    got = sw.warp_chain_rows(*ids, *rest, alpha=50.0 / K)
    torch.cuda.synchronize()
    assert sw.warp_chain_rows.launches == before + 1
    want = sw.warp_chain_rows_plain(*ids, *rest, alpha=50.0 / K)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[0].min()) >= 0 and int(got[0].max()) < K
    word = ids[2]
    first = word[::128].contiguous()
    ends = torch.clamp(torch.arange(127, n + 127, 128, device=card),
                       max=n - 1)
    span = int((word[ends] - first).max()) + 1
    win = min(1 << max(span - 1, 0).bit_length(), 500)
    tiled = sw.warp_chain_tiled_rows(*ids, first, 128, *rest, win_words=win,
                                     alpha=50.0 / K)
    for a, b in zip(tiled, got):
        assert torch.equal(a, b)


def _tokens_case(card, K, n, seed, *, near_one=False, V=500, M=300, C=2):
    """Streams of 2n + 37 word-sorted tokens (a tenth padding, docs of one
    token, an empty doc), their doc index, tables and counts on the card;
    the chain runs on the n real tokens ``idx``."""
    rng = np.random.default_rng(seed)
    N = 2 * n + 37
    word = np.sort(rng.integers(0, V, N)).astype(np.int32)
    doc = rng.integers(0, M - 3, N).astype(np.int32)
    doc[[0, N - 1]] = M - 3, M - 2
    mask = (rng.random(N) < 0.9).astype(np.int32)
    mask[[0, N - 1]] = 1
    real = np.nonzero(mask)[0]
    idx = np.sort(rng.choice(real, size=min(n, real.size), replace=False))
    u = [rng.random((C, m, N)).astype(np.float32) for m in (3, 2, 2)]
    if near_one:
        u = [np.minimum(1 - a * 2.0**-16, np.float32(1 - 2.0**-24)).astype(
            np.float32) for a in u]
    dev = lambda a: torch.from_numpy(a).to(card)  # noqa: E731
    doc_t, mask_t = dev(doc), dev(mask)
    index = mh.build_doc_index(doc_t, mask_t, M)
    tables = sw.alias_tables(dev(_warp_weights(rng, V, K, edge=False)))
    D = dev(rng.integers(0, 20, (M, K)).astype(np.int32))
    topics = dev(rng.integers(0, K, N).astype(np.int32))
    streams = (topics, doc_t, dev(word), *map(dev, u), D,
               (tables.q * 1.01).contiguous(), tables, index)
    return dev(idx.astype(np.int32)), streams


def _tokens_out(streams):
    topics = streams[0]
    return topics.clone(), torch.zeros(topics.shape, dtype=torch.uint8,
                                       device=topics.device)


@pytest.mark.cuda
@pytest.mark.parametrize("K,n", [(1, 1), (1, 129), (1, 4096), (37, 1),
                                 (37, 129), (37, 4096), (1000, 1),
                                 (1000, 129), (1000, 4096), (1025, 1),
                                 (1025, 129), (1025, 4096), (11_623, 257)])
@pytest.mark.parametrize("near_one", [False, True])
def test_warp_chain_tokens_matches_twin_bitwise(card, K, n, near_one):
    """The main path's chain, doc proposals drawn inside and the streams
    read at ``idx``: topics and accepted counts bitwise its twin
    (``mh.doc_proposals`` then ``warp_chain_ref`` on the gathered
    streams), written at ``idx`` only; the tiled launch bitwise the
    untiled one."""
    idx, streams = _tokens_case(card, K, n, K + n + 1, near_one=near_one)
    alpha = 50.0 / K
    before = sw.warp_chain_tokens.launches
    got = sw.warp_chain_tokens(idx, *streams, alpha=alpha,
                               out=_tokens_out(streams))
    torch.cuda.synchronize()
    assert sw.warp_chain_tokens.launches == before + 1
    want = sw.warp_chain_tokens_plain(idx, *streams, alpha=alpha,
                                      out=_tokens_out(streams))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    rest = torch.ones(streams[0].shape, dtype=torch.bool, device=card)
    rest[idx.long()] = False
    assert torch.equal(got[0][rest], streams[0][rest])
    assert not bool(got[1][rest].any())
    word = streams[2][idx.long()]
    first = word[::128].contiguous()
    ends = torch.clamp(torch.arange(127, idx.shape[0] + 127, 128,
                                    device=card), max=idx.shape[0] - 1)
    span = int((word[ends] - first).max()) + 1
    win = min(1 << max(span - 1, 0).bit_length(), 500)
    before = sw.warp_chain_tokens_tiled.launches
    tiled = sw.warp_chain_tokens_tiled(idx, first, 128, *streams,
                                       win_words=win, alpha=alpha,
                                       out=_tokens_out(streams))
    assert sw.warp_chain_tokens_tiled.launches == before + 1
    for a, b in zip(tiled, got):
        assert torch.equal(a, b)


_BAD_TOPIC = """
import sys, torch
sys.path.insert(0, {src!r})
sys.path.insert(0, {tests!r})
from test_torch_cuda import _tokens_case, _tokens_out
from repro_torch.kernels import sample_warp as sw
idx, streams = _tokens_case(torch.device("cuda"), 37, 129, 5)
streams[0][int(idx[3])] = 37            # a topic outside [0, K)
sw.warp_chain_tokens(idx, *streams, alpha=0.5, out=_tokens_out(streams))
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("stopped:", e)
"""


@pytest.mark.cuda
def test_warp_chain_tokens_stops_on_a_topic_out_of_range(card):
    """The main-path chain checks the values it indexes with on the card:
    a topic outside [0, K) stops the launch (in a child process: the
    failure ends its CUDA context) instead of reading past a row."""
    here = Path(__file__).resolve().parent
    code = _BAD_TOPIC.format(src=str(here.parent / "src"), tests=str(here))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert "stopped:" in proc.stdout, proc.stdout + proc.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("n,R,K,rpt,sort", [
    (2000, 50, 64, 32, True), (5000, 300, 130, 64, True),
    (4096, 1000, 256, 16, True), (777, 10, 33, 8, True),
    (300_000, 20_000, 1000, 128, True), (100_000, 3000, 1000, 128, False)])
def test_histogram_matches_twin_bitwise(card, n, R, K, rpt, sort):
    """The rebuild against its twin, ``index_put_`` and ``bincount``; wide
    rows and an unsorted stream take the fallback scatter."""
    rng = np.random.default_rng(n + R)
    rows = rng.integers(0, R, n).astype(np.int32)
    if sort:
        rows = np.sort(rows)
    topics = rng.integers(0, K, n).astype(np.int32)
    w = (rng.random(n) < 0.9).astype(np.int32)
    rows, topics, w = (torch.from_numpy(a).to(card) for a in (rows, topics,
                                                              w))
    before = hist.histogram.launches
    got = hist.histogram(rows, topics, w, n_rows=R, n_topics=K,
                         rows_per_tile=rpt)
    torch.cuda.synchronize()
    assert hist.histogram.launches == before + 1
    from repro_torch.kernels.ref import histogram_ref
    assert torch.equal(got, histogram_ref(rows, topics, w, n_rows=R,
                                          n_topics=K))
    flat = (rows.long() * K + topics.long())[w > 0]
    assert torch.equal(got.flatten().long(),
                       torch.bincount(flat, minlength=R * K))
    pad = (-n) % 512
    r_p, t_p, w_p = (torch.nn.functional.pad(a, (0, pad))
                     for a in (rows, topics, w))
    bases = r_p[::512].contiguous()
    parts = hist.histogram_partials(r_p, t_p, w_p, bases, n_topics=K,
                                    rows_per_tile=rpt)
    from repro_torch.kernels.ref import histogram_partials_ref
    want = histogram_partials_ref(r_p, t_p, w_p, bases, n_topics=K,
                                  tile_t=512, rows_per_tile=rpt)
    for a, b in zip(parts, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,R,K,block_tokens", [
    (300_000, 20_000, 1000, 4096), (200_000, 40, 1000, 4096),
    (50_000, 3, 37, 1000), (100_000, 5000, 33, 64), (7, 10, 1, 2),
    (200_000, 2000, 1025, 4096), (200_000, 2000, 1030, 4096)])
def test_histogram_sorted_route_bitwise(card, n, R, K, block_tokens):
    """The sorted route with its plan: empty rows, weight-0 tokens, rows
    split over several blocks (zeroed, then folded with atomics), K not a
    multiple of 4 or 32, full blocks whose counters start at every
    16-byte phase (K = 1025, 1030); bitwise its twin, index_put_ and
    bincount."""
    from repro_torch.kernels.ref import histogram_ref, histogram_sorted_ref
    rng = np.random.default_rng(n + R + K)
    rows = np.sort(rng.integers(0, R, n)).astype(np.int32)
    topics = rng.integers(0, K, n).astype(np.int32)
    w = (rng.random(n) < 0.9).astype(np.int32)
    rows, topics, w = (torch.from_numpy(a).to(card) for a in (rows, topics,
                                                              w))
    plan = hist.plan_row_blocks(hist.row_offsets(rows, R), K,
                                block_tokens=block_tokens)
    before = hist.histogram_sorted.launches
    got = hist.histogram_sorted(topics, w, plan)
    torch.cuda.synchronize()
    assert hist.histogram_sorted.launches == before + 1
    assert torch.equal(got, histogram_sorted_ref(topics, w, plan))
    assert torch.equal(got, histogram_ref(rows, topics, w, n_rows=R,
                                          n_topics=K))
    flat = (rows.long() * K + topics.long())[w > 0]
    assert torch.equal(got.flatten().long(),
                       torch.bincount(flat, minlength=R * K))
    long_rows = torch.diff(plan.row_ptr) > block_tokens
    assert torch.equal(plan.split_rows, long_rows.nonzero().squeeze(1))
    assert plan.split_rows.numel() > 0 or R > 40 or n < R


@pytest.mark.cuda
@pytest.mark.parametrize("K", [58_100, 58_101])
def test_count_rebuild_at_the_sorted_route_cap(card, K):
    """The trainer's count rebuild at the widest K whose row of counters
    fits a sorted-route block (58,100) and one past it, where the
    any-order ``histogram`` kernel counts: bitwise ``esca.update_counts``
    either way, through a hand-written kernel either way."""
    corpus = planted_corpus(4, n_docs=40, n_words=60, n_tokens=6_000,
                            n_planted=8, words_per_topic=6)
    tr = LDATrainer(corpus, LDAConfig(n_topics=K, tile_size=512),
                    device=card)
    assert (tr.count_plans == (None, None)) == (K > 58_100)
    before = (hist.histogram_sorted.launches, hist.histogram.launches)
    st = tr.init_state()
    torch.cuda.synchronize()
    after = (hist.histogram_sorted.launches, hist.histogram.launches)
    route = 1 if K > 58_100 else 0
    assert after[route] == before[route] + 2
    assert after[1 - route] == before[1 - route]
    D, W = esca.update_counts(tr.word_ids, tr.doc_ids, st.topics, tr.mask,
                              n_docs=tr.n_docs, n_words=tr.n_words,
                              n_topics=K)
    assert torch.equal(st.D, D) and torch.equal(st.W, W)


@pytest.mark.cuda
@pytest.mark.parametrize("over", [dict(), dict(format="hybrid",
                                               balance="tiles")])
def test_warp_fused_step_equals_stepwise_on_card(card, over):
    """On the card, with the kernels: a fused warp step equals the
    stepwise oracle bitwise, and the counts equal the rebuild."""
    corpus = relabel_by_frequency(planted_corpus(
        3, n_docs=300, n_words=2000, n_tokens=60_000, n_planted=40,
        words_per_topic=40))[0]
    cfg = LDAConfig(n_topics=64, tile_size=1024, sampler="warp", **over)
    tr = LDATrainer(corpus, cfg, device=card)
    pipe = tr.fused_pipeline()
    state = tr.init_state()
    fs = pipe.from_lda_state(state)
    chain = (sw.warp_chain_tokens, sw.warp_chain_tokens_tiled)
    launches = sum(f.launches for f in chain)
    for _ in range(2):
        fs, _, _ = pipe.step(fs)
        state, stats = tr.step(state)
    assert sum(f.launches for f in chain) > launches
    st = pipe.to_lda_state(fs)
    assert torch.equal(st.topics, state.topics)
    assert torch.equal(st.D, state.D) and torch.equal(st.W, state.W)
    assert 0.0 < stats["frac_accepted"] < 1.0


@pytest.mark.cuda
def test_warp_chain_tokens_saturates_like_its_twin(card):
    """At mh_cycles = 128 (256 proposals a token), every proposal of every
    other token accepted: the main-path chain's u8 accepted counts are
    bitwise its twin's, min(count, 255), while the reference-signature
    entry returns the int32 count (256 where all were accepted)."""
    C = 128
    idx, streams = _tokens_case(card, 37, 129, 11, C=C)
    streams[5][:, :, ::2] = 0.0                  # u_acc: accept all
    got = sw.warp_chain_tokens(idx, *streams, alpha=0.5,
                               out=_tokens_out(streams))
    want = sw.warp_chain_tokens_plain(idx, *streams, alpha=0.5,
                                      out=_tokens_out(streams))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    topics, doc, word, u_doc, u_word, u_acc, D, W_hat, tables, index = \
        streams
    i = idx.long()
    t_doc = mh.doc_proposals(u_doc[:, :, i], topics, doc[i], index,
                             n_topics=37, alpha=0.5)
    s, n_acc = sw.warp_chain_rows(
        topics[i], doc[i], word[i], t_doc, u_word[:, :, i].contiguous(),
        u_acc[:, :, i].contiguous(), D, W_hat, tables, alpha=0.5)
    assert n_acc.dtype == torch.int32 and int(n_acc.max()) == 2 * C
    assert torch.equal(got[0][i], s)
    assert torch.equal(got[1][i], torch.clamp(n_acc, max=255).to(
        torch.uint8))


@pytest.mark.cuda
def test_fold_in_sweep_on_card_matches_twin(card):
    """One fold-in sweep of ``FrozenLDAModel`` on the card against the
    same sweep on the CPU (the twins), from the same topics and uniforms:
    topics equal except at CDF boundaries (the main path's rule), and the
    batch D rebuilt by the ``histogram`` kernel bitwise its twin's."""
    from repro_torch.lda import FrozenLDAModel
    rng = np.random.default_rng(21)
    V, K = 3000, 1000
    W = (rng.integers(0, 40, (V, K)) * (rng.random((V, K)) < 0.05)
         ).astype(np.int32)
    docs = [rng.integers(0, V, rng.integers(1, 300)) for _ in range(100)]
    gpu = FrozenLDAModel(W=W, alpha=0.05, beta=0.01, device=card)
    cpu = FrozenLDAModel(W=W, alpha=0.05, beta=0.01, device="cpu")
    assert torch.equal(gpu._w_hat.cpu(), cpu._w_hat)
    bg, bc = gpu.prepare_batch(docs), cpu.prepare_batch(docs)
    n = bg.word_ids.shape[0]
    topics = torch.from_numpy(rng.integers(0, K, n).astype(np.int32))
    u = torch.from_numpy(rng.random(n).astype(np.float32))
    plan = gpu.count_plan(bg)
    D = gpu.batch_counts(bg, topics.to(card), plan)
    launches = (sf.sample_fused_rows.launches,
                hist.histogram_sorted.launches)
    got, D_got, _ = gpu.sweep(bg, u.to(card), topics.to(card), D, plan)
    torch.cuda.synchronize()
    assert (sf.sample_fused_rows.launches,
            hist.histogram_sorted.launches) == (launches[0] + 1,
                                                launches[1] + 1)
    want, D_want, _ = cpu.sweep(bc, u, topics, D.cpu(), cpu.count_plan(bc))
    real = bc.mask > 0
    d_rows = D.cpu()[bc.doc_ids.long()][real].numpy()
    w_rows = cpu._w_hat[bc.word_ids.long()][real].numpy()
    assert_topics_agree(u[real].numpy(), d_rows, w_rows, 0.05,
                        got.cpu()[real].numpy(), want[real].numpy())
    assert torch.equal(D_got, hist.histogram_sorted(got, bg.mask, plan))
    assert torch.equal(D_got.cpu(), hist.histogram_sorted(
        got.cpu(), bc.mask, cpu.count_plan(bc)))


@pytest.mark.cuda
@pytest.mark.parametrize("over", [
    dict(), dict(format="hybrid", tail_sampler="sparse", balance="tiles")],
    ids=["dense", "paper"])
def test_streamed_and_disk_equal_resident_on_card(card, over, tmp_path):
    """On the card, with the kernels and the side-stream prefetch:
    streamed == disk == resident, bitwise (topics, D, W, every LLPT), and
    the shard-by-shard count folds launch the any-order ``histogram``."""
    from repro_torch.lda import LDAEngine
    from repro_torch.lda.corpus import shard_stream
    corpus = relabel_by_frequency(planted_corpus(
        5, n_docs=400, n_words=3000, n_tokens=120_000, n_planted=40,
        words_per_topic=40))[0]
    kw = dict(n_topics=64, tile_size=1024, fused=True, eval_every=1, **over)
    res = LDAEngine(corpus, LDAConfig(**kw))
    h_res = res.fit(3)
    store = shard_stream(res.corpus, 5, multiple=1024).to_store(
        str(tmp_path / "store"))
    folds = hist.histogram.launches
    engines = [
        LDAEngine(corpus, LDAConfig(corpus_residency="streamed",
                                    stream_shards=5, **kw)),
        LDAEngine(None, LDAConfig(corpus_residency="disk",
                                  corpus_path=store.path, **kw))]
    n = res.trainer.n_padded_tokens
    for eng in engines:
        assert eng.device.type == "cuda"
        assert eng.fit(3)["llpt"] == h_res["llpt"]
        pipe = eng.trainer.fused_pipeline()
        st = pipe.to_lda_state(pipe.from_lda_state(eng.state))
        assert torch.equal(st.topics[:n], res.state.topics[:n])
        assert torch.equal(st.D, res.state.D)
        assert torch.equal(st.W, res.state.W)
        assert st.D.is_cuda and pipe.last_epoch_io["h2d_bytes"] > 0
        assert eng.score() == res.score()
    assert hist.histogram.launches >= folds + 2 * 5


@pytest.mark.cuda
def test_mid_epoch_resume_on_card(card, tmp_path):
    """A streamed engine saved mid-epoch resumes in a fresh engine and
    both finish the epoch bitwise, on the card."""
    from repro_torch.lda import LDAEngine
    corpus = relabel_by_frequency(planted_corpus(
        6, n_docs=300, n_words=2000, n_tokens=80_000, n_planted=40,
        words_per_topic=40))[0]
    cfg = LDAConfig(n_topics=64, tile_size=1024, fused=True,
                    corpus_residency="streamed", stream_shards=4)
    eng = LDAEngine(corpus, cfg, checkpoint_dir=str(tmp_path))
    eng.fit(1)
    pipe = eng.trainer.fused_pipeline()
    eng._state = pipe.run_shards(pipe.from_lda_state(eng.state), 3)
    eng.save()
    fresh = LDAEngine(corpus, cfg, checkpoint_dir=str(tmp_path)).resume()
    assert fresh.state.cursor == 3
    assert eng.fit(1)["llpt"] == fresh.fit(1)["llpt"]
    for name in ("topics", "D", "W"):
        assert torch.equal(getattr(eng.state, name),
                           getattr(fresh.state, name))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1000, 1001, 8192, 8193, 30_000])
@pytest.mark.parametrize("lo,rows", [(0, 2), (3, 5), (17, 64), (1, 300)])
def test_row_sum_of_a_window_equals_the_full_rows_on_card(card, K, lo,
                                                          rows):
    """``row_sum`` of a window of rows, in its own tensor, gives the full
    matrix's sums of those rows bit for bit, whatever the row count, the
    width or the rows' alignment (what ΣŴ and Q' of a paged W window rest
    on)."""
    from repro_torch.core.three_branch import row_sum
    g = torch.Generator(device="cuda").manual_seed(K + lo)
    x = torch.rand((1200, K), generator=g, device="cuda") ** 8
    full = row_sum(x)
    win = row_sum(x[lo:lo + rows].clone())
    assert torch.equal(win, full[lo:lo + rows])
    torch.testing.assert_close(full, x.sum(dim=-1, dtype=torch.float64)
                               .float(), rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("over", [
    dict(), dict(format="hybrid", tail_sampler="sparse", balance="tiles")],
    ids=["dense", "paper"])
def test_disk_equals_resident_at_a_wide_k_on_card(card, over, tmp_path):
    """K = 8192 with 32 shards of narrow W pages (under a quarter of the
    1,000 rows): disk == resident bitwise, topics, D, W and every LLPT."""
    from repro_torch.lda import LDAEngine
    from repro_torch.lda.corpus import shard_stream
    corpus = relabel_by_frequency(planted_corpus(
        7, n_docs=200, n_words=1000, n_tokens=60_000, n_planted=40,
        words_per_topic=40))[0]
    kw = dict(n_topics=8192, tile_size=1024, fused=True, eval_every=1,
              **over)
    res = LDAEngine(corpus, LDAConfig(**kw))
    h_res = res.fit(2)
    store = shard_stream(res.corpus, 32, multiple=1024).to_store(
        str(tmp_path / "store"))
    eng = LDAEngine(None, LDAConfig(corpus_residency="disk",
                                    corpus_path=store.path, **kw))
    pipe = eng.trainer.fused_pipeline()
    assert pipe.page_rows < 1000 // 4
    assert eng.fit(2)["llpt"] == h_res["llpt"]
    st = pipe.to_lda_state(pipe.from_lda_state(eng.state))
    n = res.trainer.n_padded_tokens
    assert torch.equal(st.topics[:n], res.state.topics[:n])
    assert torch.equal(st.D, res.state.D)
    assert torch.equal(st.W, res.state.W)


# -- the failure model on the card ----------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("over", [
    dict(), dict(format="hybrid", tail_sampler="sparse", balance="tiles",
                 selfcheck=True)], ids=["dense", "paper_selfcheck"])
def test_supervised_kill_on_card_is_bitwise(card, over, tmp_path):
    """Killed at step 5 with checkpoints every 2: one restart resumed from
    4, and the result is bitwise the uninterrupted run's, on the card."""
    from repro_torch.lda import LDAEngine
    from repro_torch.runtime import chaos
    from repro_torch.runtime.fault import SupervisePolicy
    corpus = relabel_by_frequency(planted_corpus(
        8, n_docs=300, n_words=2000, n_tokens=80_000, n_planted=40,
        words_per_topic=40))[0]
    cfg = LDAConfig(n_topics=64, tile_size=1024, fused=True, eval_every=1,
                    **over)
    ref = LDAEngine(corpus, cfg)
    h_ref = ref.fit(7)
    eng = LDAEngine(corpus, cfg, checkpoint_dir=str(tmp_path))
    with chaos.active(chaos.FaultPlan(raise_at_steps=(5,))):
        h = eng.fit(7, supervise=SupervisePolicy(checkpoint_every=2,
                                                 backoff_base=0.0))
    rep = h["restart_report"]
    assert rep.restarts == 1 and rep.resumed_from == [4]
    # the history holds the attempt that finished, as in the reference
    assert h["iteration"] == [5, 6, 7] and h["llpt"] == h_ref["llpt"][4:]
    assert eng.device.type == "cuda"
    for name in ("topics", "D", "W"):
        assert torch.equal(getattr(eng.state, name), getattr(ref.state, name))


@pytest.mark.cuda
def test_check_alias_tables_on_vose_tables_at_k_1000(card):
    """The main path's table build passes the alias check at K = 1000; one
    keep-probability past 1, or one redirect at K, trips it."""
    from repro_torch.lda import invariants
    g = torch.Generator(device="cuda").manual_seed(3)
    w = torch.rand((2048, 1000), generator=g, device="cuda") ** 4 + 1e-6
    before = sw.vose_tables.launches
    t = sw.alias_tables(w)
    assert sw.vose_tables.launches == before + 1
    invariants.check_alias_tables(t.prob, t.alias, t.q, where="card")
    for field, idx, value in (("prob", (7, 11), 1.5),
                              ("alias", (9, 3), 1000)):
        bad = getattr(t, field).clone()
        bad[idx] = value
        tables = t._replace(**{field: bad})
        with pytest.raises(invariants.InvariantViolation) as info:
            invariants.check_alias_tables(*tables, where="card")
        assert info.value.invariant == "alias_tables_valid"


@pytest.mark.cuda
def test_a_real_cuda_oom_is_classified_as_oom(card):
    from repro_torch.runtime.fault import is_oom_error
    total = torch.cuda.get_device_properties(card).total_memory
    with pytest.raises(torch.OutOfMemoryError) as info:
        torch.empty(2 * total, dtype=torch.uint8, device=card)
    assert is_oom_error(info.value)
    assert "out of memory" in str(info.value)
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("corrupt", [None, "D", "W", "colsum"])
def test_dense_count_check_on_card_equals_cpu(card, corrupt):
    """The on-card reductions give the CPU's verdict and message."""
    from repro_torch.lda import invariants
    rng = np.random.default_rng(4)
    D = rng.integers(0, 30, (3000, 1000)).astype(np.int32)
    W = rng.integers(0, 20, (2000, 1000)).astype(np.int32)
    n = int(D.sum())
    W[1, 0] += n - int(W.sum())          # sum(W) == sum(D) == n
    cs = W.sum(axis=0).astype(np.int32)
    if corrupt == "D":
        D[5, 6] -= 1
    elif corrupt == "W":
        W[7, 8] = -1
    elif corrupt == "colsum":
        cs[9] += 1

    def verdict(dev):
        try:
            invariants.check_dense_counts(
                *(torch.from_numpy(a).to(dev) for a in (D, W, cs)),
                n_tokens=n, where="card")
        except invariants.InvariantViolation as e:
            return e.invariant, e.detail
        return None

    assert verdict(card) == verdict("cpu")
    assert (verdict(card) is None) == (corrupt is None)


# -- the distributed trainer on the card --------------------------------------

def _single_on_card(card):
    from repro_torch.lda.api import LDAEngine
    eng = LDAEngine(td.make_corpus(), td.make_config(eval_every=1),
                    device=card, backend="single")
    return td.summary(eng, eng.fit(4))


def _assert_same_run(got, want):
    for key in ("topics", "D", "W"):
        assert np.array_equal(got[key], want[key]), key
    assert got["llpt"] == want["llpt"]


@pytest.mark.cuda
def test_world1_nccl_dense_is_bitwise_single_on_card(card, tmp_path):
    """A one-rank NCCL group, (1, 1) mesh: the distributed engine on the
    card is bitwise the single-device engine on the card; the mesh's
    collectives on card tensors are exact."""
    import torch.distributed as dist
    from repro_torch.lda.api import LDAEngine
    want = _single_on_card(card)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        eng = LDAEngine(td.make_corpus(), td.make_config(eval_every=1),
                        backend="distributed", pad_multiple=td.PAD)
        assert eng.trainer.mesh.backend == "nccl"
        assert eng.device.type == "cuda"
        got = td.summary(eng, eng.fit(4))
        x = torch.arange(12, dtype=torch.int32, device=card).view(3, 4)
        assert torch.equal(eng.trainer.mesh.psum(x.clone(), "data"), x)
        assert torch.equal(eng.trainer.mesh.all_gather(x, "model"), x[None])
    finally:
        dist.destroy_process_group()
    _assert_same_run(got, want)


@pytest.mark.cuda
def test_two_gloo_ranks_on_card_are_bitwise_single(card, tmp_path):
    """Two processes sharing the card over gloo: collectives on CUDA
    tensors equal their sums on the host, and a (2, 1) dense run is
    bitwise the single-device run on the card."""
    ranks = td.run_world(2, "card_world", (), tmp_path)
    want = _single_on_card(card)
    xi = sum(r["xi"].astype(np.int64) for r in ranks).astype(np.int32)
    xf = ranks[0]["xf"] + ranks[1]["xf"]           # two terms: exact order
    for r in ranks:
        assert r["on_card"]
        assert np.array_equal(r["psum_i"], xi)
        assert np.array_equal(r["psum_f"], xf)
        assert np.array_equal(r["gather"],
                              np.stack([ranks[0]["xi"], ranks[1]["xi"]]))
        _assert_same_run(r["dense"], want)


@pytest.mark.cuda
@pytest.mark.parametrize("over", [{}, dict(format="hybrid",
                                           tail_sampler="sparse"),
                                  dict(balance="tiles")])
def test_world1_nccl_streamed_equals_resident_on_card(card, over, tmp_path):
    """A one-rank NCCL group: the streamed distributed engine (3
    sub-shards, each staged on the side stream) is bitwise the resident
    distributed engine on the card: topics, D, W, every LLPT."""
    import torch.distributed as dist
    from repro_torch.lda.api import LDAEngine
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        runs = []
        for kw in ({}, dict(corpus_residency="streamed", stream_shards=3)):
            eng = LDAEngine(td.make_corpus(),
                            td.make_config(eval_every=1, **over, **kw),
                            backend="distributed", pad_multiple=td.PAD)
            runs.append(td.summary(eng, eng.fit(4)))
            assert eng.trainer.residency == ("streamed" if kw else "full")
    finally:
        dist.destroy_process_group()
    _assert_same_run(runs[1], runs[0])


@pytest.mark.cuda
@pytest.mark.parametrize("over", [{}, dict(format="hybrid",
                                           tail_sampler="sparse")])
def test_parameter_server_equals_single_on_card(card, over):
    """Four parameter-server workers on the card (pages of W pulled
    through pinned windows) are bitwise the single-device engine on the
    card, dense and hybrid with the sparse tail."""
    from repro_torch.lda.api import LDAEngine
    from repro_torch.lda.model import DistConfig
    cfg = td.make_config(eval_every=1, **over)
    single = LDAEngine(td.make_corpus(), cfg, device=card, backend="single")
    want = td.summary(single, single.fit(4))
    ps = LDAEngine(td.make_corpus(), dataclasses.replace(cfg, dist=DistConfig(
        w_sync="ps", mesh_shape=(("data", 4), ("model", 1)))),
        pad_multiple=td.PAD)
    assert ps.device.type == "cuda" and ps._backend.is_ps
    hist = ps.fit(4)
    D, W = ps.trainer.gather_global(ps.state)
    got = {"topics": ps.host_payload()["topics_global"],
           "D": D.cpu().numpy(), "W": W.cpu().numpy(),
           "llpt": hist["llpt"]}
    _assert_same_run(got, want)


@pytest.mark.cuda
def test_two_gloo_ranks_on_card_restart_together(card, tmp_path):
    """A step fault on rank 1 alone: both ranks agree on it, restart once
    from the same checkpoint and end bitwise the single run on the card,
    every LLPT evaluated on the ranks' own rows."""
    ranks = td.run_world(2, "card_supervise", (str(tmp_path / "ck"),),
                         tmp_path)
    want = _single_on_card(card)
    for r in ranks:
        by_it = dict(zip(want["iterations"], want["llpt"]))
        for key in ("topics", "D", "W"):
            assert np.array_equal(r[key], want[key]), key
        assert all(by_it[i] == v for i, v in zip(r["iterations"],
                                                 r["llpt"]))
        assert r["report"] == ranks[0]["report"]
    restarts, resumed, faults = ranks[0]["report"]
    assert restarts == 1 and resumed == [2]
    assert faults == ["RankFault: fault agreed by every rank: rank 1: "
                      "InjectedFault (restartable)"]


@pytest.mark.cuda
def test_serving_cache_is_the_full_tables_on_card(card):
    """On the card (the head's alias tables through ``vose_tables``, the
    sweeps through ``sample_fused`` and ``histogram``): a cached replica
    is bitwise a full-table one, θ and LLPT; the service answers."""
    from repro_torch.lda.api import LDAEngine
    from repro_torch.serve import LDAService, Replica, ServeConfig
    from repro_torch.serve.replicas import pack_docs
    corpus = planted_corpus(0, n_docs=400, n_words=2000, n_tokens=80_000,
                            n_planted=32)
    eng = LDAEngine(corpus, LDAConfig(n_topics=64, fused=True))
    eng.fit(3)
    model = eng.export()
    docs = corpus.documents()[:96]
    packed = pack_docs(docs, n_words=model.n_words, word_map=model.word_map,
                       doc_buckets=(128,), token_floor=256)
    sf.sample_fused_rows.launches = 0
    full = Replica(0, model, hot_words=model.n_words)
    a = full.infer_packed(packed, 3, n_sweeps=3, seq=1)
    assert sf.sample_fused_rows.launches > 0
    for hot in (1, 100, 1500):
        b = Replica(1, model, hot_words=hot).infer_packed(packed, 3,
                                                          n_sweeps=3, seq=1)
        assert np.array_equal(a[0], b[0]) and a[1] == b[1]
        assert b[2]["cache_misses"] > 0
    with LDAService(model, ServeConfig(n_replicas=2, hot_coverage=0.9,
                                       max_batch=32, buckets=(8, 16, 32))) \
            as svc:
        thetas = [f.result(timeout=120) for f in
                  [svc.submit(d) for d in docs]]
    assert all(t.shape == (64,) and np.isfinite(t).all() for t in thetas)
