"""Tests that need an NVIDIA card: the CUDA kernels against their
plain-PyTorch twins, on the same card tensors, and each tiled kernel
bitwise against its untiled one. The warp kernels (``vose_build``,
``warp_chain``) and ``histogram`` are held to their twins bitwise.

They skip without a card. This file imports neither JAX nor the
reference package, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

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
        args[0], ids, ids, args[1], args[2], alpha=alpha)]
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
        args[0], ids, ids, args[1], args[2], alpha=alpha)]
    assert_topics_agree(u, d, w, alpha, got[0], want[0], max_mismatch_frac=1)


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(card):
    u, d, w = (torch.from_numpy(x).to(card) for x in _rows(8, 4, 0))
    with pytest.raises(ValueError, match="outside"):
        ids = torch.full((8,), 9, dtype=torch.int32, device=card)
        sf.sample_fused_rows(u, ids, ids, d, w, alpha=1.0)
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
@pytest.mark.parametrize("K", [37, 1000, 1025])
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
    before = sf.sample_fused_tiled_rows.launches
    tiled = sf.sample_fused_tiled_rows(u, doc, word_t, first, size, D, W_hat,
                                       win_words=win, alpha=50.0 / K)
    untiled = sf.sample_fused_rows(u, doc, word_t, D, W_hat, alpha=50.0 / K)
    torch.cuda.synchronize()
    assert sf.sample_fused_tiled_rows.launches == before + 1
    for a, b in zip(tiled, untiled):
        assert torch.equal(a, b)


def _sparse_tokens(K, L, seed, n=4096, M=300, V=500, near_one=False):
    """Packed sorted D rows (empty slots; K1 in the row or not), Ŵ, word
    stats, and n tokens, on the CPU."""
    rng = np.random.default_rng(seed * 1009 + K + L)
    idx = np.full((M, L), EMPTY_IDX, np.int32)
    val = np.zeros((M, L), np.int32)
    for r in range(M):
        nnz = int(rng.integers(0, min(L, K) + 1))
        idx[r, :nnz] = np.sort(rng.choice(K, nnz, replace=False))
        val[r, :nnz] = rng.integers(1, 40, nnz)
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
    assert np.all(got[0][nq] == -1)
    assert got[0][~nq].min(initial=0) >= 0 and got[0].max() < K
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
        max_mismatch_frac=1 if near_one else 0.001)
    # a drawn slot is live: its topic is in the token's D row, never K1
    # unless drawn from the M branch
    in_row = (idx == got[0][:, None]) & live[t["doc"]]
    s_branch = (~nq) & (got[0] != k1)
    assert in_row[s_branch].any(axis=1).all()
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
                                 (1025, 129)])
@pytest.mark.parametrize("near_one", [False, True])
def test_warp_chain_matches_twin_bitwise(card, K, n, near_one):
    """Topics and accepted counts bitwise, u within 2^-16 of 1 included
    (⌊u·K⌋ may round up to K); the tiled launch bitwise the untiled one."""
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
    launches = sw.warp_chain_rows.launches + sw.warp_chain_tiled_rows.launches
    for _ in range(2):
        fs, _, _ = pipe.step(fs)
        state, stats = tr.step(state)
    assert sw.warp_chain_rows.launches + sw.warp_chain_tiled_rows.launches \
        > launches
    st = pipe.to_lda_state(fs)
    assert torch.equal(st.topics, state.topics)
    assert torch.equal(st.D, state.D) and torch.equal(st.W, state.W)
    assert 0.0 < stats["frac_accepted"] < 1.0
