"""Tests that need an NVIDIA card: the CUDA kernels against their
plain-PyTorch twins, on the same card tensors.

They skip without a card. This file imports neither JAX nor the
reference package, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import sample_fused as sf
from repro_torch.lda import LDAConfig, LDATrainer
from repro_torch.lda.corpus import planted_corpus
from _torch_parity import (assert_masses_close, assert_topics_agree,
                           row_total)


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
