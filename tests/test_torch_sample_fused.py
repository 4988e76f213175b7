"""The sample_fused twin against the Pallas kernel (interpret mode) and the
reference oracle, plus the wrapper's contract. The CUDA kernel itself is
held to the twin on the card in ``test_torch_cuda.py``.

Tolerances: ``_torch_parity`` (masses rtol 1e-5, S' with an absolute
term for its cancellation; topics equal except rare CDF-boundary tokens).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.sample_fused import sample_fused as pallas_sample_fused
from repro_torch.kernels import ref, sample_fused as sf
from repro_torch.kernels.ops import sample_tokens
from _torch_parity import (assert_masses_close, assert_topics_agree,
                           row_total)


def _rows(n, K, seed, ties=False):
    rng = np.random.default_rng(n * 1000 + K + seed)
    d = (rng.integers(0, 50, (n, K)) * (rng.random((n, K)) < 0.1)
         ).astype(np.int32)
    w = (rng.random((n, K)) * 0.01).astype(np.float32)
    if ties:                       # several maxima per row, and flat rows
        w[::2, K // 3] = w[::2, K - 1] = w[::2, 0] = 0.02
        w[1::5] = 0.003
    u = rng.random(n).astype(np.float32)
    return u, d, w


def _check_against(u, d, w, alpha, got, want):
    total = row_total(d, w, alpha)
    assert_masses_close(got[1], want[1], total)
    assert_masses_close(got[2], want[2], total, cancels=True)
    assert_masses_close(got[3], want[3], total)
    return assert_topics_agree(u, d, w, alpha, got[0], want[0])


@pytest.mark.parametrize("n,K", [(1, 3), (37, 1), (64, 37), (129, 130),
                                 (257, 1000), (16, 1025)])
@pytest.mark.parametrize("ties", [False, True])
def test_twin_matches_pallas_and_oracle(n, K, ties):
    u, d, w = _rows(n, K, 0, ties)
    alpha = 50.0 / K
    got = [x.numpy() for x in sf.sample_fused(
        torch.from_numpy(u), torch.from_numpy(d), torch.from_numpy(w),
        alpha=alpha)]
    pallas = [np.asarray(x) for x in pallas_sample_fused(
        jnp.asarray(u), jnp.asarray(d), jnp.asarray(w), alpha=alpha,
        interpret=True)]
    oracle = [np.asarray(x) for x in jref.sample_fused_ref(
        jnp.asarray(u), jnp.asarray(d), jnp.asarray(w), alpha=alpha)]
    _check_against(u, d, w, alpha, got, pallas)
    _check_against(u, d, w, alpha, got, oracle)
    # K1 is the FIRST maximal topic, as the Pallas kernel's strict `>`
    k1 = np.argmax(w, axis=1)
    in_m = u * (got[1] + got[2] + got[3]) < got[1]
    assert np.array_equal(got[0][in_m], k1[in_m])
    assert got[0].dtype == np.int32 and np.all(got[0] < K)


@pytest.mark.parametrize("K", [37, 1025])
def test_twin_matches_pallas_for_draws_near_one(K):
    """u just below 1: the draw sits at the end of the CDF, where the
    undershoot clamp and the last live topic meet."""
    u, d, w = _rows(200, K, 6)
    u = np.minimum(1 - u * 2.0**-16, np.float32(1 - 2.0**-24)).astype(
        np.float32)
    alpha = 50.0 / K
    got = [x.numpy() for x in sf.sample_fused(
        torch.from_numpy(u), torch.from_numpy(d), torch.from_numpy(w),
        alpha=alpha)]
    pallas = [np.asarray(x) for x in pallas_sample_fused(
        jnp.asarray(u), jnp.asarray(d), jnp.asarray(w), alpha=alpha,
        interpret=True)]
    _check_against(u, d, w, alpha, got, pallas)
    assert got[0].max() < K


def test_gathering_entry_equals_pregathered_rows():
    rng = np.random.default_rng(3)
    M, V, K, n = 30, 50, 40, 300
    D = (rng.integers(0, 9, (M, K)) * (rng.random((M, K)) < 0.3)
         ).astype(np.int32)
    W_hat = (rng.random((V, K)) * 0.01).astype(np.float32)
    doc = rng.integers(0, M, n).astype(np.int32)
    word = rng.integers(0, V, n).astype(np.int32)
    u = rng.random(n).astype(np.float32)
    T = torch.from_numpy
    a = sf.sample_fused_rows(T(u), T(doc), T(word), T(D), T(W_hat), alpha=0.5)
    b = sf.sample_fused(T(u), T(D[doc]), T(W_hat[word]), alpha=0.5)
    c = ref.sample_fused_ref(T(u), T(D[doc]), T(W_hat[word]), alpha=0.5)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_wrapper_contract_on_cpu():
    u, d, w = (torch.from_numpy(x) for x in _rows(8, 5, 1))
    before = sf.sample_fused_rows.launches
    sf.sample_fused(u, d, w, alpha=1.0)
    assert sf.sample_fused_rows.launches == before   # the twin is no launch
    with pytest.raises(ValueError, match="int32"):
        sf.sample_fused(u, d.long(), w, alpha=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        sf.sample_fused(u, d.t().contiguous().t(), w, alpha=1.0)
    with pytest.raises(ValueError, match="outside"):
        ids = torch.full((8,), 8, dtype=torch.int32)
        sf.sample_fused_rows(u, ids, ids, d, w, alpha=1.0)


def test_sample_tokens_stats_match_reference_definitions():
    u, d, w = _rows(200, 24, 2)
    T = torch.from_numpy
    ids = torch.arange(200, dtype=torch.int32)
    old = torch.zeros(200, dtype=torch.int32)
    topics, st = sample_tokens(T(u), ids, ids, old, T(d), T(w), alpha=0.7)
    t_ref, m, s, q = ref.sample_fused_ref(T(u), T(d), T(w), alpha=0.7)
    assert torch.equal(topics, t_ref)
    x = T(u) * (m + s + q)
    assert float(st.frac_m_final) == float((x < m).float().mean())
    assert float(st.frac_q_branch) == float(((x >= m) & (x >= m + s))
                                            .float().mean())

