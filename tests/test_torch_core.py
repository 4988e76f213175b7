"""repro_torch core math against the reference, on seeded NumPy inputs.

Integer stages must be equal; float stages whose arithmetic is elementwise
(Ŵ, the skip test on identical word stats) must be bitwise equal; sums
over K are held to the tolerances in ``_torch_parity``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import esca as jesca
from repro.core import llpt as jllpt
from repro.core import three_branch as jtb
from repro_torch.core import esca, llpt, three_branch as tb
from _torch_parity import assert_topics_agree



def T(a):
    """A torch tensor holding a copy of ``a`` (JAX arrays are read-only)."""
    return torch.from_numpy(np.array(a))


def _counts(seed, n=700, n_docs=25, n_words=40, K=12, pad_frac=0.1):
    rng = np.random.default_rng(seed)
    word_ids = np.sort(rng.integers(0, n_words, n)).astype(np.int32)
    doc_ids = rng.integers(0, n_docs, n).astype(np.int32)
    mask = (rng.random(n) > pad_frac).astype(np.int32)
    topics = rng.integers(0, K, n).astype(np.int32)
    return rng, word_ids, doc_ids, mask, topics, (n_docs, n_words, K)


@pytest.mark.parametrize("seed", [0, 1])
def test_counts_and_w_hat_bitwise(seed):
    rng, v, d, mask, z, (M, V, K) = _counts(seed)
    D_j, W_j = jesca.update_counts(jnp.asarray(v), jnp.asarray(d),
                                   jnp.asarray(z), jnp.asarray(mask),
                                   n_docs=M, n_words=V, n_topics=K)
    D_t, W_t = esca.update_counts(T(v), T(d), T(z), T(mask), n_docs=M,
                                  n_words=V, n_topics=K)
    assert D_t.dtype == torch.int32
    assert np.array_equal(D_t.numpy(), np.asarray(D_j))
    assert np.array_equal(W_t.numpy(), np.asarray(W_j))
    wh_j = np.asarray(jesca.compute_w_hat(W_j, 0.01))
    assert np.array_equal(esca.compute_w_hat(W_t, 0.01).numpy(), wh_j)
    colsum = W_t.sum(dim=0, dtype=torch.int32)
    assert np.array_equal(
        esca.compute_w_hat_from_colsum(W_t, colsum, 0.01).numpy(), wh_j)


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_delta_update_equals_rebuild(seed):
    rng, v, d, mask, z, (M, V, K) = _counts(seed, n=513, n_docs=20,
                                            n_words=30, K=9)
    v, d, mask = T(v), T(d), T(mask)
    topics = T(z)
    D, W = esca.update_counts(v, d, topics, mask, n_docs=M, n_words=V,
                              n_topics=K)
    colsum = W.sum(dim=0, dtype=torch.int32)
    for it in range(5):
        keep = rng.random(v.shape[0]) < 0.6
        new = T(np.where(keep, topics.numpy(), rng.integers(0, K, v.shape[0]))
                .astype(np.int32))
        esca.delta_update_counts(D, W, v, d, topics, new, mask)
        esca.delta_update_colsum(colsum, topics, new, mask)
        topics = new
        D_ref, W_ref = jesca.update_counts(
            jnp.asarray(v.numpy()), jnp.asarray(d.numpy()),
            jnp.asarray(topics.numpy()), jnp.asarray(mask.numpy()),
            n_docs=M, n_words=V, n_topics=K)
        assert np.array_equal(D.numpy(), np.asarray(D_ref)), it
        assert np.array_equal(W.numpy(), np.asarray(W_ref)), it
        assert np.array_equal(colsum.numpy(), np.asarray(W_ref).sum(0)), it


def _w_hat(seed, V=50, K=16, ties=False):
    rng = np.random.default_rng(seed)
    W = (rng.integers(0, 30, (V, K)) * (rng.random((V, K)) < 0.4)
         ).astype(np.int32)
    if ties:                         # duplicated maxima and all-equal rows
        W[::3, 5] = W[::3, 2] = 99
        W[1::7] = 4
    return W, np.asarray(jesca.compute_w_hat(jnp.asarray(W), 0.01))


@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("ties", [False, True])
def test_word_stats_match_top_k(g, ties):
    W, wh = _w_hat(g, ties=ties)
    alpha = 50.0 / wh.shape[1]
    ref = jtb.word_stats(jnp.asarray(wh), g=g, alpha=alpha)
    got = tb.word_stats(T(wh), g=g, alpha=alpha)
    assert np.array_equal(got.a.numpy(), np.asarray(ref.a))       # values
    assert np.array_equal(got.k.numpy(), np.asarray(ref.k))       # tie order
    assert np.array_equal(got.k12_packed.numpy(),
                          np.asarray(ref.k12_packed))
    np.testing.assert_allclose(got.wsum.numpy(), np.asarray(ref.wsum),
                               rtol=1e-6)
    np.testing.assert_allclose(got.q_prime.numpy(), np.asarray(ref.q_prime),
                               rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 3])
def test_skip_phase_and_compaction_bitwise(seed):
    rng, v, d, mask, z, (M, V, K) = _counts(seed, n=900, K=16)
    D_j, W_j = jesca.update_counts(jnp.asarray(v), jnp.asarray(d),
                                   jnp.asarray(z), jnp.asarray(mask),
                                   n_docs=M, n_words=V, n_topics=K)
    wh = jesca.compute_w_hat(W_j, 0.01)
    alpha, g = 50.0 / K, 2
    stats_j = jtb.word_stats(wh, g=g, alpha=alpha)
    u = rng.random(v.shape[0]).astype(np.float32)
    dec_j = jtb.skip_phase(jnp.asarray(u), jnp.asarray(v), jnp.asarray(d),
                           D_j, stats_j, g=g, alpha=alpha)
    # identical word stats in: every per-token quantity is elementwise
    stats_t = tb.WordStats(*(T(np.asarray(x)) for x in stats_j))
    dec_t = tb.skip_phase(T(u), T(v), T(d), T(np.asarray(D_j)), stats_t,
                          g=g, alpha=alpha)
    for f in ("m", "k1"):
        assert np.array_equal(getattr(dec_t, f).numpy(),
                              np.asarray(getattr(dec_j, f))), f
    # XLA contracts head + a_g·(len_d − Σb) into one FMA; PyTorch rounds
    # the product first, so S_est may differ by one ulp
    np.testing.assert_array_max_ulp(dec_t.s_est.numpy(),
                                    np.asarray(dec_j.s_est), maxulp=1)
    # ... and a skip decision may then differ only at its own margin
    own = tb.word_stats(T(np.array(wh)), g=g, alpha=alpha)
    for dec in (dec_t, tb.skip_phase(T(u), T(v), T(d), T(np.asarray(D_j)),
                                     own, g=g, alpha=alpha)):
        flip = np.flatnonzero(dec.skip.numpy() != np.asarray(dec_j.skip))
        m = dec.m.numpy()[flip]
        lhs = u[flip] * (m + dec.s_est.numpy()[flip]
                         + stats_t.q_prime.numpy()[v[flip]])
        assert np.all(np.abs(lhs - m) <= 4 * np.spacing(m)), flip
    assert 0 < int(dec_t.skip.sum()) < v.shape[0]

    rank_j, ns_j = jtb.survivor_rank(dec_j.skip)
    rank_t, ns_t = tb.survivor_rank(dec_t.skip)
    assert np.array_equal(rank_t.numpy(), np.asarray(rank_j))
    assert int(ns_t) == int(ns_j)
    for slots in (int(ns_j), int(ns_j) + 37, max(int(ns_j) - 50, 1)):
        idx_j = jtb.compact_survivor_indices(rank_j, dec_j.skip, slots)
        idx_t = tb.compact_survivor_indices(rank_t, dec_t.skip, slots)
        assert np.array_equal(idx_t.numpy(), np.asarray(idx_j)), slots


@pytest.mark.parametrize("seed", [0, 5])
def test_exact_three_branch_matches_reference(seed):
    rng, v, d, mask, z, (M, V, K) = _counts(seed, n=600, K=24)
    D_j, W_j = jesca.update_counts(jnp.asarray(v), jnp.asarray(d),
                                   jnp.asarray(z), jnp.asarray(mask),
                                   n_docs=M, n_words=V, n_topics=K)
    wh = np.asarray(jesca.compute_w_hat(W_j, 0.01))
    k1 = np.argmax(wh, axis=1).astype(np.int32)
    u = rng.random(v.shape[0]).astype(np.float32)
    alpha = 50.0 / K
    t_j, m_j = jtb.exact_three_branch(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(d), jnp.asarray(k1),
        D_j, jnp.asarray(wh), alpha=alpha, tile_size=128)
    t_t, m_t = tb.exact_three_branch(T(u), T(v), T(d), T(k1),
                                     T(np.asarray(D_j)), T(wh), alpha=alpha,
                                     tile_size=100)
    D_np = np.asarray(D_j)
    assert_topics_agree(u, D_np[d], wh[v], alpha, t_t.numpy(),
                        np.asarray(t_j))
    same = t_t.numpy() == np.asarray(t_j)
    assert np.array_equal(m_t.numpy()[same], np.asarray(m_j)[same])


@pytest.mark.parametrize("seed", [0, 2])
def test_llpt_matches_reference(seed):
    rng, v, d, mask, z, (M, V, K) = _counts(seed)
    D_j, W_j = jesca.update_counts(jnp.asarray(v), jnp.asarray(d),
                                   jnp.asarray(z), jnp.asarray(mask),
                                   n_docs=M, n_words=V, n_topics=K)
    kw = dict(alpha=50.0 / K, beta=0.01)
    ref_ll = np.asarray(jllpt.token_ll(
        jnp.asarray(v), jnp.asarray(d), D_j, W_j,
        jnp.sum(W_j, axis=0, dtype=jnp.float32), n_words=V, **kw))
    D_t, W_t = T(np.asarray(D_j)), T(np.asarray(W_j))
    got_ll = llpt.token_ll(T(v), T(d), D_t, W_t,
                           W_t.sum(dim=0, dtype=torch.float32), n_words=V,
                           tile_size=64, **kw)
    np.testing.assert_allclose(got_ll.numpy(), ref_ll, rtol=1e-5, atol=1e-5)
    ref = float(jllpt.llpt(v, d, mask, D_j, W_j, **kw))
    got = float(llpt.llpt(T(v), T(d), T(mask), D_t, W_t, **kw))
    assert got == pytest.approx(ref, rel=1e-5)


def test_reference_sampler_paths_agree_on_same_uniforms():
    """three_branch.sample (oracle and compacted) equals the reference's
    on the uniforms the reference draws."""
    rng, v, d, mask, z, (M, V, K) = _counts(11, n=800, K=10)
    D_j, W_j = jesca.update_counts(jnp.asarray(v), jnp.asarray(d),
                                   jnp.asarray(z), jnp.asarray(mask),
                                   n_docs=M, n_words=V, n_topics=K)
    key = jax.random.PRNGKey(4)
    u = np.asarray(jax.random.uniform(key, (v.shape[0],), dtype=jnp.float32))

    class Cfg:
        alpha_, beta, survivor_capacity, g, tile_size = 5.0, 0.01, None, 2, 256
    ref, _ = jtb.sample(key, jtb.Plan(g=2, tile_size=256, capacity=None),
                        jnp.asarray(v), jnp.asarray(d), jnp.asarray(z),
                        D_j, W_j, Cfg)
    D_t, W_t = T(np.asarray(D_j)), T(np.asarray(W_j))
    wh = np.asarray(jesca.compute_w_hat(W_j, 0.01))
    outs = []
    for cap in (None, 64, 10_000):
        got, st = tb.sample(T(u), tb.Plan(g=2, tile_size=256, capacity=cap),
                            T(v), T(d), T(z), D_t, W_t, Cfg)
        assert_topics_agree(u, np.asarray(D_j)[d], wh[v], 5.0, got.numpy(),
                            np.asarray(ref))
        outs.append(got.numpy())
    assert np.array_equal(outs[0], outs[1]) and np.array_equal(outs[1],
                                                               outs[2])
