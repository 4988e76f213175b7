"""The sample_sparse twins against the Pallas kernels (interpret mode),
the sparse tail draw against the reference composed with a clip-mode
gather, and the reference fault the port leaves out.

Tolerances (``_torch_parity``): S' rtol 1e-5; (topic, needs_q) equal
except rare tokens whose draw lies within 1e-5 of the total mass of a
CDF boundary (M, a live slot, the S'|Q' split, a Q' topic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse import EMPTY_IDX
from repro.core.sparse import pack_pairs as jpack
from repro.kernels import ops as jops
from repro.kernels.sample_sparse import sample_sparse as pallas_sparse
from repro.kernels.sample_sparse import \
    sample_sparse_tiled as pallas_sparse_tiled
from repro_torch.core.sparse import pack_pairs
from repro_torch.kernels import ops, sample_sparse as ss
from _torch_parity import assert_masses_close, assert_sparse_draws_agree

T = torch.from_numpy


def _tokens(n, K, L, seed, *, near_one=False):
    """Packed sorted rows with empty slots, K1 in the row or not, finite
    Ŵ everywhere (empty slots included: the Pallas kernel multiplies
    them by 0)."""
    rng = np.random.default_rng(seed * 7919 + n + K + L)
    idx = np.full((n, L), EMPTY_IDX, np.int32)
    val = np.zeros((n, L), np.int32)
    for i in range(n):
        nnz = int(rng.integers(0, min(L, K) + 1))
        idx[i, :nnz] = np.sort(rng.choice(K, nnz, replace=False))
        val[i, :nnz] = rng.integers(1, 40, nnz)
    w_rows = (rng.random((n, K)) * 0.01 + 1e-4).astype(np.float32)
    k1 = np.argmax(w_rows, axis=1).astype(np.int32)
    k1[::3] = idx[::3, 0] % K                    # K1 often inside the row
    a1 = w_rows[np.arange(n), k1]
    b1 = np.where(rng.random(n) < 0.5, rng.integers(0, 30, n), 0
                  ).astype(np.float32)
    qp = (0.05 * (w_rows.sum(1) - a1)).astype(np.float32)
    u = rng.random(n).astype(np.float32)
    if near_one:
        u = np.minimum(1 - u * 2.0**-16, np.float32(1 - 2.0**-24)).astype(
            np.float32)
    packed = np.array(jpack(jnp.asarray(idx), jnp.asarray(val)))
    w_at = np.take_along_axis(w_rows, np.minimum(idx, K - 1), axis=1)
    return dict(u=u, idx=idx, val=val, packed=packed, w_rows=w_rows,
                w_at=w_at, k1=k1, a1=a1, b1=b1, qp=qp)


def _pallas(t, alpha):
    out = pallas_sparse(*(jnp.asarray(t[k]) for k in
                          ("u", "packed", "w_at", "k1", "a1", "b1", "qp")),
                        alpha=alpha, interpret=True)
    return [np.asarray(x) for x in out]


def _port(t, alpha):
    out = ss.sample_sparse(*(T(t[k]) for k in
                             ("u", "packed", "w_at", "k1", "a1", "b1", "qp")),
                           alpha=alpha)
    return [x.numpy() for x in out]


def _agree(t, alpha, got, want, **kw):
    assert_masses_close(got[2], want[2], 0.0)
    return assert_sparse_draws_agree(
        t["u"], t["idx"], t["val"], t["w_at"], t["k1"], t["a1"], t["b1"],
        t["qp"], alpha, got[:2], want[:2], **kw)


@pytest.mark.parametrize("n,K,L", [(1, 3, 1), (64, 37, 37), (200, 100, 9),
                                   (96, 1000, 421), (40, 1025, 64)])
def test_twin_matches_pallas(n, K, L):
    t = _tokens(n, K, L, 0)
    alpha = 50.0 / K
    got, want = _port(t, alpha), _pallas(t, alpha)
    _agree(t, alpha, got, want)
    assert got[0].dtype == np.int32 and got[1].dtype == np.bool_
    nq = got[1]
    assert np.all(got[0][nq] == -1) and np.all(got[0][~nq] >= 0)
    assert np.all(got[0][~nq] < K)


def test_twin_matches_pallas_for_draws_near_one():
    t = _tokens(150, 37, 20, 3, near_one=True)
    alpha = 50.0 / 37
    _agree(t, alpha, _port(t, alpha), _pallas(t, alpha), max_mismatch_frac=1)


def test_tiled_twin_equals_untiled_and_pallas_tiled():
    n, K, L, V = 120, 40, 16, 300
    t = _tokens(n, K, L, 5)
    rng = np.random.default_rng(1)
    words = np.sort(rng.integers(150, 170, n)).astype(np.int32)
    k1_w = rng.integers(0, K, V).astype(np.int32)
    a1_w = (rng.random(V) * 0.02).astype(np.float32)
    qp_w = (rng.random(V) * 0.05).astype(np.float32)
    alpha, win = 0.3, 32
    untiled = ss.sample_sparse(T(t["u"]), T(t["packed"]), T(t["w_at"]),
                               T(k1_w[words]), T(a1_w[words]), T(t["b1"]),
                               T(qp_w[words]), alpha=alpha)
    tiled = ss.sample_sparse_tiled(
        T(t["u"]), T(t["packed"]), T(t["w_at"]), T(words), int(words[0]),
        T(k1_w), T(a1_w), T(qp_w), T(t["b1"]), alpha=alpha, win_words=win)
    for a, b in zip(untiled, tiled):
        assert torch.equal(a, b)
    want = pallas_sparse_tiled(
        jnp.asarray(t["u"]), jnp.asarray(t["packed"]), jnp.asarray(t["w_at"]),
        jnp.asarray(words), jnp.int32(words[0]), jnp.asarray(k1_w),
        jnp.asarray(a1_w), jnp.asarray(qp_w), jnp.asarray(t["b1"]),
        alpha=alpha, win_words=win, interpret=True)
    t2 = dict(t, k1=k1_w[words], a1=a1_w[words], qp=qp_w[words])
    _agree(t2, alpha, [x.numpy() for x in tiled],
           [np.asarray(x) for x in want])


def test_rows_entry_gathers_like_pregathered():
    """The main path's entry (ids into packed D, Ŵ and word stats) equals
    the reference signature on the rows it gathers."""
    rng = np.random.default_rng(4)
    M, V, K, L, n = 30, 50, 24, 10, 300
    t = _tokens(M, K, L, 9)
    W_hat = (rng.random((V, K)) * 0.01 + 1e-4).astype(np.float32)
    k1_w = W_hat.argmax(1).astype(np.int32)
    a1_w = W_hat.max(1)
    qp_w = (0.1 * (W_hat.sum(1) - a1_w)).astype(np.float32)
    doc = rng.integers(0, M, n).astype(np.int32)
    word = np.sort(rng.integers(0, V, n)).astype(np.int32)
    u = rng.random(n).astype(np.float32)
    b1 = rng.integers(0, 9, n).astype(np.float32)
    before = ss.sample_sparse_rows.launches
    got = ss.sample_sparse_rows(T(u), T(doc), T(word), T(t["packed"]),
                                T(W_hat), T(k1_w), T(a1_w), T(qp_w), T(b1),
                                alpha=0.4)
    assert ss.sample_sparse_rows.launches == before   # the twin is no launch
    idx = t["idx"][doc]
    w_at = np.where(idx < K, np.take_along_axis(
        W_hat[word], np.minimum(idx, K - 1), axis=1), 0).astype(np.float32)
    want = ss.sample_sparse(T(u), T(t["packed"][doc]), T(w_at),
                            T(k1_w[word]), T(a1_w[word]), T(b1),
                            T(qp_w[word]), alpha=0.4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    first = torch.tensor([word[0], word[128], word[256]], dtype=torch.int32)
    tiled = ss.sample_sparse_tiled_rows(
        T(u), T(doc), T(word), first, 128, T(t["packed"]), T(W_hat),
        T(k1_w), T(a1_w), T(qp_w), T(b1), win_words=V, alpha=0.4)
    for a, b in zip(got, tiled):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="outside"):
        ss.sample_sparse_rows(T(u), T(doc + M), T(word), T(t["packed"]),
                              T(W_hat), T(k1_w), T(a1_w), T(qp_w), T(b1),
                              alpha=0.4)


@pytest.mark.parametrize("K,L", [(37, 12), (300, 40)])
def test_sparse_tail_draw_matches_reference_with_clip_gather(K, L):
    """The port's tail draw against the reference built from the Pallas
    kernel fed a clip-mode gather (finite at empty slots, times val 0)
    and the reference's own Q' finish."""
    t = _tokens(400, K, L, 11)
    alpha = 50.0 / K
    j = {k: jnp.asarray(v) for k, v in t.items()}
    w_at = jnp.take_along_axis(j["w_rows"], j["idx"], axis=1, mode="clip")
    topics, needs_q, s_p = pallas_sparse(
        j["u"], j["packed"], w_at, j["k1"], j["a1"], j["b1"], j["qp"],
        alpha=alpha, interpret=True)
    want = jops._q_fallback(j["u"], topics, needs_q, s_p, j["w_rows"],
                            j["k1"], j["a1"], j["b1"], j["qp"], alpha)
    got = ops.sparse_tail_draw(
        T(t["u"]), T(t["packed"]), T(t["w_rows"]), T(t["k1"]), T(t["a1"]),
        T(t["b1"]), T(t["qp"]), alpha=alpha)
    got, want = [x.numpy() for x in got], [np.asarray(x) for x in want]
    assert_sparse_draws_agree(
        t["u"], t["idx"], t["val"], t["w_at"], t["k1"], t["a1"], t["b1"],
        t["qp"], alpha, got, want, w_rows=t["w_rows"])
    assert got[1].any() and (got[0] >= 0).all() and (got[0] < K).all()
    # the main path's id entry, with the Q' finish in small chunks
    n = len(t["u"])
    ids = torch.arange(n, dtype=torch.int32)
    stats = (T(t["k1"]), T(t["a1"]), T(t["qp"]))
    old = ops.Q_FINISH_BYTES
    try:
        ops.Q_FINISH_BYTES = 12 * K * 7           # 7 rows a chunk
        rows = ops.sparse_tail_draw_rows(
            T(t["u"]), ids, ids, T(t["packed"]), T(t["w_rows"]), *stats,
            T(t["b1"]), alpha=alpha)
    finally:
        ops.Q_FINISH_BYTES = old
    for a, b in zip(rows, got):
        assert np.array_equal(a.numpy(), b)
    tiled = ops.sparse_tail_draw_tiled(
        T(t["u"]), T(t["packed"]), T(t["w_rows"]), ids, 0, *stats,
        T(t["b1"]), alpha=alpha, win_words=n)
    for a, b in zip(tiled, got):
        assert np.array_equal(a.numpy(), b)


def test_reference_empty_slot_fault_is_absent_from_the_port():
    """The reference gathers Ŵ at the empty slots' idx 0xFFFF in fill
    mode: NaN, so S' is NaN, every token is flagged for Q' and lands on
    topic K−1. The port's empty slots add no mass."""
    K, L = 12, 6
    t = _tokens(64, K, L, 2)
    t["val"][:, 3:] = 0
    t["idx"][:, 3:] = EMPTY_IDX                  # every row has empty slots
    t["packed"] = np.array(jpack(jnp.asarray(t["idx"]),
                                 jnp.asarray(t["val"])))
    alpha = 0.5
    j = {k: jnp.asarray(v) for k, v in t.items()}
    w_fill = jnp.take_along_axis(j["w_rows"], j["idx"], axis=1)
    _, _, s_ref = pallas_sparse(j["u"], j["packed"], w_fill, j["k1"],
                                j["a1"], j["b1"], j["qp"], alpha=alpha,
                                interpret=True)
    assert np.isnan(np.asarray(s_ref)).all()
    ref_topics, ref_nq, _ = jops.sparse_tail_draw(
        j["u"], j["packed"], j["w_rows"], j["k1"], j["a1"], j["b1"],
        j["qp"], alpha=alpha, interpret=True)
    assert np.asarray(ref_nq).all()
    assert (np.asarray(ref_topics) == K - 1).all()

    topics, needs_q, in_m = ops.sparse_tail_draw(
        T(t["u"]), T(t["packed"]), T(t["w_rows"]), T(t["k1"]), T(t["a1"]),
        T(t["b1"]), T(t["qp"]), alpha=alpha)
    _, _, s = ss.sample_sparse(T(t["u"]), T(t["packed"]),
                               T(np.array(w_fill)), T(t["k1"]), T(t["a1"]),
                               T(t["b1"]), T(t["qp"]), alpha=alpha)
    assert torch.isfinite(s).all()               # NaN at empty slots: unread
    assert (topics >= 0).all() and (topics < K).all()
    assert not needs_q.all() and (topics == K - 1).float().mean() < 0.5


def test_pack_pairs_matches_reference_packing():
    t = _tokens(20, 50, 8, 1)
    assert np.array_equal(
        pack_pairs(T(t["idx"]), T(t["val"])).numpy(), t["packed"])
