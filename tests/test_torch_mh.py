"""The port's ``core/mh.py`` against the reference's: alias queues and the
Vose build, the doc index, proposals, the MH chain and the stepwise warp
sampler.

Tolerances: everything integer (queues, tables' alias, doc index,
proposals, topics, accepted counts) and every float the two packages
compute with the same IEEE operations in the same order (the Vose
``prob``, the chain's predicates) is compared bitwise, on identical
inputs. ``q = w / Σw`` reduces K floats in another order in XLA and in
PyTorch, so q may differ in the last ulp: the tests count such rows on
real-valued weights (there q agrees within rel 1e-6: a sum of K = 16
floats in two orders), and use integer-valued weights (exact sums in any
order) where a bitwise comparison needs the same q. Against the float64
oracle ``reference_chain_numpy``: acceptance ratios within rel 1e-4, and
topics equal wherever every predicate's margin exceeds 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mh as jmh
from repro_torch.core import mh

T = torch.from_numpy


def _rand_weights(rng, V, K, integer=False):
    # count-shaped weights with the spiky rows real Ŵ rows have
    w = rng.integers(0, 50, (V, K)).astype(np.float32)
    w[rng.random((V, K)) < 0.6] = 0.0
    return w + (1.0 if integer else 0.1)


def _edge_rows(K):
    """Rows that stress the pairing loop: all equal, one dominant weight,
    one tiny weight among equals, and a ramp."""
    eq = np.ones(K, np.float32)
    dom = np.full(K, 1e-3, np.float32)
    dom[K // 2] = 1e3
    tiny = np.ones(K, np.float32)
    tiny[0] = 1e-6
    ramp = np.arange(1, K + 1, dtype=np.float32)
    return np.stack([eq, dom, tiny, ramp])


def _scaled(w):
    q = w / w.sum(axis=1, keepdims=True)
    return (q * w.shape[1]).astype(np.float32)


@pytest.mark.parametrize("V,K,edge", [(30, 12, False), (40, 37, False),
                                      (8, 1, True), (4, 37, True),
                                      (4, 64, True), (25, 64, False)])
def test_queues_and_vose_bitwise_vs_reference(V, K, edge):
    """Identical ``scaled`` in, bitwise queues and (prob, alias) out,
    against both forms of the reference's build (scatter and one-hot)."""
    rng = np.random.default_rng(V * 100 + K)
    w = _edge_rows(K) if edge else _rand_weights(rng, V, K)
    scaled = _scaled(w)
    jq = jmh.alias_queues(jnp.asarray(scaled))
    tq = mh.alias_queues(T(scaled))
    for a, b in zip(jq, tq):
        assert np.array_equal(np.asarray(a), b.numpy())
    tp, ta = mh.run_vose(T(scaled), *tq)
    for onehot in (False, True):
        jp, ja = jmh.run_vose(jnp.asarray(scaled), *jq, onehot=onehot)
        assert np.array_equal(np.asarray(jp), tp.numpy())
        assert np.array_equal(np.asarray(ja), ta.numpy())
    # valid tables: prob/K plus the mass redirected to each slot is q·K/K
    recon = tp.double() / K
    recon.index_put_((torch.arange(w.shape[0])[:, None].expand(-1, K),
                      ta.long()), (1 - tp.double()) / K, accumulate=True)
    q = w / w.sum(axis=1, keepdims=True)
    assert np.allclose(recon.numpy(), q, atol=1e-5)


def test_alias_tables_row_independent_and_q_rows_counted():
    """A window of rows builds the slice of the global tables (the
    property the per-tile reference build and the port's once-per-build
    kernel both rest on); q rows against the reference's are counted."""
    rng = np.random.default_rng(3)
    w = _rand_weights(rng, 50, 16)
    full = mh.build_alias_tables(T(w))
    win = mh.build_alias_tables(T(w[17:33]))
    for a, b in zip(full, win):
        assert torch.equal(a[17:33], b)
    jt = jmh.build_alias_tables(jnp.asarray(w))
    q_rows_differ = int((~np.all(np.asarray(jt.q) == full.q.numpy(),
                                 axis=1)).sum())
    # the row sums of K floats differ by a few ulps between the two orders
    assert np.allclose(np.asarray(jt.q), full.q.numpy(), rtol=1e-6, atol=0)
    assert 0 <= q_rows_differ <= w.shape[0]     # counted, not assumed zero
    wi = _rand_weights(rng, 50, 16, integer=True)   # exact row sums
    jt, tt = jmh.build_alias_tables(jnp.asarray(wi)), mh.build_alias_tables(
        T(wi))
    for a, b in zip(jt, tt):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_build_doc_index_matches_reference():
    rng = np.random.default_rng(5)
    d = np.sort(rng.integers(0, 9, 300)).astype(np.int32)
    rng.shuffle(d)
    mask = (rng.random(300) < 0.9).astype(np.int32)
    j = jmh.build_doc_index(d, mask, 10)            # doc 9 stays empty
    t = mh.build_doc_index(T(d), T(mask), 10)
    for a, b in zip(j, t):
        assert np.array_equal(np.asarray(a), b.numpy())


def _chain_inputs(seed, V=30, K=12, M=20, n=600, C=3):
    rng = np.random.default_rng(seed)
    return dict(
        D=rng.integers(0, 40, (M, K)).astype(np.int32),
        W_hat=_rand_weights(rng, V, K, integer=True) / 64,
        d_ids=rng.integers(0, M, n).astype(np.int32),
        w_ids=rng.integers(0, V, n).astype(np.int32),
        s0=rng.integers(0, K, n).astype(np.int32), C=C, n=n, K=K, M=M)


@pytest.mark.parametrize("near_one", [False, True])
def test_proposals_and_chain_bitwise_vs_reference(near_one):
    """doc_proposals, alias_draw and mh_chain on the uniforms of
    ``jax.random.uniform``: bitwise. ``near_one`` pushes every uniform
    within 2^-16 of 1, where ⌊u·K⌋ and ⌊u·L⌋ can round up to K and L."""
    x = _chain_inputs(11)
    C, n, K = x["C"], x["n"], x["K"]
    kd, kw, ka = jax.random.split(jax.random.PRNGKey(4), 3)
    u_doc = jax.random.uniform(kd, (C, 3, n), dtype=jnp.float32)
    u_word = jax.random.uniform(kw, (C, 2, n), dtype=jnp.float32)
    u_acc = jax.random.uniform(ka, (C, 2, n), dtype=jnp.float32)
    if near_one:
        near = lambda u: jnp.minimum(1 - u * 2.0**-16,  # noqa: E731
                                     1 - 2.0**-24).astype(jnp.float32)
        u_doc, u_word = near(u_doc), near(u_word)
    mask = np.ones(n, np.int32)
    mask[::7] = 0
    d_ids = x["d_ids"].copy()
    d_ids[d_ids == 3] = 4                          # doc 3 has no tokens
    d_ids[:5] = 3                                  # ... but these masked
    mask[:5] = 0
    jidx = jmh.build_doc_index(d_ids, mask, x["M"])
    tidx = mh.build_doc_index(T(d_ids), T(mask), x["M"])
    topics = x["s0"]
    j_tdoc = jmh.doc_proposals(kd, jnp.asarray(topics), jnp.asarray(d_ids),
                               jidx, n_topics=K, alpha=0.1, n_cycles=C) \
        if not near_one else None
    t_tdoc = mh.doc_proposals(T(np.asarray(u_doc)), T(topics), T(d_ids),
                              tidx, n_topics=K, alpha=0.1)
    if j_tdoc is not None:                          # same key, same uniforms
        assert np.array_equal(np.asarray(j_tdoc), t_tdoc.numpy())
    assert int(t_tdoc.min()) >= 0 and int(t_tdoc.max()) < K

    jt = jmh.build_alias_tables(jnp.asarray(x["W_hat"]))
    tables = mh.AliasTables(*(T(np.array(a)) for a in jt))
    j_tw = jmh.alias_draw(u_word, jnp.asarray(x["w_ids"]), jt.prob, jt.alias,
                          n_topics=K)
    t_tw = mh.alias_draw(T(np.asarray(u_word)), T(x["w_ids"]), tables.prob,
                         tables.alias, n_topics=K)
    assert np.array_equal(np.asarray(j_tw), t_tw.numpy())
    assert int(t_tw.max()) < K

    Dj, Wj = jnp.asarray(x["D"]), jnp.asarray(x["W_hat"])
    dj, wj = jnp.asarray(d_ids), jnp.asarray(x["w_ids"])
    j_s, j_acc = jmh.mh_chain(
        jnp.asarray(topics), jnp.asarray(t_tdoc.numpy()), j_tw, u_acc,
        lookup_d=lambda k: Dj[dj, k].astype(jnp.float32),
        lookup_w=lambda k: Wj[wj, k], lookup_q=lambda k: jt.q[wj, k],
        alpha=0.1)
    look = mh.row_lookups(T(d_ids), T(x["w_ids"]), T(x["D"]), T(x["W_hat"]),
                          tables.q)
    t_s, t_acc = mh.mh_chain(T(topics), t_tdoc, t_tw, T(np.asarray(u_acc)),
                             lookup_d=look[0], lookup_w=look[1],
                             lookup_q=look[2], alpha=0.1)
    assert np.array_equal(np.asarray(j_s), t_s.numpy())
    assert np.array_equal(np.asarray(j_acc), t_acc.numpy())


def test_mh_chain_matches_float64_oracle():
    """The port's f32 chain against ``reference_chain_numpy``."""
    rng = np.random.default_rng(7)
    V, K, M, n, C = 30, 12, 20, 600, 3
    D = rng.integers(0, 40, (M, K)).astype(np.int32)
    W_hat = _rand_weights(rng, V, K)
    tables = mh.build_alias_tables(T(W_hat))
    d_ids = rng.integers(0, M, n).astype(np.int32)
    w_ids = rng.integers(0, V, n).astype(np.int32)
    s0 = rng.integers(0, K, n).astype(np.int32)
    t_doc = rng.integers(0, K, (C, n)).astype(np.int32)
    t_word = rng.integers(0, K, (C, n)).astype(np.int32)
    u_acc = rng.random((C, 2, n)).astype(np.float32)
    look = mh.row_lookups(T(d_ids), T(w_ids), T(D), T(W_hat), tables.q)
    s, _, ratios = mh.mh_chain(T(s0), T(t_doc), T(t_word), T(u_acc),
                               lookup_d=look[0], lookup_w=look[1],
                               lookup_q=look[2], alpha=0.1,
                               return_ratios=True)
    s_ref, ratios64 = jmh.reference_chain_numpy(
        s0, t_doc, t_word, u_acc, d_ids, w_ids, D, W_hat,
        tables.q.numpy(), alpha=0.1)
    rel = np.abs(ratios.double().numpy() - ratios64) \
        / np.maximum(ratios64, 1e-30)
    assert float(rel.max()) < 1e-4
    margin = np.min(np.abs(u_acc.astype(np.float64) - ratios64), axis=(0, 1))
    safe = margin > 1e-4
    assert safe.mean() > 0.9
    assert np.array_equal(s.numpy()[safe], s_ref[safe])


def test_sample_warp_bitwise_vs_reference():
    """The stepwise sampler on the reference key's own uniforms, with the
    same tables: topics bitwise, stats equal, padding untouched."""
    x = _chain_inputs(13, n=512, C=2)
    C, n, K = x["C"], x["n"], x["K"]
    mask = np.ones(n, np.int32)
    mask[-40:] = 0
    key = jax.random.PRNGKey(9)
    jt = jmh.build_alias_tables(jnp.asarray(x["W_hat"]))
    jidx = jmh.build_doc_index(x["d_ids"], mask, x["M"])
    j_s, j_st = jmh.sample_warp(
        key, jnp.asarray(x["w_ids"]), jnp.asarray(x["d_ids"]),
        jnp.asarray(x["s0"]), jnp.asarray(x["D"]), jnp.asarray(x["W_hat"]),
        jt, jidx, alpha=0.1, n_cycles=C, mask=jnp.asarray(mask))
    kd, kw, ka = jax.random.split(key, 3)
    u = [T(np.asarray(jax.random.uniform(k, (C, m, n), dtype=jnp.float32)))
         for k, m in ((kd, 3), (kw, 2), (ka, 2))]
    tables = mh.AliasTables(*(T(np.array(a)) for a in jt))
    t_s, t_st = mh.sample_warp(
        *u, T(x["w_ids"]), T(x["d_ids"]), T(x["s0"]), T(x["D"]),
        T(x["W_hat"]), tables, mh.build_doc_index(T(x["d_ids"]), T(mask),
                                                  x["M"]),
        alpha=0.1, mask=T(mask))
    assert np.array_equal(np.asarray(j_s), t_s.numpy())
    assert np.array_equal(t_s.numpy()[-40:], x["s0"][-40:])
    for f in mh.WarpStats._fields:
        assert float(getattr(t_st, f)) == pytest.approx(
            float(getattr(j_st, f)), abs=1e-6)
