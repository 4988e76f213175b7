"""The count rebuild: ``kernels/histogram.py`` (on the CPU: its plain
twins) against the Pallas kernel in interpret mode and its oracle,
``ops.update_counts`` against both packages' ``esca.update_counts`` and
the reference's ``kops.update_counts``, and ``core/inverted_index.py``.

Tolerance: bitwise everywhere (integer counts).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import esca as jesca
from repro.core import inverted_index as jinv
from repro.kernels import ops as jops
from repro.kernels.histogram import histogram as pallas_histogram
from repro.kernels.histogram import histogram_partials as pallas_partials
from repro.kernels.ref import histogram_ref as jax_histogram_ref
from repro_torch.core import esca, inverted_index
from repro_torch.kernels import histogram as hist
from repro_torch.kernels import ops
from repro_torch.lda import LDAConfig, LDATrainer
from _torch_parity import port_corpus

T = torch.from_numpy

# the shapes of tests/test_kernels.py::test_histogram_vs_ref
SHAPES = [(2000, 50, 64, 32),      # narrow rows
          (5000, 300, 130, 64),    # mixed
          (4096, 1000, 256, 16),   # wide rows: the fallback scatter
          (777, 10, 33, 8)]        # unaligned everything


def _tokens(n, R, K, sort=True):
    rng = np.random.default_rng(n + R)
    rows = rng.integers(0, R, n).astype(np.int32)
    if sort:
        rows = np.sort(rows)
    topics = rng.integers(0, K, n).astype(np.int32)
    w = (rng.random(n) < 0.9).astype(np.int32)
    return rows, topics, w


@pytest.mark.parametrize("n,R,K,rpt", SHAPES)
def test_histogram_bitwise_vs_pallas(n, R, K, rpt):
    rows, topics, w = _tokens(n, R, K)
    want = np.asarray(pallas_histogram(
        jnp.asarray(rows), jnp.asarray(topics), jnp.asarray(w), n_rows=R,
        n_topics=K, tile_t=512, rows_per_tile=rpt, interpret=True))
    assert np.array_equal(want, np.asarray(jax_histogram_ref(
        jnp.asarray(rows), jnp.asarray(topics), jnp.asarray(w), n_rows=R,
        n_topics=K)))
    got = hist.histogram(T(rows), T(topics), T(w), n_rows=R, n_topics=K,
                         tile_t=512, rows_per_tile=rpt)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    # any token order gives the same counts
    perm = np.random.default_rng(0).permutation(n)
    got = hist.histogram(T(rows[perm]), T(topics[perm]), T(w[perm]),
                         n_rows=R, n_topics=K)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,R,K,rpt", SHAPES)
def test_histogram_partials_bitwise_vs_pallas(n, R, K, rpt):
    """Partials and ``covered`` per tile, including the wide-row case whose
    tokens fall outside their tile's window."""
    rows, topics, w = _tokens(n, R, K)
    pad = (-n) % 512
    rows, topics, w = (np.pad(a, (0, pad)) for a in (rows, topics, w))
    bases = rows[::512].copy()
    jp, jc = pallas_partials(jnp.asarray(rows), jnp.asarray(topics),
                             jnp.asarray(w), jnp.asarray(bases), n_topics=K,
                             tile_t=512, rows_per_tile=rpt, interpret=True)
    tp, tc = hist.histogram_partials(T(rows), T(topics), T(w), T(bases),
                                     n_topics=K, tile_t=512,
                                     rows_per_tile=rpt)
    assert np.array_equal(np.asarray(jp), tp.numpy())
    assert np.array_equal(np.asarray(jc), tc.numpy())
    if R == 1000:
        assert not tc.numpy()[w > 0].all()      # the fallback is exercised


def test_histogram_rejects_bad_inputs():
    rows, topics, w = _tokens(100, 5, 4)
    with pytest.raises(ValueError, match="int32"):
        hist.histogram(T(rows).long(), T(topics), T(w), n_rows=5, n_topics=4)
    with pytest.raises(ValueError, match="multiple"):
        hist.histogram_partials(T(rows), T(topics), T(w), T(rows[:1]),
                                n_topics=4, tile_t=64)


def test_update_counts_bitwise_vs_both_packages(small_corpus):
    c = small_corpus
    K = 16
    rng = np.random.default_rng(0)
    topics = rng.integers(0, K, c.n_tokens).astype(np.int32)
    mask = np.ones(c.n_tokens, np.int32)
    mask[::11] = 0
    wi, di = c.word_ids.astype(np.int32), c.doc_ids.astype(np.int32)
    kw = dict(n_docs=c.n_docs, n_words=c.n_words, n_topics=K)
    seg = inverted_index.doc_segment_ids(port_corpus(c))
    assert np.array_equal(seg, jinv.doc_segment_ids(c))
    D0, W0 = esca.update_counts(T(wi), T(di), T(topics), T(mask), **kw)
    D1, W1 = ops.update_counts(T(wi), T(di), T(topics), T(mask),
                               T(c.inv_token_idx), T(seg), **kw)
    Dj, Wj = jesca.update_counts(jnp.asarray(wi), jnp.asarray(di),
                                 jnp.asarray(topics), jnp.asarray(mask), **kw)
    Dk, Wk = jops.update_counts(
        jnp.asarray(wi), jnp.asarray(di), jnp.asarray(topics),
        jnp.asarray(mask), jnp.asarray(c.inv_token_idx), jnp.asarray(seg),
        interpret=True, **kw)
    for a in (D0, D1):
        assert np.array_equal(a.numpy(), np.asarray(Dj))
        assert np.array_equal(a.numpy(), np.asarray(Dk))
    for a in (W0, W1):
        assert np.array_equal(a.numpy(), np.asarray(Wj))
        assert np.array_equal(a.numpy(), np.asarray(Wk))


def test_inverted_index_matches_reference(small_corpus):
    c = small_corpus
    tc = port_corpus(c)
    order = inverted_index.doc_major_order(tc)
    assert np.array_equal(order, jinv.doc_major_order(c))
    vals = np.arange(c.n_tokens, dtype=np.int32) * 3
    dm = inverted_index.to_doc_major(T(vals), T(order))
    assert np.array_equal(dm.numpy(), np.asarray(jinv.to_doc_major(
        jnp.asarray(vals), jnp.asarray(order))))
    back = inverted_index.from_doc_major(dm, T(order), c.n_tokens)
    assert np.array_equal(back.numpy(), vals)
    assert np.array_equal(back.numpy(), np.asarray(jinv.from_doc_major(
        jnp.asarray(dm.numpy()), jnp.asarray(order), c.n_tokens)))


@pytest.mark.parametrize("sampler", ["three_branch", "warp"])
def test_trainer_rebuilds_through_the_kernel_route(small_corpus, sampler):
    """With ``impl="kernel"`` every full rebuild of the trainer (initial
    counts, ``state_from_topics``, ``step``) goes through
    ``ops.update_counts``; the counts equal ``impl="torch"``'s."""
    tc = port_corpus(small_corpus)
    cfg = dict(n_topics=16, tile_size=512, sampler=sampler)
    tk = LDATrainer(tc, LDAConfig(impl="kernel", **cfg), device="cpu")
    tt = LDATrainer(tc, LDAConfig(impl="torch", **cfg), device="cpu")
    calls = []
    real = ops.update_counts

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    ops.update_counts = spy
    try:
        sk = tk.init_state()
        sk = tk.state_from_topics(sk.topics, 0)
        sk, _ = tk.step(sk)
    finally:
        ops.update_counts = real
    assert len(calls) == 3
    st, _ = tt.step(tt.init_state())
    for f in ("topics", "D", "W"):
        assert torch.equal(getattr(sk, f), getattr(st, f))
