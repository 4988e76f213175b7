"""The stepwise sparse-D sampler (``kernels/ops.py::sample_tokens_sparse_d``)
and the inverted-index D rebuild (``core/inverted_index.py::
reconstruct_d_rows``) against the reference.

The sampler draws from packed ELL D rows (``build_sparse_rows``, the
reference's own input) with the same uniforms as the reference's Pallas
path in interpret mode: topics equal except rare tokens whose draw lies
within 1e-5 of the total mass of a CDF boundary (M, a live slot, the
S'|Q' split, a Q' topic; ``tests/_torch_parity.py``), the stats within
those tokens. Against the port's dense draw it is the reference's own
check (``tests/test_kernels.py``): topic histograms within a total
variation of 0.05, M decisions equal but at their rounding margin. The D
rebuild is integer work: bitwise, on both ``histogram`` routes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import esca as jesca
from repro.core import inverted_index as jii
from repro.core import three_branch as jtb
from repro.core.sparse import build_sparse_rows as jbuild
from repro.kernels import ops as jops
from repro.lda.model import LDAConfig as JaxConfig
from repro.lda.trainer import LDATrainer as JaxTrainer
from repro_torch.core import inverted_index as tii
from repro_torch.core import sparse as tsp
from repro_torch.kernels import ops
from _torch_parity import assert_sparse_draws_agree

T = torch.from_numpy


@pytest.fixture(scope="module")
def trained(small_corpus):
    """The reference trainer after 5 steps (the reference's own test)."""
    cfg = JaxConfig(n_topics=16, tile_size=512)
    tr = JaxTrainer(small_corpus, cfg, _from_engine=True)
    state = tr.init_state()
    for _ in range(5):
        state, _ = tr.step(state)
    return tr, state, cfg


def _arrays(tr, state, cfg):
    a = {k: np.array(getattr(tr, k)) for k in ("word_ids", "doc_ids")}
    a["topics"] = np.array(state.topics)
    a["D"] = np.array(state.D)
    a["W_hat"] = np.array(jesca.compute_w_hat(state.W, cfg.beta))
    a["u"] = np.array(jax.random.uniform(jax.random.PRNGKey(0),
                                         a["word_ids"].shape, jnp.float32))
    return a


def _port(a, packed, alpha):
    return ops.sample_tokens_sparse_d(
        T(a["u"]), T(a["word_ids"]), T(a["doc_ids"]), T(a["topics"]),
        torch.as_tensor(np.array(packed)), T(a["D"]), T(a["W_hat"]),
        alpha=alpha)


def test_sparse_d_draws_match_reference(trained):
    tr, state, cfg = trained
    a = _arrays(tr, state, cfg)
    L = int((a["D"] > 0).sum(1).max())                       # max row nnz
    packed = np.asarray(jbuild(state.D, capacity=L))
    assert np.array_equal(tsp.build_sparse_rows(T(a["D"]), L).numpy(),
                          packed)
    want, want_stats = jops.sample_tokens_sparse_d(
        jax.random.PRNGKey(0), tr.word_ids, tr.doc_ids, state.topics,
        jnp.asarray(packed), state.D, jnp.asarray(a["W_hat"]),
        alpha=cfg.alpha_, interpret=True)
    got, got_stats = _port(a, packed, cfg.alpha_)
    # per-token inputs of the boundary test, from the reference's stats
    sw = jtb.word_stats(jnp.asarray(a["W_hat"]), g=2, alpha=cfg.alpha_)
    v, d = a["word_ids"], a["doc_ids"]
    k1 = np.asarray(sw.k[:, 0])[v]
    rows = packed[d]
    idx = (rows.view(np.uint32) >> 16).astype(np.int64)
    val = (rows & 0xFFFF).astype(np.int64)
    w_rows = a["W_hat"][v]
    w_at = np.take_along_axis(w_rows, idx, axis=1)
    n_off = assert_sparse_draws_agree(
        a["u"], idx, val, w_at, k1, np.asarray(sw.a[:, 0])[v],
        a["D"][d, k1].astype(np.float32), np.asarray(sw.q_prime)[v],
        cfg.alpha_, (got.numpy(),), (np.asarray(want),), w_rows=w_rows)
    n = len(v)
    for name in want_stats._fields:
        assert abs(float(getattr(got_stats, name))
                   - float(getattr(want_stats, name))) <= n_off / n + 1e-6


def test_sparse_d_draws_like_the_dense_sampler(trained):
    """The reference's own check, on the port: the same distribution as the
    dense draw, the M decisions equal but at their rounding margin."""
    tr, state, cfg = trained
    a = _arrays(tr, state, cfg)
    dense, _ = ops.sample_tokens(T(a["u"]), T(a["word_ids"]),
                                 T(a["doc_ids"]), T(a["topics"]), T(a["D"]),
                                 T(a["W_hat"]), alpha=cfg.alpha_)
    for packed in (tsp.build_sparse_rows(T(a["D"]), 16),
                   tsp.pack_rows_sorted(T(a["D"]), 16)[0]):
        got, stats = _port(a, packed, cfg.alpha_)
        h_sp = np.bincount(got.numpy(), minlength=16) / got.shape[0]
        h_rf = np.bincount(dense.numpy(), minlength=16) / got.shape[0]
        assert 0.5 * np.abs(h_sp - h_rf).sum() < 0.05, (h_sp, h_rf)
        k1 = np.argmax(a["W_hat"], axis=1)[a["word_ids"]]
        m_sp, m_dn = got.numpy() == k1, dense.numpy() == k1
        assert (m_sp != m_dn).mean() < 0.01
        assert 0.0 < float(stats.frac_m_final) < 1.0


def test_sorted_and_updated_rows_draw_like_top_k_rows(trained):
    """The same D as top_k rows, as sorted rows, and as the sorted rows of
    an older D taken to it by ``ell_apply_deltas``: the updated rows keep
    their EMPTY_IDX slots a suffix (the kernel's early exit needs it), and
    all three give the same M decisions but at a margin."""
    tr, state, cfg = trained
    a = _arrays(tr, state, cfg)
    D = T(a["D"])
    L = min(int(np.bincount(a["doc_ids"][:tr.corpus.n_tokens]).max()), 16)
    rng = np.random.default_rng(0)
    tok = rng.choice(tr.corpus.n_tokens, 200, replace=False)
    rows = T(a["doc_ids"][tok])
    old = T(rng.integers(0, 16, len(tok)).astype(np.int32))
    new = T(a["topics"][tok])
    before = D.clone()                     # D with the 200 moves undone
    before.index_put_((rows.long(), new.long()),
                      -torch.ones(len(tok), dtype=torch.int32),
                      accumulate=True)
    before.index_put_((rows.long(), old.long()),
                      torch.ones(len(tok), dtype=torch.int32),
                      accumulate=True)
    packed, dropped = tsp.ell_apply_deltas(
        tsp.pack_rows_sorted(before, L)[0], rows, old, new,
        torch.ones(len(tok), dtype=torch.int32))
    assert int(dropped) == 0
    assert torch.equal(tsp.densify_rows(packed, 16), D)
    empty = (((packed >> 16) & 0xFFFF) == tsp.EMPTY_IDX).int()
    assert bool((empty[:, 1:] >= empty[:, :-1]).all())
    k1 = np.argmax(a["W_hat"], axis=1)[a["word_ids"]]
    top, _ = _port(a, tsp.build_sparse_rows(D, L), cfg.alpha_)
    for rows_ in (tsp.pack_rows_sorted(D, L)[0], packed):
        got, _ = _port(a, rows_, cfg.alpha_)
        assert ((got.numpy() == k1) != (top.numpy() == k1)).mean() < 0.01


def test_sparse_d_refuses_the_topic_that_packs_like_an_empty_slot():
    """At K = 65,536 topic 65,535 packs as idx 0xFFFF, the EMPTY_IDX at
    which ``sample_sparse`` stops reading a row: the sampler refuses."""
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="65535"):
        ops.sample_tokens_sparse_d(
            torch.zeros(1), one, one, one, one[:, None],
            torch.zeros((1, 65_536), dtype=torch.int32),
            torch.full((1, 65_536), 1e-5), alpha=0.1)


@pytest.mark.parametrize("route", ["sorted", "any_order"])
def test_reconstruct_d_rows_bitwise(trained, monkeypatch, route):
    tr, state, cfg = trained
    corpus = tr.corpus
    inv = np.asarray(corpus.inv_token_idx)
    seg = jii.doc_segment_ids(corpus)
    want = jii.reconstruct_d_rows(state.topics, jnp.asarray(inv),
                                  jnp.asarray(seg), corpus.n_docs, 16)
    if route == "any_order":
        monkeypatch.setattr(tii.hist, "sorted_route_fits", lambda k: False)
    got = tii.reconstruct_d_rows(T(np.array(state.topics)), T(inv),
                                 T(seg.astype(np.int32)), corpus.n_docs, 16)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), np.asarray(state.D))
