"""The port's packed sparse rows and hybrid layout against the reference.

Everything here is integers, so every comparison is bitwise: pair
packing over the full 16-bit index range (idx >= 32768 and EMPTY_IDX
included), sorted packing with its overflow count, densifying, the
bucket plan, and ``HybridLayout`` built on the same corpora.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse as jsp
from repro.lda.model import HybridLayout as JaxLayout
from repro.lda.model import LDAConfig as JaxConfig
from repro_torch.core import esca, sparse as tsp
from repro_torch.lda.corpus import (relabel_by_frequency,
                                    synthetic_lda_corpus, zipf_corpus)
from repro_torch.lda.model import HybridLayout, LDAConfig, LDAState
from _torch_parity import port_corpus


def _counts(seed, rows, k, density=0.2, top=40):
    rng = np.random.default_rng(seed)
    c = rng.integers(1, top, (rows, k)) * (rng.random((rows, k)) < density)
    c[0] = 0                                    # an empty row
    c[1] = rng.integers(1, top, k)              # a full row
    return c.astype(np.int32)


def test_pack_unpack_round_trip_full_index_range():
    idx = np.array([0, 1, 32767, 32768, 40000, 65534, jsp.EMPTY_IDX],
                   np.int32)
    val = np.array([0, 65535, 7, 1, 300, 2, 0], np.int32)
    got = tsp.pack_pairs(torch.from_numpy(idx), torch.from_numpy(val))
    want = np.asarray(jsp.pack_pairs(jnp.asarray(idx), jnp.asarray(val)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert got[3] < 0 and got[-1] == -65536     # negative past 32767
    i, v = tsp.unpack_pairs(got)
    assert np.array_equal(i.numpy(), idx) and np.array_equal(v.numpy(), val)
    ji, jv = jsp.unpack_pairs(jnp.asarray(want))
    assert np.array_equal(np.asarray(ji), idx)


@pytest.mark.parametrize("rows,k,cap", [(30, 16, 16), (40, 37, 9),
                                        (25, 64, 64), (12, 1, 1)])
def test_pack_and_densify_sorted_match_reference(rows, k, cap):
    dense = _counts(rows + k, rows, k)
    got, ov = tsp.pack_rows_sorted(torch.from_numpy(dense), cap)
    want, jov = jsp.pack_rows_sorted(jnp.asarray(dense), cap)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(ov) == int(jov)
    assert int(ov) == int(np.maximum((dense > 0).sum(1) - cap, 0).sum())
    back = tsp.densify_rows_sorted(got, k)
    jback = jsp.densify_rows_sorted(jnp.asarray(want), k)
    assert np.array_equal(back.numpy(), np.asarray(jback))
    assert np.array_equal(tsp.densify_rows(got, k).numpy(),
                          np.asarray(jsp.densify_rows(jnp.asarray(want), k)))
    if cap >= k:                                 # no overflow: exact
        assert np.array_equal(back.numpy(), dense)


@pytest.mark.parametrize("rows,k,cap", [(30, 16, 16), (40, 37, 9),
                                        (25, 64, 64), (50, 300, 70),
                                        (12, 1, 1)])
def test_packed_rows_end_at_their_first_empty_slot(rows, k, cap):
    """The sparse kernels read a packed row up to its first empty slot:
    ``pack_rows_sorted`` leaves no live slot after an empty one, and the
    live slots ascend by idx (overflowing rows included)."""
    dense = _counts(rows * k + cap, rows, k)
    dense[2, : k // 2] = 0                      # live slots only at the end
    packed, _ = tsp.pack_rows_sorted(torch.from_numpy(dense), cap)
    idx, val = (x.numpy() for x in tsp.unpack_pairs(packed))
    empty = idx == tsp.EMPTY_IDX
    assert np.array_equal(empty, val == 0)
    after_empty = np.cumsum(empty, axis=1) > 0
    assert not (after_empty & ~empty).any()
    live = ~empty
    assert np.array_equal(live.sum(1), np.minimum((dense > 0).sum(1), cap))
    step = np.diff(np.where(live, idx, np.iinfo(np.int32).max), axis=1)
    assert (step[live[:, 1:]] > 0).all()


def test_pack_with_small_row_blocks_is_the_same(monkeypatch):
    dense = _counts(9, 50, 30)
    whole = tsp.pack_rows_sorted(torch.from_numpy(dense), 12)
    monkeypatch.setattr(tsp, "_ROW_BLOCK_BYTES", 64)     # one row a block
    blocked = tsp.pack_rows_sorted(torch.from_numpy(dense), 12)
    assert torch.equal(whole[0], blocked[0]) and int(whole[1]) == \
        int(blocked[1])
    assert torch.equal(tsp.densify_rows(blocked[0], 30),
                       torch.from_numpy(np.array(jsp.densify_rows(
                           jnp.asarray(blocked[0].numpy()), 30))))


def test_bucket_plan_matches_reference():
    rng = np.random.default_rng(2)
    upper = np.sort(rng.integers(1, 300, 200))[::-1]
    for cap, floor in ((256, 8), (64, 4), (16, 16)):
        assert tsp.bucket_plan(upper, cap, floor) == \
            jsp.bucket_plan(upper, cap, floor)
    with pytest.raises(ValueError, match="non-increasing"):
        tsp.bucket_plan(np.array([1, 3, 2]), 8)


@pytest.mark.parametrize("which", ["small", "skewed"])
@pytest.mark.parametrize("knobs", [dict(), dict(dense_word_threshold=5,
                                                d_capacity=200)])
def test_layout_build_matches_reference(small_corpus, skewed_corpus, which,
                                        knobs):
    jc = small_corpus if which == "small" else skewed_corpus
    cfg = LDAConfig(n_topics=16, format="hybrid", **knobs)
    got = HybridLayout.build(port_corpus(jc), cfg)
    want = JaxLayout.build(jc, JaxConfig(n_topics=16, format="hybrid",
                                         **knobs))
    for f in ("n_topics", "n_docs", "n_words", "d_capacity", "v_dense",
              "tail_starts", "tail_caps"):
        assert getattr(got, f) == getattr(want, f), f


def test_layout_round_trip_and_state_bytes(skewed_corpus):
    c = port_corpus(skewed_corpus)
    cfg = LDAConfig(n_topics=16, format="hybrid")
    lay = HybridLayout.build(c, cfg)
    gen = torch.Generator().manual_seed(0)
    topics, D, W = esca.init_counts(
        gen, torch.from_numpy(c.word_ids.astype(np.int32)),
        torch.from_numpy(c.doc_ids.astype(np.int32)),
        torch.ones(c.n_tokens, dtype=torch.int32), n_docs=c.n_docs,
        n_words=c.n_words, n_topics=16)
    state = LDAState(topics=topics, D=D, W=W, iteration=3)
    hs = lay.to_sparse(state)
    assert hs.D.shape == (c.n_docs, lay.d_capacity)
    assert len(hs.W_tail) == len(lay.tail_caps)
    assert int(hs.overflow) == 0 and hs.iteration == 3
    assert torch.equal(hs.colsum, W.sum(dim=0, dtype=torch.int32))
    back = lay.to_dense(hs)
    assert torch.equal(back.D, D) and torch.equal(back.W, W)
    assert torch.equal(back.topics, topics)
    hs.topics[0] += 1                           # fresh buffers
    assert not torch.equal(hs.topics, topics)
    want = 4 * (hs.D.numel() + hs.W_head.numel() + 16
                + sum(b.numel() for b in hs.W_tail))
    assert hs.nbytes() == want < state.nbytes()


def test_layout_build_errors():
    unrelabeled = synthetic_lda_corpus(0, n_docs=20, n_words=40, n_topics=4,
                                       mean_doc_len=20)
    assert np.any(np.diff(unrelabeled.word_token_counts) > 0)
    with pytest.raises(ValueError, match="relabel"):
        HybridLayout.build(unrelabeled, LDAConfig(n_topics=8,
                                                  format="hybrid"))
    c = relabel_by_frequency(zipf_corpus(0, n_docs=20, n_words=40,
                                         mean_doc_len=20))[0]
    bound = int(min(c.doc_lengths.max(), 8))
    with pytest.raises(ValueError, match="d_capacity"):
        HybridLayout.build(c, LDAConfig(n_topics=8, format="hybrid",
                                        d_capacity=bound - 1))
    assert HybridLayout.build(c, LDAConfig(
        n_topics=8, format="hybrid", d_capacity=bound)).d_capacity == bound
