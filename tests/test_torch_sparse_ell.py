"""The port's ELL rows, incremental ELL ops, bucketed rows, hybrid W and
Table I byte models against ``src/repro/core/sparse.py``.

Everything here is integers, so every comparison is bitwise on the packed
words, the stale idx bits of free slots included: ``build_sparse_rows``
(ties of ``top_k``), ``sparse_lookup``, ``ell_lookup``, ``ell_sub_one``,
``ell_add_one``, ``ell_apply_deltas`` and ``ell_slot_apply`` on the
reference's own property sequences (``tests/test_sparse.py``), the full
16-bit index range, duplicates and overflow; ``build_bucketed`` and
``build_hybrid_w``; the ``bytes_*`` models at PubMed's published
statistics; the ``convert`` round trip. Sorted-packed rows keep their
``EMPTY_IDX`` slots a suffix under random ``ell_apply_deltas`` sequences,
which the ``sample_sparse`` kernel's early exit needs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.core import sparse as jsp
from repro.lda.corpus import relabel_by_frequency, zipf_corpus
from repro_torch.core import sparse as tsp
from repro_torch.lda import convert

# benchmarks/_common.py: PubMed's published statistics and the analytic
# Zipf token counts that benchmarks/table1_memory.py evaluates them with
PUBMED_WORDS, PUBMED_TOKENS = 141_043, 738e6


def _zipf_counts(n_words: int, n_tokens: float, exponent=1.1) -> np.ndarray:
    ranks = np.arange(1, n_words + 1, dtype=np.float64)
    p = ranks ** (-exponent)
    p /= p.sum()
    return np.maximum((p * n_tokens).astype(np.int64), 1)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.int32))


def _eq(got, want) -> bool:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return np.array_equal(got, np.asarray(want))


def _both(name, *arrays):
    """(port, reference) results of ``sparse.<name>`` on the same arrays."""
    got = getattr(tsp, name)(*(_t(a) for a in arrays))
    want = getattr(jsp, name)(*(jnp.asarray(a, jnp.int32) for a in arrays))
    return got, want


def _assert_same(name, *arrays):
    got, want = _both(name, *arrays)
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            assert _eq(g, w), name
        return got
    assert _eq(got, want), name
    return got


def _moves(rng, dense, c, k):
    """A batch of c ±1 moves valid for ``dense``: rows, old and new
    columns, weights (0 where the row had nothing left to move)."""
    r = dense.shape[0]
    rows = rng.integers(0, r, c).astype(np.int32)
    new = rng.integers(0, k, c).astype(np.int32)
    old = np.zeros(c, np.int32)
    w = np.zeros(c, np.int32)
    budget = dense.copy()
    for i in range(c):
        nz = np.nonzero(budget[rows[i]])[0]
        if len(nz) and rng.random() < 0.8:
            old[i] = rng.choice(nz)
            w[i] = 1
            budget[rows[i], old[i]] -= 1
    return rows, old, new, w


@pytest.mark.parametrize("seed,rows,k,cap,density", [
    (0, 7, 12, 12, 0.4), (1, 30, 40, 16, 0.3), (2, 5, 64, 1, 0.9),
    (3, 9, 33, 0, 0.5), (4, 300, 128, 50, 0.2)])
def test_build_sparse_rows_bitwise(seed, rows, k, cap, density):
    rng = np.random.default_rng(seed)
    dense = (rng.integers(1, 6, (rows, k))
             * (rng.random((rows, k)) < density)).astype(np.int32)
    dense[0] = 0                                  # an empty row
    got = tsp.build_sparse_rows(_t(dense), cap)
    want = jsp.build_sparse_rows(jnp.asarray(dense), cap)
    assert _eq(got, want)
    assert _eq(tsp.densify_rows(got, k), jsp.densify_rows(want, k))


def test_build_sparse_rows_ties_go_to_the_lower_column():
    """top_k keeps equal counts in ascending column order: the zero-count
    slots carry the row's lowest zero columns."""
    dense = np.array([[0, 3, 0, 3, 1, 3, 0, 0],
                      [2, 2, 2, 2, 2, 2, 2, 2],
                      [0, 0, 0, 0, 0, 0, 0, 5]], np.int32)
    got = tsp.build_sparse_rows(_t(dense), 6)
    assert _eq(got, jsp.build_sparse_rows(jnp.asarray(dense), 6))
    idx, val = tsp.unpack_pairs(got)
    assert idx[0].tolist() == [1, 3, 5, 4, 0, 2]
    assert idx[2].tolist() == [7, 0, 1, 2, 3, 4]
    assert val[2].tolist() == [5, 0, 0, 0, 0, 0]
    with pytest.raises(ValueError, match="capacity"):
        tsp.build_sparse_rows(_t(dense), 9)


def test_sparse_and_ell_lookup_bitwise():
    rng = np.random.default_rng(3)
    dense = (rng.integers(1, 9, (6, 20)) * (rng.random((6, 20)) < 0.4)
             ).astype(np.int32)
    packed = np.asarray(jsp.build_sparse_rows(jnp.asarray(dense), 12))
    for r in range(6):
        for col in (0, 5, 19):
            got = tsp.sparse_lookup(_t(packed[r]), col)
            want = jsp.sparse_lookup(jnp.asarray(packed[r]), jnp.int32(col))
            assert int(got) == int(want) == dense[r, col]
    rows = rng.integers(0, 6, 25).astype(np.int32)
    for cols in (rng.integers(0, 20, 25), rng.integers(0, 20, (25, 3))):
        cols = cols.astype(np.int32)
        got = _assert_same("ell_lookup", packed, rows, cols)
        assert _eq(got, dense[rows[:, None], cols.reshape(25, -1)].reshape(
            cols.shape))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_ell_insert_remove_sequences_bitwise(seed):
    """The reference's random ±1 sequences (remove-to-zero reclamation,
    freed slots reused) through both packages: the packed words bitwise
    after every op, misses and overflows equal, densify == the oracle."""
    rng = np.random.default_rng(seed)
    R, K = 6, 20
    dense = np.zeros((R, K), np.int32)
    packed = np.asarray(jsp.build_sparse_rows(jnp.asarray(dense), K))
    for _ in range(8):
        C = 24
        rows = rng.integers(0, R, C).astype(np.int32)
        add = rng.integers(0, K, C).astype(np.int32)
        w_add = rng.integers(0, 2, C).astype(np.int32)
        sub = np.zeros(C, np.int32)
        w_sub = np.zeros(C, np.int32)
        budget = dense.copy()
        for i in range(C):
            nz = np.nonzero(budget[rows[i]])[0]
            if len(nz) and rng.random() < 0.7:
                sub[i] = rng.choice(nz)
                w_sub[i] = 1
                budget[rows[i], sub[i]] -= 1
        got, miss = _assert_same("ell_sub_one", packed, rows, sub, w_sub)
        got, over = _assert_same("ell_add_one", got.numpy(), rows, add,
                                 w_add)
        packed = got.numpy()
        np.subtract.at(dense, (rows[w_sub > 0], sub[w_sub > 0]), 1)
        np.add.at(dense, (rows[w_add > 0], add[w_add > 0]), 1)
        assert int(miss) == 0 and int(over) == 0
        assert _eq(tsp.densify_rows(got, K), dense)
    # remove everything from row 0, then a full load of fresh columns
    for c in np.nonzero(dense[0])[0]:
        reps = int(dense[0, c])
        got, miss = _assert_same("ell_sub_one", packed, np.zeros(reps),
                                 np.full(reps, c), np.ones(reps))
        packed = got.numpy()
        assert int(miss) == 0
    got, over = _assert_same("ell_add_one", packed, np.zeros(K),
                             np.arange(K), np.ones(K))
    assert int(over) == 0
    assert _eq(tsp.densify_rows(got, K)[0], np.ones(K))


@settings(max_examples=30, deadline=None)
@given(col=st.integers(0, 65_535), count=st.integers(1, 60_000))
def test_ell_ops_full_16bit_index_range_bitwise(col, count):
    """idx >= 32768 and 0xFFFF must not sign-extend in either package."""
    packed = np.zeros((1, 4), np.int32)
    rows, cols = np.zeros(3, np.int32), np.full(3, col, np.int32)
    got, over = _assert_same("ell_add_one", packed, rows, cols, np.ones(3))
    assert int(over) == 0
    packed = got.numpy()
    packed[0, 0] = int(jsp.pack_pairs(jnp.int32(col), jnp.int32(count)))
    packed[0, 1:] = 0
    got = _assert_same("ell_lookup", packed, rows[:1], cols[:1])
    assert int(got[0]) == count
    got, _ = _assert_same("ell_sub_one", packed, rows[:1], cols[:1],
                          np.ones(1))
    assert int(tsp.ell_lookup(got, _t(rows[:1]), _t(cols[:1]))[0]) \
        == count - 1


def test_ell_apply_deltas_duplicates_bitwise():
    """Duplicate (row, col) updates in ONE batch accumulate exactly."""
    rng = np.random.default_rng(5)
    R, K = 4, 12
    dense = rng.integers(0, 4, (R, K)).astype(np.int32)
    packed = np.asarray(jsp.build_sparse_rows(jnp.asarray(dense), K))
    rows, old, new, w = _moves(rng, dense, 40, K)
    got, dropped = _assert_same("ell_apply_deltas", packed, rows, old, new, w)
    oracle = dense.copy()
    np.subtract.at(oracle, (rows[w > 0], old[w > 0]), 1)
    np.add.at(oracle, (rows[w > 0], new[w > 0]), 1)
    assert int(dropped) == 0
    assert _eq(tsp.densify_rows(got, K), oracle)


def test_ell_overflow_counted_bitwise():
    """Inserts past the capacity drop and count; live slots stay intact;
    a missing column counts as missing."""
    packed = np.asarray(jsp.build_sparse_rows(jnp.zeros((2, 8), jnp.int32),
                                              2))
    rows = np.array([0, 0, 0, 1, 1, 1, 1], np.int32)
    cols = np.array([1, 2, 3, 5, 5, 6, 7], np.int32)
    got, over = _assert_same("ell_add_one", packed, rows, cols, np.ones(7))
    assert int(over) == 1 + 1
    back = tsp.densify_rows(got, 8)
    assert int(back[0].sum()) == 2 and int(back[1, 5]) == 2
    got, miss = _assert_same("ell_sub_one", got.numpy(), rows[:2],
                             np.array([4, 1], np.int32), np.ones(2))
    assert int(miss) == 1


def test_ell_slot_apply_bitwise():
    rng = np.random.default_rng(9)
    R, K, L = 5, 16, 16
    dense = rng.integers(0, 5, (R, K)).astype(np.int32)
    for packed in (np.asarray(jsp.pack_rows_sorted(jnp.asarray(dense), L)[0]),
                   np.asarray(jsp.build_sparse_rows(jnp.asarray(dense), L))):
        delta = np.where(dense > 0, rng.integers(-1, 3, (R, K)), 0)
        delta = np.maximum(delta, -dense).astype(np.int32)
        got = _assert_same("ell_slot_apply", packed, delta)
        assert _eq(tsp.densify_rows(got, K), dense + delta)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_sorted_rows_keep_empty_slots_a_suffix(seed):
    """Random ``ell_apply_deltas`` batches on sorted-packed rows, bitwise
    the reference's: the EMPTY_IDX slots of every row stay a suffix (the
    kernel's early exit), densify == the dense oracle, nothing drops."""
    rng = np.random.default_rng(seed)
    R, K = 8, 24
    dense = (rng.integers(1, 4, (R, K)) * (rng.random((R, K)) < 0.25)
             ).astype(np.int32)
    L = K                                      # the row-nnz bound
    packed = np.asarray(jsp.pack_rows_sorted(jnp.asarray(dense), L)[0])
    for _ in range(6):
        rows, old, new, w = _moves(rng, dense, 30, K)
        got, dropped = _assert_same("ell_apply_deltas", packed, rows, old,
                                    new, w)
        packed = got.numpy()
        np.subtract.at(dense, (rows[w > 0], old[w > 0]), 1)
        np.add.at(dense, (rows[w > 0], new[w > 0]), 1)
        assert int(dropped) == 0
        assert _eq(tsp.densify_rows(got, K), dense)
        empty = (packed.view(np.uint32) >> 16) == tsp.EMPTY_IDX
        assert np.all(np.diff(empty.astype(np.int8), axis=1) >= 0)


def test_blocked_ops_apply_one_batch(monkeypatch):
    """Token and row blocks of one slot each give the same words as one
    block: the blocks only search slots, the batch lands at once."""
    rng = np.random.default_rng(11)
    R, K = 10, 30
    dense = (rng.integers(1, 4, (R, K)) * (rng.random((R, K)) < 0.3)
             ).astype(np.int32)
    packed = tsp.pack_rows_sorted(_t(dense), K)[0]
    rows, old, new, w = _moves(rng, dense, 60, K)
    args = (packed, _t(rows), _t(old), _t(new), _t(w))
    whole = tsp.ell_apply_deltas(*args)
    lookup = tsp.ell_lookup(packed, _t(rows), _t(new))
    monkeypatch.setattr(tsp, "_ROW_BLOCK_BYTES", 1)
    blocked = tsp.ell_apply_deltas(*args)
    assert torch.equal(whole[0], blocked[0]) and int(blocked[1]) == 0
    assert torch.equal(lookup, tsp.ell_lookup(packed, _t(rows), _t(new)))
    assert torch.equal(tsp.build_sparse_rows(_t(dense), 9),
                       torch.from_numpy(np.asarray(jsp.build_sparse_rows(
                           jnp.asarray(dense), 9))))


@pytest.fixture(scope="module")
def skewed():
    c = zipf_corpus(1, n_docs=100, n_words=300, exponent=1.3, mean_doc_len=50)
    return relabel_by_frequency(c)[0]


def _consistent_W(corpus, K, seed=2):
    rng = np.random.default_rng(seed)
    W = np.zeros((corpus.n_words, K), np.int32)
    for v in range(corpus.n_words):
        c = int(corpus.word_token_counts[v])
        if c:
            np.add.at(W[v], rng.integers(0, K, c), 1)
    return W


@pytest.mark.parametrize("K", [8, 32, 512])
def test_hybrid_w_and_buckets_bitwise(skewed, K):
    W = _consistent_W(skewed, K)
    counts = skewed.word_token_counts
    got = tsp.build_hybrid_w(_t(W), counts, threshold=K)
    want = jsp.build_hybrid_w(jnp.asarray(W), counts, threshold=K)
    assert got.v_dense == want.v_dense
    assert _eq(got.dense, want.dense)
    assert got.sparse.row_starts == want.sparse.row_starts
    assert got.sparse.capacities == want.sparse.capacities
    assert len(got.sparse.buckets) == len(want.sparse.buckets)
    for g, w in zip(got.sparse.buckets, want.sparse.buckets):
        assert _eq(g, w)
    assert got.nbytes() == want.nbytes()
    assert got.sparse.n_rows == want.sparse.n_rows
    assert _eq(got.densify(K), W)
    tail = np.minimum(counts[got.v_dense:], K)
    b_got = tsp.build_bucketed(_t(W[got.v_dense:]), tail, max_capacity=K,
                               min_capacity=4)
    b_want = jsp.build_bucketed(jnp.asarray(W[got.v_dense:]), tail,
                                max_capacity=K, min_capacity=4)
    assert b_got.capacities == b_want.capacities
    assert all(_eq(g, w) for g, w in zip(b_got.buckets, b_want.buckets))


def test_unsorted_inputs_raise_as_the_reference():
    with pytest.raises(ValueError, match="relabel"):
        tsp.bucket_plan(np.array([1, 5, 3]), max_capacity=8)
    with pytest.raises(ValueError, match="relabel"):
        tsp.build_hybrid_w(torch.zeros((3, 4), dtype=torch.int32),
                           np.array([1, 9, 2]), threshold=4)


@pytest.mark.parametrize("K", [1_000, 10_000, 32_768])
def test_byte_models_match_reference_on_pubmed(K):
    counts = _zipf_counts(PUBMED_WORDS, PUBMED_TOKENS)
    assert tsp.bytes_hybrid(counts, K) == jsp.bytes_hybrid(counts, K)
    assert tsp.bytes_dense(PUBMED_WORDS, K) == jsp.bytes_dense(PUBMED_WORDS,
                                                               K)
    tail = np.minimum(counts, K)
    assert tsp.bytes_bucketed(tail, K) == jsp.bytes_bucketed(tail, K)
    assert tsp.bytes_pair_csr(tail) == jsp.bytes_pair_csr(tail)
    hb = tsp.bytes_hybrid(counts, K)
    assert hb["total"] < tsp.bytes_dense(PUBMED_WORDS, K)


def test_convert_round_trip(skewed):
    K = 32
    W = _consistent_W(skewed, K)
    ref = jsp.build_hybrid_w(jnp.asarray(W), skewed.word_token_counts,
                             threshold=K)
    port = convert.hybrid_w_to_port(ref)
    arrays = convert.hybrid_w_to_numpy(port)
    back = jsp.HybridW(
        jnp.asarray(arrays["dense"]),
        jsp.BucketedSparse(tuple(map(jnp.asarray,
                                     arrays["sparse"]["buckets"])),
                           arrays["sparse"]["row_starts"],
                           arrays["sparse"]["capacities"]),
        arrays["v_dense"])
    assert back.v_dense == ref.v_dense
    assert back.sparse.row_starts == ref.sparse.row_starts
    assert back.sparse.capacities == ref.sparse.capacities
    assert _eq(back.dense, ref.dense)
    assert all(_eq(a, b) for a, b in zip(back.sparse.buckets,
                                         ref.sparse.buckets))
    assert np.array_equal(np.asarray(back.densify(K)), W)
    assert _eq(convert.hybrid_w_to_port(arrays).densify(K), W)
    # packed rows with free slots' stale idx bits and idx >= 32768
    rows = np.asarray(jsp.pack_pairs(jnp.asarray([[40_000, 3, 65_535]]),
                                     jnp.asarray([[2, 0, 0]])))
    t = convert.packed_rows_to_port(rows)
    assert t.dtype == torch.int32 and _eq(t, rows)
    assert np.array_equal(convert.packed_rows_to_numpy(t), rows)
