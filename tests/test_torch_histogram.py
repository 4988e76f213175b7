"""The count rebuild: ``kernels/histogram.py`` (on the CPU: its plain
twins) against the Pallas kernel in interpret mode and its oracle, the
sorted route's plan and its plan-following twin against ``index_put_``
and both packages' ``esca.update_counts``, ``ops.update_counts`` against
both packages' ``esca.update_counts`` and the reference's
``kops.update_counts``, and ``core/inverted_index.py``.

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
from repro_torch.lda import LDAConfig, LDAEngine, LDATrainer
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


# (n, rows, K, block_tokens, row draw): empty rows, weight-0 tokens, rows
# split over several blocks, tokens in the first and last rows, K not a
# multiple of 4 or 32, ids outside [0, rows)
SORTED = [(3000, 50, 7, 64, "uniform"),        # every row split
          (2000, 400, 33, 128, "zipf"),        # split head, empty tail rows
          (500, 3, 1000, 8, "ends"),           # only the first and last rows
          (1000, 200, 1, 4096, "uniform"),     # K = 1, one block budget
          (0, 5, 4, 16, "uniform"),            # no tokens: rows of zeros
          (800, 30, 37, 16, "outside")]        # ids below 0 and past R


def _sorted_tokens(n, R, K, draw):
    rng = np.random.default_rng(n + R + K)
    if draw == "zipf":
        rows = np.minimum(rng.zipf(1.3, n) - 1, R - 1)
    elif draw == "ends":
        rows = np.where(rng.random(n) < 0.5, 0, R - 1)
    elif draw == "outside":
        rows = rng.integers(-3, R + 3, n)
    else:
        rows = rng.integers(0, R, n)
    rows = np.sort(rows).astype(np.int32)
    topics = rng.integers(0, K, n).astype(np.int32)
    w = (rng.random(n) < 0.8).astype(np.int32)
    return rows, topics, w


@pytest.mark.parametrize("n,R,K,bt,draw", SORTED)
def test_sorted_route_twin_bitwise(n, R, K, bt, draw):
    """The sorted route's twin follows its plan (owned rows and split rows
    written, tokens counted by block) and equals ``index_put_`` and the
    Pallas kernel's fold."""
    rows, topics, w = _sorted_tokens(n, R, K, draw)
    plan = hist.plan_row_blocks(hist.row_offsets(T(rows), R), K,
                                block_tokens=bt)
    got = hist.histogram_sorted(T(topics), T(w), plan)
    want = hist.histogram(T(rows), T(topics), T(w), n_rows=R, n_topics=K)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    if n:
        pallas = np.asarray(pallas_histogram(
            jnp.asarray(rows), jnp.asarray(topics), jnp.asarray(w),
            n_rows=R, n_topics=K, tile_t=512, rows_per_tile=8,
            interpret=True))
        assert np.array_equal(got.numpy(), pallas)
    if draw in ("uniform", "zipf") and bt < n // R:
        assert plan.split_rows.numel() > 0


@pytest.mark.parametrize("n,R,K,bt,draw", SORTED)
def test_plan_row_blocks_covers_rows_and_tokens_once(n, R, K, bt, draw):
    rows, _, _ = _sorted_tokens(n, R, K, draw)
    ptr = hist.row_offsets(T(rows), R)
    plan = hist.plan_row_blocks(ptr, K, block_tokens=bt)
    b = plan.blocks.numpy()
    p = ptr.numpy()
    assert b.shape[1] == 4 and plan.max_rows >= 1
    # blocks tile the token range [ptr[0], ptr[R]) in order
    assert np.array_equal(b[1:, 2], b[:-1, 3])
    assert b[0, 2] == p[0] and b[-1, 3] == p[R]
    # and the rows [0, R): a row is owned by one block or split into pieces
    lens = np.diff(p)
    split = lens > bt
    assert np.array_equal(plan.split_rows.numpy(), np.flatnonzero(split))
    owned = (p[b[:, 0]] == b[:, 2]) & (p[b[:, 1]] == b[:, 3])
    covered = np.zeros(R, int)
    for lo, hi in b[owned, :2]:
        covered[lo:hi] += 1
    assert np.array_equal(covered, (~split).astype(int))
    assert np.all(b[~owned, 1] - b[~owned, 0] == 1)
    assert np.all(split[b[~owned, 0]])
    # budgets: rows per block, tokens per block and per piece
    assert np.all(b[:, 1] - b[:, 0] <= plan.max_rows)
    assert np.all(b[owned, 3] - b[owned, 2] < 2 * bt)
    assert np.all(b[~owned, 3] - b[~owned, 2] <= bt)
    # a split row's pieces cover it exactly
    for r in np.flatnonzero(split):
        pieces = b[(~owned) & (b[:, 0] == r)]
        assert pieces[0, 2] == p[r] and pieces[-1, 3] == p[r + 1]


@pytest.mark.parametrize("K", [1, 33, 37, 1000, 1025, 1027, 1030])
def test_sorted_smem_covers_the_zeroing_pass(K):
    """A sorted-route block's shared reservation (``_sorted_smem``, as
    ``sorted_smem`` in the .cu) holds the row offsets and every int4 the
    zeroing pass clears: ceil((shift + rows·K) / 4) of them from the
    unshifted base, shift = (row_lo·K) mod 4, in blocks of ``max_rows``
    rows at every shift they reach."""
    R = 8 * max(1, hist.BLOCK_SMEM // (4 * K))
    rows = np.repeat(np.arange(R, dtype=np.int32), 3)
    plan = hist.plan_row_blocks(hist.row_offsets(T(rows), R), K,
                                block_tokens=1 << 20)
    b = plan.blocks.numpy()
    n_rows = b[:, 1] - b[:, 0]
    shift = (b[:, 0] * K) % 4
    full = n_rows == plan.max_rows
    assert set(shift[full]) == {j * plan.max_rows * K % 4 for j in range(4)}
    if K == 1025:                   # 11 rows of 1025: the widest overhang
        assert 3 in set(shift[full])
    ptrs = (plan.max_rows + 2) // 2 * 16
    zeroed = ptrs + (shift + n_rows * K + 3) // 4 * 16
    assert zeroed.max() <= hist._sorted_smem(plan.max_rows, K)


def test_sorted_route_rejects_what_it_cannot_take():
    rows, topics, w = _sorted_tokens(100, 5, 4, "uniform")
    plan = hist.plan_row_blocks(hist.row_offsets(T(rows), 5), 4)
    with pytest.raises(ValueError, match="int32"):
        hist.histogram_sorted(T(topics).long(), T(w), plan)
    with pytest.raises(ValueError, match="past the"):
        hist.histogram_sorted(T(topics[:50]), T(w[:50]), plan)
    with pytest.raises(ValueError, match="shared memory"):
        hist.plan_row_blocks(hist.row_offsets(T(rows), 5), 100_000)


def test_count_plans_offsets_match_the_corpus(small_corpus):
    """The CSR offsets of the trainer's plans, from the padded word ids
    and the doc-major segments, equal np.searchsorted on the corpus."""
    c = small_corpus
    tc = port_corpus(c)
    tr = LDATrainer(tc, LDAConfig(n_topics=16, tile_size=512,
                                  impl="kernel"), device="cpu")
    w_plan, d_plan = tr.count_plans
    probe = np.arange(c.n_words + 1)
    assert np.array_equal(w_plan.row_ptr.numpy(), np.searchsorted(
        tr.word_ids.numpy(), probe))
    last = int(c.word_ids[-1])             # padding extends only this row
    assert np.array_equal(w_plan.row_ptr.numpy()[:last + 1],
                          np.searchsorted(c.word_ids, probe[:last + 1]))
    seg = inverted_index.doc_segment_ids(tc)
    assert np.array_equal(d_plan.row_ptr.numpy(), np.searchsorted(
        seg, np.arange(c.n_docs + 1)))
    assert np.array_equal(np.diff(d_plan.row_ptr.numpy()), c.doc_lengths)
    assert w_plan.n_topics == d_plan.n_topics == 16


@pytest.mark.parametrize("K", [16, 37, 58_100, 58_101])
def test_sorted_update_counts_bitwise_vs_both_packages(small_corpus, K):
    """``ops.update_counts`` on the trainer's plans (the main path)
    against both packages' ``esca.update_counts``, with masked tokens;
    past K = 58,100 the trainer holds no plans and the any-order route
    (blocked by 128 topics) counts."""
    c = small_corpus
    tc = port_corpus(c)
    tr = LDATrainer(tc, LDAConfig(n_topics=K, tile_size=512, impl="kernel"),
                    device="cpu")
    assert (tr.count_plans == (None, None)) == (K > 58_100)
    rng = np.random.default_rng(K)
    topics = rng.integers(0, K, tr.word_ids.shape[0]).astype(np.int32)
    topics[::5] = K - 1
    mask = tr.mask.numpy().copy()
    mask[::7] = 0
    kw = dict(n_docs=c.n_docs, n_words=c.n_words, n_topics=K)
    D1, W1 = ops.update_counts(tr.word_ids, tr.doc_ids, T(topics), T(mask),
                               tr.inv_token_idx, tr.doc_segments,
                               plans=tr.count_plans, **kw)
    D0, W0 = esca.update_counts(tr.word_ids, tr.doc_ids, T(topics), T(mask),
                                **kw)
    Dj, Wj = jesca.update_counts(jnp.asarray(tr.word_ids.numpy()),
                                 jnp.asarray(tr.doc_ids.numpy()),
                                 jnp.asarray(topics), jnp.asarray(mask), **kw)
    assert torch.equal(D1, D0) and torch.equal(W1, W0)
    assert np.array_equal(D1.numpy(), np.asarray(Dj))
    assert np.array_equal(W1.numpy(), np.asarray(Wj))


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


def test_sorted_route_fit_is_pinned_at_its_cap():
    """One row of K = 58,100 counters fits a sorted-route block, 58,101
    does not: ``count_plans`` then records no plans instead of raising."""
    assert hist.sorted_route_fits(58_100) and not hist.sorted_route_fits(
        58_101)
    ids = T(np.repeat(np.arange(3, dtype=np.int32), 4))
    plans = ops.count_plans(ids, ids, n_docs=3, n_words=3, n_topics=58_100)
    assert all(p is not None and p.max_rows == 1 for p in plans)
    assert ops.count_plans(ids, ids, n_docs=3, n_words=3,
                           n_topics=58_101) == (None, None)


def test_engine_trains_past_the_sorted_route_cap_on_the_cpu():
    """``LDAEngine(..., LDAConfig(n_topics=58101, fused=True),
    device="cpu")`` constructs and trains (the reference does; the sorted
    route's plans used to refuse this K). The count rebuilds take the
    any-order route: the initial state and every count after ``fit(1)``
    are bitwise ``impl="torch"``'s (``esca.update_counts``), and so are
    the topics of ``fit(1)``."""
    K = 58_101
    rng = np.random.default_rng(7)
    docs = [rng.integers(0, 30, rng.integers(5, 25)) for _ in range(24)]
    engines = {impl: LDAEngine(docs, LDAConfig(n_topics=K, fused=True,
                                               tile_size=256, impl=impl),
                               device="cpu", n_words=30)
               for impl in ("kernel", "torch")}
    tk, tt = engines["kernel"].trainer, engines["torch"].trainer
    assert tk.count_plans == (None, None)
    s0 = tk.init_state()
    for f in ("topics", "D", "W"):
        assert torch.equal(getattr(s0, f), getattr(tt.init_state(), f))
    for e in engines.values():
        h = e.fit(1)
        assert h["iteration"] == [1] and np.isfinite(h["llpt"]).all()
        st = e.state
        D, W = esca.update_counts(tk.word_ids, tk.doc_ids, st.topics,
                                  tk.mask, n_docs=tk.n_docs,
                                  n_words=tk.n_words, n_topics=K)
        assert torch.equal(st.D, D) and torch.equal(st.W, W)
        assert int(st.W.sum()) == tk.n_real_tokens
    assert torch.equal(engines["kernel"].state.topics,
                       engines["torch"].state.topics)
