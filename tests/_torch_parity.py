"""Shared helpers for the parity tests between ``repro`` and ``repro_torch``.

Tolerances (stated once, used by every ``test_torch_*`` file):

* integer stages (counts, indices, skip decisions, ranks) must be equal;
* branch masses M, S', Q' are float32 sums over K topics taken in another
  order by each implementation: ``MASS_RTOL`` relative, plus
  ``MASS_ATOL_FRAC`` of the token's total mass for S', which subtracts
  a1·b1 from ΣD∘Ŵ and so can cancel;
* a sampled topic may differ only where the draw x − M (x for the
  two-branch draw) lies within ``BOUNDARY_FRAC`` of the total mass of a
  CDF boundary (float32 sums of K ≤ 2048 terms in two orders differ by
  well under 1e-5 relative), and such tokens must stay rare
  (``MAX_MISMATCH_FRAC``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

MASS_RTOL = 1e-5
MASS_ATOL_FRAC = 1e-6
BOUNDARY_FRAC = 1e-5
MAX_MISMATCH_FRAC = 0.01


def port_corpus(corpus):
    """The same corpus arrays as a ``repro_torch`` Corpus."""
    from repro_torch.lda.corpus import Corpus
    return Corpus(**{f.name: np.asarray(getattr(corpus, f.name))
                     if isinstance(getattr(corpus, f.name), np.ndarray)
                     else getattr(corpus, f.name)
                     for f in dataclasses.fields(Corpus)})


def row_total(d_rows, w_rows, alpha):
    """float64 total mass Σ_k (D[k]+α)·Ŵ[k] per token."""
    d = np.asarray(d_rows, np.float64)
    w = np.asarray(w_rows, np.float64)
    return ((d + alpha) * w).sum(axis=1)


def assert_masses_close(got, want, total, *, cancels=False):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = MASS_ATOL_FRAC * np.asarray(total) if cancels else 0.0
    bad = np.abs(got - want) > MASS_RTOL * np.abs(want) + atol
    assert not bad.any(), (int(bad.sum()), got[bad][:5], want[bad][:5])


def boundary_distance(u, d_rows, w_rows, alpha, t_a, t_b):
    """Distance, as a fraction of the total mass, from the float64 draw to
    the CDF boundary that separates topics t_a and t_b of one token."""
    d = np.asarray(d_rows, np.float64)
    w = np.asarray(w_rows, np.float64)
    k1 = int(np.argmax(w))
    m = w[k1] * (d[k1] + alpha)
    mass = (d + alpha) * w
    mass[k1] = 0.0
    cum = np.cumsum(mass)
    total = m + cum[-1]
    x = float(u) * total
    if k1 in (t_a, t_b):                  # M branch against the sweep
        dist = abs(x - m)
    else:
        dist = abs(x - m - cum[min(t_a, t_b)])
    if len(w) - 1 in (t_a, t_b):          # the undershoot clamp to K-1
        dist = min(dist, abs(x - total))
    return dist / total


def assert_topics_agree(u, d_rows, w_rows, alpha, got, want, *,
                        max_mismatch_frac=MAX_MISMATCH_FRAC):
    """Topics equal except rare tokens sitting on a CDF boundary.

    Draws packed at the end of the CDF (u near 1) meet the crowded
    boundaries of its last, lightest topics; callers pass
    ``max_mismatch_frac=1`` there and keep only the boundary test.
    Returns the number of such tokens.
    """
    got, want = np.asarray(got), np.asarray(want)
    diff = np.flatnonzero(got != want)
    assert diff.size <= max(1, max_mismatch_frac * got.size), diff.size
    for i in diff:
        dist = boundary_distance(u[i], d_rows[i], w_rows[i], alpha,
                                 int(got[i]), int(want[i]))
        assert dist <= BOUNDARY_FRAC, (int(i), got[i], want[i], dist)
    return int(diff.size)


def sparse_boundaries(idx, val, w_at, w_row, k1, a1, b1, q_prime, alpha):
    """float64 (M, boundaries, total) of one token's sparse three-branch
    draw: M, then M plus the running S' mass over its live slots, then
    M + S' plus the running Q' mass α·Ŵ'[k] over the topics (when the
    token's Ŵ row ``w_row`` is given)."""
    idx, val = np.asarray(idx), np.asarray(val)
    live = (val > 0) & (idx != k1)
    p = np.where(live, val * np.asarray(w_at, np.float64), 0.0)
    m = float(a1) * (float(b1) + alpha)
    s = p.sum()
    bounds = [m, *(m + np.cumsum(p))]
    if w_row is not None:
        wq = alpha * np.asarray(w_row, np.float64)
        wq[int(k1)] = 0.0
        bounds += list(m + s + np.cumsum(wq))
    total = m + s + float(q_prime)
    return m, np.asarray(bounds + [total]), total


def assert_sparse_draws_agree(u, idx, val, w_at, k1, a1, b1, q_prime, alpha,
                              got, want, *, w_rows=None,
                              max_mismatch_frac=MAX_MISMATCH_FRAC):
    """Sparse draws (topic, needs_q) equal except rare tokens whose draw
    lies within ``BOUNDARY_FRAC`` of the total mass of a CDF boundary
    (M, a live slot, S'|Q', or — with ``w_rows`` — a Q' topic). Returns
    the number of such tokens."""
    diff = np.zeros(len(u), bool)
    for g, w in zip(got, want):
        diff |= np.asarray(g) != np.asarray(w)
    diff = np.flatnonzero(diff)
    assert diff.size <= max(1, max_mismatch_frac * len(u)), diff.size
    for i in diff:
        _, bounds, total = sparse_boundaries(
            idx[i], val[i], w_at[i], None if w_rows is None else w_rows[i],
            k1[i], a1[i], b1[i], q_prime[i], alpha)
        x = float(u[i]) * total
        dist = np.min(np.abs(bounds - x)) / total
        assert dist <= BOUNDARY_FRAC, (int(i), dist)
    return int(diff.size)


def two_branch_distance(u, d_row, w_row, alpha, topic):
    """Distance, as a fraction of the total mass, from one token's float64
    two-branch draw x = u·(S + Q) to the draw interval of ``topic``: its
    slot in the S branch's CDF of D∘Ŵ or in the Q branch's of α·Ŵ after
    it (0 when x lies inside either; the last Q slot takes every x past
    the end, the reference's clamp)."""
    d = np.asarray(d_row, np.float64)
    w = np.asarray(w_row, np.float64)
    cdf = np.concatenate([np.cumsum(d * w), (d * w).sum()
                          + np.cumsum(alpha * w)])
    total = cdf[-1]
    x = float(u) * total
    k = len(w)
    dist = np.inf
    for c in (int(topic), k + int(topic)):
        lo = cdf[c - 1] if c else 0.0
        hi = np.inf if c == 2 * k - 1 else cdf[c]
        dist = min(dist, max(lo - x, x - hi, 0.0))
    return dist / total


def assert_two_branch_agree(u, d_rows, w_rows, alpha, got, want, *,
                            max_mismatch_frac=MAX_MISMATCH_FRAC):
    """Two-branch topics equal except rare tokens whose float64 draw lies
    within ``BOUNDARY_FRAC`` of the total mass of both topics' intervals.
    Returns the number of such tokens."""
    got, want = np.asarray(got), np.asarray(want)
    diff = np.flatnonzero(got != want)
    assert diff.size <= max(1, max_mismatch_frac * got.size), diff.size
    for i in diff:
        for t in (got[i], want[i]):
            dist = two_branch_distance(u[i], d_rows[i], w_rows[i], alpha, t)
            assert dist <= BOUNDARY_FRAC, (int(i), got[i], want[i], dist)
    return int(diff.size)
