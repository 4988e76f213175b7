"""Plain-PyTorch oracles for the port's kernels (the correctness contracts).

Port of ``src/repro/kernels/ref.py``: each function states its kernel's
math with straight tensor operations.
"""

from __future__ import annotations

import torch

from repro_torch.core import mh

__all__ = ["fused_word_stats", "sample_fused_stats_ref", "sample_fused_ref",
           "sample_sparse_ref", "q_fallback_ref", "warp_chain_ref",
           "histogram_ref", "histogram_partials_ref", "histogram_sorted_ref"]


def fused_word_stats(w_rows: torch.Tensor, *, alpha: float):
    """Per row of Ŵ: (K1 int32, a1, Q') with K1 the first maximal topic,
    a1 = w[K1] and Q' = α·(Σ_k w[k] − a1) — what ``word_stats`` holds per
    word (``k[:, 0]``, ``a[:, 0]``, ``q_prime``), from rows."""
    k1 = torch.argmax(w_rows, dim=1)                  # first max
    a1 = w_rows.gather(1, k1[:, None])[:, 0]
    return k1.to(torch.int32), a1, alpha * (w_rows.sum(dim=1) - a1)


def sample_fused_stats_ref(u: torch.Tensor, d_rows: torch.Tensor,
                           w_rows: torch.Tensor, k1: torch.Tensor,
                           a1: torch.Tensor, q_prime: torch.Tensor, *,
                           alpha: float):
    """Oracle for the ``sample_fused`` kernel: the exact three-branch draw
    (combined CDF) from the tokens' gathered D rows (N, K) int32 and Ŵ
    rows (N, K) float32 and their words' K1, a1 and Q' (N,). Returns
    (topic int32, M, S', Q')."""
    d = d_rows.float()
    w = w_rows
    k1 = k1.long()
    b1 = d.gather(1, k1[:, None])[:, 0]
    m = a1 * (b1 + alpha)
    s_p = (d * w).sum(dim=1) - a1 * b1
    x = u * (m + s_p + q_prime)
    in_m = x < m
    k_iota = torch.arange(w.shape[1], device=w.device)[None, :]
    mass = torch.where(k_iota != k1[:, None], (d + alpha) * w, 0.0)
    cdf = torch.cumsum(mass, dim=1)
    hit = cdf > (x - m)[:, None]
    found = hit.any(dim=1)
    first = torch.argmax(hit.to(torch.uint8), dim=1)
    topic = torch.where(in_m, k1,
                        torch.where(found, first, w.shape[1] - 1))
    return topic.to(torch.int32), m, s_p, q_prime


def sample_fused_ref(u: torch.Tensor, d_rows: torch.Tensor,
                     w_rows: torch.Tensor, *, alpha: float):
    """Oracle for kernels/sample_fused.py on the reference's signature
    (exact three-branch, combined CDF): K1, a1 and Q' come from the
    gathered Ŵ rows themselves. Returns (topic int32, M, S', Q')."""
    return sample_fused_stats_ref(u, d_rows, w_rows,
                                  *fused_word_stats(w_rows, alpha=alpha),
                                  alpha=alpha)


def sample_sparse_ref(u: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                      w_at_idx: torch.Tensor, k1: torch.Tensor,
                      a1: torch.Tensor, b1: torch.Tensor,
                      q_prime: torch.Tensor, *, alpha: float):
    """Oracle for kernels/sample_sparse.py (sparse-S' draw, O(L) per token).

    ``idx``/``val`` (N, L) are the unpacked D-row slots, ``w_at_idx`` Ŵ[v]
    at those slots; k1, a1, b1, Q' are per-token. Returns (topic, needs_q,
    S'); topic is -1 where needs_q (the draw fell into Q', which the
    caller finishes).

    A slot adds mass only if it is live: val > 0 and idx ≠ K1. The
    reference's oracle multiplies every slot, so an empty slot whose Ŵ
    gather is NaN (its wrapper's fill-mode gather at idx 0xFFFF) poisons
    S'; on finite inputs the two agree.
    """
    m = a1 * (b1 + alpha)
    live = (val > 0) & (idx != k1[:, None])
    p_s = torch.where(live, val.float() * w_at_idx, 0.0)
    s_p = p_s.sum(dim=1)
    x = u * (m + s_p + q_prime)
    in_m = x < m
    cdf = torch.cumsum(p_s, dim=1)
    hit = live & (cdf > (x - m)[:, None])
    found = hit.any(dim=1)
    slot = torch.argmax(hit.to(torch.uint8), dim=1)
    topic_s = idx.gather(1, slot[:, None])[:, 0]
    in_s = (~in_m) & found & (x < m + s_p)
    needs_q = (~in_m) & (~in_s)
    topic = torch.where(in_m, k1, torch.where(in_s, topic_s, -1))
    return topic.to(torch.int32), needs_q, s_p


def q_fallback_ref(u, topics, needs_q, s_prime, w_rows, k1, a1, b1,
                   q_prime, alpha):
    """The Q'-branch finish of the sparse draw (the reference's
    ``kernels/ops.py`` ``_q_fallback``): for the flagged tokens, the
    first topic whose running sum of α·Ŵ'[k] (``w_rows`` (C, K) with the
    K1 entry counted as 0) exceeds xq = u·(M+S'+Q') − M − S', clamped to
    K−1, with the kernel's own S' so that the target agrees with the
    needs_q decision. Returns (topics, needs_q, in_m)."""
    k_total = w_rows.shape[1]
    k_iota = torch.arange(k_total, device=w_rows.device)
    w_prime = torch.where(k_iota[None, :] == k1[:, None].long(), 0.0, w_rows)
    m = a1 * (b1 + alpha)
    xq = u * (m + s_prime + q_prime) - m - s_prime
    cq = torch.cumsum(alpha * w_prime, dim=1)
    topic_q = torch.clamp(
        torch.searchsorted(cq, xq[:, None].contiguous(), right=True)[:, 0],
        max=k_total - 1).to(torch.int32)
    topics = torch.where(needs_q, topic_q, topics)
    in_m = u * (m + s_prime + q_prime) < m
    return topics, needs_q, in_m


def warp_chain_ref(s0, doc, word, t_doc, u_draw, u_acc, D, W_hat, q, prob,
                   alias, *, alpha: float):
    """Oracle for the ``warp_chain`` kernel (kernels/sample_warp.py): the
    word proposals drawn from the alias tables ``prob``/``alias`` with
    ``u_draw`` (C, 2, N), then ``core/mh.py`` ``mh_chain`` over the rows
    D[doc], Ŵ[word] and q[word]. Returns (topics, accepted counts)."""
    t_word = mh.alias_draw(u_draw, word, prob, alias,
                           n_topics=W_hat.shape[1])
    look_d, look_w, look_q = mh.row_lookups(doc, word, D, W_hat, q)
    return mh.mh_chain(s0, t_doc, t_word, u_acc, lookup_d=look_d,
                       lookup_w=look_w, lookup_q=look_q, alpha=alpha)


def _in_range(row_ids, topics, n_rows, n_topics):
    return (row_ids >= 0) & (row_ids < n_rows) & (topics >= 0) \
        & (topics < n_topics)


def histogram_ref(row_ids: torch.Tensor, topics: torch.Tensor,
                  weights: torch.Tensor, *, n_rows: int, n_topics: int):
    """Oracle for kernels/histogram.py (the count-matrix rebuild):
    out[row, topic] += weight for every token, (n_rows, n_topics) int32.
    Tokens whose row or topic lies outside the matrix add nothing."""
    out = torch.zeros((n_rows, n_topics), dtype=torch.int32,
                      device=row_ids.device)
    ok = _in_range(row_ids, topics, n_rows, n_topics)
    out.index_put_((row_ids[ok].long(), topics[ok].long()),
                   weights[ok].to(torch.int32), accumulate=True)
    return out


def histogram_partials_ref(row_ids: torch.Tensor, topics: torch.Tensor,
                           weights: torch.Tensor, tile_bases: torch.Tensor,
                           *, n_topics: int, tile_t: int,
                           rows_per_tile: int):
    """Oracle for ``histogram_partials``: token tile c (tokens [c·T,
    (c+1)·T)) counts its tokens whose row lies in [base_c, base_c + R)
    into partial[c, row − base_c, topic] (adding the token's weight), and
    ``covered`` marks those tokens (weight > 0 and row in the window).
    Returns (partials (n_tiles, R, K) int32, covered (N,) bool)."""
    n = row_ids.shape[0]
    n_tiles = n // tile_t
    tile = torch.arange(n, device=row_ids.device) // tile_t
    rel = row_ids.long() - tile_bases.long()[tile]
    covered = (rel >= 0) & (rel < rows_per_tile) & (weights > 0)
    use = covered & (topics >= 0) & (topics < n_topics)
    partials = torch.zeros((n_tiles, rows_per_tile, n_topics),
                           dtype=torch.int32, device=row_ids.device)
    partials.index_put_((tile[use], rel[use], topics[use].long()),
                        weights[use].to(torch.int32), accumulate=True)
    return partials, covered


def _ranges(lo: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Concatenated aranges [lo[i], lo[i] + count[i])."""
    idx = torch.repeat_interleave(torch.arange(lo.shape[0],
                                               device=lo.device), count)
    first = torch.cumsum(count, 0) - count
    return lo[idx] + torch.arange(idx.shape[0], device=lo.device) \
        - first[idx]


def histogram_sorted_ref(topics: torch.Tensor, weights: torch.Tensor, plan):
    """Oracle for ``histogram_sorted``, following its plan
    (``kernels/histogram.py`` ``RowBlocks``): the rows each block owns and
    the split rows start at 0, then every block adds its tokens [tok_lo,
    tok_hi) at their rows (the CSR offsets) and topics. A row no block
    covers stays -1, and a token no block covers adds nothing, so a plan
    that misses or repeats rows or tokens shows. Returns (n_rows, K)
    int32."""
    k, row_ptr, blocks = plan.n_topics, plan.row_ptr, plan.blocks
    out = torch.full((row_ptr.shape[0] - 1, k), -1, dtype=torch.int32,
                     device=topics.device)
    row_lo, row_hi, tok_lo, tok_hi = blocks.unbind(1)
    owned = (row_ptr[row_lo] == tok_lo) & (row_ptr[row_hi] == tok_hi)
    out[_ranges(row_lo[owned], (row_hi - row_lo)[owned])] = 0
    out[plan.split_rows] = 0
    tok = _ranges(tok_lo, tok_hi - tok_lo)
    row = torch.searchsorted(row_ptr, tok, right=True) - 1
    t, w = topics[tok].long(), weights[tok]
    ok = (t >= 0) & (t < k) & (w != 0)
    out.index_put_((row[ok], t[ok]), w[ok].to(torch.int32), accumulate=True)
    return out
