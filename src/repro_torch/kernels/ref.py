"""Plain-PyTorch oracles for the port's kernels (the correctness contracts).

Port of ``src/repro/kernels/ref.py``: each function states its kernel's
math with straight tensor operations.
"""

from __future__ import annotations

import torch

from repro_torch.core import mh

__all__ = ["sample_fused_ref", "sample_sparse_ref", "warp_chain_ref",
           "histogram_ref", "histogram_partials_ref"]


def sample_fused_ref(u: torch.Tensor, d_rows: torch.Tensor,
                     w_rows: torch.Tensor, *, alpha: float):
    """Oracle for kernels/sample_fused.py (exact three-branch, combined CDF).

    ``d_rows`` (N, K) int32 and ``w_rows`` (N, K) float32 are the tokens'
    gathered D and Ŵ rows. Returns (topic int32, M, S', Q').
    """
    d = d_rows.float()
    w = w_rows
    k1 = torch.argmax(w, dim=1)                       # first max, int64
    a1 = w.gather(1, k1[:, None])[:, 0]
    b1 = d.gather(1, k1[:, None])[:, 0]
    m = a1 * (b1 + alpha)
    s_p = (d * w).sum(dim=1) - a1 * b1
    q_p = alpha * (w.sum(dim=1) - a1)
    x = u * (m + s_p + q_p)
    in_m = x < m
    k_iota = torch.arange(w.shape[1], device=w.device)[None, :]
    mass = torch.where(k_iota != k1[:, None], (d + alpha) * w, 0.0)
    cdf = torch.cumsum(mass, dim=1)
    hit = cdf > (x - m)[:, None]
    found = hit.any(dim=1)
    first = torch.argmax(hit.to(torch.uint8), dim=1)
    topic = torch.where(in_m, k1,
                        torch.where(found, first, w.shape[1] - 1))
    return topic.to(torch.int32), m, s_p, q_p


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
