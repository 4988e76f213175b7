"""Wrappers that put the kernels to work on whole token lists.

Port of ``src/repro/kernels/ops.py``: ``sample_tokens``, the stepwise
``impl="kernel"`` sampler; ``sample_warp_tokens``, its warp counterpart;
the sparse tail draw of the hybrid state (``_q_fallback``,
``sparse_tail_draw``, ``sparse_tail_draw_tiled``); and ``update_counts``,
the count rebuild through the ``histogram`` kernel. The reference gathers
rows for its Pallas kernels; here the kernels gather their own rows, so
one call covers every token.

The sparse tail draw leaves out a fault of the reference's: it gathers Ŵ
at the packed slot ids with ``jnp.take_along_axis``, whose default fill
mode returns NaN at the empty slots' idx 0xFFFF, so S' turns NaN, every
tail token is flagged for Q', and the Q' draw, fed a NaN target, clamps
it to topic K−1. Here an empty slot adds no mass (``sample_sparse``).
``sample_tokens_sparse_d`` (the stepwise sparse-D sampler) is not ported
yet.
"""

from __future__ import annotations

import torch

from repro_torch.core import mh, three_branch
from repro_torch.core.sparse import unpack_pairs
from repro_torch.kernels import histogram as _hist
from repro_torch.kernels import sample_sparse as _sparse
from repro_torch.kernels import sample_warp as _warp
from repro_torch.kernels.sample_fused import sample_fused_rows, window_rows

__all__ = ["sample_tokens", "sample_warp_tokens", "sparse_tail_draw",
           "sparse_tail_draw_tiled", "sparse_tail_draw_rows",
           "update_counts"]

# Bytes of (C, K) float32 temporaries one Q' finish chunk may hold.
Q_FINISH_BYTES = 1 << 30


def sample_tokens(u: torch.Tensor, word_ids: torch.Tensor,
                  doc_ids: torch.Tensor, old_topics: torch.Tensor,
                  D: torch.Tensor, W_hat: torch.Tensor, *, alpha: float):
    """Exact three-branch draw for every token through the fused kernel.

    ``u`` is the (N,) uniform draw of this iteration. Returns (topics,
    stats) shaped like ``three_branch.sample``'s output.
    """
    f32 = torch.float32
    topics, m, s, q = sample_fused_rows(u, doc_ids, word_ids, D, W_hat,
                                        alpha=alpha)
    x = u * (m + s + q)
    in_m = x < m
    in_q = (~in_m) & (x >= m + s)                     # landed past S'
    k1 = torch.argmax(W_hat, dim=-1).to(torch.int32)[word_ids.long()]
    stats = three_branch.ThreeBranchStats(
        frac_skipped=in_m.to(f32).mean(),             # kernel = exact path
        frac_m_final=in_m.to(f32).mean(),
        frac_unchanged=(topics == old_topics).to(f32).mean(),
        frac_at_max=(topics == k1).to(f32).mean(),
        frac_q_branch=in_q.to(f32).mean(),
    )
    return topics, stats


def sample_warp_tokens(u_doc, u_word, u_acc, word_ids, doc_ids, topics, D,
                       W_hat, tables: mh.AliasTables, index: mh.DocIndex, *,
                       alpha: float, mask=None):
    """``mh.sample_warp`` with the chain on the ``warp_chain`` kernel: one
    MH iteration over every token (the stepwise ``impl="kernel"`` warp
    sampler). Padding tokens keep their topic. Returns (topics,
    WarpStats)."""
    t_doc = mh.doc_proposals(u_doc, topics, doc_ids, index,
                             n_topics=W_hat.shape[1], alpha=alpha)
    s, n_acc = _warp.warp_chain_rows(topics, doc_ids, word_ids, t_doc,
                                     u_word, u_acc, D, W_hat, tables,
                                     alpha=alpha)
    if mask is not None:
        real = mask > 0
        s = torch.where(real, s, topics)
        n_acc = torch.where(real, n_acc, 0)
    return s, mh.warp_stats(mask, n_acc > 0, s, topics, u_acc.shape[0])


def update_counts(word_ids, doc_ids, topics, mask, inv_token_idx,
                  doc_segment_ids, *, n_docs: int, n_words: int,
                  n_topics: int):
    """Count rebuild through the ``histogram`` kernel: W over the
    word-sorted token list, D over its document-major order.

    ``inv_token_idx`` lists the tokens' positions by document (the
    inverted index, ``core/inverted_index.py``) and ``doc_segment_ids``
    the document of each of those slots; tokens it does not list (the
    padding) add nothing to D, and ``mask == 0`` tokens nothing to W.
    Bitwise equal to ``esca.update_counts`` (the oracle). ``doc_ids`` is
    unused, as in the reference: the document view comes from the index.
    Returns (D, W).
    """
    w = (mask > 0).to(torch.int32)
    W = _hist.histogram(word_ids, topics, w, n_rows=n_words,
                        n_topics=n_topics)
    inv = inv_token_idx.long()
    D = _hist.histogram(doc_segment_ids, topics[inv].contiguous(),
                        w[inv].contiguous(), n_rows=n_docs,
                        n_topics=n_topics)
    return D, W


def _q_fallback(u, topics, needs_q, s_prime, w_rows, k1, a1, b1, q_prime,
                alpha):
    """Q'-branch finish: inverse CDF over α·Ŵ' for the flagged tokens.

    Uses the kernel's own S', so the target agrees with the needs_q
    decision. Returns (topics, needs_q, in_m).
    """
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


def _slot_gather(w_rows, packed_rows):
    """Ŵ rows (C, K) at the packed slot ids (C, L); empty slots give 0."""
    k = w_rows.shape[1]
    idx, _ = unpack_pairs(packed_rows)
    return torch.where(idx < k, torch.gather(
        w_rows, 1, torch.clamp(idx, max=k - 1).long()), 0.0)


def sparse_tail_draw(u, packed_rows, w_rows, k1, a1, b1, q_prime, *,
                     alpha: float):
    """One O(L) three-branch draw per token over pre-gathered rows (the
    reference's signature): ``sample_sparse`` for the M and S' branches,
    then the Q' finish. packed_rows (C, L); w_rows = Ŵ[word] (C, K);
    k1/a1/b1/q_prime per token. Returns (topics, needs_q, in_m)."""
    topics, needs_q, s_prime = _sparse.sample_sparse(
        u, packed_rows, _slot_gather(w_rows, packed_rows), k1, a1, b1,
        q_prime, alpha=alpha)
    return _q_fallback(u, topics, needs_q, s_prime, w_rows, k1, a1, b1,
                       q_prime, alpha)


def sparse_tail_draw_tiled(u, packed_rows, w_hat, word_ids, first_word,
                           k1_w, a1_w, q_prime_w, b1, *, alpha: float,
                           win_words: int):
    """Tile-scheduled sparse tail draw (the reference's signature): one
    tile of C tokens whose run starts at ``first_word``; Ŵ rows and word
    stats read through the tile's window. Bitwise equal to
    ``sparse_tail_draw`` on the per-token gathers."""
    v_total = w_hat.shape[0]
    win = min(int(win_words), v_total)
    first = torch.as_tensor(first_word, dtype=torch.int32).reshape(1).to(
        u.device)
    rows_v = window_rows(word_ids.long(), first.long(), max(u.shape[0], 1),
                         win, v_total)
    rows = w_hat[rows_v]
    topics, needs_q, s_prime = _sparse.sample_sparse_tiled(
        u, packed_rows, _slot_gather(rows, packed_rows), word_ids, first,
        k1_w, a1_w, q_prime_w, b1, alpha=alpha, win_words=win)
    return _q_fallback(u, topics, needs_q, s_prime, rows, k1_w[rows_v],
                       a1_w[rows_v], b1, q_prime_w[rows_v], alpha)


def sparse_tail_draw_rows(u, doc, word, D_packed, W_hat, k1_w, a1_w,
                          q_prime_w, b1, *, alpha: float, tiles=None,
                          win_words: int | None = None):
    """The main path's sparse tail draw over ids: the kernel gathers its
    own rows (``tiles=(tile_first, tile_size)`` takes the tiled kernel),
    then the Q' finish runs on the flagged tokens only, compacted, with
    their Ŵ rows gathered in chunks of at most ``Q_FINISH_BYTES``.

    Returns (topics, needs_q, in_m). Every value the finish reads is
    read by word id: for a tile that fits its window that is the row the
    tiled kernel read.
    """
    stats = (k1_w, a1_w, q_prime_w)
    if tiles is None:
        topics, needs_q, s_prime = _sparse.sample_sparse_rows(
            u, doc, word, D_packed, W_hat, *stats, b1, alpha=alpha)
    else:
        topics, needs_q, s_prime = _sparse.sample_sparse_tiled_rows(
            u, doc, word, tiles[0], tiles[1], D_packed, W_hat, *stats, b1,
            win_words=win_words, alpha=alpha)
    v = word.long()
    a1, qp = a1_w[v], q_prime_w[v]
    m = a1 * (b1 + alpha)
    in_m = u * (m + s_prime + qp) < m
    flagged = needs_q.nonzero().squeeze(1)
    step = max(1, Q_FINISH_BYTES // (12 * W_hat.shape[1]))
    for lo in range(0, flagged.shape[0], step):
        f = flagged[lo:lo + step]
        vf = v[f]
        topics[f] = _q_fallback(u[f], topics[f], needs_q[f], s_prime[f],
                                W_hat[vf], k1_w[vf], a1[f], b1[f], qp[f],
                                alpha)[0]
    return topics, needs_q, in_m
