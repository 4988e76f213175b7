"""Wrappers that put the kernels to work on whole token lists.

Port of ``src/repro/kernels/ops.py``: ``sample_tokens``, the stepwise
``impl="kernel"`` sampler; ``sample_warp_tokens``, its warp counterpart;
the sparse tail draw of the hybrid state (``sparse_tail_draw``,
``sparse_tail_draw_tiled`` with the Q' finish ``ref.q_fallback_ref``, and
``sparse_tail_draw_rows``, whose kernel finishes the Q' branch itself);
and ``update_counts``, the count rebuild through the ``histogram``
kernels. The reference gathers rows for its Pallas kernels; here the
kernels gather their own rows, so one call covers every token.

The sparse tail draw leaves out a fault of the reference's: it gathers Ŵ
at the packed slot ids with ``jnp.take_along_axis``, whose default fill
mode returns NaN at the empty slots' idx 0xFFFF, so S' turns NaN, every
tail token is flagged for Q', and the Q' draw, fed a NaN target, clamps
it to topic K−1. Here an empty slot adds no mass (``sample_sparse``).

``sample_tokens_sparse_d`` is the stepwise sparse-D sampler (paper
§IV-C): every token drawn over packed D rows by ``sample_sparse_rows``,
which gathers its own rows and finishes the Q' branch, so neither the
reference's (N, L) row gather nor its (N, K) Ŵ gather is formed. The
kernel stops after the 32-slot step that holds the first ``EMPTY_IDX``
slot, which is exact while each row's ``EMPTY_IDX`` slots form a suffix:
``pack_rows_sorted`` makes them so, the ELL ops keep them so (inserts take
the lowest free slots), and ``build_sparse_rows`` has none below K =
65,535 (its spare slots carry zero-count columns), so on its rows the
kernel walks all L slots.
"""

from __future__ import annotations

import torch

from repro_torch.core import mh, three_branch
from repro_torch.core.sparse import EMPTY_IDX, unpack_pairs
from repro_torch.kernels import histogram as _hist
from repro_torch.kernels import sample_sparse as _sparse
from repro_torch.kernels import sample_warp as _warp
from repro_torch.kernels.ref import q_fallback_ref
from repro_torch.kernels.sample_fused import (sample_fused_rows, window_rows,
                                              word_stats_arrays)

__all__ = ["sample_tokens", "sample_warp_tokens", "sparse_tail_draw",
           "sparse_tail_draw_tiled", "sparse_tail_draw_rows",
           "sample_tokens_sparse_d", "count_plans", "update_counts"]


def sample_tokens(u: torch.Tensor, word_ids: torch.Tensor,
                  doc_ids: torch.Tensor, old_topics: torch.Tensor,
                  D: torch.Tensor, W_hat: torch.Tensor, *, alpha: float):
    """Exact three-branch draw for every token through the fused kernel.

    ``u`` is the (N,) uniform draw of this iteration. The kernel takes
    Ŵ's per-word K1, a1 and Q' (``word_stats_arrays``, equal to what the
    fused iteration's ``word_stats`` hands it). Returns (topics, stats)
    shaped like ``three_branch.sample``'s output.
    """
    f32 = torch.float32
    k1_w, a1_w, q_w = word_stats_arrays(W_hat, alpha=alpha)
    topics, m, s, q = sample_fused_rows(u, doc_ids, word_ids, D, W_hat,
                                        k1_w, a1_w, q_w, alpha=alpha)
    x = u * (m + s + q)
    in_m = x < m
    in_q = (~in_m) & (x >= m + s)                     # landed past S'
    k1 = k1_w[word_ids.long()]
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
    """``mh.sample_warp`` with the chain, doc proposals included, on the
    ``warp_chain`` kernel: one MH iteration over every token (the stepwise
    ``impl="kernel"`` warp sampler). Padding tokens keep their topic.
    Returns (topics, WarpStats)."""
    idx = torch.arange(topics.shape[0], device=topics.device) \
        if mask is None else (mask > 0).nonzero().squeeze(1)
    s, accepted = _warp.warp_chain_tokens(
        idx.to(torch.int32), topics, doc_ids, word_ids, u_doc, u_word, u_acc,
        D, W_hat, tables, index, alpha=alpha,
        out=(topics.clone(), torch.zeros(topics.shape, dtype=torch.uint8,
                                         device=topics.device)))
    return s, mh.warp_stats(mask, accepted > 0, s, topics, u_acc.shape[0])


def count_plans(word_ids, doc_segment_ids, *, n_docs: int, n_words: int,
                n_topics: int):
    """The sorted ``histogram`` route's plans for the count rebuild, static
    per corpus: W over the word-sorted token list, D over its doc-major
    order (``doc_segment_ids``, the document of each doc-major slot), each
    from its rows' CSR offsets. Returns (W plan, D plan), or (None, None)
    when one row of ``n_topics`` counters does not fit a block's shared
    memory: ``update_counts`` then takes the any-order route."""
    if not _hist.sorted_route_fits(n_topics):
        return None, None
    return tuple(_hist.plan_row_blocks(_hist.row_offsets(rows, n), n_topics)
                 for rows, n in ((word_ids, n_words),
                                 (doc_segment_ids, n_docs)))


def update_counts(word_ids, doc_ids, topics, mask, inv_token_idx,
                  doc_segment_ids, *, n_docs: int, n_words: int,
                  n_topics: int, plans=None):
    """Count rebuild through the ``histogram`` kernels: W over the
    word-sorted token list, D over its document-major order.

    ``inv_token_idx`` lists the tokens' positions by document (the
    inverted index, ``core/inverted_index.py``) and ``doc_segment_ids``
    the document of each of those slots; tokens it does not list (the
    padding) add nothing to D, and ``mask == 0`` tokens nothing to W.
    ``plans`` are ``count_plans`` of these ids (made here when not given;
    the trainer makes them once). With plans the sorted route counts;
    where K is too wide for it (plans of None) the any-order route,
    blocked by 128 topics, counts the same streams. Bitwise equal to
    ``esca.update_counts`` (the oracle) either way. ``doc_ids`` is
    unused, as in the reference: the document view comes from the index.
    Returns (D, W).
    """
    if plans is None:
        plans = count_plans(word_ids, doc_segment_ids, n_docs=n_docs,
                            n_words=n_words, n_topics=n_topics)
    w_plan, d_plan = plans
    w = (mask > 0).to(torch.int32)
    inv = inv_token_idx.long()
    t_doc, w_doc = topics[inv].contiguous(), w[inv].contiguous()
    if w_plan is None:
        W = _hist.histogram(word_ids, topics, w, n_rows=n_words,
                            n_topics=n_topics)
        D = _hist.histogram(doc_segment_ids, t_doc, w_doc, n_rows=n_docs,
                            n_topics=n_topics)
        return D, W
    return (_hist.histogram_sorted(t_doc, w_doc, d_plan),
            _hist.histogram_sorted(topics, w, w_plan))


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
    return q_fallback_ref(u, topics, needs_q, s_prime, w_rows, k1, a1, b1,
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
    return q_fallback_ref(u, topics, needs_q, s_prime, rows, k1_w[rows_v],
                          a1_w[rows_v], b1, q_prime_w[rows_v], alpha)


def sparse_tail_draw_rows(u, doc, word, D_packed, W_hat, k1_w, a1_w,
                          q_prime_w, b1, *, alpha: float, tiles=None,
                          win_words: int | None = None):
    """The main path's sparse tail draw over ids: one kernel launch
    (``tiles=(tile_first, tile_size)`` takes the tiled kernel) gathers its
    own rows and finishes the Q' branch itself, so the draw is done.

    Returns (topics, needs_q, in_m), as ``sparse_tail_draw``.
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
    m = a1_w[v] * (b1 + alpha)
    in_m = u * (m + s_prime + q_prime_w[v]) < m
    return topics, needs_q, in_m


def sample_tokens_sparse_d(u: torch.Tensor, word_ids: torch.Tensor,
                           doc_ids: torch.Tensor, old_topics: torch.Tensor,
                           packed_d_rows: torch.Tensor, D: torch.Tensor,
                           W_hat: torch.Tensor, *, alpha: float):
    """The stepwise sparse-D sampler (paper §IV-C): every token's exact
    three-branch draw in O(L) over its packed D row, the rare Q' branch
    finished against α·Ŵ'.

    ``u`` is the (N,) uniform draw; ``packed_d_rows`` (M, L) int32 packed
    ELL rows of D (``build_sparse_rows``, ``pack_rows_sorted`` or rows kept
    by the ELL ops: each row's ``EMPTY_IDX`` slots a suffix); ``D`` gives
    b1 = D[doc][K1]. One ``sample_sparse_rows`` launch on the card, its
    plain twin on the CPU. The M branch is x < M (exact masses), the Q'
    branch the kernel's needs_q, ``frac_at_max`` the tokens on K1.
    Returns (topics, ThreeBranchStats). K is at most 65,535: topic
    65,535 would pack like an ``EMPTY_IDX`` slot, which ends the row for
    the kernel in rows that are not sorted-packed.
    """
    if W_hat.shape[1] > EMPTY_IDX:
        raise ValueError(
            f"sample_tokens_sparse_d: K = {W_hat.shape[1]} > {EMPTY_IDX}: "
            f"topic {EMPTY_IDX} packs like an empty slot (EMPTY_IDX), "
            "where sample_sparse stops reading a row")
    f32 = torch.float32
    k1_w, a1_w, q_w = word_stats_arrays(W_hat, alpha=alpha)
    k1 = k1_w[word_ids.long()]
    b1 = D[doc_ids.long(), k1.long()].to(f32)
    topics, needs_q, in_m = sparse_tail_draw_rows(
        u, doc_ids, word_ids, packed_d_rows, W_hat, k1_w, a1_w, q_w, b1,
        alpha=alpha)
    stats = three_branch.ThreeBranchStats(
        frac_skipped=in_m.to(f32).mean(),             # kernel = exact path
        frac_m_final=in_m.to(f32).mean(),
        frac_unchanged=(topics == old_topics).to(f32).mean(),
        frac_at_max=(topics == k1).to(f32).mean(),
        frac_q_branch=needs_q.to(f32).mean(),
    )
    return topics, stats
