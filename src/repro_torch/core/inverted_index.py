"""Inverted index: the document view of the word-sorted token list.

Port of ``src/repro/core/inverted_index.py`` (paper Fig 5). ``T`` is
sorted by word; per-document passes (the D count rebuild of
``kernels/ops.py`` ``update_counts``, ``reconstruct_d_rows``) need the
tokens grouped by document. The index stores, per document, the
positions in T of its tokens; it is built once per corpus
(``Corpus.inv_token_idx``).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.kernels import histogram as hist

if TYPE_CHECKING:
    from repro_torch.lda.corpus import Corpus

__all__ = ["doc_major_order", "to_doc_major", "from_doc_major",
           "doc_segment_ids", "reconstruct_d_rows"]


def doc_major_order(corpus: Corpus) -> np.ndarray:
    """Positions in T grouped by document (the index of Fig 5(b))."""
    return corpus.inv_token_idx


def to_doc_major(values_by_token: torch.Tensor,
                 inv_token_idx: torch.Tensor) -> torch.Tensor:
    """Reorder a token-major array into document-major order."""
    return values_by_token[inv_token_idx.long()]


def from_doc_major(values_doc_major: torch.Tensor,
                   inv_token_idx: torch.Tensor,
                   n_tokens: int) -> torch.Tensor:
    """Scatter a document-major array back to token-major positions
    (slots no document lists stay 0)."""
    out = torch.zeros((n_tokens,) + tuple(values_doc_major.shape[1:]),
                      dtype=values_doc_major.dtype,
                      device=values_doc_major.device)
    out[inv_token_idx.long()] = values_doc_major
    return out


def doc_segment_ids(corpus: Corpus) -> np.ndarray:
    """(N,) doc id per doc-major slot: the row of each doc-major token."""
    return np.repeat(np.arange(corpus.n_docs, dtype=np.int32),
                     corpus.doc_lengths)


def reconstruct_d_rows(topics: torch.Tensor, inv_token_idx: torch.Tensor,
                       segment_ids: torch.Tensor, n_docs: int, n_topics: int,
                       *, plan=None) -> torch.Tensor:
    """Rebuild D by scanning the inverted index (paper §IV-C): the
    histogram of each document's topics, every token the index lists
    counted once.

    The document-major topics go through the ``histogram`` kernel (its
    plain twin for CPU tensors), as ``kernels/ops.py::update_counts``
    rebuilds D: the sorted route over the rows of ``segment_ids`` (the
    document of each doc-major slot, int32), or the any-order route where
    one row of ``n_topics`` counters does not fit a block. ``plan`` is the
    sorted route's ``RowBlocks`` of these rows (``ops.count_plans``' D
    plan), made here when not given. Bitwise equal to the reference's
    one-hot segment sum. Returns (n_docs, n_topics) int32.
    """
    t_doc = topics[inv_token_idx.long()].to(torch.int32).contiguous()
    ones = torch.ones_like(t_doc)
    if plan is None and hist.sorted_route_fits(n_topics):
        plan = hist.plan_row_blocks(hist.row_offsets(segment_ids, n_docs),
                                    n_topics)
    if plan is None:
        return hist.histogram(segment_ids, t_doc, ones, n_rows=n_docs,
                              n_topics=n_topics)
    return hist.histogram_sorted(t_doc, ones, plan)
