"""Inverted index: the document view of the word-sorted token list.

Port of ``src/repro/core/inverted_index.py`` (paper Fig 5). ``T`` is
sorted by word; per-document passes (the D count rebuild of
``kernels/ops.py`` ``update_counts``) need the tokens grouped by
document. The index stores, per document, the positions in T of its
tokens; it is built once per corpus (``Corpus.inv_token_idx``).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:
    from repro_torch.lda.corpus import Corpus

__all__ = ["doc_major_order", "to_doc_major", "from_doc_major",
           "doc_segment_ids"]


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
