"""Hierarchical workload balancing: equal-token tiles (paper §V-A).

Port of the single-device part of ``src/repro/core/balance.py``, in
NumPy as there. The word-sorted token list is cut into tiles of
``tile_size`` tokens: a tile packs many small words (the paper's dynamic
word-to-block assignment) and a large word spans many tiles (its
dissection). The per-tile word run is the second level of the paper's
two-level (word, region) index; the fused pipeline
(``train/lda_step.py``) recomputes it on the card for the live survivor
stream and uses this plan only for its first word window.

``assign_token_shards`` and ``load_imbalance`` belong to the multi-GPU
slice (ROADMAP.md Queue 1 #12).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from repro_torch.lda.corpus import Corpus

__all__ = ["TilePlan", "build_tiles", "build_tiles_from_word_ids",
           "tiles_spanned"]


@dataclasses.dataclass(frozen=True)
class TilePlan:
    tile_size: int
    n_tiles: int
    # Per tile: ids of the first/last word whose tokens appear in the tile.
    tile_first_word: np.ndarray    # (n_tiles,) int32
    tile_last_word: np.ndarray     # (n_tiles,) int32
    # Max distinct words any tile spans (static bound for kernel scratch).
    max_words_per_tile: int
    # Max tiles any single word spans (dissection depth).
    max_tiles_per_word: int


def tiles_spanned(offsets: np.ndarray, counts: np.ndarray,
                  tile_size: int) -> np.ndarray:
    """Exact number of tiles each word's token run overlaps.

    A word whose tokens occupy ``[offset, offset + count)`` of the
    word-sorted token list touches tiles ``offset // tile`` through
    ``(offset + count - 1) // tile`` inclusive — zero tiles for an absent
    word.
    """
    offsets = np.asarray(offsets, np.int64)
    counts = np.asarray(counts, np.int64)
    last = np.maximum(offsets + counts - 1, offsets)
    span = last // tile_size - offsets // tile_size + 1
    return np.where(counts > 0, span, 0)


def _plan(first: np.ndarray, last: np.ndarray, spans: np.ndarray,
          tile_size: int) -> TilePlan:
    words_per_tile = last - first + 1
    return TilePlan(
        tile_size=tile_size, n_tiles=int(first.shape[0]),
        tile_first_word=first, tile_last_word=last,
        max_words_per_tile=int(words_per_tile.max(initial=1)),
        max_tiles_per_word=int(spans.max(initial=1)))


def _tile_ends(word_ids: np.ndarray, n: int, tile_size: int):
    starts = np.arange(0, n, tile_size, dtype=np.int64)
    ends = np.minimum(starts + tile_size, n) - 1
    return (word_ids[starts].astype(np.int32),
            word_ids[ends].astype(np.int32))


def build_tiles_from_word_ids(word_ids: np.ndarray, tile_size: int,
                              n_tokens: int | None = None) -> TilePlan:
    """Tile any word-sorted id array (a corpus or a live survivor stream).

    ``n_tokens`` restricts the plan to a leading prefix of ``word_ids``.
    Tile t covers ``[t·tile, min((t+1)·tile, n))``: every token lands in
    exactly one tile, and no tile is empty. The word runs come from the
    run boundaries of the sorted ids (the reference takes ``np.unique``,
    which sorts again; on sorted ids the two agree).
    """
    if tile_size < 1:
        raise ValueError(f"tile_size={tile_size} must be >= 1")
    word_ids = np.asarray(word_ids)
    n = int(word_ids.shape[0]) if n_tokens is None else int(n_tokens)
    if n < 0 or n > word_ids.shape[0]:
        raise ValueError(
            f"n_tokens={n} outside [0, {word_ids.shape[0]}]")
    if n == 0:
        return TilePlan(tile_size=tile_size, n_tiles=0,
                        tile_first_word=np.zeros(0, np.int32),
                        tile_last_word=np.zeros(0, np.int32),
                        max_words_per_tile=1, max_tiles_per_word=1)
    w = word_ids[:n].astype(np.int64)
    step = np.diff(w)
    if np.any(step < 0):
        raise ValueError("word_ids must be sorted ascending (the word-"
                         "sorted token list T) to build a tile plan")
    offs = np.concatenate([[0], np.flatnonzero(step) + 1])
    cnts = np.diff(np.append(offs, n))
    first, last = _tile_ends(word_ids, n, tile_size)
    return _plan(first, last, tiles_spanned(offs, cnts, tile_size),
                 tile_size)


def build_tiles(corpus: "Corpus", tile_size: int) -> TilePlan:
    """Static tile plan over a corpus's word-sorted token list, with the
    exact per-word dissection depth from the corpus CSR offsets."""
    if tile_size < 1:
        raise ValueError(f"tile_size={tile_size} must be >= 1")
    n = corpus.n_tokens
    if n == 0:
        return build_tiles_from_word_ids(corpus.word_ids, tile_size)
    first, last = _tile_ends(corpus.word_ids, n, tile_size)
    spans = tiles_spanned(corpus.word_offsets[:-1],
                          corpus.word_token_counts, tile_size)
    return _plan(first, last, spans, tile_size)
