"""Hierarchical workload balancing: equal-token tiles (paper §V-A).

Port of the single-device part of ``src/repro/core/balance.py``, in
NumPy as there. The word-sorted token list is cut into tiles of
``tile_size`` tokens: a tile packs many small words (the paper's dynamic
word-to-block assignment) and a large word spans many tiles (its
dissection). The per-tile word run is the second level of the paper's
two-level (word, region) index; the fused pipeline
(``train/lda_step.py``) recomputes it on the card for the live survivor
stream and uses this plan only for its first word window.

``assign_token_shards`` is the device-level assignment of the
distributed trainer's ``balance="tiles"`` (``lda/distributed.py``):
tokens go to data shards through word runs of the word-sorted list, a
word larger than the dissection threshold split across shards.
``load_imbalance`` is the reference's max/mean load of a scheduling
scheme. Both are the reference's, bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from repro_torch.lda.corpus import Corpus

__all__ = ["TilePlan", "build_tiles", "build_tiles_from_word_ids",
           "tiles_spanned", "assign_token_shards", "load_imbalance"]


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


def assign_token_shards(corpus: Corpus, n_shards: int,
                        dissect_threshold: int | None = None
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Device-level token-balanced shard assignment (paper SS V-A applied
    at shard granularity).

    Work units are word runs of the word-sorted token list; any word with
    more than ``dissect_threshold`` tokens is DISSECTED into contiguous
    pieces of at most that size (the paper's huge-word dissection), then
    units are packed greedy longest-processing-time onto shards. Every
    token is assigned through its unit, so per-shard loads are balanced
    even when one power-law head word dwarfs whole documents — the case
    greedy *document* chunking cannot fix (the head word rides inside many
    documents, but a single-document corpus or a corpus dominated by one
    word still serializes).

    ``dissect_threshold=None`` auto-sizes to ``ceil(n_tokens / (4·S))`` so
    no unit exceeds a quarter of a perfect shard load (max/mean <= 1.25 by
    LPT's bound, in practice ~1.0). Returns ``(token_shard (N,) int32,
    loads (S,) int64)``.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards} must be >= 1")
    n = corpus.n_tokens
    if dissect_threshold is None:
        dissect_threshold = max(1, -(-n // (4 * n_shards)))
    if dissect_threshold < 1:
        raise ValueError(
            f"dissect_threshold={dissect_threshold} must be >= 1")
    token_shard = np.zeros(n, np.int32)
    loads = np.zeros(n_shards, np.int64)
    if n == 0:
        return token_shard, loads
    # units: (start, size) spans of T — word runs, dissected at threshold
    starts: list[int] = []
    sizes: list[int] = []
    offs = corpus.word_offsets
    for v in range(corpus.n_words):
        o, e = int(offs[v]), int(offs[v + 1])
        while e - o > dissect_threshold:
            starts.append(o)
            sizes.append(dissect_threshold)
            o += dissect_threshold
        if e > o:
            starts.append(o)
            sizes.append(e - o)
    order = np.argsort(-np.asarray(sizes), kind="stable")    # LPT
    for i in order:
        s = int(np.argmin(loads))
        token_shard[starts[i]:starts[i] + sizes[i]] = s
        loads[s] += sizes[i]
    return token_shard, loads


def load_imbalance(corpus: Corpus, scheme: str, n_units: int,
                   tile_size: int = 4096,
                   dissect_threshold: int = 10_000) -> dict:
    """Max/mean load ratio for a scheduling scheme (benchmarks/fig15).

    Schemes:
      block_per_word    -- SaberLDA-style: unit u processes words u, u+P, ...
      dynamic           -- paper's atomic small-word balancing: greedy
                           longest-processing-time word->unit packing.
      dynamic+dissect   -- + large-word dissection at ``dissect_threshold``.
      token_tiles       -- this work: equal-token tiles round-robined.
    """
    counts = corpus.word_token_counts.astype(np.int64)
    loads = np.zeros(n_units, dtype=np.int64)
    if scheme == "block_per_word":
        for v, c in enumerate(counts):
            loads[v % n_units] += c
    elif scheme in ("dynamic", "dynamic+dissect"):
        work = list(counts)
        if scheme == "dynamic+dissect":
            pieces: list[int] = []
            for c in work:
                while c > dissect_threshold:
                    pieces.append(dissect_threshold)
                    c -= dissect_threshold
                if c:
                    pieces.append(c)
            work = pieces
        for c in sorted(work, reverse=True):
            loads[int(np.argmin(loads))] += c
    elif scheme == "token_tiles":
        n_tiles = (corpus.n_tokens + tile_size - 1) // tile_size
        for t in range(n_tiles):
            sz = min(tile_size, corpus.n_tokens - t * tile_size)
            loads[t % n_units] += sz
    else:
        raise ValueError(scheme)
    mean = loads.mean() if loads.mean() > 0 else 1.0
    return {"scheme": scheme, "max": int(loads.max()), "mean": float(mean),
            "imbalance": float(loads.max() / mean)}
