"""Corpus representation & preprocessing (NumPy, host side).

The port's own copy of the reference's corpus layer
(``src/repro/lda/corpus.py``): the same token list ``T`` sorted by word id,
the same frequency relabeling, the same inverted index, and the same
padding rule. Nothing here touches a device; the trainer moves the arrays
onto one.

``planted_corpus`` is new in the port: a vectorised generator for a
planted-topic corpus at the scale of the paper's NYTimes setting
(~300k documents, ~100k words, ~100 M tokens), where the per-document and
per-token loops of ``synthetic_lda_corpus`` would take hours.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "Corpus",
    "from_documents",
    "relabel_by_frequency",
    "synthetic_lda_corpus",
    "zipf_corpus",
    "pad_corpus",
    "planted_corpus",
]


@dataclasses.dataclass(frozen=True)
class Corpus:
    """A numerical corpus in EZLDA layout.

    ``word_ids``/``doc_ids`` form the token list ``T`` (topic assignments live
    in the trainer state, not here). Tokens are sorted by ``word_ids`` (stable,
    so tokens of one word keep document order) -- the paper's ``T`` layout.
    """

    word_ids: np.ndarray          # (N,) int32, sorted ascending
    doc_ids: np.ndarray           # (N,) int32
    n_words: int                  # V
    n_docs: int                   # M

    word_offsets: np.ndarray      # (V+1,) int64 CSR over T by word
    word_token_counts: np.ndarray # (V,)   int64
    doc_lengths: np.ndarray       # (M,)   int64
    inv_doc_offsets: np.ndarray   # (M+1,) int64 -- inverted index (Fig 5b)
    inv_token_idx: np.ndarray     # (N,)   int64 -- positions in T per document

    @property
    def n_tokens(self) -> int:
        return int(self.word_ids.shape[0])

    def documents(self) -> list[np.ndarray]:
        """Per-document word-id lists, each in T (word-sorted) order."""
        return [self.word_ids[self.inv_token_idx[
                    self.inv_doc_offsets[d]:self.inv_doc_offsets[d + 1]]]
                for d in range(self.n_docs)]

    def validate(self) -> None:
        if self.word_ids.shape != self.doc_ids.shape:
            raise ValueError("word_ids and doc_ids differ in shape")
        if np.any(np.diff(self.word_ids) < 0):
            raise ValueError("T must be sorted by wordId")
        if self.n_tokens and (self.word_ids.min() < 0
                              or self.word_ids.max() >= self.n_words
                              or self.doc_ids.min() < 0
                              or self.doc_ids.max() >= self.n_docs):
            raise ValueError("a word or doc id lies outside [0, V) x [0, M)")
        if self.inv_doc_offsets[-1] != self.n_tokens \
                or self.word_offsets[-1] != self.n_tokens:
            raise ValueError("index offsets do not cover the token list")
        # The inverted index must cover every token exactly once (a
        # permutation of arange(N)); bincount checks it in O(N), where
        # the reference's sort costs O(N log N) at 100 M tokens.
        idx = self.inv_token_idx
        if idx.shape[0] != self.n_tokens or (self.n_tokens and (
                idx.min() < 0 or idx.max() >= self.n_tokens
                or np.any(np.bincount(idx, minlength=self.n_tokens) != 1))):
            raise ValueError("inverted index is not a permutation of T")


def _build_indexes(word_ids: np.ndarray, doc_ids: np.ndarray, n_words: int,
                   n_docs: int) -> Corpus:
    word_token_counts = np.bincount(word_ids, minlength=n_words).astype(np.int64)
    word_offsets = np.zeros(n_words + 1, dtype=np.int64)
    np.cumsum(word_token_counts, out=word_offsets[1:])

    doc_lengths = np.bincount(doc_ids, minlength=n_docs).astype(np.int64)
    inv_doc_offsets = np.zeros(n_docs + 1, dtype=np.int64)
    np.cumsum(doc_lengths, out=inv_doc_offsets[1:])
    # Stable argsort by doc id gives, per document, its token positions in T.
    inv_token_idx = np.argsort(doc_ids, kind="stable").astype(np.int64)

    return Corpus(
        word_ids=word_ids.astype(np.int32),
        doc_ids=doc_ids.astype(np.int32),
        n_words=int(n_words),
        n_docs=int(n_docs),
        word_offsets=word_offsets,
        word_token_counts=word_token_counts,
        doc_lengths=doc_lengths,
        inv_doc_offsets=inv_doc_offsets,
        inv_token_idx=inv_token_idx,
    )


def from_documents(docs: Sequence[Sequence[int]], n_words: int) -> Corpus:
    """Build a Corpus from per-document word-id lists (Fig 1's numerical corpus)."""
    doc_ids = np.concatenate([
        np.full(len(d), i, dtype=np.int64) for i, d in enumerate(docs)
    ]) if docs else np.zeros(0, dtype=np.int64)
    word_ids = np.concatenate([np.asarray(d, dtype=np.int64) for d in docs]) \
        if docs else np.zeros(0, dtype=np.int64)
    order = np.argsort(word_ids, kind="stable")
    c = _build_indexes(word_ids[order], doc_ids[order], n_words, len(docs))
    c.validate()
    return c


def relabel_by_frequency(corpus: Corpus) -> tuple[Corpus, np.ndarray]:
    """Relabel words so higher-token-count words get smaller ids (SS IV-B).

    Returns (new_corpus, old_to_new) mapping.
    """
    order = np.argsort(-corpus.word_token_counts, kind="stable")
    old_to_new = np.empty_like(order)
    old_to_new[order] = np.arange(corpus.n_words)
    new_word_ids = old_to_new[corpus.word_ids]
    sort = np.argsort(new_word_ids, kind="stable")
    c = _build_indexes(new_word_ids[sort], corpus.doc_ids[sort],
                       corpus.n_words, corpus.n_docs)
    c.validate()
    return c, old_to_new


def synthetic_lda_corpus(seed: int, n_docs: int, n_words: int, n_topics: int,
                         mean_doc_len: int = 64,
                         topic_word_conc: float = 0.05,
                         doc_topic_conc: float = 0.2,
                         return_truth: bool = False):
    """Planted-topic corpus drawn exactly from the LDA graphical model.

    Same generator, draw for draw, as the reference's: one seed gives the
    same corpus in both packages.
    """
    rng = np.random.default_rng(seed)
    phi = rng.dirichlet(np.full(n_words, topic_word_conc), size=n_topics)  # (Kt,V)
    theta = rng.dirichlet(np.full(n_topics, doc_topic_conc), size=n_docs)  # (M,Kt)
    doc_lens = np.maximum(1, rng.poisson(mean_doc_len, size=n_docs))
    docs = []
    for d in range(n_docs):
        zs = rng.choice(n_topics, size=doc_lens[d], p=theta[d])
        ws = np.array([rng.choice(n_words, p=phi[z]) for z in zs], dtype=np.int64)
        docs.append(ws)
    corpus = from_documents(docs, n_words)
    if return_truth:
        return corpus, {"phi": phi, "theta": theta}
    return corpus


def zipf_corpus(seed: int, n_docs: int, n_words: int, exponent: float = 1.1,
                mean_doc_len: int = 64) -> Corpus:
    """Power-law word-frequency corpus (paper Fig 8's token distribution)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_words + 1, dtype=np.float64)
    p = ranks ** (-exponent)
    p /= p.sum()
    doc_lens = np.maximum(1, rng.poisson(mean_doc_len, size=n_docs))
    docs = [rng.choice(n_words, size=doc_lens[d], p=p) for d in range(n_docs)]
    return from_documents(docs, n_words)


def pad_corpus(corpus: Corpus, multiple: int) -> tuple[Corpus, np.ndarray]:
    """Pad T to a multiple of ``multiple`` tokens.

    Pad tokens use the *last* (max) word id, so T stays sorted by word, and
    doc 0, with a zero mask; they never touch the count matrices. Returns
    (padded corpus, mask) where mask is 1 for real tokens. The derived
    indexes describe only the real tokens.
    """
    n = corpus.n_tokens
    n_pad = (-n) % multiple
    if n_pad == 0:
        return corpus, np.ones(n, dtype=np.int32)
    pad_word = corpus.word_ids[-1] if n else np.int32(0)
    word_ids = np.concatenate([corpus.word_ids,
                               np.full(n_pad, pad_word, np.int32)])
    doc_ids = np.concatenate([corpus.doc_ids, np.zeros(n_pad, np.int32)])
    mask = np.concatenate([np.ones(n, np.int32), np.zeros(n_pad, np.int32)])
    padded = dataclasses.replace(corpus, word_ids=word_ids, doc_ids=doc_ids)
    return padded, mask


def planted_corpus(seed: int, n_docs: int, n_words: int, n_tokens: int, *,
                   n_planted: int = 1000, topics_per_doc: int = 4,
                   words_per_topic: int = 200, background: float = 0.3,
                   zipf_exponent: float = 1.05) -> Corpus:
    """Vectorised planted-topic corpus, already relabeled by frequency.

    Each document mixes ``topics_per_doc`` of ``n_planted`` topics with
    Dirichlet(1) weights. A token takes a background word from a global
    Zipf law with probability ``background``, else a word from its topic's
    own Zipf law over ``words_per_topic`` words drawn for that topic. Doc
    lengths are Poisson around ``n_tokens / n_docs``. Every step is a NumPy
    array operation, so 100 M tokens take seconds to a minute, not hours.

    The word ids are relabeled so that higher-count words get smaller ids
    (what ``relabel_by_frequency`` would produce), which lets the engine
    skip its own relabel pass.
    """
    rng = np.random.default_rng(seed)
    lens = np.maximum(1, rng.poisson(n_tokens / n_docs, size=n_docs))
    doc_ids = np.repeat(np.arange(n_docs, dtype=np.int32), lens)
    n = int(doc_ids.shape[0])

    # per-document topic slots and their cumulative Dirichlet weights
    doc_topics = rng.integers(0, n_planted, (n_docs, topics_per_doc),
                              dtype=np.int32)
    cum = np.cumsum(rng.dirichlet(np.ones(topics_per_doc), size=n_docs)
                    .astype(np.float32), axis=1)
    u = rng.random(n, dtype=np.float32)
    slot = (u[:, None] > cum[doc_ids]).sum(axis=1)
    np.minimum(slot, topics_per_doc - 1, out=slot)
    z = doc_topics[doc_ids, slot]
    del u, slot

    def zipf_ranks(size: int, n_ranks: int) -> np.ndarray:
        cdf = np.cumsum(np.arange(1, n_ranks + 1, dtype=np.float64)
                        ** -zipf_exponent)
        cdf /= cdf[-1]
        r = np.searchsorted(cdf, rng.random(size), side="right")
        return np.minimum(r, n_ranks - 1).astype(np.int32)

    topic_words = rng.integers(0, n_words, (n_planted, words_per_topic),
                               dtype=np.int32)
    word_ids = topic_words[z, zipf_ranks(n, words_per_topic)]
    del z
    bg = rng.random(n, dtype=np.float32) < background
    word_ids[bg] = rng.permutation(n_words).astype(np.int32)[
        zipf_ranks(int(bg.sum()), n_words)]
    del bg

    counts = np.bincount(word_ids, minlength=n_words)
    old_to_new = np.empty(n_words, np.int32)
    old_to_new[np.argsort(-counts, kind="stable")] = np.arange(
        n_words, dtype=np.int32)
    word_ids = old_to_new[word_ids]
    order = np.argsort(word_ids, kind="stable")
    c = _build_indexes(word_ids[order], doc_ids[order], n_words, n_docs)
    c.validate()
    return c
