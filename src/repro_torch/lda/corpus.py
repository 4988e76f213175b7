"""Corpus representation & preprocessing (NumPy, host side).

The port's own copy of the reference's corpus layer
(``src/repro/lda/corpus.py``): the same token list ``T`` sorted by word id,
the same frequency relabeling, the same inverted index, and the same
padding rule. Nothing here touches a device; the trainer moves the arrays
onto one.

``ShardedCorpus`` and ``shard_stream`` tile the padded token list into the
equal epoch shards that the streaming pipelines move through the device
one at a time (``corpus_residency="streamed"``); ``ShardedCorpus.to_store``
writes them out as the disk-native corpus store (``lda/storage.py``). For
the same corpus, shard count and multiple their arrays are bitwise the
reference's. ``chunk_documents`` is the distributed trainer's greedy
document chunking (``lda/distributed.py``), the reference's.

``planted_corpus`` is new in the port: a vectorised generator for a
planted-topic corpus at the scale of the paper's NYTimes setting
(~300k documents, ~100k words, ~100 M tokens), where the per-document and
per-token loops of ``synthetic_lda_corpus`` would take hours.
"""

from __future__ import annotations

import dataclasses
import heapq
import zlib
from typing import Sequence

import numpy as np

__all__ = [
    "Corpus",
    "ShardedCorpus",
    "from_documents",
    "relabel_by_frequency",
    "synthetic_lda_corpus",
    "zipf_corpus",
    "chunk_documents",
    "pad_corpus",
    "planted_corpus",
    "shard_stream",
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


def _stable_argsort(keys: np.ndarray) -> np.ndarray:
    """``np.argsort(keys, kind="stable")`` of non-negative integer keys
    below 2**32, as 16-bit radix passes (NumPy's stable sort is a radix
    sort only for keys of 16 bits or fewer): the same permutation, about
    twice as fast on 10 M keys."""
    k = keys.astype(np.uint32, copy=False)
    order = np.argsort((k & 0xFFFF).astype(np.uint16), kind="stable")
    if k.size and int(k.max()) >> 16:
        order = order[np.argsort((k >> 16).astype(np.uint16)[order],
                                 kind="stable")]
    return order


def _build_indexes(word_ids: np.ndarray, doc_ids: np.ndarray, n_words: int,
                   n_docs: int) -> Corpus:
    word_token_counts = np.bincount(word_ids, minlength=n_words).astype(np.int64)
    word_offsets = np.zeros(n_words + 1, dtype=np.int64)
    np.cumsum(word_token_counts, out=word_offsets[1:])

    doc_lengths = np.bincount(doc_ids, minlength=n_docs).astype(np.int64)
    inv_doc_offsets = np.zeros(n_docs + 1, dtype=np.int64)
    np.cumsum(doc_lengths, out=inv_doc_offsets[1:])
    # Stable argsort by doc id gives, per document, its token positions in T.
    inv_token_idx = _stable_argsort(doc_ids).astype(np.int64)

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
    sort = _stable_argsort(new_word_ids)
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


def chunk_documents(corpus: Corpus, n_chunks: int) -> np.ndarray:
    """Greedy token-balanced document->chunk assignment (SS V-B).

    The paper observes <=5% max/min token imbalance from round-robin; greedy
    longest-processing-time packing does at least as well deterministically.
    Returns (M,) int32 chunk id per document.
    """
    order = np.argsort(-corpus.doc_lengths, kind="stable")
    # a heap of (load, chunk): its top is np.argmin of the loads, the
    # lowest chunk among equal loads
    heap = [(0, c) for c in range(n_chunks)]
    chunks = []
    for n in corpus.doc_lengths[order].tolist():
        load, c = heapq.heappop(heap)
        chunks.append(c)
        heapq.heappush(heap, (load + n, c))
    assign = np.zeros(corpus.n_docs, dtype=np.int32)
    assign[order] = chunks
    return assign


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


@dataclasses.dataclass(frozen=True)
class ShardedCorpus:
    """Word-sorted token shards for out-of-core (streamed) training.

    The padded, word-sorted token stream ``T`` cut into ``n_shards``
    contiguous slices of ``shard_len`` tokens, so that an epoch streams
    them through the device one (double-buffered) shard at a time while D
    and W stay resident. Shard ``s`` covers padded stream positions
    ``[s·shard_len, (s+1)·shard_len)``; positions past ``n_padded`` (the
    resident path's padded length, which is also the length of an
    iteration's uniform draw) are extra pad slots with mask 0.

    Per shard: its word run (``first_word``/``last_word``, the W rows it
    touches; ``last_word == first_word - 1`` for a shard without real
    tokens) and, built lazily and cached, a CSR by word
    (``word_offsets``), an inverted index over its real slots
    (``inv_doc_offsets``/``inv_token_idx``) and crc32 checksums
    (``shard_checksums``). The training pipelines read none of the lazy
    ones.
    """

    n_shards: int
    shard_len: int                # L — uniform padded slice length
    n_padded: int                 # resident padded stream length (u length)
    n_tokens: int                 # real tokens (== corpus.n_tokens)
    n_words: int
    n_docs: int
    word_ids: np.ndarray          # (S, L) int32 — word-sorted within shard
    doc_ids: np.ndarray           # (S, L) int32
    mask: np.ndarray              # (S, L) int32 — 1 = real token
    first_word: np.ndarray        # (S,) int32
    last_word: np.ndarray         # (S,) int32 (== first-1 for empty shards)

    def _cached(self, name: str, build):
        value = self.__dict__.get(name)
        if value is None:
            value = build()
            object.__setattr__(self, name, value)
        return value

    @property
    def word_offsets(self) -> np.ndarray:
        """(S, V+1) int64 — per-shard CSR by word."""
        def build():
            out = np.zeros((self.n_shards, self.n_words + 1), np.int64)
            for s in range(self.n_shards):
                real = int(self.real_per_shard[s])
                counts = np.bincount(self.word_ids[s, :real],
                                     minlength=self.n_words)
                np.cumsum(counts.astype(np.int64), out=out[s, 1:])
            return out
        return self._cached("_word_offsets", build)

    @property
    def inv_doc_offsets(self) -> np.ndarray:
        """(S, M+1) int64 — per-shard CSR by doc."""
        return self._inverted()[0]

    @property
    def inv_token_idx(self) -> np.ndarray:
        """(S, L) int64 — shard-local token positions in doc order (the
        tail past the shard's real count holds the sentinel L)."""
        return self._inverted()[1]

    def _inverted(self) -> tuple[np.ndarray, np.ndarray]:
        def build():
            S, L, M = self.n_shards, self.shard_len, self.n_docs
            offs = np.zeros((S, M + 1), np.int64)
            idx = np.full((S, L), L, np.int64)
            for s in range(S):
                real = int(self.real_per_shard[s])
                d = self.doc_ids[s, :real]
                counts = np.bincount(d, minlength=M).astype(np.int64)
                np.cumsum(counts, out=offs[s, 1:])
                idx[s, :real] = _stable_argsort(d)
            return offs, idx
        return self._cached("_inv_cache", build)

    @property
    def global_lo(self) -> np.ndarray:
        """(S,) int64 — shard s's start offset in the padded stream."""
        return np.arange(self.n_shards, dtype=np.int64) * self.shard_len

    @property
    def real_per_shard(self) -> np.ndarray:
        """(S,) int64 — REAL (unpadded) tokens per shard."""
        return np.clip(self.n_tokens - self.global_lo, 0, self.shard_len)

    @staticmethod
    def slice_checksum(word_ids: np.ndarray, doc_ids: np.ndarray,
                       mask: np.ndarray) -> int:
        """crc32 over one shard slice's (word, doc, mask) bytes."""
        crc = zlib.crc32(np.ascontiguousarray(word_ids))
        crc = zlib.crc32(np.ascontiguousarray(doc_ids), crc)
        return zlib.crc32(np.ascontiguousarray(mask), crc)

    @property
    def shard_checksums(self) -> np.ndarray:
        """(S,) uint32 — per-shard crc32 over (word, doc, mask) bytes."""
        def build():
            out = np.zeros(self.n_shards, np.uint32)
            for s in range(self.n_shards):
                out[s] = self.slice_checksum(
                    self.word_ids[s], self.doc_ids[s], self.mask[s])
            return out
        return self._cached("_shard_checksums", build)

    def validate(self, deep: bool = False) -> None:
        """Invariant checks, O(tokens); ``deep=True`` also checks the lazy
        index slices (and so builds them)."""
        def need(ok, what):
            if not ok:
                raise ValueError(f"ShardedCorpus: {what}")

        need(self.word_ids.shape == (self.n_shards, self.shard_len),
             "word_ids is not (n_shards, shard_len)")
        need(self.n_shards * self.shard_len >= self.n_padded,
             "the shards do not cover the padded stream")
        # exact cover: the masked slots are the first n_tokens, in order
        flat_mask = self.mask.reshape(-1)
        need(int(flat_mask.sum()) == self.n_tokens
             and np.array_equal(np.nonzero(flat_mask)[0],
                                np.arange(self.n_tokens)),
             "the real slots are not the first n_tokens of the stream")
        for s in range(self.n_shards):
            real = int(self.real_per_shard[s])
            w = self.word_ids[s, :real]
            need(np.all(np.diff(w) >= 0), f"shard {s} is not word-sorted")
            if real:
                need(self.first_word[s] == w[0]
                     and self.last_word[s] == w[-1],
                     f"shard {s}'s word run disagrees with its slice")
            if not deep:
                continue
            counts = np.bincount(w, minlength=self.n_words).astype(np.int64)
            need(np.array_equal(np.diff(self.word_offsets[s]), counts),
                 f"shard {s}'s word CSR disagrees with its slice")
            idx = self.inv_token_idx[s, :real]
            offs = self.inv_doc_offsets[s]
            expect = np.repeat(np.arange(self.n_docs, dtype=np.int64),
                               np.diff(offs))
            need(np.array_equal(np.sort(idx), np.arange(real))
                 and offs[-1] == real
                 and np.array_equal(self.doc_ids[s, idx].astype(np.int64),
                                    expect),
                 f"shard {s}'s inverted index disagrees with its slice")

    def to_store(self, path: str):
        """Write this stream out as an on-disk corpus store and return the
        opened ``lda.storage.CorpusStore``; ``from_store`` reads it back
        bitwise."""
        from repro_torch.lda import storage  # storage imports this module

        return storage.write_store(self, path)

    @staticmethod
    def from_store(path_or_store) -> "ShardedCorpus":
        """Load a corpus store wholly back into host memory, every shard
        crc32-checked by ``CorpusStore.read_shard``."""
        from repro_torch.lda import storage  # storage imports this module

        store = (path_or_store
                 if isinstance(path_or_store, storage.CorpusStore)
                 else storage.CorpusStore.open(path_or_store))
        S, L = store.n_shards, store.shard_len
        arrays = [np.zeros((S, L), np.int32) for _ in range(3)]
        for s in range(S):
            for a, got in zip(arrays, store.read_shard(s)):
                a[s] = got
        out = ShardedCorpus(
            n_shards=S, shard_len=L, n_padded=store.n_padded,
            n_tokens=store.n_tokens, n_words=store.n_words,
            n_docs=store.n_docs, word_ids=arrays[0], doc_ids=arrays[1],
            mask=arrays[2], first_word=np.asarray(store.first_word, np.int32),
            last_word=np.asarray(store.last_word, np.int32))
        out.validate()
        return out


def shard_stream(corpus: Corpus, n_shards: int,
                 multiple: int = 1) -> ShardedCorpus:
    """Tile the padded word-sorted token stream into epoch shards.

    The stream is padded first exactly as ``pad_corpus(corpus,
    multiple)`` pads it (``multiple`` is the trainer's ``tile_size``), so
    an epoch's uniform draw of length ``n_padded`` and the shard slices
    line up with the resident token array. Each shard is padded to the
    common ``shard_len`` (a multiple of ``multiple``) with mask-0 slots
    carrying the largest word id, so every shard stays word-sorted.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards} must be >= 1")
    padded, mask = pad_corpus(corpus, multiple)
    n_pad = padded.n_tokens
    shard_len = -(-n_pad // n_shards)
    shard_len = max(-(-shard_len // multiple) * multiple, multiple)
    total = n_shards * shard_len
    pad_word = padded.word_ids[-1] if n_pad else np.int32(0)

    def extend(arr, fill):
        out = np.full(total, fill, arr.dtype)
        out[:n_pad] = arr
        return out.reshape(n_shards, shard_len)

    word_ids = extend(padded.word_ids.astype(np.int32), pad_word)
    doc_ids = extend(padded.doc_ids.astype(np.int32), 0)
    mask_sh = extend(mask.astype(np.int32), 0)

    first = np.zeros(n_shards, np.int32)
    last = np.full(n_shards, -1, np.int32)
    for s in range(n_shards):
        real = int(np.clip(corpus.n_tokens - s * shard_len, 0, shard_len))
        if real:
            first[s] = word_ids[s, 0]
            last[s] = word_ids[s, real - 1]

    sc = ShardedCorpus(
        n_shards=n_shards, shard_len=shard_len, n_padded=n_pad,
        n_tokens=corpus.n_tokens, n_words=corpus.n_words,
        n_docs=corpus.n_docs, word_ids=word_ids, doc_ids=doc_ids,
        mask=mask_sh, first_word=first, last_word=last)
    sc.validate()
    return sc


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
    # the slots whose cumulative weight lies below u (doc_ids is lens'
    # runs, so a doc's weight repeats over its tokens)
    slot = np.zeros(n, np.int64)
    for j in range(topics_per_doc):
        slot += u > np.repeat(cum[:, j], lens)
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
    order = _stable_argsort(word_ids)
    c = _build_indexes(word_ids[order], doc_ids[order], n_words, n_docs)
    c.validate()
    return c
