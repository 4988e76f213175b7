"""Disk-native corpus storage: the shard files are the corpus.

Port of ``src/repro/lda/storage.py``, in the same on-disk format, so that
each package opens the other's store. A corpus store is one directory:

    manifest.json     -- format version, shard count and length, padded
                         and real token counts, vocabulary and document
                         counts, each shard's word run (first_word /
                         last_word: the W rows it touches, which the paged
                         W window is planned from), its crc32, and the
                         shard file names
    corpus_meta.npz   -- word_token_counts (V,) and doc_lengths (M,): all
                         a HybridLayout needs beyond the manifest
    shard_00000.npz.. -- one uncompressed npz per epoch shard holding
                         word_ids / doc_ids / mask, each (shard_len,)
                         int32, word-sorted (a ShardedCorpus slice)

``read_shard`` checks every slice against the manifest's crc32, always; a
missing, truncated, foreign or bit-flipped shard file raises
``ShardCorruptionError`` naming the shard. Writes are atomic (a temporary
file, then ``os.replace``) and the manifest is written last, so a torn
write leaves a directory that refuses to open. A training load
(``read_shard(s, _chaos=True)``) runs an armed fault plan's hooks
(``runtime/chaos.py``) inside the file layer, as the reference does.
"""

from __future__ import annotations

import dataclasses
import json
import os
import uuid
import zipfile

import numpy as np

from repro_torch.lda.corpus import ShardedCorpus
from repro_torch.lda.invariants import ShardCorruptionError
from repro_torch.runtime import chaos

__all__ = ["CorpusStore", "CorpusMeta", "write_store",
           "MANIFEST_NAME", "META_NAME", "FORMAT_VERSION"]

MANIFEST_NAME = "manifest.json"
META_NAME = "corpus_meta.npz"
FORMAT_VERSION = 1

_SHARD_KEYS = ("word_ids", "doc_ids", "mask")


def _shard_name(s: int) -> str:
    return f"shard_{s:05d}.npz"


def _atomic_write(path: str, write_fn) -> None:
    """Write through a temporary file and ``os.replace``, so readers never
    see a torn file."""
    tmp = f"{path}.tmp-{uuid.uuid4().hex}"
    try:
        with open(tmp, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@dataclasses.dataclass(frozen=True)
class CorpusMeta:
    """The corpus-level metadata a store carries beyond the manifest: the
    ``Corpus`` attributes ``HybridLayout.build`` reads, so the hybrid
    pipelines plan their packed layout without a ``Corpus``."""
    word_token_counts: np.ndarray   # (V,) int64, non-increasing
    doc_lengths: np.ndarray         # (M,) int64
    n_words: int
    n_docs: int


class CorpusStore:
    """Read interface over one on-disk corpus directory.

    Carries the ``ShardedCorpus`` stream metadata (n_shards, shard_len,
    n_padded, n_tokens, n_words, n_docs, first_word, last_word,
    shard_checksums, real_per_shard), so the streaming pipelines take
    either; the token bytes come from ``read_shard``, one checked shard at
    a time.
    """

    def __init__(self, path: str, manifest: dict):
        self.path = str(path)
        v = manifest.get("format_version")
        if v != FORMAT_VERSION:
            raise ValueError(
                f"corpus store {self.path!r} has format_version={v!r}; "
                f"this build reads version {FORMAT_VERSION} — regenerate "
                "the store with ShardedCorpus.to_store()")
        self.n_shards = int(manifest["n_shards"])
        self.shard_len = int(manifest["shard_len"])
        self.n_padded = int(manifest["n_padded"])
        self.n_tokens = int(manifest["n_tokens"])
        self.n_words = int(manifest["n_words"])
        self.n_docs = int(manifest["n_docs"])
        self.first_word = np.asarray(manifest["first_word"], np.int32)
        self.last_word = np.asarray(manifest["last_word"], np.int32)
        self.shard_checksums = np.asarray(manifest["checksums"], np.uint32)
        self.shard_files = list(manifest["shards"])
        self._meta: CorpusMeta | None = None
        self.validate()

    @classmethod
    def open(cls, path: str) -> "CorpusStore":
        manifest_path = os.path.join(str(path), MANIFEST_NAME)
        try:
            with open(manifest_path, "r", encoding="utf-8") as f:
                manifest = json.load(f)
        except FileNotFoundError:
            raise FileNotFoundError(
                f"no corpus store at {path!r}: {MANIFEST_NAME} is missing "
                "(write one with ShardedCorpus.to_store(path), or check "
                "LDAConfig.corpus_path)") from None
        except (json.JSONDecodeError, OSError) as e:
            raise ValueError(
                f"corpus store manifest {manifest_path!r} is unreadable "
                f"({type(e).__name__}: {e}): the store was torn mid-write "
                "— regenerate it with ShardedCorpus.to_store()") from e
        return cls(path, manifest)

    def validate(self) -> None:
        """Manifest consistency; the shard bytes are checked by
        ``read_shard``."""
        S, L = self.n_shards, self.shard_len
        ok = (S >= 1 and L >= 1 and S * L >= self.n_padded
              and 0 <= self.n_tokens <= self.n_padded
              and len(self.shard_files) == S
              and self.shard_checksums.shape == (S,)
              and self.first_word.shape == (S,)
              and self.last_word.shape == (S,))
        if not ok:
            raise ValueError(
                f"corpus store {self.path!r} manifest is inconsistent "
                f"(n_shards={S}, shard_len={L}, n_padded={self.n_padded}, "
                f"n_tokens={self.n_tokens}, {len(self.shard_files)} shard "
                "files): regenerate the store with ShardedCorpus.to_store()")

    @property
    def real_per_shard(self) -> np.ndarray:
        lo = np.arange(self.n_shards, dtype=np.int64) * self.shard_len
        return np.clip(self.n_tokens - lo, 0, self.shard_len)

    @staticmethod
    def slice_checksum(word_ids, doc_ids, mask) -> int:
        return ShardedCorpus.slice_checksum(word_ids, doc_ids, mask)

    def nbytes(self) -> int:
        """Bytes of the store's files on disk."""
        names = [MANIFEST_NAME, META_NAME, *self.shard_files]
        return sum(os.path.getsize(os.path.join(self.path, n))
                   for n in names)

    def corpus_meta(self) -> CorpusMeta:
        if self._meta is None:
            meta_path = os.path.join(self.path, META_NAME)
            try:
                with np.load(meta_path) as z:
                    self._meta = CorpusMeta(
                        word_token_counts=np.asarray(
                            z["word_token_counts"], np.int64),
                        doc_lengths=np.asarray(z["doc_lengths"], np.int64),
                        n_words=self.n_words, n_docs=self.n_docs)
            except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
                raise ValueError(
                    f"corpus store {self.path!r}: {META_NAME} is missing "
                    f"or unreadable ({type(e).__name__}: {e}) — regenerate "
                    "the store with ShardedCorpus.to_store()") from e
        return self._meta

    def read_shard(self, s: int, *, _chaos: bool = False) -> tuple:
        """(word_ids, doc_ids, mask) of shard ``s``, crc32-checked.

        ``_chaos=True`` marks a training load: an armed fault plan's
        ``io_fault`` fires before the file is read and ``corrupt_arrays``
        between the read and the crc32 check (which runs always), under
        the prefetcher's retry loop, where a flaky disk would bite. The
        count folds and the LLPT read with ``_chaos=False``, so drills
        target the training stream only.
        """
        s = int(s)
        if not 0 <= s < self.n_shards:
            raise IndexError(
                f"shard {s} out of range for {self.n_shards}-shard store "
                f"{self.path!r}")
        if _chaos and chaos.armed():
            chaos.io_fault(s)
        fname = os.path.join(self.path, self.shard_files[s])
        try:
            with np.load(fname) as z:
                arrays = tuple(np.asarray(z[k], np.int32)
                               for k in _SHARD_KEYS)
        except FileNotFoundError:
            raise ShardCorruptionError(
                f"stream shard {s} is missing on disk "
                f"({self.shard_files[s]} not found in {self.path!r}): "
                "the store is incomplete — restore it from a replica or "
                "rewrite it with ShardedCorpus.to_store()") from None
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as e:
            raise ShardCorruptionError(
                f"stream shard {s} is unreadable "
                f"({self.shard_files[s]}: {type(e).__name__}: {e}): "
                "truncated or torn shard file — restore the store from a "
                "replica") from e
        if any(a.shape != (self.shard_len,) for a in arrays):
            raise ShardCorruptionError(
                f"stream shard {s} has wrong shapes "
                f"({[a.shape for a in arrays]}, expected "
                f"({self.shard_len},) each): the shard file does not "
                "belong to this manifest")
        if _chaos and chaos.armed():
            arrays = chaos.corrupt_arrays(s, arrays)
        want = int(self.shard_checksums[s])
        got = int(self.slice_checksum(*arrays))
        if got != want:
            raise ShardCorruptionError(
                f"stream shard {s} failed its crc32 self-check "
                f"(expected {want:#010x}, got {got:#010x}): shard bytes "
                "corrupted on disk or in flight — restore the store from "
                "a replica or rewrite it with ShardedCorpus.to_store()")
        return arrays


def write_store(stream: ShardedCorpus, path: str) -> CorpusStore:
    """Write a ``ShardedCorpus`` out as a corpus store directory and return
    it opened. Shards are written verbatim, each atomically; the manifest
    lands last."""
    path = str(path)
    os.makedirs(path, exist_ok=True)
    wc = np.zeros(stream.n_words, np.int64)
    dl = np.zeros(stream.n_docs, np.int64)
    for s in range(stream.n_shards):
        w, d, m = stream.word_ids[s], stream.doc_ids[s], stream.mask[s]
        real = m.astype(bool)
        wc += np.bincount(w[real], minlength=stream.n_words)
        dl += np.bincount(d[real], minlength=stream.n_docs)
        _atomic_write(
            os.path.join(path, _shard_name(s)),
            lambda f, w=w, d=d, m=m: np.savez(
                f, word_ids=np.asarray(w, np.int32),
                doc_ids=np.asarray(d, np.int32),
                mask=np.asarray(m, np.int32)))
    _atomic_write(
        os.path.join(path, META_NAME),
        lambda f: np.savez(f, word_token_counts=wc, doc_lengths=dl))
    manifest = {
        "format_version": FORMAT_VERSION,
        "n_shards": int(stream.n_shards),
        "shard_len": int(stream.shard_len),
        "n_padded": int(stream.n_padded),
        "n_tokens": int(stream.n_tokens),
        "n_words": int(stream.n_words),
        "n_docs": int(stream.n_docs),
        "first_word": [int(v) for v in stream.first_word],
        "last_word": [int(v) for v in stream.last_word],
        "checksums": [int(v) for v in stream.shard_checksums],
        "shards": [_shard_name(s) for s in range(stream.n_shards)],
    }
    _atomic_write(
        os.path.join(path, MANIFEST_NAME),
        lambda f: f.write(
            json.dumps(manifest, indent=1).encode("utf-8")))
    return CorpusStore.open(path)
