"""The port's epoch shards and disk-native corpus store against the
reference's: ``shard_stream`` / ``ShardedCorpus`` arrays, word runs,
index slices and checksums bitwise; stores written by either package
open and read bitwise in the other; every way a store rots on disk
(missing, truncated, bit-flipped or foreign shard, torn manifest, future
format) raises a loud error naming what broke.
"""

import json
import os

import numpy as np
import pytest

from repro.lda.corpus import from_documents as jax_from_documents
from repro.lda.corpus import shard_stream as jax_shard_stream
from repro.lda.storage import CorpusStore as JaxStore
from repro_torch.lda.corpus import ShardedCorpus, from_documents, shard_stream
from repro_torch.lda.invariants import ShardCorruptionError
from repro_torch.lda.storage import (FORMAT_VERSION, MANIFEST_NAME,
                                     META_NAME, CorpusStore)
from _torch_parity import port_corpus

FIELDS = ("n_shards", "shard_len", "n_padded", "n_tokens", "n_words",
          "n_docs")
ARRAYS = ("word_ids", "doc_ids", "mask", "first_word", "last_word")


def _random_docs(seed, n_docs=25, n_words=30, max_len=12):
    """Docs with empty ones, 0-token words and the largest word id."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(0, n_words, rng.integers(0, max_len + 1))
            for _ in range(n_docs)]
    docs[0] = np.array([n_words - 1])
    return docs, n_words


def _assert_streams_equal(a, b, deep=True):
    for f in FIELDS:
        assert getattr(a, f) == getattr(b, f), f
    for f in ARRAYS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert np.array_equal(a.shard_checksums, b.shard_checksums)
    assert np.array_equal(a.real_per_shard, b.real_per_shard)
    if deep:
        for f in ("word_offsets", "inv_doc_offsets", "inv_token_idx"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("seed,n_shards,multiple", [
    (0, 1, 1), (1, 3, 8), (2, 4, 16), (3, 7, 4), (4, 2, 512), (5, 6, 1)])
def test_shard_stream_bitwise_the_reference(seed, n_shards, multiple):
    docs, V = _random_docs(seed)
    jc = jax_from_documents(docs, V)
    ref = jax_shard_stream(jc, n_shards, multiple=multiple)
    got = shard_stream(port_corpus(jc), n_shards, multiple=multiple)
    _assert_streams_equal(got, ref)
    got.validate(deep=True)


def test_shard_stream_on_the_small_corpus(small_corpus):
    for n_shards in (2, 4, 8):
        _assert_streams_equal(
            shard_stream(port_corpus(small_corpus), n_shards, multiple=512),
            jax_shard_stream(small_corpus, n_shards, multiple=512))
    with pytest.raises(ValueError, match="n_shards"):
        shard_stream(port_corpus(small_corpus), 0)


def test_slice_checksum_detects_a_flipped_byte():
    sc = shard_stream(from_documents([[0, 1, 2], [2, 3]], 4), 2, multiple=2)
    w = sc.word_ids[0].copy()
    want = ShardedCorpus.slice_checksum(w, sc.doc_ids[0], sc.mask[0])
    assert want == int(sc.shard_checksums[0])
    w.view(np.uint8)[0] ^= 1
    assert ShardedCorpus.slice_checksum(w, sc.doc_ids[0], sc.mask[0]) != want


def _stream(seed=7, n_shards=4, multiple=8):
    docs, V = _random_docs(seed, n_docs=40)
    return jax_from_documents(docs, V), n_shards, multiple


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_stores_interchange_bitwise(writer, tmp_path):
    jc, S, mult = _stream()
    ref = jax_shard_stream(jc, S, multiple=mult)
    got = shard_stream(port_corpus(jc), S, multiple=mult)
    path = str(tmp_path / "store")
    (got if writer == "port" else ref).to_store(path)
    port_store, jax_store = CorpusStore.open(path), JaxStore.open(path)
    for f in FIELDS:
        assert getattr(port_store, f) == getattr(jax_store, f) \
            == getattr(ref, f), f
    for f in ("first_word", "last_word", "shard_checksums"):
        assert np.array_equal(getattr(port_store, f), getattr(jax_store, f))
    for s in range(S):
        for a, b, c in zip(port_store.read_shard(s), jax_store.read_shard(s),
                           (ref.word_ids[s], ref.doc_ids[s], ref.mask[s])):
            assert a.dtype == b.dtype == np.int32
            assert np.array_equal(a, b) and np.array_equal(a, c)
    pm, jm = port_store.corpus_meta(), jax_store.corpus_meta()
    assert np.array_equal(pm.word_token_counts, jm.word_token_counts)
    assert np.array_equal(pm.doc_lengths, jm.doc_lengths)
    assert np.array_equal(pm.word_token_counts, jc.word_token_counts)
    _assert_streams_equal(ShardedCorpus.from_store(path), ref, deep=False)
    assert port_store.nbytes() > 0


def test_port_and_reference_write_the_same_files(tmp_path):
    jc, S, mult = _stream(seed=3)
    jax_shard_stream(jc, S, multiple=mult).to_store(str(tmp_path / "j"))
    shard_stream(port_corpus(jc), S, multiple=mult).to_store(
        str(tmp_path / "p"))
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "p"))
    with open(tmp_path / "j" / MANIFEST_NAME, "rb") as f, \
            open(tmp_path / "p" / MANIFEST_NAME, "rb") as g:
        assert f.read() == g.read()


def _good_store(tmp_path):
    jc, S, mult = _stream(seed=11)
    return shard_stream(port_corpus(jc), S, multiple=mult).to_store(
        str(tmp_path / "store"))


def _shard_file(store, s):
    return os.path.join(store.path, store.shard_files[s])


@pytest.mark.parametrize("rot", ["missing", "truncated", "bit_flip",
                                 "foreign"])
def test_a_rotten_shard_names_itself(rot, tmp_path):
    store = _good_store(tmp_path)
    victim = _shard_file(store, 2)
    if rot == "missing":
        os.remove(victim)
        match = "shard 2 is missing"
    elif rot == "truncated":
        size = os.path.getsize(victim)
        with open(victim, "r+b") as f:
            f.truncate(size // 2)
        match = "shard 2 is unreadable"
    elif rot == "bit_flip":
        w, d, m = store.read_shard(2)
        d = d.copy()
        d[0] ^= 1
        with open(victim, "wb") as f:
            np.savez(f, word_ids=w, doc_ids=d, mask=m)
        match = "shard 2 failed its crc32"
    else:
        with open(victim, "wb") as f:
            z = np.zeros(store.shard_len + 1, np.int32)
            np.savez(f, word_ids=z, doc_ids=z, mask=z)
        match = "shard 2 has wrong shapes"
    with pytest.raises(ShardCorruptionError, match=match):
        store.read_shard(2)
    with pytest.raises(ShardCorruptionError, match="shard 2"):
        ShardedCorpus.from_store(store.path)
    store.read_shard(1)                   # the others still read
    with pytest.raises(IndexError):
        store.read_shard(store.n_shards)


@pytest.mark.parametrize("rot", ["missing", "torn", "future", "inconsistent",
                                 "no_meta"])
def test_a_rotten_manifest_refuses_to_open(rot, tmp_path):
    store = _good_store(tmp_path)
    mpath = os.path.join(store.path, MANIFEST_NAME)
    with open(mpath) as f:
        manifest = json.load(f)
    if rot == "missing":
        os.remove(mpath)
        with pytest.raises(FileNotFoundError, match="no corpus store"):
            CorpusStore.open(store.path)
        return
    if rot == "no_meta":
        os.remove(os.path.join(store.path, META_NAME))
        with pytest.raises(ValueError, match=META_NAME):
            CorpusStore.open(store.path).corpus_meta()
        return
    if rot == "torn":
        text, match = json.dumps(manifest)[:40], "unreadable"
    elif rot == "future":
        manifest["format_version"] = FORMAT_VERSION + 1
        text, match = json.dumps(manifest), "format_version"
    else:
        manifest["shards"] = manifest["shards"][:-1]
        text, match = json.dumps(manifest), "inconsistent"
    with open(mpath, "w") as f:
        f.write(text)
    with pytest.raises(ValueError, match=match):
        CorpusStore.open(store.path)
