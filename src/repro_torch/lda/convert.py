"""The canonical checkpoint payload, and carrying a state across packages.

The canonical payload of both packages (``src/repro/lda/api.py``) is
``{topics_global: (n_tokens,) int32, key: (2,) uint32, iteration}``:
topics in unpadded global token order of the engine's prepped corpus
(relabeled by frequency), the key data of a JAX PRNG key, and the
iteration. The counts D and W are derived state, so the topics alone
rebuild them exactly (through the ``histogram`` kernel with
``impl="kernel"``: ``LDATrainer.rebuild_counts``). A payload of any
sampler, the warp engine's included, carries only this state.

The port draws iteration ``i``'s uniforms from ``(config.seed, i + 1)``
(``lda/model.py``), so ``{topics, iteration}`` resumes a port run
bitwise and the key is ignored on restore. The port writes
``key_data(config.seed)``, the key data of ``PRNGKey(config.seed)``, so
that the reference can restore a port checkpoint at all (its trainer
wraps the key). Between the packages the counts and the iteration carry
over exactly; the random stream does not: a run resumed in the other
package continues from the same state with other draws.

A payload restores through ``LDATrainer.state_from_payload`` (or
``LDAEngine.restore``), on the corpus the writing engine trained on,
prepped as its engine preps it: the port's ``LDAEngine`` applies the
reference's prep, so ``engine.corpus`` is that corpus.

A streamed trainer saved mid-epoch adds the keys of
``train/lda_step.py::STREAM_PAYLOAD_KEYS`` (``stream_cursor``,
``stream_done_topics``, ``stream_n_shards``); ``topics_global`` is then
the epoch-start topics. Every conversion here passes those keys through,
and only a streamed or disk trainer on the same shard grid restores such
a payload.

The packed sparse state crosses too: ``packed_rows_to_port`` and
``packed_rows_to_numpy`` carry packed ELL rows (int32 words, stale idx
bits of free slots included) both ways, and ``hybrid_w_to_port`` and
``hybrid_w_to_numpy`` a ``HybridW`` (its dense head, its buckets and
their row starts and capacities, ``v_dense``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import sparse

__all__ = ["canonical_topics", "key_data", "to_canonical",
           "stream_payload_keys", "packed_rows_to_port",
           "packed_rows_to_numpy", "hybrid_w_to_port", "hybrid_w_to_numpy"]


def stream_payload_keys(payload: dict[str, Any]) -> dict[str, Any]:
    """The mid-epoch keys ``payload`` carries (none at a boundary)."""
    from repro_torch.train.lda_step import STREAM_PAYLOAD_KEYS
    return {k: payload[k] for k in STREAM_PAYLOAD_KEYS if k in payload}


def canonical_topics(payload: dict[str, Any], n_tokens: int,
                     padded_len: int | None = None, *,
                     streamed: bool = False) -> np.ndarray:
    """Unpadded global-order topics from a canonical OR legacy payload
    (the reference's ``_canonical_topics``).

    A legacy (padded ``"topics"``) payload is accepted only when its length
    is exactly ``n_tokens`` or exactly ``padded_len`` (the restoring
    trainer's padded length, when known), so a payload from a different
    corpus never silently truncates into garbage counts.

    A payload saved mid-epoch by a streamed trainer (``stream_cursor >
    0``) is rejected unless ``streamed``: its ``topics_global`` is
    rewound to the epoch start (the open epoch's sampled shards live only
    in ``stream_done_topics``), so only a streaming pipeline can re-open
    that epoch; a resident trainer adopting it would train on from stale
    topics at the iteration the payload claims.
    """
    cursor = payload.get("stream_cursor")
    if not streamed and cursor is not None and int(np.asarray(cursor)) > 0:
        raise ValueError(
            "checkpoint was saved mid-epoch by a streamed trainer "
            f"(stream_cursor={int(np.asarray(cursor))}): restore it with "
            "corpus_residency='streamed' (and the same stream_shards), or "
            "re-save it at an epoch boundary")
    if "topics_global" in payload:
        tg = np.asarray(payload["topics_global"], np.int32)
        if tg.shape[0] != n_tokens:
            raise ValueError(
                f"checkpoint topics_global has {tg.shape[0]} entries but "
                f"the corpus holds {n_tokens} tokens: the checkpoint "
                "belongs to a different corpus")
        return tg
    if "topics" in payload:
        tg = np.asarray(payload["topics"], np.int32)
        if tg.shape[0] != n_tokens and (padded_len is None
                                        or tg.shape[0] != padded_len):
            want = f"{n_tokens}" if padded_len is None \
                else f"{n_tokens} (unpadded) or {padded_len} (padded)"
            raise ValueError(
                f"legacy checkpoint topics have {tg.shape[0]} entries; "
                f"expected {want}: the checkpoint belongs to a different "
                "corpus or tiling")
        return tg[:n_tokens]
    raise ValueError(
        "checkpoint payload has neither 'topics_global' (canonical) "
        f"nor 'topics' (legacy): keys = {sorted(payload)}")


def key_data(seed: int) -> np.ndarray:
    """The key data of the reference's ``jax.random.PRNGKey(seed)``
    (threefry: the seed's high and low 32 bits)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def to_canonical(payload: dict[str, Any], n_tokens: int) -> dict[str, Any]:
    """Trainer payload (padded ``topics``) -> canonical payload; the
    mid-epoch keys ride through."""
    return {"topics_global": np.asarray(payload["topics"],
                                        np.int32)[:n_tokens],
            "key": np.asarray(payload["key"], np.uint32),
            "iteration": int(payload["iteration"]),
            **stream_payload_keys(payload)}


def packed_rows_to_numpy(rows) -> np.ndarray:
    """Packed ELL rows of either package (a tensor, a NumPy or a JAX
    array) as an int32 NumPy array, the words unchanged."""
    if isinstance(rows, torch.Tensor):
        rows = rows.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(rows), np.int32)


def packed_rows_to_port(rows, device=None) -> torch.Tensor:
    """Packed ELL rows of either package as an int32 tensor on ``device``
    (the CPU by default), the words unchanged."""
    return torch.from_numpy(packed_rows_to_numpy(rows)).to(device or "cpu")


def hybrid_w_to_port(hw, device=None) -> sparse.HybridW:
    """A ``HybridW`` of either package (anything with its fields: the
    reference's NamedTuple of JAX arrays, or ``hybrid_w_to_numpy``'s dict)
    as the port's, its tensors on ``device``."""
    if isinstance(hw, dict):
        dense, sp, v_dense = hw["dense"], hw["sparse"], hw["v_dense"]
        buckets, starts, caps = (sp["buckets"], sp["row_starts"],
                                 sp["capacities"])
    else:
        dense, v_dense = hw.dense, hw.v_dense
        buckets, starts, caps = (hw.sparse.buckets, hw.sparse.row_starts,
                                 hw.sparse.capacities)
    return sparse.HybridW(
        dense=packed_rows_to_port(dense, device),
        sparse=sparse.BucketedSparse(
            tuple(packed_rows_to_port(b, device) for b in buckets),
            tuple(int(x) for x in starts), tuple(int(x) for x in caps)),
        v_dense=int(v_dense))


def hybrid_w_to_numpy(hw) -> dict[str, Any]:
    """A ``HybridW`` as NumPy arrays: ``{"dense", "sparse": {"buckets",
    "row_starts", "capacities"}, "v_dense"}``, the reference's fields."""
    return {"dense": packed_rows_to_numpy(hw.dense),
            "sparse": {"buckets": tuple(packed_rows_to_numpy(b)
                                        for b in hw.sparse.buckets),
                       "row_starts": tuple(int(x)
                                           for x in hw.sparse.row_starts),
                       "capacities": tuple(int(x)
                                           for x in hw.sparse.capacities)},
            "v_dense": int(hw.v_dense)}
