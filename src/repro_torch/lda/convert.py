"""Carry a reference (JAX) training state across into the port.

The reference's canonical checkpoint payload (``src/repro/lda/api.py``)
is ``{topics_global, key, iteration}``: topics in unpadded global token
order, a JAX PRNG key, and the iteration. The counts D and W are derived
state, so the topics alone rebuild them exactly (through the
``histogram`` kernel with ``impl="kernel"``: ``LDATrainer.rebuild_counts``).
A payload of any sampler, the warp engine's included, carries only this
state. The JAX key has no
counterpart here and is ignored: the port seeds iteration ``i`` from
``(config.seed, i)`` (see ``lda/model.py``).

``corpus`` must be the corpus the reference engine trained on, prepped as
its engine preps it (relabeled by frequency) — the port's ``LDAEngine``
applies the same prep, so ``engine.corpus`` is the right one to pass.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.lda.corpus import Corpus, pad_corpus
from repro_torch.lda.model import LDAConfig, LDAState
from repro_torch.lda.trainer import LDATrainer

__all__ = ["state_from_reference", "reference_topics"]


def reference_topics(payload: dict[str, Any], corpus: Corpus,
                     config: LDAConfig) -> tuple[np.ndarray, int]:
    """(padded topics, iteration) of a reference canonical payload, padded
    for ``config.tile_size`` as the port's trainer pads the corpus."""
    topics = np.asarray(payload["topics_global"], np.int32)
    if topics.shape != (corpus.n_tokens,):
        raise ValueError(
            f"payload topics_global has {topics.shape[0]} entries but the "
            f"corpus holds {corpus.n_tokens} tokens: it belongs to a "
            "different corpus")
    if topics.size and (topics.min() < 0 or topics.max() >= config.n_topics):
        raise ValueError(f"payload topics lie outside [0, {config.n_topics})")
    n_padded = pad_corpus(corpus, config.tile_size)[0].n_tokens
    padded = np.zeros(n_padded, np.int32)          # pad slots: mask 0
    padded[:corpus.n_tokens] = topics
    return padded, int(payload["iteration"])


def state_from_reference(payload: dict[str, Any], corpus: Corpus,
                         config: LDAConfig, device=None) -> LDAState:
    """Port LDAState from a reference canonical payload, with D and W
    rebuilt from its topics. ``device=None`` means the CUDA card."""
    trainer = LDATrainer(corpus, config, device=device)
    return trainer.state_from_topics(
        *reference_topics(payload, corpus, config))
