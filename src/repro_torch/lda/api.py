"""The front door: ``LDAEngine`` on one device.

Port of the single-backend part of ``src/repro/lda/api.py``: the engine
owns corpus prep (documents -> ``Corpus``, relabel by frequency, keep the
``word_map``), builds the trainer on the training device, and accumulates
the history of every ``fit`` call.

The engine runs on the CUDA card unless it is given ``device="cpu"``;
with no card and no explicit CPU it raises. The paper's configuration
runs through the same door::

    LDAEngine(corpus, LDAConfig(n_topics=1000, format="hybrid",
                                tail_sampler="sparse", balance="tiles",
                                fused=True)).fit(5)

``engine.state`` stays a dense ``LDAState`` whatever the format, as in
the reference: a hybrid run packs it on entry to ``fit`` and densifies
it on the way out. Checkpoints, the distributed
backends, serving (``export``) and supervised fits are later slices of
the port (ROADMAP.md Queue 1 #5, #11-#13).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np

from repro_torch.lda.convert import reference_topics
from repro_torch.lda.corpus import Corpus, from_documents, relabel_by_frequency
from repro_torch.lda.model import LDAConfig, LDAState
from repro_torch.lda.trainer import LDATrainer

__all__ = ["LDAEngine"]


class LDAEngine:
    """Train EZLDA on one device.

    >>> engine = LDAEngine(corpus, LDAConfig(n_topics=64))
    >>> engine.fit(100)
    >>> engine.score()
    """

    def __init__(self, corpus: Corpus | Sequence[Sequence[int]],
                 config: LDAConfig, device=None, *,
                 n_words: int | None = None, backend: str = "single",
                 checkpoint_dir: str | None = None):
        if backend not in ("auto", "single"):
            raise NotImplementedError(
                f"backend={backend!r}: only the single-device backend is "
                "ported (the distributed ones arrive with ROADMAP.md Queue "
                "1 #12)")
        if checkpoint_dir is not None:
            raise NotImplementedError(
                "checkpointing is not ported yet: it arrives with ROADMAP.md "
                "Queue 1 #5 (until then, carry a reference payload across "
                "with restore())")
        if not isinstance(corpus, Corpus):
            docs = [np.asarray(d, np.int64) for d in corpus]
            if n_words is None:
                n_words = int(max((int(d.max()) for d in docs if d.size),
                                  default=-1)) + 1
            corpus = from_documents(docs, n_words)
        self.word_map = None
        counts = np.asarray(corpus.word_token_counts)
        if counts.size and np.any(np.diff(counts) > 0):
            corpus, self.word_map = relabel_by_frequency(corpus)
        self.corpus = corpus
        self.config = config
        self.trainer = LDATrainer(corpus, config, device=device)
        self.device = self.trainer.device
        self._state: LDAState | None = None
        self.history: dict[str, list] = {"iteration": [], "llpt": [],
                                         "tokens_per_sec": [], "stats": []}

    @property
    def state(self) -> LDAState:
        if self._state is None:
            raise RuntimeError("no training state yet: call fit() first")
        return self._state

    @property
    def iteration(self) -> int:
        return int(self.state.iteration)

    def fit(self, n_iters: int, *,
            log_fn: Callable[[str], None] | None = None) -> dict[str, list]:
        """Train for n_iters from the current state (or a fresh init).
        Returns this call's history; ``engine.history`` accumulates."""
        if self._state is None:
            self._state = self.trainer.init_state()
        self._state, hist = self.trainer.run(n_iters, self._state, log_fn)
        for k, v in hist.items():
            self.history[k].extend(v)
        return hist

    def score(self) -> float:
        """Training-corpus LLPT (Eq 5) at the current state."""
        return self.trainer.evaluate(self.state)

    def restore(self, payload: dict[str, Any]) -> "LDAEngine":
        """Adopt a reference canonical payload (``topics_global``,
        ``iteration``) as the current state; see ``lda/convert.py``."""
        self._state = self.trainer.state_from_topics(
            *reference_topics(payload, self.corpus, self.config))
        return self
