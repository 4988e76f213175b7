"""Bounded-staleness model refresh: live trainer -> serving artifact.

Port of ``src/repro/serve/refresh.py``. A streamed trainer holds, on its
device and mid-epoch, everything a fresh serving view needs: the
epoch-start counts and the moves of the shards sampled so far.
``StreamingPipeline.serving_counts`` exports ``W0 + ΔW``, a W whose
staleness is ``(n_shards - cursor) / n_shards`` epochs; at an epoch
boundary (``cursor == 0``) it is the exact counts, so a swap there is
bitwise a freeze of the boundary state.

``ServingSnapshot`` is the publish unit (a host W and its staleness
coordinates); ``LDAEngine.subscribe`` delivers one per publish point, and
``attach(engine, service)`` wires them into ``LDAService.refresh``: each
replica's new tables are built off the serving path, then a pointer swap
retires the old ones once in-flight batches drop them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

__all__ = ["ServingSnapshot", "attach"]


@dataclasses.dataclass(frozen=True)
class ServingSnapshot:
    """One published serving view of a (possibly mid-epoch) model.

    ``cursor``/``n_shards`` place the view inside the open epoch
    (``cursor == 0``: an exact epoch-boundary state); ``seq`` is the
    publisher's monotone sequence number: a service drops snapshots that
    arrive out of order, so a slow build never rolls serving back.
    """
    W: np.ndarray                       # (V, K) int32 topic-word counts
    alpha: float
    beta: float
    g: int
    iteration: int
    cursor: int = 0
    n_shards: int = 1
    seq: int = 0
    word_map: np.ndarray | None = None
    tile_size: int = 8192

    @property
    def staleness_steps(self) -> float:
        """Epochs behind a just-closed epoch: 0 at a boundary, (S -
        cursor)/S with cursor of S shards sampled."""
        if self.cursor == 0:
            return 0.0
        return (self.n_shards - self.cursor) / self.n_shards

    def freeze(self, device=None):
        """A standalone ``FrozenLDAModel`` of this view on ``device``
        (None: the card)."""
        from repro_torch.lda.api import FrozenLDAModel
        return FrozenLDAModel(W=np.asarray(self.W, np.int32),
                              alpha=self.alpha, beta=self.beta, g=self.g,
                              word_map=self.word_map,
                              tile_size=self.tile_size, device=device)

    @classmethod
    def from_engine(cls, engine, seq: int = 0) -> "ServingSnapshot":
        """Snapshot an engine's current state (boundary or mid-epoch)."""
        W, cursor, n_shards = engine._backend.serving_W(engine.state)
        return cls(W=W, alpha=engine.config.alpha_,
                   beta=engine.config.beta, g=engine.config.g,
                   iteration=engine.iteration, cursor=cursor,
                   n_shards=n_shards, seq=seq, word_map=engine.word_map,
                   tile_size=engine.config.tile_size)


def attach(engine, service, *,
           on_snapshot: Callable[[Any], None] | None = None) -> Callable:
    """Subscribe ``service`` to ``engine``'s publish stream: every snapshot
    becomes a ``service.refresh(snapshot)`` swap. Returns the engine's
    unsubscribe callable."""

    def deliver(snap: ServingSnapshot) -> None:
        service.refresh(snap)
        if on_snapshot is not None:
            on_snapshot(snap)

    return engine.subscribe(deliver)
