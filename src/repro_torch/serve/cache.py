"""Hot-word stats cache: pin the skewed head of the query vocabulary.

Port of ``src/repro/serve/cache.py``. A serving replica needs four
per-word tables to answer a fold-in batch: Ŵ rows, the three-branch word
stats (top-(g+1), Q', ΣŴ) and the alias tables of the warm-start proposal.
Each is a ROW-LOCAL function of (W[v], colsum):

  * Ŵ[v] is an elementwise expression of the row and the global column sum
    (``lda/api.py::frozen_w_hat``, NumPy float32 as ``FrozenLDAModel``);
  * ``three_branch.word_stats`` sorts each row and sums it with
    ``row_sum`` (pairwise on the card), so a slice of rows gives the slice
    of the full stats;
  * the alias tables normalise each row with ``row_sum`` too and build it
    alone: ``kernels/sample_warp.py::alias_tables`` (the ``vose_build``
    kernel's main-path entry) on the card, its plain twin
    (``mh.build_alias_tables``' queues and pairing) on the CPU.

So the top ``hot_words`` rows (the engine's frequency relabeling puts the
most frequent words first: "hot" is ``id < H``) are built once a snapshot
and pinned on the device, and a batch's tail words are gathered from tail
tables built once a snapshot by the same row-local ops and parked on the
host: a batch samples against ``cat(hot, tail)`` with its word ids
remapped to that local table, bitwise what it draws against the full
V-row tables.

Refresh is tear-free: every table of a snapshot lives in one immutable
``_CacheState``; ``assemble`` reads the state once a batch, and
``refresh`` builds the replacement off the serving path and swaps the
pointer.

By design, where the reference pads every tail block to the whole tail
span (a fixed jit signature), the port runs eagerly and assembles exactly
the batch's distinct tail rows, in the same order and with the same
local ids: the reference's block without its zero padding.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import three_branch
from repro_torch.kernels import sample_warp
from repro_torch.lda.api import frozen_w_hat
from repro_torch.runtime.device import resolve_device

__all__ = ["AssembledBatch", "HotWordCache", "WordTables"]


class WordTables(NamedTuple):
    """Per-word serving tables for a (sub)vocabulary, on one device (or
    the host, for a parked tail): ``w_hat`` (R, K) float32, ``stats`` a
    ``three_branch.WordStats`` of R rows, and the alias tables' ``prob``
    and ``alias`` (R, K), None without the warm start."""
    w_hat: torch.Tensor
    stats: three_branch.WordStats
    prob: torch.Tensor | None
    alias: torch.Tensor | None

    @property
    def n_rows(self) -> int:
        return int(self.w_hat.shape[0])

    def as_args(self) -> tuple:
        """The reference's ``WordTables.as_args`` order: Ŵ, the five stats,
        then prob and alias when there are alias tables."""
        flat = (self.w_hat,) + tuple(self.stats)
        if self.prob is not None:
            flat += (self.prob, self.alias)
        return flat

    @classmethod
    def from_args(cls, args) -> "WordTables":
        w_hat, *rest = args
        stats = three_branch.WordStats(*rest[:5])
        prob, alias = rest[5:] if len(rest) > 5 else (None, None)
        return cls(w_hat, stats, prob, alias)

    def map(self, fn) -> "WordTables":
        return WordTables.from_args([fn(t) for t in self.as_args()])


class AssembledBatch(NamedTuple):
    """One batch's sampling tables and locally remapped word ids.

    ``tables`` is the pinned head; ``tail_args`` the batch's distinct tail
    rows of every table, host tensors in ``WordTables.as_args`` order
    (empty when every token is hot)."""
    local_ids: np.ndarray       # (N,) int32 into cat(head, tail)
    tables: WordTables          # rows [0, H), on the device
    tail_args: tuple            # the batch's tail rows, on the host
    n_rows: int                 # H + distinct tail words
    hits: int                   # tokens resolved from the pinned head
    misses: int                 # tokens that needed a tail gather


@dataclasses.dataclass(frozen=True)
class _CacheState:
    """One model snapshot's tables: immutable, swapped as a unit."""
    W: np.ndarray               # (V, K) int32 host counts
    hot: WordTables             # rows [0, H), on the device
    host_tail: WordTables | None  # rows [H, V), on the host
    tail_memo: dict             # the last tail assembly, by its words


class HotWordCache:
    """Pinned head and on-demand tail for one replica.

    ``hot_words=H`` pins rows [0, H); ``hot_words >= n_words`` is the
    full-table layout, which is how replicas without a cache are built:
    one code path. ``device`` None is the model's device.
    """

    def __init__(self, model, *, hot_words: int | None = None,
                 warm_start: bool = True, device=None):
        V = model.n_words
        self.n_words = V
        self.hot_words = max(1, min(int(hot_words or V), V))
        self.warm_start = bool(warm_start)
        self.device = resolve_device(model.device if device is None
                                     else device)
        self.g, self.alpha, self.beta = model.g, float(model.alpha), \
            float(model.beta)
        self._state = self._build_state(np.asarray(model.W, np.int32))
        self.hits = 0
        self.misses = 0

    # -- snapshot construction and refresh ------------------------------------

    def _build_rows(self, W_rows: np.ndarray,
                    colsum: np.ndarray) -> WordTables:
        """The tables of some rows, on the device: the same row-local ops
        whatever rows ride along."""
        w_hat = torch.from_numpy(frozen_w_hat(
            W_rows, colsum, self.n_words, self.beta)).to(self.device)
        stats = three_branch.word_stats(w_hat, g=self.g, alpha=self.alpha)
        stats = three_branch.WordStats(*(t.contiguous() for t in stats))
        prob = alias = None
        if self.warm_start:
            tables = sample_warp.alias_tables(w_hat)
            prob, alias = tables.prob, tables.alias
        return WordTables(w_hat, stats, prob, alias)

    def _build_state(self, W: np.ndarray) -> _CacheState:
        colsum = W.sum(axis=0, dtype=np.int64)
        hot = self._build_rows(W[:self.hot_words], colsum)
        host_tail = None
        if not self.is_full:
            # derived once a snapshot by the build the head takes, then
            # parked on the host: a batch gathers and uploads its rows, and
            # the device holds only H rows and one batch's tail
            pin = self.device.type == "cuda"
            host_tail = self._build_rows(W[self.hot_words:], colsum).map(
                lambda t: t.cpu().pin_memory() if pin else t.cpu())
        return _CacheState(W=W, hot=hot, host_tail=host_tail, tail_memo={})

    def refresh(self, W: np.ndarray) -> None:
        """Adopt a new snapshot: build the whole replacement off the serving
        path, then swap the pointer (atomic under the GIL: a concurrent
        ``assemble`` sees the old state or the new, never a mix)."""
        self._state = self._build_state(np.asarray(W, np.int32))

    @property
    def is_full(self) -> bool:
        return self.hot_words >= self.n_words

    @property
    def hit_rate(self) -> float | None:
        tok = self.hits + self.misses
        return self.hits / tok if tok else None

    # -- per-batch assembly ----------------------------------------------------

    def assemble(self, word_ids: np.ndarray) -> AssembledBatch:
        """Sampling tables and local ids for one batch's word ids.

        A hot word v < H keeps id v; each distinct tail word gets H + its
        rank among the batch's sorted distinct tail words (the reference's
        ids)."""
        state = self._state                      # ONE read: no tearing
        ids = np.asarray(word_ids, np.int64)
        H = self.hot_words
        if self.is_full:
            self.hits += int(ids.size)
            return AssembledBatch(ids.astype(np.int32), state.hot, (),
                                  state.hot.n_rows, int(ids.size), 0)
        hot_mask = ids < H
        n_hot = int(hot_mask.sum())
        n_tail_tok = int(ids.size) - n_hot
        self.hits += n_hot
        self.misses += n_tail_tok
        tail_words = np.unique(ids[~hot_mask])
        if tail_words.size == 0:
            return AssembledBatch(ids.astype(np.int32), state.hot, (), H,
                                  n_hot, 0)
        tail_args = self._assemble_tail(state, tail_words)
        local = ids.copy()
        local[~hot_mask] = H + np.searchsorted(tail_words, ids[~hot_mask])
        return AssembledBatch(local.astype(np.int32), state.hot, tail_args,
                              H + int(tail_words.size), n_hot, n_tail_tok)

    def _assemble_tail(self, state: _CacheState,
                       tail_words: np.ndarray) -> tuple:
        memo_key = tail_words.tobytes()
        hit = state.tail_memo.get(memo_key)
        if hit is not None:
            return hit
        idx = torch.from_numpy(tail_words - self.hot_words)
        tail_args = tuple(t.index_select(0, idx)
                          for t in state.host_tail.as_args())
        # one entry: consecutive batches of a Zipf stream often repeat the
        # exact tail set; older assemblies are dead weight
        state.tail_memo.clear()
        state.tail_memo[memo_key] = tail_args
        return tail_args
