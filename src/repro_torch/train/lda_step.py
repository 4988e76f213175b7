"""The fused LDA training iteration, dense state, one device.

Port of the dense, three-branch, ``balance="none"`` part of
``src/repro/train/lda_step.py``. One iteration (``FusedPipeline._iteration``)
runs, back to back on the state's device:

  1. Ŵ from the maintained int32 column sum (no O(V·K) reduction);
  2. per-word top-(g+1) stats and the phase-1 skip test for every token;
  3. survivor compaction, then phase 2 over chunks of ``capacity``
     survivors: the ``sample_fused`` kernel when ``config.impl ==
     "kernel"``, the plain ``three_branch.exact_three_branch`` when
     ``"torch"``;
  4. ±1 count updates at the tokens whose topic changed.

Where the reference compiles this into one donated ``lax.scan`` with no
host sync, PyTorch runs it eagerly: the survivor count is read back to
size the chunk loop, the changed-token count to size the scatters, and
the state is updated in place (the pipeline owns the tensors it was handed
by ``from_lda_state``).

Randomness: iteration ``i`` draws its (N,) uniforms from
``lda.model.uniforms_generator(config.seed, i + 1)`` on the state's
device, so a run resumed from ``{topics, iteration}`` continues exactly,
and the stepwise trainer draws the same uniforms for the same iteration.
``_iteration`` takes the uniforms as an argument, so tests can hand it the
reference's own draw.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import esca, three_branch
from repro_torch.kernels.sample_fused import sample_fused_rows
from repro_torch.lda.model import LDAState, uniforms_generator

__all__ = ["FusedState", "FusedPipeline", "scatter_changed_deltas",
           "branch_stats", "plan_capacity", "draw_uniforms"]


class FusedState(NamedTuple):
    """LDAState + the incrementally maintained Ŵ column sum."""
    topics: torch.Tensor   # (N,) int32
    D: torch.Tensor        # (M, K) int32
    W: torch.Tensor        # (V, K) int32
    colsum: torch.Tensor   # (K,) int32 == W.sum(dim=0), kept by deltas
    iteration: int


def draw_uniforms(seed: int, iteration: int, n: int,
                  device: torch.device) -> torch.Tensor:
    """The (n,) float32 uniforms of iteration ``iteration`` (0-based)."""
    return torch.rand(n, generator=uniforms_generator(seed, iteration + 1,
                                                      device),
                      device=device, dtype=torch.float32)


def scatter_changed_deltas(topics, new_topics, doc_ids, word_ids, mask, *,
                           D, W, colsum):
    """±1 scatters into D, W and colsum at the CHANGED tokens only, in place.

    Semantics of esca.delta_update_counts (the oracle the tests pin); the
    scatters touch ~n_changed entries instead of 2N.
    """
    idx = ((new_topics != topics) & (mask > 0)).nonzero().squeeze(1)
    old, new = topics[idx], new_topics[idx]
    esca.scatter_moves(D, doc_ids[idx], old, new)
    esca.scatter_moves(W, word_ids[idx], old, new)
    esca.scatter_moves(colsum, None, old, new)
    return D, W, colsum


def branch_stats(skip, in_m_acc, new_topics, old_topics, k1):
    """The ThreeBranchStats both paths report (Fig 12 fractions)."""
    f32 = torch.float32
    return three_branch.ThreeBranchStats(
        frac_skipped=skip.to(f32).mean(),
        frac_m_final=(skip | in_m_acc).to(f32).mean(),
        frac_unchanged=(new_topics == old_topics).to(f32).mean(),
        frac_at_max=(new_topics == k1).to(f32).mean(),
    )


def plan_capacity(ema_survivors: float, n_tokens: int, *,
                  target_chunks: int = 8, floor: int = 2048) -> int:
    """Survivor-chunk capacity from the survivor-count EMA.

    Aims at about ``target_chunks`` chunks per iteration, rounded up to a
    power of two, floored at ``floor`` and capped at the token count.
    """
    want = max(float(ema_survivors) / target_chunks, float(floor))
    cap = 1 << max(int(want) - 1, 1).bit_length()
    return int(min(cap, n_tokens))


class FusedPipeline:
    """The fused dense iteration for one (corpus, config) pair.

    Built from the padded token arrays on the training device (see
    ``lda.trainer.LDATrainer``).
    """

    def __init__(self, word_ids: torch.Tensor, doc_ids: torch.Tensor,
                 mask: torch.Tensor, *, n_docs: int, n_words: int, config):
        self.config = config
        self.word_ids = word_ids
        self.doc_ids = doc_ids
        self.mask = mask
        self.n_docs = n_docs
        self.n_words = n_words
        self.n_tokens = int(word_ids.shape[0])
        self.device = word_ids.device
        cap = config.survivor_capacity
        self.capacity = min(max(int(cap) if cap else self.n_tokens, 1),
                            max(self.n_tokens, 1))
        # an explicitly configured capacity is pinned: the EMA keeps
        # tracking survivors but never overrides the user's knob
        self._capacity_pinned = cap is not None
        self._surv_ema: float | None = None

    # -- state conversion --------------------------------------------------

    def from_lda_state(self, state: LDAState) -> FusedState:
        """Attach the derived colsum to an LDAState.

        Copies the tensors: the pipeline updates its state in place, and
        must not change the caller's LDAState under it.
        """
        return FusedState(topics=state.topics.clone(), D=state.D.clone(),
                          W=state.W.clone(),
                          colsum=state.W.sum(dim=0, dtype=torch.int32),
                          iteration=int(state.iteration))

    def to_lda_state(self, fstate: FusedState) -> LDAState:
        return LDAState(topics=fstate.topics, D=fstate.D, W=fstate.W,
                        iteration=fstate.iteration)

    # -- the fused iteration -------------------------------------------------

    def _dense_chunk_sampler(self, u, word_ids, doc_ids, D, W_hat,
                             k1_per_word):
        """The phase-2 ``sample_chunk(idx) -> (topics, in_m)`` closure."""
        cfg = self.config
        alpha = cfg.alpha_

        def sample_chunk(idx):
            u_c, v_c, d_c = u[idx], word_ids[idx], doc_ids[idx]
            if cfg.impl == "kernel":
                t_c, m, s, q = sample_fused_rows(u_c, d_c, v_c, D, W_hat,
                                                 alpha=alpha)
                return t_c, u_c * (m + s + q) < m
            return three_branch.exact_three_branch(
                u_c, v_c, d_c, k1_per_word, D, W_hat, alpha=alpha,
                tile_size=cfg.tile_size)

        return sample_chunk

    def _iteration(self, fstate: FusedState, u: torch.Tensor, *,
                   capacity: int):
        """One iteration on uniforms ``u``; returns (state, stats, n_surv).

        Updates ``fstate``'s count tensors in place.
        """
        cfg = self.config
        alpha, g = cfg.alpha_, cfg.g
        word_ids, doc_ids, mask = self.word_ids, self.doc_ids, self.mask
        topics, D, W, colsum, iteration = fstate

        W_hat = esca.compute_w_hat_from_colsum(W, colsum, cfg.beta)
        stats_w = three_branch.word_stats(W_hat, g=g, alpha=alpha)
        dec = three_branch.skip_phase(u, word_ids, doc_ids, D, stats_w,
                                      g=g, alpha=alpha)
        rank, n_surv = three_branch.survivor_rank(dec.skip)
        n_s = int(n_surv)               # host read: sizes the chunk loop
        surv_idx = three_branch.compact_survivor_indices(
            rank, dec.skip, n_s).long()
        del rank

        sample_chunk = self._dense_chunk_sampler(
            u, word_ids, doc_ids, D, W_hat, stats_w.k[:, 0])
        new_topics = dec.k1.clone()                     # skipped ⇒ K1
        in_m_acc = torch.zeros_like(dec.skip)
        for lo in range(0, n_s, capacity):
            idx = surv_idx[lo:lo + capacity]
            new_topics[idx], in_m_acc[idx] = sample_chunk(idx)

        st = branch_stats(dec.skip, in_m_acc, new_topics, topics, dec.k1)
        scatter_changed_deltas(topics, new_topics, doc_ids, word_ids, mask,
                               D=D, W=W, colsum=colsum)
        new_state = FusedState(topics=new_topics, D=D, W=W, colsum=colsum,
                               iteration=iteration + 1)
        return new_state, st, n_surv

    # -- entry points ---------------------------------------------------------

    def step(self, fstate: FusedState):
        """One fused iteration: (state, stats, n_surv)."""
        u = draw_uniforms(self.config.seed, fstate.iteration, self.n_tokens,
                          self.device)
        return self._iteration(fstate, u, capacity=self.capacity)

    def run_fused(self, fstate: FusedState, n_iters: int,
                  replan: bool = True):
        """n_iters iterations. Returns (state, stats, n_surv), the stats
        and survivor counts stacked along a leading (n_iters,) axis. With
        ``replan=True`` the survivor counts update the capacity EMA after
        the stretch, for the next one."""
        stats, n_surv = [], []
        for _ in range(int(n_iters)):
            fstate, st, ns = self.step(fstate)
            stats.append(st)
            n_surv.append(ns)
        stacked = three_branch.ThreeBranchStats(*(
            torch.stack([torch.as_tensor(getattr(s, f)) for s in stats])
            for f in three_branch.ThreeBranchStats._fields))
        n_surv = torch.stack(n_surv)
        if replan:
            self.note_survivors(n_surv)
        return fstate, stacked, n_surv

    # -- between-stretch capacity planning (host side) -----------------------

    def note_survivors(self, n_surv, decay: float = 0.7) -> None:
        vals = np.atleast_1d(np.asarray(torch.as_tensor(n_surv).cpu()))
        ema = self._surv_ema
        for v in vals.astype(np.float64):
            ema = float(v) if ema is None else decay * ema + (1 - decay) * v
        self._surv_ema = ema
        if not self._capacity_pinned:
            self.capacity = plan_capacity(ema, self.n_tokens)
