"""The fused LDA training iteration, dense and hybrid state, one device.

Port of the single-device, three-branch part of
``src/repro/train/lda_step.py``. One iteration (``FusedPipeline._iteration``)
runs, back to back on the state's device:

  1. Ŵ from the maintained int32 column sum (no O(V·K) reduction);
  2. per-word top-(g+1) stats and the phase-1 skip test for every token;
  3. survivor compaction, then phase 2: the ``sample_fused`` kernel when
     ``config.impl == "kernel"``, the plain
     ``three_branch.exact_three_branch`` when ``"torch"``;
  4. ±1 count updates at the tokens whose topic changed.

Phase 2 runs one of two ways:

* ``balance="none"``: chunks of ``capacity`` survivors, ``capacity``
  planned from the survivor-count EMA (about 8 chunks an iteration).
* ``balance="tiles"`` (paper §V-A): the compacted survivor stream is cut
  into tiles of ``capacity`` tokens (planned by ``plan_tile_capacity``:
  128 at K = 1000), and a tile's Ŵ rows are read through a
  ``(win_words, K)`` window starting at its first word. The reference
  runs its tiles in a ``lax.fori_loop`` with a ``lax.cond`` per tile;
  here every tile's word run is found at once on the device (a segmented
  min and max over the survivor stream), the tiles are split by the
  reference's own test ``last − first < win_words``, and the tiled kernel
  runs once over the tiles that fit and the untiled one once over the
  rest: at most two launches a segment an iteration, whatever the tile
  count. The two routes give the same bits, so the split never changes a
  result. The window is re-planned between stretches from the widest
  tile of the live stream (``note_spans``).

``HybridFusedPipeline`` runs the same iteration over the hybrid state
(``format="hybrid"``): it densifies the packed state once an iteration,
samples, applies the ±1 scatters, and repacks.

With ``sampler="warp"`` (the WarpLDA-style MH engine, ``core/mh.py``) an
iteration is ``_warp_iteration``: doc proposals, then the MH chain over
every real token (the ``warp_chain`` kernel when ``impl == "kernel"``, its
plain twin when ``"torch"``) on the same chunk and tile machinery, then
the same ±1 scatters. The alias tables (``build_warp_proposal``: the
``vose_build`` kernel over W̃) are built once per ``run_fused`` call from
the counts at its start and held fixed for that call's iterations: the
reference's staleness, which MH makes sound. ``step`` builds them afresh.

Where the reference compiles this into one donated ``lax.scan`` with no
host sync, PyTorch runs it eagerly: the survivor count is read back to
size the chunk loop, the changed-token count to size the scatters, and
the state is updated in place (the pipeline owns the tensors it was handed
by ``from_lda_state``).

Randomness: iteration ``i`` draws its (N,) uniforms from
``lda.model.uniforms_generator(config.seed, i + 1)`` on the state's
device, so a run resumed from ``{topics, iteration}`` continues exactly,
and the stepwise trainer draws the same uniforms for the same iteration.
The warp engine draws three tensors from that generator, in this order:
doc uniforms (C, 3, N), word uniforms (C, 2, N) and accept uniforms
(C, 2, N) (``draw_warp_uniforms``). ``_iteration`` and ``_warp_iteration``
take the uniforms as an argument, so tests can hand them the reference's
own draw.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import balance as balance_mod
from repro_torch.core import esca, mh, sparse, three_branch
from repro_torch.kernels import ops as kops
from repro_torch.kernels.sample_fused import (sample_fused_rows,
                                              sample_fused_tiled_rows,
                                              window_rows)
from repro_torch.kernels.sample_warp import (alias_tables, warp_chain_rows,
                                             warp_chain_rows_plain,
                                             warp_chain_tiled_rows,
                                             warp_chain_tiled_rows_plain)
from repro_torch.lda.model import (HybridLayout, LDAState, SparseLDAState,
                                   uniforms_generator)

__all__ = ["FusedState", "FusedPipeline", "HybridFusedPipeline",
           "scatter_changed_deltas", "branch_stats", "plan_capacity",
           "plan_tile_capacity", "plan_window", "draw_uniforms",
           "draw_warp_uniforms", "build_warp_proposal",
           "TILE_WORKING_SET_BYTES"]

# Per-tile phase-2 working set (capacity · K · 4 B): the reference's
# budget for a tile's gathered rows (its shared-memory-sized block).
TILE_WORKING_SET_BYTES = 1 << 18


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


def draw_warp_uniforms(seed: int, iteration: int, n: int, n_cycles: int,
                       device: torch.device):
    """The warp engine's uniforms of iteration ``iteration`` (0-based):
    (doc (C, 3, n), word (C, 2, n), accept (C, 2, n)) float32, drawn in
    that order from the iteration's generator."""
    g = uniforms_generator(seed, iteration + 1, device)
    return tuple(torch.rand((n_cycles, k, n), generator=g, device=device,
                            dtype=torch.float32) for k in (3, 2, 2))


def build_warp_proposal(W: torch.Tensor, colsum: torch.Tensor, beta: float,
                        *, kernel: bool = True) -> mh.AliasTables:
    """The warp proposal from the live integer counts: alias tables over
    W̃ = Ŵ of these counts (``kernel``: the pairing loop on ``vose_build``,
    else ``mh.build_alias_tables``). The chain reads W̃ only through the
    tables' ``q``, so W̃ itself is not kept."""
    w_til = esca.compute_w_hat_from_colsum(W, colsum, beta)
    return alias_tables(w_til) if kernel else mh.build_alias_tables(w_til)


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


def plan_tile_capacity(ema_survivors: float, n_tokens: int,
                       n_topics: int, *, floor: int = 128) -> int:
    """Tile size under ``balance="tiles"``: the survivor-EMA capacity,
    capped by ``TILE_WORKING_SET_BYTES`` of (capacity, K) float32 rows and
    floored at ``floor`` tokens."""
    budget = TILE_WORKING_SET_BYTES // (4 * max(int(n_topics), 1))
    budget = max(floor, 1 << max(int(budget).bit_length() - 1, 0))
    return max(floor, min(plan_capacity(ema_survivors, n_tokens), budget))


def plan_window(max_span: float, n_words: int, *, floor: int = 64) -> int:
    """Tile word-window size from the observed survivor-tile word spans:
    the widest span, rounded up to a power of two, floored at ``floor``
    and capped at the vocabulary."""
    want = max(float(max_span), float(floor))
    win = 1 << max(int(want) - 1, 1).bit_length()
    return int(min(win, n_words))


class Tiles(NamedTuple):
    """The tiles of one survivor segment (tile c covers stream positions
    [c·capacity, (c+1)·capacity)): each tile's word run, and the
    reference's test of whether that run fits the window."""
    first: torch.Tensor      # (n_tiles,) int32 first word of each run
    last: torch.Tensor       # (n_tiles,) int32 last word
    fits: torch.Tensor       # (n_tiles,) bool: last − first < win_words


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
        # -- the warp MH engine: the static doc -> token index ---------------
        self.sampler = config.sampler
        self.doc_index = mh.build_doc_index(doc_ids, mask, n_docs) \
            if self.sampler == "warp" else None
        # -- tile-scheduled balancing (paper §V-A) --------------------------
        self.balance = config.balance
        self._span_ema: float | None = None
        self.win_words = n_words
        self.tile_routes = {"tiled": 0, "untiled": 0}   # tiles per route
        if self.balance == "tiles":
            if not self._capacity_pinned:
                # full-survivorship tile size; the EMA refines it later
                self.capacity = plan_tile_capacity(
                    self.n_tokens, self.n_tokens, config.n_topics)
            self._plan_tiles(word_ids)

    def _plan_tiles(self, word_ids: torch.Tensor) -> None:
        """First window, from the static corpus stream at the current
        tile size; re-planned from the live survivor tiles later."""
        plan = balance_mod.build_tiles_from_word_ids(
            word_ids.cpu().numpy(), min(self.capacity, self.n_tokens))
        self.win_words = plan_window(plan.max_words_per_tile, self.n_words)

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

    # -- tiles ---------------------------------------------------------------

    # a word window must be much narrower than the vocabulary to pay (the
    # reference's rule); wider streams still run in tiles, untiled
    WINDOW_VOCAB_FRACTION = 4

    def _use_tiles(self, win_words: int) -> bool:
        return self.balance == "tiles" \
            and win_words * self.WINDOW_VOCAB_FRACTION <= self.n_words

    def _chunk_run(self, v_s: torch.Tensor, capacity: int):
        """(first, last) word of every tile of a survivor stream ``v_s``:
        a segmented min and max over tiles of ``capacity`` tokens (the
        reference's per-chunk ``_chunk_run``, for all tiles at once)."""
        n = v_s.shape[0]
        n_tiles = -(-n // capacity)
        pad = n_tiles * capacity - n
        if pad:                      # repeat the last id: min/max unchanged
            v_s = torch.cat([v_s, v_s[-1:].expand(pad)])
        v = v_s.view(n_tiles, capacity)
        return (v.amin(dim=1).to(torch.int32),
                v.amax(dim=1).to(torch.int32))

    @staticmethod
    def _max_chunk_span(first: torch.Tensor, last: torch.Tensor) -> int:
        """Widest word span over a stream's tiles (0 without tiles)."""
        return int((last - first).max()) + 1 if first.numel() else 0

    def _tiles(self, v_s: torch.Tensor, capacity: int,
               win_words: int) -> Tiles:
        first, last = self._chunk_run(v_s, capacity)
        fits = (last - first) < win_words
        if not self._use_tiles(win_words):
            fits = torch.zeros_like(fits)
        return Tiles(first=first, last=last, fits=fits)

    def _run_segment(self, surv_idx, sample_chunk, new_topics, in_m_acc, *,
                     capacity: int, win_words: int) -> int:
        """Phase 2 over one compacted survivor stream; returns the widest
        tile span (for re-planning) or 0 without tiles.

        Without tiles: chunks of ``capacity``. With tiles: one call of the
        tiled sampler over the tiles that fit the window (their tokens
        concatenated in order, so tile c of the call is the c-th fitting
        tile and only the last can be short) and one of the untiled
        sampler over the rest.
        """
        n_s = surv_idx.shape[0]
        if self.balance != "tiles":
            for lo in range(0, n_s, capacity):
                idx = surv_idx[lo:lo + capacity]
                new_topics[idx], in_m_acc[idx] = sample_chunk(idx)
            return 0
        if n_s == 0:
            return 0
        tiles = self._tiles(self.word_ids[surv_idx], capacity, win_words)
        n_fit = int(tiles.fits.sum())
        self.tile_routes["tiled"] += n_fit
        self.tile_routes["untiled"] += tiles.fits.shape[0] - n_fit
        fit_tok = tiles.fits.repeat_interleave(capacity)[:n_s]
        for idx, sel in ((surv_idx[fit_tok], tiles.fits),
                         (surv_idx[~fit_tok], None)):
            if idx.shape[0]:
                window = None if sel is None \
                    else (tiles.first[sel], capacity, win_words)
                new_topics[idx], in_m_acc[idx] = sample_chunk(idx, window)
        return self._max_chunk_span(tiles.first, tiles.last)

    # -- the fused iteration -------------------------------------------------

    def _dense_chunk_sampler(self, u, word_ids, doc_ids, D, W_hat,
                             k1_per_word):
        """The phase-2 ``sample_chunk(idx, window=None) -> (topics, in_m)``
        closure. With ``window = (first, tile_size, win_words)`` — each
        tile's first word, tiles of ``tile_size`` tokens over ``idx`` — the
        Ŵ rows are read through the tiles' windows."""
        cfg = self.config
        alpha = cfg.alpha_

        def sample_chunk(idx, window=None):
            u_c, v_c, d_c = u[idx], word_ids[idx], doc_ids[idx]
            if cfg.impl == "kernel":
                if window is None:
                    t_c, m, s, q = sample_fused_rows(u_c, d_c, v_c, D, W_hat,
                                                     alpha=alpha)
                else:
                    first, size, win = window
                    t_c, m, s, q = sample_fused_tiled_rows(
                        u_c, d_c, v_c, first, size, D, W_hat,
                        win_words=win, alpha=alpha)
                return t_c, u_c * (m + s + q) < m
            if window is None:
                return three_branch.exact_three_branch(
                    u_c, v_c, d_c, k1_per_word, D, W_hat, alpha=alpha,
                    tile_size=cfg.tile_size)
            # the fitting tiles' windows laid end to end are rows of Ŵ
            first, size, win = window
            rows = window_rows(v_c.long(), first.long(), size, win,
                               self.n_words)
            return three_branch.exact_three_branch_tiled(
                u_c, rows, d_c, k1_per_word, D, W_hat, alpha=alpha,
                tile_size=cfg.tile_size)

        return sample_chunk

    def _iteration(self, fstate: FusedState, u: torch.Tensor, *,
                   capacity: int, win_words: int | None = None):
        """One iteration on uniforms ``u``; returns (state, stats, n_surv).

        Updates ``fstate``'s count tensors in place. The widest survivor
        tile span of the iteration is left in ``self.last_span``.
        """
        cfg = self.config
        alpha, g = cfg.alpha_, cfg.g
        word_ids, doc_ids, mask = self.word_ids, self.doc_ids, self.mask
        topics, D, W, colsum, iteration = fstate
        win = self.win_words if win_words is None else win_words

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
        self.last_span = self._run_segment(
            surv_idx, sample_chunk, new_topics, in_m_acc, capacity=capacity,
            win_words=win)

        st = branch_stats(dec.skip, in_m_acc, new_topics, topics, dec.k1)
        scatter_changed_deltas(topics, new_topics, doc_ids, word_ids, mask,
                               D=D, W=W, colsum=colsum)
        new_state = FusedState(topics=new_topics, D=D, W=W, colsum=colsum,
                               iteration=iteration + 1)
        return new_state, st, n_surv

    # -- the warp MH iteration ----------------------------------------------

    def _proposal_counts(self, fstate) -> tuple:
        """(W, colsum) the warp proposal builds from; the hybrid pipeline
        densifies its packed W."""
        return fstate.W, fstate.colsum

    def build_proposal(self, fstate) -> mh.AliasTables:
        """The warp proposal (alias tables over W̃) of ``fstate``'s counts."""
        W, colsum = self._proposal_counts(fstate)
        return build_warp_proposal(W, colsum, self.config.beta,
                                   kernel=self.config.impl == "kernel")

    def _warp_chunk_sampler(self, topics, t_doc, u_word, u_acc, D, W_hat,
                            tables: mh.AliasTables):
        """The warp ``sample_chunk(idx, window=None) -> (topics,
        accepted any)`` closure: the MH chain over tokens ``idx``, their
        rows read through the tiles' windows when ``window = (first,
        tile_size, win_words)`` is given."""
        cfg = self.config
        kernel = cfg.impl == "kernel"
        word_ids, doc_ids = self.word_ids, self.doc_ids

        def sample_chunk(idx, window=None):
            ids = (topics[idx], doc_ids[idx], word_ids[idx])
            rest = (t_doc[:, idx], u_word[:, :, idx], u_acc[:, :, idx], D,
                    W_hat, tables)
            if window is None:
                chain = warp_chain_rows if kernel else warp_chain_rows_plain
                s, n_acc = chain(*ids, *rest, alpha=cfg.alpha_)
            else:
                first, size, win = window
                chain = warp_chain_tiled_rows if kernel \
                    else warp_chain_tiled_rows_plain
                s, n_acc = chain(*ids, first, size, *rest, win_words=win,
                                 alpha=cfg.alpha_)
            return s, n_acc > 0

        return sample_chunk

    def _warp_iteration(self, fstate: FusedState, tables: mh.AliasTables, u,
                        *, capacity: int, win_words: int | None = None):
        """One warp iteration on uniforms ``u`` = (doc, word, accept)
        against the proposal ``tables``: doc proposals, then the MH chain
        over every real token on the chunk and tile machinery (MH has no
        skip: the survivors are the real tokens; padding keeps its topic),
        then the ±1 scatters. Returns (state, WarpStats, n_surv); updates
        ``fstate``'s count tensors in place."""
        cfg = self.config
        topics, D, W, colsum, iteration = fstate
        win = self.win_words if win_words is None else win_words
        u_doc, u_word, u_acc = u
        W_hat = esca.compute_w_hat_from_colsum(W, colsum, cfg.beta)
        t_doc = mh.doc_proposals(u_doc, topics, self.doc_ids, self.doc_index,
                                 n_topics=cfg.n_topics, alpha=cfg.alpha_)
        surv_idx = (self.mask > 0).nonzero().squeeze(1)
        n_surv = torch.tensor(surv_idx.shape[0], dtype=torch.int32)
        new_topics = topics.clone()
        acc_any = torch.zeros(topics.shape, dtype=torch.bool,
                              device=topics.device)
        sample_chunk = self._warp_chunk_sampler(topics, t_doc, u_word, u_acc,
                                                D, W_hat, tables)
        self.last_span = self._run_segment(
            surv_idx, sample_chunk, new_topics, acc_any, capacity=capacity,
            win_words=win)
        del W_hat, t_doc, sample_chunk
        st = mh.warp_stats(self.mask, acc_any, new_topics, topics,
                           cfg.mh_cycles)
        scatter_changed_deltas(topics, new_topics, self.doc_ids,
                               self.word_ids, self.mask, D=D, W=W,
                               colsum=colsum)
        return (FusedState(topics=new_topics, D=D, W=W, colsum=colsum,
                           iteration=iteration + 1), st, n_surv)

    # -- entry points ---------------------------------------------------------

    def step(self, fstate: FusedState, tables: mh.AliasTables | None = None):
        """One fused iteration: (state, stats, n_surv). The warp engine
        draws from ``tables`` when given, else from tables built from
        ``fstate``'s counts."""
        cfg = self.config
        if self.sampler == "warp":
            if tables is None:
                tables = self.build_proposal(fstate)
            u = draw_warp_uniforms(cfg.seed, fstate.iteration, self.n_tokens,
                                   cfg.mh_cycles, self.device)
            return self._warp_iteration(fstate, tables, u,
                                        capacity=self.capacity)
        u = draw_uniforms(cfg.seed, fstate.iteration, self.n_tokens,
                          self.device)
        return self._iteration(fstate, u, capacity=self.capacity)

    def run_fused(self, fstate: FusedState, n_iters: int,
                  replan: bool = True):
        """n_iters iterations. Returns (state, stats, n_surv), the stats
        and survivor counts stacked along a leading (n_iters,) axis. The
        warp proposal is built once, from the counts at the start, and
        held for every iteration of the call. With ``replan=True`` the
        survivor counts update the capacity EMA after the stretch, for the
        next one."""
        tables = self.build_proposal(fstate) \
            if self.sampler == "warp" and n_iters > 0 else None
        stats, n_surv, spans = [], [], []
        for _ in range(int(n_iters)):
            fstate, st, ns = self.step(fstate, tables)
            stats.append(st)
            n_surv.append(ns)
            spans.append(self.last_span)
        del tables
        kind = type(stats[0]) if stats else three_branch.ThreeBranchStats
        stacked = kind(*(
            torch.stack([torch.as_tensor(getattr(s, f)) for s in stats])
            for f in kind._fields))
        n_surv = torch.stack(n_surv)
        if replan:
            self.note_survivors(n_surv)
            if self.balance == "tiles":
                self.note_spans(spans)
        return fstate, stacked, n_surv

    # -- between-stretch capacity planning (host side) -----------------------

    def note_survivors(self, n_surv, decay: float = 0.7) -> None:
        vals = np.atleast_1d(np.asarray(torch.as_tensor(n_surv).cpu()))
        ema = self._surv_ema
        for v in vals.astype(np.float64):
            ema = float(v) if ema is None else decay * ema + (1 - decay) * v
        self._surv_ema = ema
        if not self._capacity_pinned:
            self.capacity = plan_tile_capacity(
                ema, self.n_tokens, self.config.n_topics) \
                if self.balance == "tiles" \
                else plan_capacity(ema, self.n_tokens)

    def note_spans(self, spans, decay: float = 0.7) -> None:
        """Re-tile: update the live word-span EMA and re-plan the window.

        The EMA is floored at the newest observed max, so the window lags
        only on shrink, never on growth: an undershot window sends tiles
        down the untiled route, an overshot one only widens the window.
        """
        m = float(np.max(np.atleast_1d(np.asarray(spans, np.float64))))
        ema = self._span_ema
        self._span_ema = m if ema is None \
            else max(m, decay * ema + (1 - decay) * m)
        self.win_words = plan_window(self._span_ema, self.n_words)


class HybridFusedPipeline(FusedPipeline):
    """The fused iteration over the hybrid sparse state (paper §IV).

    The state between iterations is a ``SparseLDAState``: packed sorted D
    rows and W as a dense head plus packed tail buckets. Each iteration
    densifies D and W once (exact integers), runs the dense pipeline's
    sampling on them, applies the same ±1 scatters, and repacks, as the
    reference does (the paper's kernels likewise densify rows into shared
    memory while the formats at rest stay packed).

    Phase 2 is dispatched by the T partition, split at the static
    ``layout.v_dense``. With ``tail_sampler="exact"`` both partitions run
    the dense exact draw as one segment, bitwise equal to the dense
    ``FusedPipeline``. With ``"sparse"`` the head and tail survivors are
    compacted separately: the head runs the dense draw, the tail the O(L)
    sparse draw over the packed D rows (``kernels/ops.py``
    ``sparse_tail_draw_rows``), which draws from the same distribution
    with another order of the topics, so it is equal in distribution,
    not in bits. As in the reference, the tail takes the sparse kernel
    whatever ``impl`` says.
    """

    def __init__(self, word_ids: torch.Tensor, doc_ids: torch.Tensor,
                 mask: torch.Tensor, *, n_docs: int, n_words: int, config,
                 corpus):
        super().__init__(word_ids, doc_ids, mask, n_docs=n_docs,
                         n_words=n_words, config=config)
        self.layout = HybridLayout.build(corpus, config)
        self.head_mask = word_ids < self.layout.v_dense
        self.n_head = int(self.head_mask.sum())
        self.n_tail = self.n_tokens - self.n_head
        self.last_survivors = {"head": 0, "tail": 0}

    # -- state conversion --------------------------------------------------

    def from_lda_state(self, state: LDAState) -> SparseLDAState:
        """Dense LDAState -> SparseLDAState, in fresh buffers."""
        return self.layout.to_sparse(state)

    def to_lda_state(self, hs: SparseLDAState) -> LDAState:
        return self.layout.to_dense(hs)

    def _repack_counts(self, d_new, w_new, overflow):
        """Updated dense matrices -> sorted packed state; the overflow
        tripwire stays 0 because capacities are row-nnz upper bounds."""
        lay = self.layout
        d_packed, ov = sparse.pack_rows_sorted(d_new, lay.d_capacity)
        overflow = overflow + ov
        w_tail = []
        for start, end, cap in lay.tail_ranges():
            bucket, ov = sparse.pack_rows_sorted(w_new[start:end], cap)
            w_tail.append(bucket)
            overflow = overflow + ov
        return d_packed, w_new[:lay.v_dense].clone(), tuple(w_tail), overflow

    # -- the warp MH iteration ----------------------------------------------

    def _proposal_counts(self, hs: SparseLDAState) -> tuple:
        # the tables build over the densified W (exact integers): one
        # densify per build, not per iteration
        return self.layout.densify_w(hs.W_head, hs.W_tail), hs.colsum

    def _warp_iteration(self, hs: SparseLDAState, tables: mh.AliasTables, u,
                        *, capacity: int, win_words: int | None = None):
        """The warp iteration over the packed state: densify once (exact
        integers), run the dense pipeline's warp iteration on the dense
        matrices, repack once, so it is bitwise the dense one. The T
        partition does not split: the chain reads rows of the densified
        matrices, so head and tail words route alike (``tail_sampler`` is
        a knob of the exact sampler)."""
        lay = self.layout
        topics, d_packed, w_head, w_tail, colsum, overflow, iteration = hs
        dense = FusedState(
            topics=topics,
            D=sparse.densify_rows_sorted(d_packed, lay.n_topics),
            W=lay.densify_w(w_head, w_tail), colsum=colsum,
            iteration=iteration)
        self.last_survivors = {}
        fs, st, n_surv = super()._warp_iteration(
            dense, tables, u, capacity=capacity, win_words=win_words)
        d_packed, w_head, w_tail, overflow = self._repack_counts(
            fs.D, fs.W, overflow)
        return (SparseLDAState(
            topics=fs.topics, D=d_packed, W_head=w_head, W_tail=w_tail,
            colsum=fs.colsum, overflow=overflow, iteration=fs.iteration),
            st, n_surv)

    # -- the fused iteration -------------------------------------------------

    def _iteration(self, hs: SparseLDAState, u: torch.Tensor, *,
                   capacity: int, win_words: int | None = None):
        """One iteration on uniforms ``u``; returns (state, stats, n_surv)
        with ``n_surv`` over both segments. ``self.last_survivors`` holds
        the head and tail survivor counts, ``self.last_span`` the widest
        survivor tile span."""
        cfg, lay = self.config, self.layout
        alpha, g = cfg.alpha_, cfg.g
        word_ids, doc_ids, mask = self.word_ids, self.doc_ids, self.mask
        win = self.win_words if win_words is None else win_words
        topics, d_packed, w_head, w_tail, colsum, overflow, iteration = hs

        # densify once: exact integers, so everything downstream is the
        # dense pipeline's arithmetic
        d_dense = sparse.densify_rows_sorted(d_packed, lay.n_topics)
        w_int = lay.densify_w(w_head, w_tail)
        w_hat = esca.compute_w_hat_from_colsum(w_int, colsum, cfg.beta)
        stats_w = three_branch.word_stats(w_hat, g=g, alpha=alpha)
        dec = three_branch.skip_phase(u, word_ids, doc_ids, d_dense,
                                      stats_w, g=g, alpha=alpha)
        k1_per_word = stats_w.k[:, 0].contiguous()
        a1_per_word = stats_w.a[:, 0].contiguous()

        dense_chunk = self._dense_chunk_sampler(
            u, word_ids, doc_ids, d_dense, w_hat, k1_per_word)

        def sparse_tail_chunk(idx, window=None):
            u_c, v_c, d_c = u[idx], word_ids[idx], doc_ids[idx]
            b1 = d_dense[d_c.long(), k1_per_word[v_c.long()].long()].float()
            t_c, _needs_q, in_m = kops.sparse_tail_draw_rows(
                u_c, d_c, v_c, d_packed, w_hat, k1_per_word, a1_per_word,
                stats_w.q_prime, b1, alpha=alpha,
                tiles=None if window is None else window[:2],
                win_words=None if window is None else window[2])
            return t_c, in_m

        # phase 2, dispatched by the T partition; with the exact tail
        # sampler both partitions route alike and run as one segment
        if cfg.tail_sampler == "sparse" and self.n_tail:
            segments = [("head", self.head_mask, self.n_head, dense_chunk),
                        ("tail", ~self.head_mask, self.n_tail,
                         sparse_tail_chunk)]
        else:
            segments = [("head", None, self.n_tokens, dense_chunk)]
        new_topics = dec.k1.clone()                     # skipped ⇒ K1
        in_m_acc = torch.zeros_like(dec.skip)
        self.last_survivors = {"head": 0, "tail": 0}
        self.last_span = 0
        for name, seg_mask, n_seg, chunk_fn in segments:
            if n_seg == 0:
                continue
            skip_seg = dec.skip if seg_mask is None else dec.skip | ~seg_mask
            rank, n_surv = three_branch.survivor_rank(skip_seg)
            n_s = int(n_surv)
            surv_idx = three_branch.compact_survivor_indices(
                rank, skip_seg, n_s).long()
            del rank, skip_seg
            self.last_survivors[name] = n_s
            self.last_span = max(self.last_span, self._run_segment(
                surv_idx, chunk_fn, new_topics, in_m_acc, capacity=capacity,
                win_words=win))

        # the same ±1 scatters as the dense pipeline, into the densified
        # matrices (their sampling consumers are done), then repack
        scatter_changed_deltas(topics, new_topics, doc_ids, word_ids, mask,
                               D=d_dense, W=w_int, colsum=colsum)
        d_packed, w_head, w_tail, overflow = self._repack_counts(
            d_dense, w_int, overflow)
        st = branch_stats(dec.skip, in_m_acc, new_topics, topics, dec.k1)
        n_total = torch.tensor(sum(self.last_survivors.values()),
                               dtype=torch.int32)
        new_state = SparseLDAState(
            topics=new_topics, D=d_packed, W_head=w_head, W_tail=w_tail,
            colsum=colsum, overflow=overflow, iteration=iteration + 1)
        return new_state, st, n_total
