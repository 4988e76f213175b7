"""The fused LDA training iteration, dense and hybrid state, one device.

Port of the single-device, three-branch part of
``src/repro/train/lda_step.py``. One iteration (``FusedPipeline._iteration``)
runs, back to back on the state's device:

  1. Ŵ from the maintained int32 column sum (no O(V·K) reduction);
  2. per-word top-(g+1) stats and the phase-1 skip test for every token;
  3. survivor compaction, then phase 2: the ``sample_fused`` kernel when
     ``config.impl == "kernel"`` (fed the words' K1, a1 and Q' from step
     2), the plain ``three_branch.exact_three_branch`` when ``"torch"``;
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
iteration is ``_warp_iteration``: the MH chain over every real token, its
doc proposals drawn inside (the ``warp_chain`` kernel's main-path entries
when ``impl == "kernel"``, which read the corpus streams in place and
write the topics where they belong; their plain twins when ``"torch"``),
on the same chunk and tile machinery, then the same ±1 scatters. The
alias tables (``build_warp_proposal``: the ``vose_build`` kernel, queues
built inside, over W̃) are built once per ``run_fused`` call from the
counts at its start and held fixed for that call's iterations: the
reference's staleness, which MH makes sound. ``step`` builds them afresh.

Where the reference compiles this into one donated ``lax.scan`` with no
host sync, PyTorch runs it eagerly: the survivor count is read back to
size the chunk loop, the changed-token count to size the scatters, and
the state is updated in place (the pipeline owns the tensors it was handed
by ``from_lda_state``).

Streaming (``corpus_residency="streamed"`` and ``"disk"``):
``StreamingPipeline`` and ``StreamingHybridPipeline`` run an iteration as
an epoch over the shards of a ``ShardedCorpus`` or a ``CorpusStore``, each
shard through the resident iteration's own body (``_sample``) against the
epoch-start counts, its ±1 moves scattered into delta tensors by the same
``scatter_changed_deltas``; the next shard loads on a worker thread and
is copied on a side CUDA stream while the current one samples
(``_Prefetcher``). The planners (``plan_stream_shards``,
``resolve_residency``) and the mid-epoch checkpoint keys
(``STREAM_PAYLOAD_KEYS``) live here too.

Randomness: iteration ``i`` draws its (N,) uniforms from
``lda.model.uniforms_generator(config.seed, i + 1)`` on the state's
device, so a run resumed from ``{topics, iteration}`` continues exactly,
and the stepwise trainer draws the same uniforms for the same iteration.
The warp engine draws three tensors from that generator, in this order:
doc uniforms (C, 3, N), word uniforms (C, 2, N) and accept uniforms
(C, 2, N) (``draw_warp_uniforms``). ``_iteration`` and ``_warp_iteration``
take the uniforms as an argument, so tests can hand them the reference's
own draw.

The failure model (as in the reference): each pipeline's ``selfcheck``
runs the count tripwires of ``lda/invariants.py`` on its live state, the
warp proposal's tables are checked when built, and the streaming epoch
checks its deltas before they land and its counts after, all under
``config.selfcheck``; an armed chaos plan (``runtime/chaos.py``) fires in
the shard loads and before each shard. Off, each hook is one flag test.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import time
import warnings
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import balance as balance_mod
from repro_torch.core import esca, mh, sparse, three_branch
from repro_torch.core import llpt as llpt_mod
from repro_torch.kernels import histogram as _hist
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import histogram_ref
from repro_torch.kernels.sample_fused import (sample_fused_rows,
                                              sample_fused_tiled_rows,
                                              window_rows)
from repro_torch.kernels.sample_warp import (
    alias_tables, check_doc_streams, warp_chain_tokens,
    warp_chain_tokens_plain, warp_chain_tokens_tiled,
    warp_chain_tokens_tiled_plain)
from repro_torch.lda import invariants
from repro_torch.lda.model import (HybridLayout, LDAState, SparseLDAState,
                                   uniforms_generator)
from repro_torch.runtime import chaos

__all__ = ["FusedState", "FusedPipeline", "HybridFusedPipeline",
           "scatter_changed_deltas", "survivor_indices",
           "branch_stats", "plan_capacity",
           "plan_tile_capacity", "plan_window", "draw_uniforms",
           "draw_warp_uniforms", "build_warp_proposal", "repack_counts",
           "TILE_WORKING_SET_BYTES",
           "STREAM_BYTES_PER_TOKEN", "RESIDENT_BYTES_PER_TOKEN",
           "STREAM_WINDOW_BYTES_PER_TOKEN",
           "STREAM_WINDOW_BUDGET_FRACTION", "STREAM_PAYLOAD_KEYS",
           "plan_stream_shards", "resolves_to_disk", "resolve_residency",
           "device_budget", "PrefetchTimeout", "StreamState", "HostPages",
           "StreamingPipeline", "StreamingHybridPipeline"]

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
    W̃ = Ŵ of these counts (``kernel``: queues and pairing loop in the
    ``vose_build`` kernel, else ``mh.build_alias_tables``). The chain
    reads W̃ only through the tables' ``q``, so W̃ itself is not kept."""
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


def _writing(sample_chunk, out):
    """The ``sample_chunk`` that ``_run_segment`` calls, from one that
    returns its tokens' (topics, flags): it writes them at ``idx`` into
    ``out`` = (topics, flags)."""
    new_topics, flags = out

    def write(idx, window=None):
        new_topics[idx], flags[idx] = sample_chunk(idx, window)

    return write


def survivor_indices(skip: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The tokens not in ``skip`` as int64 indices in T order (the order
    ``three_branch.compact_survivor_indices`` gives), and their count. A
    draw reads only its own u and rows, and the counts change after phase
    2, so the order of the survivors changes no result."""
    surv = (~skip).nonzero().squeeze(1)   # host sync: sizes the chunk loop
    return surv, surv.shape[0]


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
        self.word_ids = word_ids
        self.doc_ids = doc_ids
        self.mask = mask
        self.device = word_ids.device
        self._init_plan(config, n_docs=n_docs, n_words=n_words,
                        n_tokens=int(word_ids.shape[0]))
        # -- the warp MH engine: the static doc -> token index and the real
        # tokens (int32), the chain's survivors; ids checked once here -----
        self.doc_index = self.real_idx = None
        if self.sampler == "warp":
            self.doc_index = mh.build_doc_index(doc_ids, mask, n_docs)
            check_doc_streams(doc_ids, word_ids, self.doc_index,
                              n_docs=n_docs, n_words=n_words)
            self.real_idx = (mask > 0).nonzero().squeeze(1).to(torch.int32)
        if self.balance == "tiles":
            self._plan_tiles(word_ids)

    def _init_plan(self, config, *, n_docs: int, n_words: int,
                   n_tokens: int) -> None:
        """Shapes and the chunk and tile plans, from the token count."""
        self.config = config
        self.n_docs = n_docs
        self.n_words = n_words
        self.n_tokens = n_tokens
        cap = config.survivor_capacity
        self.capacity = min(max(int(cap) if cap else self.n_tokens, 1),
                            max(self.n_tokens, 1))
        # an explicitly configured capacity is pinned: the EMA keeps
        # tracking survivors but never overrides the user's knob
        self._capacity_pinned = cap is not None
        self._surv_ema: float | None = None
        self.last_n_surv = 0        # the newest iteration's survivors
        self.sampler = config.sampler
        # -- tile-scheduled balancing (paper §V-A) --------------------------
        self.balance = config.balance
        self._span_ema: float | None = None
        self.win_words = n_words
        self.tile_routes = {"tiled": 0, "untiled": 0}   # tiles per route
        if self.balance == "tiles" and not self._capacity_pinned:
            # full-survivorship tile size; the EMA refines it later
            self.capacity = plan_tile_capacity(
                self.n_tokens, self.n_tokens, config.n_topics)

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

    # -- count-invariant tripwires (config.selfcheck, lda/invariants.py) ----

    def _n_real_tokens(self) -> int:
        n = getattr(self, "_n_real", None)
        if n is None:
            n = self._n_real = int(self.mask.sum(dtype=torch.int64))
        return n

    def selfcheck(self, fstate) -> None:
        """Count-invariant tripwire on the live state (``config.selfcheck``):
        reduced on the state's device, one readback, so callers run it at
        chunk boundaries, not per step."""
        invariants.check_dense_counts(
            fstate.D, fstate.W, fstate.colsum,
            n_tokens=self._n_real_tokens(),
            where=f"chunk boundary (iteration {int(fstate.iteration)})")

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

    def _run_segment(self, surv_idx, word_ids, sample_chunk, *,
                     capacity: int, win_words: int) -> int:
        """Phase 2 over one compacted survivor stream of the tokens
        ``word_ids``; returns the widest tile span (for re-planning) or 0
        without tiles. ``sample_chunk(idx, window=None)`` samples the
        tokens ``idx`` and writes their results.

        Without tiles: chunks of ``capacity``. With tiles: one call of the
        tiled sampler over the tiles that fit the window (their tokens
        concatenated in order, so tile c of the call is the c-th fitting
        tile and only the last can be short) and one of the untiled
        sampler over the rest.
        """
        n_s = surv_idx.shape[0]
        if self.balance != "tiles":
            for lo in range(0, n_s, capacity):
                sample_chunk(surv_idx[lo:lo + capacity])
            return 0
        if n_s == 0:
            return 0
        tiles = self._tiles(word_ids[surv_idx], capacity, win_words)
        n_fit = int(tiles.fits.sum())
        self.tile_routes["tiled"] += n_fit
        self.tile_routes["untiled"] += tiles.fits.shape[0] - n_fit
        fit_tok = tiles.fits.repeat_interleave(capacity)[:n_s]
        for idx, sel in ((surv_idx[fit_tok], tiles.fits),
                         (surv_idx[~fit_tok], None)):
            if idx.shape[0]:
                window = None if sel is None \
                    else (tiles.first[sel], capacity, win_words)
                sample_chunk(idx, window)
        return self._max_chunk_span(tiles.first, tiles.last)

    # -- the fused iteration -------------------------------------------------

    def _dense_chunk_sampler(self, u, word_ids, doc_ids, D, W_hat,
                             stats_w: three_branch.WordStats):
        """The phase-2 ``sample_chunk(idx, window=None) -> (topics, in_m)``
        closure. With ``window = (first, tile_size, win_words)`` — each
        tile's first word, tiles of ``tile_size`` tokens over ``idx`` — the
        Ŵ rows are read through the tiles' windows. The kernels take the
        words' K1, a1 and Q' from ``stats_w``."""
        cfg = self.config
        alpha = cfg.alpha_
        k1_per_word = stats_w.k[:, 0].contiguous()
        stats = (k1_per_word, stats_w.a[:, 0].contiguous(),
                 stats_w.q_prime.contiguous())

        def sample_chunk(idx, window=None):
            u_c, v_c, d_c = u[idx], word_ids[idx], doc_ids[idx]
            if cfg.impl == "kernel":
                if window is None:
                    t_c, m, s, q = sample_fused_rows(u_c, d_c, v_c, D, W_hat,
                                                     *stats, alpha=alpha)
                else:
                    first, size, win = window
                    t_c, m, s, q = sample_fused_tiled_rows(
                        u_c, d_c, v_c, first, size, D, W_hat, *stats,
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

    def _sparse_tail_sampler(self, u, word_ids, doc_ids, D, d_packed,
                             W_hat, stats_w: three_branch.WordStats):
        """The hybrid tail's ``sample_chunk(idx, window=None) -> (topics,
        in_m)``: the O(L) draw over the packed D rows ``d_packed`` (its b1
        from the dense ``D``), the Q' branch finished in the kernel."""
        alpha = self.config.alpha_
        k1_w = stats_w.k[:, 0].contiguous()
        a1_w = stats_w.a[:, 0].contiguous()

        def sample_chunk(idx, window=None):
            u_c, v_c, d_c = u[idx], word_ids[idx], doc_ids[idx]
            b1 = D[d_c.long(), k1_w[v_c.long()].long()].float()
            t_c, _needs_q, in_m = kops.sparse_tail_draw_rows(
                u_c, d_c, v_c, d_packed, W_hat, k1_w, a1_w,
                stats_w.q_prime, b1, alpha=alpha,
                tiles=None if window is None else window[:2],
                win_words=None if window is None else window[2])
            return t_c, in_m

        return sample_chunk

    def _sample(self, u, word_ids, doc_ids, D, W_hat,
                stats_w: three_branch.WordStats, *, capacity: int,
                win_words: int, sparse_tail=None):
        """Sampling of one token list against fixed counts: the skip test,
        then phase 2 over the survivors. The resident iteration hands it
        the whole corpus, a streamed epoch one shard at a time; ``D``,
        ``W_hat`` and ``stats_w`` are the iteration's. ``word_ids`` index
        the rows of ``W_hat`` and ``stats_w`` (window-local ids when W is
        paged). With ``sparse_tail = (d_packed, head_mask)`` the head and
        tail survivors are compacted apart and the tail takes the sparse
        draw. Returns (skip decision, new topics, in_m, survivors by
        segment); the widest tile span is left in ``self.last_span``."""
        cfg = self.config
        dec = three_branch.skip_phase(u, word_ids, doc_ids, D, stats_w,
                                      g=cfg.g, alpha=cfg.alpha_)
        dense_chunk = self._dense_chunk_sampler(u, word_ids, doc_ids, D,
                                                W_hat, stats_w)
        if sparse_tail is None:
            segments = [("head", None, dense_chunk)]
        else:
            d_packed, head_mask = sparse_tail
            segments = [("head", head_mask, dense_chunk),
                        ("tail", ~head_mask, self._sparse_tail_sampler(
                            u, word_ids, doc_ids, D, d_packed, W_hat,
                            stats_w))]
        new_topics = dec.k1.clone()                     # skipped ⇒ K1
        in_m_acc = torch.zeros_like(dec.skip)
        survivors = {"head": 0, "tail": 0}
        self.last_span = 0
        for name, seg_mask, chunk_fn in segments:
            skip_seg = dec.skip if seg_mask is None else dec.skip | ~seg_mask
            surv_idx, n_s = survivor_indices(skip_seg)
            del skip_seg
            survivors[name] = n_s
            if n_s == 0:
                continue
            self.last_span = max(self.last_span, self._run_segment(
                surv_idx, word_ids, _writing(chunk_fn, (new_topics,
                                                        in_m_acc)),
                capacity=capacity, win_words=win_words))
        return dec, new_topics, in_m_acc, survivors

    def _iteration(self, fstate: FusedState, u: torch.Tensor, *,
                   capacity: int, win_words: int | None = None):
        """One iteration on uniforms ``u``; returns (state, stats, n_surv).

        Updates ``fstate``'s count tensors in place. The widest survivor
        tile span of the iteration is left in ``self.last_span``.
        """
        cfg = self.config
        word_ids, doc_ids, mask = self.word_ids, self.doc_ids, self.mask
        topics, D, W, colsum, iteration = fstate
        W_hat = esca.compute_w_hat_from_colsum(W, colsum, cfg.beta)
        stats_w = three_branch.word_stats(W_hat, g=cfg.g, alpha=cfg.alpha_)
        dec, new_topics, in_m_acc, survivors = self._sample(
            u, word_ids, doc_ids, D, W_hat, stats_w, capacity=capacity,
            win_words=self.win_words if win_words is None else win_words)
        n_surv = torch.tensor(survivors["head"], dtype=torch.int32)
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
        """The warp proposal (alias tables over W̃) of ``fstate``'s counts.
        Under ``config.selfcheck`` the freshly built tables run the alias
        invariants before any chain reads them."""
        W, colsum = self._proposal_counts(fstate)
        tables = build_warp_proposal(W, colsum, self.config.beta,
                                     kernel=self.config.impl == "kernel")
        if self.config.selfcheck:
            invariants.check_alias_tables(
                tables.prob, tables.alias, tables.q,
                where=f"warp proposal build (iteration "
                      f"{int(fstate.iteration)})")
        return tables

    def _warp_chunk_sampler(self, topics, u, D, W_hat,
                            tables: mh.AliasTables, out):
        """The warp ``sample_chunk(idx, window=None)`` closure: the MH chain
        over tokens ``idx`` of the corpus streams (doc proposals drawn
        inside), their rows read through the tiles' windows when ``window =
        (first, tile_size, win_words)`` is given; writes ``out`` = (topics,
        accepted counts) at ``idx``."""
        cfg = self.config
        kernel = cfg.impl == "kernel"
        streams = (topics, self.doc_ids, self.word_ids, *u, D, W_hat, tables,
                   self.doc_index)

        def sample_chunk(idx, window=None):
            if window is None:
                chain = warp_chain_tokens if kernel \
                    else warp_chain_tokens_plain
                chain(idx, *streams, alpha=cfg.alpha_, out=out)
            else:
                first, size, win = window
                chain = warp_chain_tokens_tiled if kernel \
                    else warp_chain_tokens_tiled_plain
                chain(idx, first, size, *streams, win_words=win,
                      alpha=cfg.alpha_, out=out)

        return sample_chunk

    def _warp_iteration(self, fstate: FusedState, tables: mh.AliasTables, u,
                        *, capacity: int, win_words: int | None = None):
        """One warp iteration on uniforms ``u`` = (doc, word, accept)
        against the proposal ``tables``: the MH chain, doc proposals drawn
        inside, over every real token on the chunk and tile machinery (MH
        has no skip: the survivors are the real tokens; padding keeps its
        topic), then the ±1 scatters. Returns (state, WarpStats, n_surv);
        updates ``fstate``'s count tensors in place."""
        cfg = self.config
        topics, D, W, colsum, iteration = fstate
        win = self.win_words if win_words is None else win_words
        W_hat = esca.compute_w_hat_from_colsum(W, colsum, cfg.beta)
        surv_idx = self.real_idx
        n_surv = torch.tensor(surv_idx.shape[0], dtype=torch.int32)
        new_topics = topics.clone()
        accepted = torch.zeros(topics.shape, dtype=torch.uint8,
                               device=topics.device)
        sample_chunk = self._warp_chunk_sampler(topics, u, D, W_hat, tables,
                                                (new_topics, accepted))
        self.last_span = self._run_segment(
            surv_idx, self.word_ids, sample_chunk, capacity=capacity,
            win_words=win)
        del W_hat, sample_chunk
        st = mh.warp_stats(self.mask, accepted > 0, new_topics, topics,
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
        if vals.size:
            self.last_n_surv = int(vals[-1])
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

    def selfcheck(self, hs: SparseLDAState) -> None:
        invariants.check_packed_counts(
            hs.colsum, hs.overflow, n_tokens=self._n_real_tokens(),
            where=f"chunk boundary (iteration {int(hs.iteration)})")

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
        d_packed, w_head, w_tail, overflow = repack_counts(
            self.layout, fs.D, fs.W, overflow)
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
        word_ids, doc_ids, mask = self.word_ids, self.doc_ids, self.mask
        topics, d_packed, w_head, w_tail, colsum, overflow, iteration = hs

        # densify once: exact integers, so everything downstream is the
        # dense pipeline's arithmetic
        d_dense = sparse.densify_rows_sorted(d_packed, lay.n_topics)
        w_int = lay.densify_w(w_head, w_tail)
        w_hat = esca.compute_w_hat_from_colsum(w_int, colsum, cfg.beta)
        stats_w = three_branch.word_stats(w_hat, g=cfg.g, alpha=cfg.alpha_)
        # phase 2, dispatched by the T partition; with the exact tail
        # sampler both partitions route alike and run as one segment
        sparse_tail = (d_packed, self.head_mask) \
            if cfg.tail_sampler == "sparse" and self.n_tail else None
        dec, new_topics, in_m_acc, self.last_survivors = self._sample(
            u, word_ids, doc_ids, d_dense, w_hat, stats_w,
            capacity=capacity,
            win_words=self.win_words if win_words is None else win_words,
            sparse_tail=sparse_tail)

        # the same ±1 scatters as the dense pipeline, into the densified
        # matrices (their sampling consumers are done), then repack
        scatter_changed_deltas(topics, new_topics, doc_ids, word_ids, mask,
                               D=d_dense, W=w_int, colsum=colsum)
        d_packed, w_head, w_tail, overflow = repack_counts(
            self.layout, d_dense, w_int, overflow)
        st = branch_stats(dec.skip, in_m_acc, new_topics, topics, dec.k1)
        n_total = torch.tensor(sum(self.last_survivors.values()),
                               dtype=torch.int32)
        new_state = SparseLDAState(
            topics=new_topics, D=d_packed, W_head=w_head, W_tail=w_tail,
            colsum=colsum, overflow=overflow, iteration=iteration + 1)
        return new_state, st, n_total


def repack_counts(layout: HybridLayout, d_new, w_new, overflow):
    """Updated dense matrices -> the sorted packed state (D rows, W head,
    W tail buckets) and the overflow tripwire, which stays 0 because the
    capacities are row-nnz upper bounds."""
    d_packed, ov = sparse.pack_rows_sorted(d_new, layout.d_capacity)
    overflow = overflow + ov
    w_tail = []
    for start, end, cap in layout.tail_ranges():
        bucket, ov = sparse.pack_rows_sorted(w_new[start:end], cap)
        w_tail.append(bucket)
        overflow = overflow + ov
    return d_packed, w_new[:layout.v_dense].clone(), tuple(w_tail), overflow


# ---------------------------------------------------------------------------
# out-of-core streaming (corpus_residency="streamed" and "disk")
# ---------------------------------------------------------------------------

# Device bytes per resident token: word + doc + mask + topic, int32 each.
STREAM_BYTES_PER_TOKEN = 16

# Peak device bytes per token of the port's resident three-branch paths, by
# which the residency auto-policy prices keeping a corpus resident: the
# paper configuration's peak of 25,791,926,272 B over 99,992,516 tokens at
# K = 1000 (chip_smoke.py, H100). It holds the token list, the uniforms,
# the skip test's per-token temporaries, the survivor index and the count
# matrices. The reference prices the token list alone
# (STREAM_BYTES_PER_TOKEN), which would keep corpora of ~0.17-2.6 G tokens
# resident on an 80 GB card that cannot hold them.
RESIDENT_BYTES_PER_TOKEN = 258

# Device bytes per token of a streamed shard window: the resident
# quadruple plus the shard's slice of the epoch's uniforms (float32).
STREAM_WINDOW_BYTES_PER_TOKEN = STREAM_BYTES_PER_TOKEN + 4

# The double-buffered token window may use 1/4 of the device budget; the
# rest stays free for D, W, Ŵ, the epoch's delta matrices and temporaries.
STREAM_WINDOW_BUDGET_FRACTION = 4

# The canonical checkpoint payload's mid-epoch keys. Every conversion of a
# payload passes them through: a dropped key would bypass the mid-epoch
# restore guards.
STREAM_PAYLOAD_KEYS = ("stream_cursor", "stream_done_topics",
                       "stream_n_shards")

# Least rows of a paged W window (when V has them): ``three_branch.row_sum``
# sums a window's Ŵ rows as the full matrix's only with more than one row
# (on the CPU a one-output reduction may split its row across threads).
PAGE_ROWS_FLOOR = 2


def plan_stream_shards(n_padded_tokens: int, budget_bytes: int | None, *,
                       multiple: int = 1, floor: int = 4) -> int:
    """Shard count so that two shards' token buffers fit the window budget:
    ``2 · 20 B · ceil(N/S) <= budget / STREAM_WINDOW_BUDGET_FRACTION``,
    at least ``floor`` shards, at most one pad multiple a shard."""
    if n_padded_tokens <= 0:
        return 1
    shards = floor
    if budget_bytes:
        window = max(budget_bytes // STREAM_WINDOW_BUDGET_FRACTION, 1)
        shards = max(shards, -(-2 * STREAM_WINDOW_BYTES_PER_TOKEN
                               * n_padded_tokens // window))
    max_shards = max(n_padded_tokens // max(multiple, 1), 1)
    return int(min(shards, max_shards))


def resolves_to_disk(config) -> bool:
    """True iff ``config`` trains disk-native: residency "disk", or "auto"
    with a ``corpus_path`` (which resolves to "disk" before any budget
    probe)."""
    return config.corpus_residency == "disk" or (
        config.corpus_residency == "auto"
        and config.corpus_path is not None)


_BUDGET_WARNED = False


def device_budget(device) -> int | None:
    """Half the card's memory (``total_memory``), or None on the CPU,
    which has no budget to plan from (warned once a process)."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory) // 2
    global _BUDGET_WARNED
    if not _BUDGET_WARNED:
        _BUDGET_WARNED = True
        warnings.warn(
            "resolve_residency: the CPU has no device budget, so "
            "corpus_residency='auto' resolves to 'full' and 'streamed' "
            "takes the minimum shard count — set "
            "LDAConfig.device_budget_bytes to make the residency decision "
            "explicit", RuntimeWarning, stacklevel=3)
    return None


def resolve_residency(config, n_padded_tokens: int,
                      device=None) -> tuple[str, int]:
    """(residency, n_shards) for one (config, corpus) pair.

    "full" and "streamed" are honoured as written; "auto" with a
    ``corpus_path`` is "disk", whose shard count the store fixes (0 here);
    else "auto" streams iff the resident path's bytes
    (``RESIDENT_BYTES_PER_TOKEN`` · N) exceed the budget:
    ``config.device_budget_bytes``, else ``device_budget(device)`` (none on
    the CPU: the corpus stays resident). Only this price differs from the
    reference's policy.
    """
    mode = config.corpus_residency
    if mode == "auto" and config.corpus_path is not None:
        mode = "disk"
    if mode == "disk":
        return "disk", 0
    budget = config.device_budget_bytes
    if budget is None and (mode == "auto" or (
            mode == "streamed" and config.stream_shards is None)):
        # the budget feeds both the auto policy and the shard planner
        budget = device_budget(device)
    if mode == "auto":
        if budget is None:
            return "full", 1
        mode = "streamed" if (RESIDENT_BYTES_PER_TOKEN * n_padded_tokens
                              > budget) else "full"
    if mode == "full":
        return "full", 1
    if config.stream_shards is not None:
        return "streamed", max(int(config.stream_shards), 2)
    return "streamed", max(plan_stream_shards(
        n_padded_tokens, budget, multiple=config.tile_size), 2)


class PrefetchTimeout(TimeoutError):
    """The prefetch watchdog expired: a shard's load did not complete
    within ``LDAConfig.stream_watchdog_seconds``. Raised from ``take()``."""


class _Prefetcher:
    """One-deep prefetch queue on one worker thread.

    ``submit`` starts loading the next shard while the current one
    samples; ``take`` waits for it and returns it. A failed load is
    retried ``retries`` times with exponential backoff before it
    surfaces; ``take`` enforces the optional watchdog ``deadline_s``
    (``PrefetchTimeout``). Failures surface only from ``take``; ``close``
    drains and never re-raises.
    """

    def __init__(self, *, retries: int = 2, backoff_s: float = 0.05,
                 deadline_s: float | None = None):
        self._ex = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="lda-stream-prefetch")
        self._fut = None
        self.retries = max(int(retries), 0)
        self.backoff_s = float(backoff_s)
        self.deadline_s = deadline_s

    def _attempt(self, fn, args):
        for attempt in range(self.retries + 1):
            try:
                return fn(*args)
            except Exception:
                if attempt == self.retries:
                    raise
                time.sleep(self.backoff_s * (2 ** attempt))

    def submit(self, fn, *args) -> None:
        if self._fut is not None:
            raise RuntimeError("prefetch queue is one deep: take() first")
        self._fut = self._ex.submit(self._attempt, fn, args)

    def take(self):
        fut, self._fut = self._fut, None
        if fut is None:
            return None
        try:
            return fut.result(timeout=self.deadline_s)
        except concurrent.futures.TimeoutError:
            fut.cancel()
            raise PrefetchTimeout(
                f"prefetch exceeded its {self.deadline_s}s watchdog "
                "deadline (stream_watchdog_seconds): the load thread hung "
                "or host I/O stalled") from None

    def close(self) -> None:
        fut, self._fut = self._fut, None
        if fut is not None:
            fut.cancel()
            try:
                fut.result(timeout=1.0)
            except Exception:
                pass        # teardown never re-raises a pending failure
        self._ex.shutdown(wait=False)

    def __del__(self):
        try:
            self._ex.shutdown(wait=False)
        except Exception:
            pass


class _Staged(NamedTuple):
    """A shard's buffers on the device, copied on the side stream: usable
    on the main stream after ``claim()``."""
    tensors: list
    event: torch.cuda.Event | None
    host: list               # the pinned sources, alive until claimed

    def claim(self) -> list:
        if self.event is not None:
            main = torch.cuda.current_stream(self.tensors[0].device)
            main.wait_event(self.event)
            for t in self.tensors:
                # allocated on the side stream: without this the caching
                # allocator may reuse the memory under a running kernel
                t.record_stream(main)
        return self.tensors


class _Readback(NamedTuple):
    """A device tensor being copied to host memory, without a sync."""
    host: torch.Tensor
    event: torch.cuda.Event | None

    def get(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def _read_back(t: torch.Tensor) -> _Readback:
    if t.device.type != "cuda":
        return _Readback(t, None)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return _Readback(host, ev)


@dataclasses.dataclass
class _EpochCarry:
    """Mid-epoch state (exists only while an epoch is open).

    ``derived`` holds the iteration-start quantities every shard samples
    against (Ŵ and word stats, and the hybrid pipeline's densified
    counts); ``deltas`` accumulates the epoch's ±1 moves, so no shard sees
    another's updates; ``old_topics`` keeps the epoch-start topics of the
    sampled shards, so a mid-epoch checkpoint can rebuild the counts.
    Device readbacks are deferred one shard deep.
    """
    u_host: torch.Tensor           # the epoch's uniforms, host-staged
    derived: tuple
    deltas: tuple
    old_topics: list
    pending_topics: list = dataclasses.field(default_factory=list)
    stats_parts: list = dataclasses.field(default_factory=list)
    # paged mode only: the shards' (page_rows, K) dW windows on their way
    # back to ``HostPages.dw``
    pending_dw: list = dataclasses.field(default_factory=list)
    n_surv: int = 0
    max_span: int = 0
    stat_sums: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(4, np.float64))

    def flush_stats(self) -> None:
        for n_surv, span, sums in self.stats_parts:
            self.n_surv += int(n_surv)
            self.max_span = max(self.max_span, int(span))
            self.stat_sums += sums.cpu().numpy().astype(np.float64)
        self.stats_parts = []


class HostPages:
    """W of the paged (disk) mode, on the host: ``w`` the epoch-start
    counts and ``dw`` the open epoch's moves (None between epochs), both
    (V, K) int32. ``pull_page(lo, hi)`` gives the rows a shard samples
    against, ``push_page(lo, hi, delta)`` adds a shard's moves to ``dw``,
    ``finish_round()`` lands them at the epoch close, and ``current()`` is
    W with the moves so far. Pulls see only epoch-start rows, which is what
    keeps paged training equal to resident training."""

    def __init__(self, w: np.ndarray):
        self.w = w
        self.dw: np.ndarray | None = None

    def open_round(self, dw: np.ndarray | None = None) -> None:
        self.dw = np.zeros_like(self.w) if dw is None else dw

    def pull_page(self, lo: int, hi: int) -> np.ndarray:
        return self.w[lo:hi]

    def push_page(self, lo: int, hi: int, delta: np.ndarray) -> None:
        self.dw[lo:hi] += delta

    def finish_round(self) -> None:
        self.w += self.dw
        self.dw = None

    def current(self) -> np.ndarray:
        return self.w.copy() if self.dw is None else self.w + self.dw


@dataclasses.dataclass
class StreamState:
    """Training state of the streaming pipelines.

    The topics live on the host, one array per shard; only the counts stay
    on the device: ``counts`` is (D, W, colsum) dense, or the hybrid
    packed tuple (d_packed, W head, W tail buckets, colsum, overflow). In
    paged (disk) mode W lives on the host in ``pages`` and ``counts``
    drops it: (D, colsum) or (d_packed, colsum, overflow). ``cursor``
    counts the shards already sampled in the open epoch (0 between
    epochs).
    """
    shard_topics: list
    counts: tuple
    iteration: int
    cursor: int = 0
    epoch: _EpochCarry | None = None
    pages: HostPages | None = None

    @property
    def topics(self):
        return self.shard_topics


def _shard_stat_sums(lo, n, dec, in_m, new_topics, old_topics):
    """A shard's stat sums over the slots of the resident stream (global
    index < n), so the epoch's totals divide to the resident fractions."""
    L = new_topics.shape[0]
    valid = (lo + torch.arange(L, device=new_topics.device)) < n
    return torch.stack([(x & valid).sum().to(torch.float32) for x in (
        dec.skip, dec.skip | in_m, new_topics == old_topics,
        new_topics == dec.k1)])


class StreamingPipeline(FusedPipeline):
    """The fused iteration, one epoch shard at a time.

    The token list never lies on the device whole: an iteration is an
    epoch over the shards of a ``ShardedCorpus`` (or, paged, of a
    ``CorpusStore``), the next shard's buffers loaded and copied to the
    device on a worker thread and a side CUDA stream while the current
    one samples. Every shard runs the resident iteration's own body,
    ``FusedPipeline._sample``. Streamed training equals resident training
    bit for bit:

      * an epoch's uniforms are drawn once, at the resident padded length,
        from the resident iteration's generator, staged on the host and
        shipped a shard slice at a time;
      * every shard samples against the epoch-start counts, Ŵ and word
        stats; its ±1 moves go through ``scatter_changed_deltas`` into
        delta tensors that land at the epoch close (integer adds commute);
      * shard sizes, chunk capacities and tiles change no bit.

    Paged (``corpus_residency="disk"``): W lives on the host and each
    shard gets a ``(page_rows, K)`` window of W rows starting at its
    ``page_base``, sampling with window-local word ids; Ŵ and the word
    stats are row-wise, so the window's rows are the resident ones. Tiles
    stay off (the window is the vocabulary) and the shard's dW window
    comes back one shard deferred through ``HostPages``.
    """

    def __init__(self, stream, *, n_docs: int, n_words: int, config,
                 device=None):
        from repro_torch.lda.corpus import ShardedCorpus
        from repro_torch.lda.storage import CorpusStore
        if config.sampler == "warp":
            raise ValueError(
                "sampler='warp' does not support corpus_residency="
                "'streamed': the MH doc proposal gathers topics of "
                "arbitrary tokens of the same document, which breaks the "
                "epoch-shard locality streaming is built on. Use "
                "corpus_residency='full', or sampler='three_branch' for "
                "streamed training")
        self.paged = isinstance(stream, CorpusStore)
        if not self.paged and not isinstance(stream, ShardedCorpus):
            raise ValueError(
                "StreamingPipeline takes a repro_torch.lda.corpus."
                "ShardedCorpus (shard_stream(corpus, n_shards, multiple="
                "config.tile_size)) or a repro_torch.lda.storage."
                "CorpusStore (corpus_residency='disk')")
        self.word_ids = self.doc_ids = self.mask = None
        self.doc_index = self.real_idx = None
        self.device = torch.device("cpu" if device is None else device)
        self._init_plan(config, n_docs=n_docs, n_words=n_words,
                        n_tokens=stream.n_padded)
        self.stream = stream
        self.capacity = min(self.capacity, stream.shard_len)
        if self.paged:
            # every shard's [first_word, last_word] run fits one window of
            # page_rows W rows starting at its page_base (empty trailing
            # shards span 0 words, counted as 1)
            spans = np.maximum(
                np.asarray(stream.last_word, np.int64)
                - np.asarray(stream.first_word, np.int64) + 1, 1)
            self.page_rows = int(min(max(int(spans.max()),
                                         PAGE_ROWS_FLOOR), n_words))
            self.page_base = np.minimum(
                np.maximum(np.asarray(stream.first_word, np.int64), 0),
                max(n_words - self.page_rows, 0))
        elif self.balance == "tiles":
            # the word window covers the widest tile run of any shard
            spans = [1]
            for s in range(stream.n_shards):
                real = int(stream.real_per_shard[s])
                if real:
                    spans.append(balance_mod.build_tiles_from_word_ids(
                        stream.word_ids[s][:real],
                        min(self.capacity, real)).max_words_per_tile)
            self.win_words = plan_window(max(spans), n_words)
        self._prefetch = _Prefetcher(
            deadline_s=config.stream_watchdog_seconds)
        self._side = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self.last_epoch_device_bytes = 0
        self.last_epoch_io: dict = {}

    # -- the state format (the hybrid pipeline overrides these) ------------

    def _counts_from_dense(self, D, W, colsum) -> tuple:
        """At-rest counts from dense D and W (this call owns D; W is a
        host array in paged mode and stays out of the tuple)."""
        return (D, colsum) if self.paged else (D, W.clone(), colsum)

    def _derive(self, counts) -> tuple:
        """The epoch-start quantities every shard samples against."""
        if self.paged:
            return ()
        D, W, colsum = counts
        return self._w_hat_stats(W, colsum)

    def _zero_deltas(self, counts, derived) -> tuple:
        if self.paged:
            D, colsum = counts
            return torch.zeros_like(D), torch.zeros_like(colsum)
        return tuple(torch.zeros_like(c) for c in counts)

    def _sampling_inputs(self, ss: StreamState, w_win) -> tuple:
        """(dense D, Ŵ, word stats, packed D rows or None) of a shard;
        paged, Ŵ and the stats of the shard's W window."""
        if self.paged:
            D, colsum = ss.counts
            W_hat, stats = self._w_hat_stats(w_win, colsum)
            return D, W_hat, stats, None
        W_hat, stats = ss.epoch.derived
        return ss.counts[0], W_hat, stats, None

    def _w_hat_stats(self, W, colsum):
        """Ŵ and the word stats of W's rows (all of W, or a paged window:
        both are row-wise, so a window's rows are the full matrix's)."""
        W_hat = esca.compute_w_hat_from_colsum(W, colsum, self.config.beta,
                                               n_words=self.n_words)
        return W_hat, three_branch.word_stats(W_hat, g=self.config.g,
                                              alpha=self.config.alpha_)

    def _apply_epoch(self, counts, derived, deltas) -> tuple:
        """Epoch close: land the deltas (in place; integer adds)."""
        for c, d in zip(counts, deltas):
            c += d
        return counts

    def _dense_counts(self, ss: StreamState) -> tuple:
        """(D, W or None when paged, colsum) of a boundary state."""
        if self.paged:
            D, colsum = ss.counts
            return D, None, colsum
        return ss.counts

    @property
    def _split_tail(self) -> bool:
        return False

    # -- state conversion ----------------------------------------------------

    def _split_topics(self, topics) -> list:
        st = self.stream
        flat = np.zeros(st.n_shards * st.shard_len, np.int32)
        flat[:len(topics)] = topics
        return list(flat.reshape(st.n_shards, st.shard_len))

    def from_lda_state(self, state) -> StreamState:
        """A dense ``LDAState`` -> ``StreamState`` (copies; a StreamState,
        mid-epoch too, passes through)."""
        if isinstance(state, StreamState):
            return state
        W = state.W
        colsum = W.sum(dim=0, dtype=torch.int32)
        ss = StreamState(
            shard_topics=self._split_topics(
                state.topics.cpu().numpy().astype(np.int32)),
            counts=self._counts_from_dense(state.D.clone(), W, colsum),
            iteration=int(state.iteration),
            pages=HostPages(W.cpu().numpy().astype(np.int32))
            if self.paged else None)
        return ss

    def _require_boundary(self, ss: StreamState, what: str) -> None:
        if ss.cursor:
            raise ValueError(
                f"{what} needs an epoch boundary but {ss.cursor} of "
                f"{self.stream.n_shards} shards of the open epoch are "
                "already sampled: finish the epoch (run_fused) or "
                "checkpoint through stream_payload()")

    def to_lda_state(self, ss: StreamState) -> LDAState:
        """The dense resident state (topics and W uploaded; a paged W is
        the one export that re-uploads the whole matrix)."""
        self._require_boundary(ss, "to_lda_state")
        topics = np.concatenate(ss.shard_topics)[:self.n_tokens]
        D, W, _colsum = self._dense_counts(ss)
        if W is None:
            W = torch.from_numpy(ss.pages.w).to(self.device)
        return LDAState(topics=torch.from_numpy(topics).to(self.device),
                        D=D, W=W, iteration=ss.iteration)

    def dense_W(self, ss: StreamState) -> np.ndarray:
        """A boundary state's W as a host int32 array."""
        self._require_boundary(ss, "dense_W")
        if self.paged:
            return ss.pages.current()
        return self._dense_counts(ss)[1].cpu().numpy().astype(np.int32)

    def nbytes(self, ss: StreamState) -> int:
        """Bytes of the device-resident counts."""
        return sum(int(t.numel()) * t.element_size() for t in _leaves(
            ss.counts))

    # -- the shard loads ------------------------------------------------------

    def _read_slices(self, s: int) -> tuple:
        """(word, doc, mask) host arrays of shard ``s`` for the count folds
        and the LLPT; paged, a file read, crc32-checked by
        ``CorpusStore.read_shard``."""
        st = self.stream
        if self.paged:
            return st.read_shard(s)
        return st.word_ids[s], st.doc_ids[s], st.mask[s]

    def _load_shard_slices(self, s: int) -> tuple:
        """The training load of shard ``s``, self-checked.

        Under ``config.selfcheck`` (or an armed chaos plan) the in-memory
        slices are checked against the stream's per-shard crc32 before
        they reach the device, so corrupted host bytes surface as a
        restartable ``ShardCorruptionError`` at the load. The fault hooks
        run on the NumPy slices: ``corrupt_arrays`` flips a bit in a copy,
        never in the ``ShardedCorpus`` the slices share memory with. Paged,
        the load is ``CorpusStore.read_shard(s, _chaos=True)``, which owns
        the (unconditional) crc32 check and the hooks.
        """
        st = self.stream
        if self.paged:
            return st.read_shard(s, _chaos=True)
        arrays = self._read_slices(s)
        if chaos.armed():
            chaos.io_fault(s)
            arrays = chaos.corrupt_arrays(s, arrays)
        if self.config.selfcheck or chaos.armed():
            want = int(st.shard_checksums[s])
            got = int(st.slice_checksum(*arrays))
            if got != want:
                raise invariants.ShardCorruptionError(
                    f"stream shard {s} failed its crc32 self-check "
                    f"(expected {want:#010x}, got {got:#010x}): host "
                    "shard bytes corrupted in flight — restore from the "
                    "newest checkpoint")
        return arrays

    def _to_device(self, host: list) -> _Staged:
        if self.device.type != "cuda":
            return _Staged(host, None, host)
        pinned = [t.pin_memory() for t in host]
        with torch.cuda.stream(self._side):
            dev = [t.to(self.device, non_blocking=True) for t in pinned]
            ev = torch.cuda.Event()
            ev.record(self._side)
        self.last_epoch_io["h2d_bytes"] += sum(
            t.numel() * t.element_size() for t in pinned)
        return _Staged(dev, ev, pinned)

    def _put_shard(self, s: int, topics_host, u_host, pages=None) -> _Staged:
        """Shard ``s``'s (word, doc, mask, topics, u[, W window]) staged
        on the device (runs on the prefetch thread)."""
        L = self.stream.shard_len
        host = [torch.from_numpy(np.ascontiguousarray(a, np.int32))
                for a in self._load_shard_slices(s)]
        host += [torch.from_numpy(topics_host), u_host[s * L:(s + 1) * L]]
        if self.paged:
            b = int(self.page_base[s])
            host.append(torch.from_numpy(np.ascontiguousarray(
                pages.pull_page(b, b + self.page_rows))))
        return self._to_device(host)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.device)

    # -- the epoch loop --------------------------------------------------------

    def _open_epoch(self, ss: StreamState, u=None) -> StreamState:
        """Open the epoch of ``ss.iteration``: its uniforms (drawn at the
        resident length as ``draw_uniforms`` draws them, or ``u`` when
        given), staged on the host; the derived quantities; zero deltas."""
        st, n = self.stream, self.n_tokens
        self.last_epoch_io = {"h2d_bytes": 0, "d2h_bytes": 0,
                              "take_wait_s": 0.0, "shard_s": [],
                              "t_open": time.perf_counter()}
        if u is None:
            u = draw_uniforms(self.config.seed, ss.iteration, n, self.device)
        u_host = torch.zeros(st.n_shards * st.shard_len,
                             dtype=torch.float32,
                             pin_memory=self.device.type == "cuda")
        u_host[:n].copy_(u)
        if self.device.type == "cuda":
            self.last_epoch_io["d2h_bytes"] += 4 * n
        del u
        derived = self._derive(ss.counts)
        ss.epoch = _EpochCarry(u_host=u_host, derived=derived,
                               deltas=self._zero_deltas(ss.counts, derived),
                               old_topics=[])
        if self.paged:
            ss.pages.open_round()
        return ss

    def _sample_shard(self, ss: StreamState, s: int, window: list):
        """Sample shard ``s`` (its staged buffers ``window``) against the
        epoch-start counts; its moves go into the epoch's deltas (paged:
        its W moves into a fresh window, returned). Returns (topics, dW
        window or None, survivors, span, stat sums)."""
        cfg, ep, L = self.config, ss.epoch, self.stream.shard_len
        word_s, doc_s, mask_s, topics_s, u_s = window[:5]
        D, W_hat, stats_w, d_packed = self._sampling_inputs(
            ss, window[5] if self.paged else None)
        win = self.win_words
        if self.paged:
            P = self.page_rows
            word_l = torch.clamp(word_s - int(self.page_base[s]), 0, P - 1)
            dW = torch.zeros((P, cfg.n_topics), dtype=torch.int32,
                             device=self.device)
            win = self.n_words                    # tiles off
        else:
            word_l, dW = word_s, ep.deltas[1]
        sparse_tail = (d_packed, word_s < self.layout.v_dense) \
            if self._split_tail else None
        dec, new_t, in_m, survivors = self._sample(
            u_s, word_l, doc_s, D, W_hat, stats_w, capacity=self.capacity,
            win_words=win, sparse_tail=sparse_tail)
        scatter_changed_deltas(topics_s, new_t, doc_s, word_l, mask_s,
                               D=ep.deltas[0], W=dW, colsum=ep.deltas[-1])
        sums = _shard_stat_sums(s * L, self.n_tokens, dec, in_m, new_t,
                                topics_s)
        return (new_t, dW if self.paged else None,
                sum(survivors.values()), self.last_span, sums)

    def _resolve_pending(self, ss: StreamState, keep: int) -> None:
        """Land deferred readbacks until ``keep`` of each remain."""
        ep = ss.epoch
        while len(ep.pending_topics) > keep:
            s_prev, rb = ep.pending_topics.pop(0)
            ss.shard_topics[s_prev] = rb.get()
        while len(ep.pending_dw) > keep:
            b, rb = ep.pending_dw.pop(0)
            ss.pages.push_page(b, b + self.page_rows, rb.get())

    def _advance(self, ss: StreamState,
                 max_shards: int | None = None) -> StreamState:
        """Sample shards ``cursor..stop`` of the open epoch (opening one as
        needed) without closing it; shard s+1 loads while s samples."""
        st, io = self.stream, None
        if ss.epoch is None:
            ss = self._open_epoch(ss)
        io = self.last_epoch_io
        stop = st.n_shards if max_shards is None \
            else min(st.n_shards, ss.cursor + max_shards)
        if ss.cursor >= stop:
            return ss
        ep = ss.epoch
        pages = ss.pages
        first = ss.cursor
        self._prefetch.take()                   # drop any stale prefetch
        while ss.cursor < stop:
            s = ss.cursor
            t0 = time.perf_counter()
            # the first shard loads inline, as in the reference: a fault
            # there reaches the supervisor, the prefetched shards' go
            # through the worker's retries first
            staged = self._put_shard(s, ss.shard_topics[s], ep.u_host,
                                     pages) if s == first \
                else self._prefetch.take()
            io["take_wait_s"] += time.perf_counter() - t0
            if chaos.armed():
                chaos.shard_event(ss.iteration, s)
            window = staged.claim()
            if s + 1 < stop:
                self._prefetch.submit(self._put_shard, s + 1,
                                      ss.shard_topics[s + 1], ep.u_host,
                                      pages)
            new_t, dw_win, n_surv, span, sums = self._sample_shard(
                ss, s, window)
            if self.last_epoch_device_bytes == 0:
                self.last_epoch_device_bytes = self._device_bytes(
                    ss, window + [new_t] + ([] if dw_win is None
                                            else [dw_win]))
            ep.old_topics.append(ss.shard_topics[s])
            ep.stats_parts.append((n_surv, span, sums))
            ep.pending_topics.append((s, _read_back(new_t)))
            if dw_win is not None:
                ep.pending_dw.append((int(self.page_base[s]),
                                      _read_back(dw_win)))
            if self.device.type == "cuda":
                io["d2h_bytes"] += new_t.numel() * 4 + (
                    0 if dw_win is None else dw_win.numel() * 4)
            del window, staged, new_t, dw_win
            # one deep: shard s-1's readbacks land after shard s is queued
            self._resolve_pending(ss, keep=1)
            ss.cursor += 1
            io["shard_s"].append(time.perf_counter() - t0)
        self._resolve_pending(ss, keep=0)
        return ss

    def _close_epoch(self, ss: StreamState) -> StreamState:
        ep = ss.epoch
        self._resolve_pending(ss, keep=0)
        if self.config.selfcheck:
            self._selfcheck_deltas(ss)
        ss.counts = self._apply_epoch(ss.counts, ep.derived, ep.deltas)
        if self.paged:
            ss.pages.finish_round()
        ss.iteration += 1
        ss.cursor = 0
        ss.epoch = None
        if self.config.selfcheck:
            self._selfcheck_counts(ss)
        io = self.last_epoch_io
        if "t_open" in io:
            io["epoch_s"] = time.perf_counter() - io.pop("t_open")
        return ss

    # -- count-invariant tripwires (config.selfcheck, lda/invariants.py) ----
    # Paged, W and the epoch's dW live on the host (HostPages): their
    # reductions run there by design, the rest on the card.

    def _selfcheck_deltas(self, ss: StreamState) -> None:
        """Before the epoch lands: its ΔD, ΔW and Δcolsum sum to zero."""
        deltas = ss.epoch.deltas
        dD, dW, dcs = (deltas[0], ss.pages.dw, deltas[1]) if self.paged \
            else deltas
        invariants.check_delta_conservation(
            dD, dW, dcs, where=f"epoch {ss.iteration} close (deltas)")

    def _selfcheck_counts(self, ss: StreamState) -> None:
        """After the epoch lands: the counts conserve the tokens."""
        D, W, colsum = self._dense_counts(ss)
        invariants.check_dense_counts(
            D, ss.pages.w if W is None else W, colsum,
            n_tokens=self.stream.n_tokens,
            where=f"epoch {ss.iteration} close (counts)")

    def selfcheck(self, ss) -> None:
        # the epoch close already ran the tripwires on this state; the
        # chunk-boundary call the resident pipelines need is a no-op here
        pass

    def close(self) -> None:
        """Stop the prefetch worker; a pending load is dropped unread."""
        self._prefetch.close()

    def run_shards(self, ss: StreamState, n_shards: int = 1) -> StreamState:
        """Advance up to ``n_shards`` shards of the current epoch without
        closing it. A mid-epoch state checkpoints through
        ``stream_payload`` and resumes through
        ``state_from_stream_payload`` (or ``run_fused``, whose first epoch
        finishes the open one) bit for bit."""
        return self._advance(ss, max_shards=max(int(n_shards), 0))

    def _run_epoch(self, ss: StreamState):
        """One full epoch (resuming an open one at ``ss.cursor``): (state,
        survivors, widest span, stat means)."""
        ss = self._advance(ss)
        ep = ss.epoch
        ep.flush_stats()
        means = ep.stat_sums / max(self.n_tokens, 1)
        return self._close_epoch(ss), ep.n_surv, ep.max_span, means

    def step(self, ss: StreamState, tables=None):
        ss, stats, n_surv = self.run_fused(ss, 1)
        return ss, type(stats)(*(x[0] for x in stats)), n_surv[0]

    def run_fused(self, ss: StreamState, n_iters: int, replan: bool = True):
        """``n_iters`` epochs: (state, stats, survivors), each with a
        leading (n_iters,) axis, as ``FusedPipeline.run_fused``. Between
        calls the epoch survivor counts re-plan the chunk capacity (and
        the tile window under ``balance="tiles"``)."""
        ss = self.from_lda_state(ss)
        surv, spans, means = [], [], []
        for _ in range(int(n_iters)):
            ss, n_surv, span, m = self._run_epoch(ss)
            surv.append(n_surv)
            spans.append(span)
            means.append(m)
        if replan and surv:
            self.note_survivors(np.asarray(surv, np.float64))
            if self.balance == "tiles":
                self.note_spans(spans)
        m = torch.as_tensor(np.asarray(means, np.float32).reshape(-1, 4))
        stats = three_branch.ThreeBranchStats(
            frac_skipped=m[:, 0], frac_m_final=m[:, 1],
            frac_unchanged=m[:, 2], frac_at_max=m[:, 3],
            frac_q_branch=torch.zeros(m.shape[0]))
        return ss, stats, torch.as_tensor(np.asarray(surv, np.int64))

    def note_survivors(self, n_surv, decay: float = 0.7) -> None:
        super().note_survivors(n_surv, decay)
        self.capacity = min(self.capacity, self.stream.shard_len)

    def note_spans(self, spans, decay: float = 0.7) -> None:
        if self.paged:
            # the paged window is the vocabulary: tiles stay off
            return
        super().note_spans(spans, decay)

    def _device_bytes(self, ss: StreamState, window: list) -> int:
        """Live device bytes at the streaming steady state: the counts,
        the open epoch's derived and delta tensors, and two shard windows
        (the current and the prefetched one)."""
        total = sum(t.numel() * t.element_size()
                    for t in _leaves((ss.counts, ss.epoch.derived,
                                      ss.epoch.deltas)))
        return int(total + 2 * sum(t.numel() * t.element_size()
                                   for t in window))

    def serving_counts(self, ss: StreamState) -> tuple:
        """(W, cursor, n_shards): a host W of the current view. Mid-epoch
        it is the epoch-start W plus the sampled shards' moves (stale by
        at most the unsampled shards' share of one epoch); at a boundary
        the exact counts."""
        st = self.stream
        if ss.epoch is None or ss.cursor == 0:
            return self.dense_W(ss), 0, st.n_shards
        if self.paged:
            return ss.pages.current(), int(ss.cursor), st.n_shards
        W = self._epoch_start_w(ss) + ss.epoch.deltas[1]
        return W.cpu().numpy().astype(np.int32), int(ss.cursor), st.n_shards

    def _epoch_start_w(self, ss: StreamState) -> torch.Tensor:
        return ss.counts[1]

    # -- checkpoints (mid-epoch capable) ---------------------------------------

    def stream_payload(self, ss: StreamState) -> dict:
        """Canonical checkpoint payload, at an epoch boundary or mid-epoch.

        Mid-epoch it adds ``stream_cursor``, ``stream_done_topics`` (the
        sampled shards' new topics) and ``stream_n_shards``;
        ``topics_global`` is then the epoch-start topics, from which a
        restore rebuilds the counts, Ŵ and the deltas. ``key`` is
        ``PRNGKey(config.seed)``'s key data, as in every port payload.
        """
        from repro_torch.lda.convert import key_data
        st = self.stream
        n_real = st.n_tokens
        key = key_data(self.config.seed)
        if ss.cursor == 0:
            topics = np.concatenate(ss.shard_topics)[:n_real]
            return {"topics_global": topics, "key": key,
                    "iteration": int(ss.iteration)}
        start = np.concatenate(
            list(ss.epoch.old_topics) + ss.shard_topics[ss.cursor:])[:n_real]
        n_done = int(min(ss.cursor * st.shard_len, n_real))
        done = np.concatenate(ss.shard_topics[:ss.cursor])[:n_done]
        return {"topics_global": start, "key": key,
                "iteration": int(ss.iteration),
                "stream_cursor": np.int64(ss.cursor),
                "stream_done_topics": done.astype(np.int32),
                "stream_n_shards": np.int64(st.n_shards)}

    def _fold_counts(self, topics_flat: np.ndarray, n_shards: int):
        """(D, W) of the first ``n_shards`` shards' topics, folded shard by
        shard on the device through the ``histogram`` kernel's any-order
        route (a word-sorted shard's doc ids are unsorted); integer adds,
        so the fold is bitwise the resident rebuild. Paged, W is a host
        array folded from the shards' windows."""
        st, cfg = self.stream, self.config
        K, L = cfg.n_topics, st.shard_len
        count = _hist.histogram if cfg.impl == "kernel" else histogram_ref
        D = torch.zeros((self.n_docs, K), dtype=torch.int32,
                        device=self.device)
        if self.paged:
            W = np.zeros((self.n_words, K), np.int32)
        else:
            W = torch.zeros((self.n_words, K), dtype=torch.int32,
                            device=self.device)
        for s in range(n_shards):
            w, d, m = self._read_slices(s)
            t = self._upload(topics_flat[s * L:(s + 1) * L])
            m = self._upload(m)
            D += count(self._upload(d), t, m, n_rows=self.n_docs,
                       n_topics=K)
            if self.paged:
                b, P = int(self.page_base[s]), self.page_rows
                w_l = torch.clamp(self._upload(w) - b, 0, P - 1)
                W[b:b + P] += count(w_l, t, m, n_rows=P,
                                    n_topics=K).cpu().numpy()
            else:
                W += count(self._upload(w), t, m, n_rows=self.n_words,
                           n_topics=K)
        return D, W

    def state_from_topics(self, topics: np.ndarray,
                          iteration: int) -> StreamState:
        """A boundary StreamState from topics in padded stream order (the
        real tokens' or all ``n_padded`` slots'; the rest take topic 0),
        its counts folded shard by shard on the device."""
        st = self.stream
        flat = np.zeros(st.n_shards * st.shard_len, np.int32)
        flat[:len(topics)] = topics
        D0, W0 = self._fold_counts(flat, st.n_shards)
        if self.paged:
            colsum = torch.from_numpy(W0.sum(axis=0, dtype=np.int32)).to(
                self.device)
        else:
            colsum = W0.sum(dim=0, dtype=torch.int32)
        ss = StreamState(
            shard_topics=list(flat.reshape(st.n_shards, st.shard_len)),
            counts=self._counts_from_dense(D0, W0, colsum),
            iteration=int(iteration),
            pages=HostPages(W0) if self.paged else None)
        return ss

    def state_from_stream_payload(self, payload: dict) -> StreamState:
        """A StreamState (mid-epoch too) from a canonical payload. The
        counts are folded from the epoch-start topics, the epoch is
        re-opened, and the deltas are the difference of the sampled
        shards' folds under their new and their old topics."""
        st = self.stream
        n_real, K = st.n_tokens, self.config.n_topics
        tg = np.asarray(payload["topics_global"], np.int32)
        if tg.shape[0] != n_real:
            raise ValueError(
                f"checkpoint topics_global has {tg.shape[0]} entries but "
                f"the corpus holds {n_real} tokens: the checkpoint belongs "
                "to a different corpus")
        if tg.size and (tg.min() < 0 or tg.max() >= K):
            raise ValueError(f"checkpoint topics lie outside [0, {K})")
        sn = payload.get("stream_n_shards")
        if sn is not None and int(sn) != st.n_shards:
            raise ValueError(
                f"checkpoint was saved mid-epoch with {int(sn)} stream "
                f"shards but this pipeline streams {st.n_shards}: the "
                "shard grid must match to resume mid-epoch (re-save the "
                "checkpoint at an epoch boundary to re-shard)")
        ss = self.state_from_topics(tg, int(payload["iteration"]))
        flat = np.concatenate(ss.shard_topics)
        cursor = int(np.asarray(payload.get("stream_cursor", 0)))
        if cursor == 0:
            return ss
        if not 0 < cursor <= st.n_shards:
            raise ValueError(
                f"stream_cursor={cursor} out of range for {st.n_shards} "
                "shards: the checkpoint was written for a different "
                "stream sharding (stream_shards must match to resume "
                "mid-epoch)")
        n_done = int(min(cursor * st.shard_len, n_real))
        done = np.asarray(payload["stream_done_topics"], np.int32)
        if done.shape[0] != n_done:
            raise ValueError(
                f"stream_done_topics has {done.shape[0]} entries; cursor "
                f"{cursor} implies {n_done}: inconsistent mid-epoch payload")
        ss = self._open_epoch(ss)
        new_flat = flat.copy()
        new_flat[:n_done] = done
        Dn, Wn = self._fold_counts(new_flat, cursor)
        Do, Wo = self._fold_counts(flat, cursor)
        dD, dW = Dn - Do, Wn - Wo
        del Dn, Do, Wn, Wo
        if self.paged:
            ss.pages.open_round(dW)
            ss.epoch.deltas = (dD, torch.from_numpy(
                dW.sum(axis=0, dtype=np.int32)).to(self.device))
        else:
            ss.epoch.deltas = (dD, dW, dW.sum(dim=0, dtype=torch.int32))
        shards = new_flat.reshape(st.n_shards, st.shard_len)
        ss.epoch.old_topics = list(flat.reshape(st.n_shards,
                                                st.shard_len)[:cursor])
        for s in range(cursor):
            ss.shard_topics[s] = shards[s]
        ss.cursor = cursor
        return ss

    # -- evaluation: Eq 5 folded over the shards -------------------------------

    def eval_llpt(self, ss: StreamState) -> float:
        """LLPT (Eq 5) of a boundary state without the whole token list on
        the device; bitwise the resident ``llpt``."""
        self._require_boundary(ss, "eval_llpt")
        D, W, colsum = self._dense_counts(ss)
        return self.llpt_of(D, W, colsum, ss)

    def llpt_of(self, D, W, colsum, ss: StreamState | None = None) -> float:
        """LLPT of dense counts, ``core/llpt.py::token_ll`` folded over the
        shards (paged: each shard's W window from ``ss``, window-local
        ids) and reduced by ``reduce_ll``. A shard is whole tiles of
        ``tile_size`` tokens, so every tile, and so every per-token value,
        is the resident call's, and the same reduction over the same
        vector gives the same bits."""
        st, cfg = self.stream, self.config
        colsum_f = colsum.float()
        parts = []
        for s in range(st.n_shards):
            w, d, _m = self._read_slices(s)
            if W is None:
                b, P = int(self.page_base[s]), self.page_rows
                w_win = self._upload(ss.pages.pull_page(b, b + P))
                v = torch.clamp(self._upload(w) - b, 0, P - 1)
            else:
                w_win, v = W, self._upload(w)
            parts.append(llpt_mod.token_ll(
                v, self._upload(d), D, w_win, colsum_f, alpha=cfg.alpha_,
                beta=cfg.beta, n_words=self.n_words,
                tile_size=cfg.tile_size))
        ll = torch.cat(parts)[:self.n_tokens]
        # the real tokens are exactly the first n_tokens padded slots
        mask = (torch.arange(self.n_tokens, device=self.device)
                < st.n_tokens).to(torch.int32)
        return float(llpt_mod.reduce_ll(ll, mask))


def _leaves(tree) -> list:
    """The tensors of a nested tuple (counts, derived, deltas)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _leaves(x)]
    return []


class StreamingHybridPipeline(StreamingPipeline):
    """Epoch-shard streaming over the hybrid sparse state.

    At rest between epochs the counts stay packed (the packed D rows, the
    W head and tail buckets, colsum, the overflow tripwire; paged: D rows,
    colsum, overflow, with W on the host). The epoch open densifies them
    once into the integer matrices every shard samples against (what the
    resident ``HybridFusedPipeline`` does once an iteration), and the
    epoch close lands the deltas and repacks. In paged mode the head/tail
    split keys on global word ids, the Ŵ gathers on window-local ones.
    """

    def __init__(self, stream, *, n_docs: int, n_words: int, config,
                 corpus, device=None):
        super().__init__(stream, n_docs=n_docs, n_words=n_words,
                         config=config, device=device)
        self.layout = HybridLayout.build(corpus, config)

    @property
    def _split_tail(self) -> bool:
        return self.config.tail_sampler == "sparse" \
            and self.layout.v_dense < self.n_words

    def _counts_from_dense(self, D, W, colsum) -> tuple:
        lay = self.layout
        ov = torch.zeros((), dtype=torch.int32, device=self.device)
        if self.paged:
            return lay.pack_d(D), colsum, ov
        w_head, w_tail = lay.split_w(W)
        return lay.pack_d(D), w_head, w_tail, colsum, ov

    def _densify(self, counts) -> tuple:
        """(dense D, dense W or None when paged) of packed counts."""
        lay = self.layout
        d_dense = sparse.densify_rows_sorted(counts[0], lay.n_topics)
        if self.paged:
            return d_dense, None
        return d_dense, lay.densify_w(counts[1], counts[2])

    def _derive(self, counts) -> tuple:
        d_dense, w_int = self._densify(counts)
        if self.paged:
            return (d_dense,)
        return (d_dense, w_int) + self._w_hat_stats(w_int, counts[3])

    def _zero_deltas(self, counts, derived) -> tuple:
        colsum = counts[1] if self.paged else counts[3]
        return tuple(torch.zeros_like(t) for t in derived[:2]) \
            + (torch.zeros_like(colsum),)

    def _sampling_inputs(self, ss: StreamState, w_win) -> tuple:
        d_packed = ss.counts[0]
        if self.paged:
            (d_dense,) = ss.epoch.derived
            W_hat, stats = self._w_hat_stats(w_win, ss.counts[1])
            return d_dense, W_hat, stats, d_packed
        d_dense, _w_int, W_hat, stats = ss.epoch.derived
        return d_dense, W_hat, stats, d_packed

    def _apply_epoch(self, counts, derived, deltas) -> tuple:
        d_dense = derived[0] + deltas[0]
        colsum = counts[-2] + deltas[-1]
        if self.paged:
            d_packed, ov = sparse.pack_rows_sorted(d_dense,
                                                   self.layout.d_capacity)
            return d_packed, colsum, counts[-1] + ov
        d_packed, w_head, w_tail, overflow = repack_counts(
            self.layout, d_dense, derived[1] + deltas[1], counts[-1])
        return d_packed, w_head, w_tail, colsum, overflow

    def _dense_counts(self, ss: StreamState) -> tuple:
        d_dense, w_int = self._densify(ss.counts)
        return d_dense, w_int, ss.counts[-2]

    def _epoch_start_w(self, ss: StreamState) -> torch.Tensor:
        return ss.epoch.derived[1]

    def overflow_count(self, ss: StreamState) -> int:
        """The packed-update tripwire (0 by the capacity-bound design)."""
        return int(ss.counts[-1])

    def _selfcheck_counts(self, ss: StreamState) -> None:
        invariants.check_packed_counts(
            ss.counts[-2], ss.counts[-1], n_tokens=self.stream.n_tokens,
            where=f"epoch {ss.iteration} close (packed counts)")
