r"""EZLDA three-branch sampling (paper §III, Eq 6-10).

Port of ``src/repro/core/three_branch.py``. The decomposition

    p ∝ D[d]∘Ŵ'[v]  +  α∘Ŵ'[v]  +  (D[d]+α)∘Ŵ[v]^m          (Eq 6)
        \_ S' ____/     \_ Q' __/     \_ M branch _________/

singles out each word's most popular topic K1 (a1 = max_k Ŵ[v][k]); the
M branch is the one entry M = a1·(b1+α) with b1 = D[d][K1]. Phase 1 bounds
S' from above with the g-term tail estimate (Eq 9-10) and skips every token
whose uniform u is proven to land in M; phase 2 samples the survivors
exactly with the same u, so skipping never changes the distribution.

Two things differ from the reference in how, not what:

* ``torch.topk`` promises no order among tied values, while
  ``jax.lax.top_k`` puts the lower index first. ``word_stats`` therefore
  takes the top g+1 from a *stable* descending sort, which gives the
  reference's order exactly.
* The reference's survivor loop is a cond-guarded ``fori_loop`` over a
  static chunk budget, so that no host sync happens. Here PyTorch runs
  eagerly and the survivor count is read back once per iteration to size
  the loop; chunks past it are never launched.
* On the card ``word_stats`` sums each Ŵ row in a fixed pairwise order
  (``row_sum``), not by ``Tensor.sum``, whose order there follows the
  tensor's shape: a paged window of Ŵ rows then gives the full matrix's
  ΣŴ and Q' bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import esca

__all__ = [
    "WordStats", "word_stats", "row_sum", "SkipDecision", "skip_phase",
    "exact_three_branch", "exact_three_branch_tiled", "ThreeBranchStats",
    "sample",
    "build_plan", "Plan", "survivor_rank", "compact_survivor_indices",
    "pack_pairs",
]

_VAL_MASK = 0xFFFF


def pack_pairs(idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """(idx,val) -> int32 with idx in high 16 bits (paper's pair storage)."""
    return (idx.to(torch.int32) << 16) | (val.to(torch.int32) & _VAL_MASK)


# ---------------------------------------------------------------------------
# per-word phase (amortized over the word's tokens, paper Fig 4b steps 1/3)
# ---------------------------------------------------------------------------

class WordStats(NamedTuple):
    """Per-word quantities shared by every token of the word."""
    a: torch.Tensor          # (V, g+1) top-(g+1) values of Ŵ[v], descending
    k: torch.Tensor          # (V, g)   topic ids of the top-g values (k[:,0]=K1)
    k12_packed: torch.Tensor # (V,) int32 — K1/K2 pair-packed (paper §III-C)
    q_prime: torch.Tensor    # (V,)  Q' = α·(ΣŴ[v] − a1)
    wsum: torch.Tensor       # (V,)  ΣŴ[v]


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis, each row in an order fixed by its length
    alone, so a window of rows sums as the full matrix's rows do.

    On the CPU that is ``Tensor.sum``'s: a reduction with more than one
    output splits its outputs across threads, never a row, and each row
    takes the same vectorized pass. On the card ``Tensor.sum`` picks its
    thread layout from the tensor's shape and each row's address, so there
    the rows are halved pairwise instead (``x[..., :h] + x[..., h:2h]``,
    an odd last column carried along) until one column is left: a chain
    of elementwise adds whose bits depend on the row's values alone.
    """
    if x.device.type != "cuda":
        return x.sum(dim=-1)
    while x.shape[-1] > 1:
        w = x.shape[-1]
        h = w // 2
        y = x[..., :h] + x[..., h:2 * h]
        x = torch.cat([y, x[..., 2 * h:]], dim=-1) if w % 2 else y
    return x[..., 0]


def word_stats(W_hat: torch.Tensor, *, g: int, alpha: float) -> WordStats:
    vals, idxs = torch.sort(W_hat, dim=-1, descending=True, stable=True)
    vals = vals[:, :g + 1].contiguous()
    k = idxs[:, :g].to(torch.int32)
    wsum = row_sum(W_hat)
    q_prime = alpha * (wsum - vals[:, 0])
    k2 = k[:, 1] if g >= 2 else torch.zeros_like(k[:, 0])
    return WordStats(a=vals, k=k, k12_packed=pack_pairs(k[:, 0], k2),
                     q_prime=q_prime, wsum=wsum)


# ---------------------------------------------------------------------------
# phase 1: the skip test (cheap, all tokens)
# ---------------------------------------------------------------------------

class SkipDecision(NamedTuple):
    skip: torch.Tensor       # (N,) bool — u proven to land in the M branch
    m: torch.Tensor          # (N,) f32 — M = a1·(b1+α)  (Eq 8)
    s_est: torch.Tensor      # (N,) f32 — Eq 10 upper bound on S'
    k1: torch.Tensor         # (N,) int32 — the word's most popular topic


def skip_phase(u: torch.Tensor, word_ids: torch.Tensor, doc_ids: torch.Tensor,
               D: torch.Tensor, stats: WordStats, *, g: int,
               alpha: float) -> SkipDecision:
    """Eq 8-10 + the skip test. O(g) gathers per token, no O(K) work."""
    w_idx, d_idx = word_ids.long(), doc_ids.long()
    a = stats.a[w_idx]                                      # (N, g+1)
    ktop = stats.k[w_idx]                                   # (N, g)
    q_prime = stats.q_prime[w_idx]                          # (N,)
    len_d = D.sum(dim=-1, dtype=torch.float32)[d_idx]       # (N,) exact
    b = D[d_idx[:, None], ktop.long()].float()              # (N, g)
    m = a[:, 0] * (b[:, 0] + alpha)                         # Eq 8
    head = (a[:, 1:g] * b[:, 1:g]).sum(dim=-1)              # empty if g=1
    tail = a[:, g] * (len_d - b.sum(dim=-1))
    s_est = head + tail
    skip = u * (m + s_est + q_prime) < m
    return SkipDecision(skip=skip, m=m, s_est=s_est, k1=ktop[:, 0])


# ---------------------------------------------------------------------------
# phase 2: exact three-branch sampling (only needed for un-skipped tokens)
# ---------------------------------------------------------------------------

def _exact_rows(u, d_rows, w_rows, k1, alpha):
    """Exact Eq 6 draw for a tile of tokens from their gathered rows.

    The combined sweep: per-topic mass (D[k]+α)·Ŵ[k] for k≠K1 partitions
    S'+Q' exactly, so one cumsum and one search draw from it. Returns
    (topic, in_m), in_m flagging tokens that landed in the M branch.
    """
    d_f = d_rows.float()
    k_iota = torch.arange(w_rows.shape[-1], device=w_rows.device)
    k1_l = k1.long()[:, None]
    mass = torch.where(k_iota[None, :] == k1_l, 0.0, (d_f + alpha) * w_rows)
    m = w_rows.gather(1, k1_l)[:, 0] * (d_f.gather(1, k1_l)[:, 0] + alpha)
    cum = torch.cumsum(mass, dim=-1)
    x = u * (m + cum[:, -1])                                # m+S'+Q'
    in_m = x < m
    k_c = torch.searchsorted(cum, (x - m)[:, None], right=True)[:, 0]
    k_c = torch.clamp(k_c, max=cum.shape[-1] - 1).to(torch.int32)
    return torch.where(in_m, k1.to(torch.int32), k_c), in_m


def exact_three_branch(u: torch.Tensor, word_ids: torch.Tensor,
                       doc_ids: torch.Tensor, k1_per_word: torch.Tensor,
                       D: torch.Tensor, W_hat: torch.Tensor, *, alpha: float,
                       tile_size: int = 8192):
    """Dense exact branch over a token batch, tiled to bound live memory at
    O(tile_size·K)."""
    n = word_ids.shape[0]
    topics = torch.empty(n, dtype=torch.int32, device=u.device)
    in_m = torch.empty(n, dtype=torch.bool, device=u.device)
    for lo in range(0, n, tile_size):
        hi = min(lo + tile_size, n)
        v_t, d_t = word_ids[lo:hi].long(), doc_ids[lo:hi].long()
        topics[lo:hi], in_m[lo:hi] = _exact_rows(
            u[lo:hi], D[d_t], W_hat[v_t], k1_per_word[v_t], alpha)
    return topics, in_m


def exact_three_branch_tiled(u: torch.Tensor, local_word: torch.Tensor,
                             doc_ids: torch.Tensor, k1_win: torch.Tensor,
                             D: torch.Tensor, w_win: torch.Tensor, *,
                             alpha: float, tile_size: int = 8192):
    """Tile-scheduled exact branch: Ŵ rows (and K1) read from a word
    window by local offset ``local_word``.

    Same per-token arithmetic as ``exact_three_branch`` on identical row
    values, so bitwise equal to it; only where the rows are read from
    differs. The fused pipeline hands every fitting tile of a segment in
    one call: the tiles' windows laid end to end are rows of Ŵ itself, so
    it passes ``w_win = Ŵ`` and ``local_word`` = window start + offset.
    """
    return exact_three_branch(u, local_word, doc_ids, k1_win, D, w_win,
                              alpha=alpha, tile_size=tile_size)


# ---------------------------------------------------------------------------
# full sampler: phase 1 + (compacted) phase 2
# ---------------------------------------------------------------------------

class ThreeBranchStats(NamedTuple):
    frac_skipped: torch.Tensor    # skipped S' construction (phase-1 skip)
    frac_m_final: torch.Tensor    # landed in M branch (skipped final sampling)
    frac_unchanged: torch.Tensor
    frac_at_max: torch.Tensor
    # Q'-branch landings; 0.0 on paths that use the combined S'+Q' sweep
    frac_q_branch: torch.Tensor | float = 0.0


@dataclasses.dataclass(frozen=True)
class Plan:
    """Static sampling plan (built once per corpus/config)."""
    g: int
    tile_size: int
    capacity: int | None          # survivor-chunk capacity; None = reference


def build_plan(config) -> Plan:
    cap = int(config.survivor_capacity) if config.survivor_capacity else None
    return Plan(g=config.g, tile_size=config.tile_size, capacity=cap)


def survivor_rank(skip: torch.Tensor):
    """(rank, n_surv): dense rank of each un-skipped token, survivor count."""
    rank = torch.cumsum(~skip, dim=0) - 1
    n_surv = (rank[-1] + 1).to(torch.int32) if skip.shape[0] \
        else torch.zeros((), dtype=torch.int32, device=skip.device)
    return rank, n_surv


def compact_survivor_indices(rank: torch.Tensor, skip: torch.Tensor,
                             total_slots: int) -> torch.Tensor:
    """Dense survivor token-index list built with one O(N) scatter.

    The first n_surv entries are the indices of the un-skipped tokens in
    rank order; the remaining slots hold the out-of-range sentinel ``n``.
    Survivors ranked at or past ``total_slots`` are dropped.
    """
    n = rank.shape[0]
    keep = (~skip) & (rank < total_slots)
    buf = torch.full((total_slots,), n, dtype=torch.int32, device=rank.device)
    buf[rank[keep]] = torch.arange(n, dtype=torch.int32,
                                   device=rank.device)[keep]
    return buf


def _mean(x: torch.Tensor) -> torch.Tensor:
    return x.float().mean()


def sample(u: torch.Tensor, plan: Plan, word_ids, doc_ids, old_topics, D, W,
           config):
    """Full EZLDA sampler: Ŵ, phase 1, (compacted) phase 2, stats.

    ``u`` is the (N,) uniform draw of this iteration. Without a capacity
    every token runs the exact phase 2 (the oracle, whose topics equal the
    skip decision's K1 wherever it skips); with one, only the survivors run
    it, in chunks of ``plan.capacity``.
    """
    alpha, g = config.alpha_, plan.g
    W_hat = esca.compute_w_hat(W, config.beta)
    stats_w = word_stats(W_hat, g=g, alpha=alpha)
    dec = skip_phase(u, word_ids, doc_ids, D, stats_w, g=g, alpha=alpha)
    k1_per_word = stats_w.k[:, 0]
    if plan.capacity is None:
        topics_exact, in_m = exact_three_branch(
            u, word_ids, doc_ids, k1_per_word, D, W_hat, alpha=alpha,
            tile_size=plan.tile_size)
        new_topics = torch.where(dec.skip, dec.k1, topics_exact)
        m_final = in_m
    else:
        rank, n_surv = survivor_rank(dec.skip)
        n_s = int(n_surv)
        surv_idx = compact_survivor_indices(rank, dec.skip, n_s).long()
        new_topics = dec.k1.clone()
        m_final = dec.skip.clone()
        for lo in range(0, n_s, plan.capacity):
            idx = surv_idx[lo:lo + plan.capacity]
            t_c, in_m_c = exact_three_branch(
                u[idx], word_ids[idx], doc_ids[idx], k1_per_word, D, W_hat,
                alpha=alpha, tile_size=plan.tile_size)
            new_topics[idx] = t_c
            m_final[idx] = in_m_c
    st = ThreeBranchStats(
        frac_skipped=_mean(dec.skip),
        frac_m_final=_mean(m_final),
        frac_unchanged=_mean(new_topics == old_topics),
        frac_at_max=_mean(new_topics == dec.k1),
    )
    return new_topics, st
