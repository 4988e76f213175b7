"""WarpLDA-style Metropolis–Hastings sampling (``sampler="warp"``).

Port of ``src/repro/core/mh.py``. The exact three-branch sampler pays
O(K) per surviving token; the warp engine replaces the exact draw with an
MH chain whose proposals cost O(1) per token:

  * **doc proposal** — q_doc(k) ∝ D[d][k] + α, drawn positionally: a
    uniformly random token of the same document lends its
    iteration-start topic, or an α-uniform topic is taken with
    probability Kα/(L_d + Kα);
  * **word proposal** — q_word(k) ∝ W̃[v][k], drawn from a Walker alias
    table over the word's row of the (possibly stale) W̃.

Each token runs ``mh_cycles`` cycles of (doc proposal, word proposal).
With target p(k) ∝ (D[d][k]+α)·Ŵ[v][k], the doc-proposal ratio is
Ŵ[v][t]/Ŵ[v][s] and the word-proposal ratio is

    [(D[d][t]+α)·Ŵ[v][t]·q̃[v][s]] / [(D[d][s]+α)·Ŵ[v][s]·q̃[v][t]].

Acceptance compares ``u·den < num`` (no division), as the reference does.

Where the reference takes PRNG keys, every function here takes the
uniforms the caller drew from the iteration's ``torch.Generator``
(``train/lda_step.py`` ``draw_warp_uniforms``), so a test can hand both
packages the same numbers. ``reference_chain_numpy``, the float64 oracle,
stays in the reference; the tests import it from there.

``run_vose`` is the plain twin of the ``vose_build`` CUDA kernel
(``kernels/sample_warp.py``); ``mh_chain`` with ``alias_draw`` that of
``warp_chain``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.three_branch import row_sum

__all__ = ["AliasTables", "DocIndex", "WarpStats", "alias_queues", "run_vose",
           "build_alias_tables", "build_doc_index", "doc_proposals",
           "word_proposals", "alias_draw", "mh_chain", "sample_warp"]


class AliasTables(NamedTuple):
    """Walker alias tables over each row of a weight matrix.

    ``q`` is the normalised proposal distribution the tables draw from;
    the acceptance ratio reads it even after the tables go stale.
    """
    prob: torch.Tensor    # (R, K) float32 in [0, 1]: keep-slot probability
    alias: torch.Tensor   # (R, K) int32: redirect target per slot
    q: torch.Tensor       # (R, K) float32: the normalised weights


class DocIndex(NamedTuple):
    """Static doc -> token index for the positional doc proposal."""
    start: torch.Tensor   # (M,) int32: first slot of each doc in ``perm``
    length: torch.Tensor  # (M,) int32: real tokens per doc
    perm: torch.Tensor    # (n_real,) int32: token indices sorted by doc


class WarpStats(NamedTuple):
    """Per-iteration MH statistics."""
    frac_accepted: torch.Tensor   # tokens that accepted >= 1 proposal
    frac_unchanged: torch.Tensor  # final topic == iteration-start topic
    n_proposals: torch.Tensor     # proposals issued per token (2·mh_cycles)


# ---------------------------------------------------------------------------
# Walker alias tables (Vose construction)
# ---------------------------------------------------------------------------

def alias_queues(scaled: torch.Tensor):
    """Initial Vose small/large queues for each row of ``scaled`` (= q·K).

    Returns ``(squeue, lqueue, n_small)``: per row, ``squeue`` holds the
    small slots (scaled < 1) ascending, then the large ones ascending;
    ``lqueue`` the large ones ascending, then the small ones. Integer, so
    bitwise equal to the reference's sort on the same ``scaled``.
    """
    R, K = scaled.shape
    is_small = scaled < 1.0
    k_idx = torch.arange(K, dtype=torch.int32,
                         device=scaled.device).expand(R, K)
    n_small = is_small.sum(dim=1, dtype=torch.int32)
    squeue = torch.sort(torch.where(is_small, k_idx, k_idx + K), dim=1).values
    squeue = torch.where(k_idx < n_small[:, None], squeue, squeue - K)
    lqueue = torch.sort(torch.where(is_small, k_idx + K, k_idx), dim=1).values
    lqueue = torch.where(k_idx < (K - n_small)[:, None], lqueue, lqueue - K)
    return squeue.contiguous(), lqueue.contiguous(), n_small


def run_vose(scaled: torch.Tensor, squeue: torch.Tensor, lqueue: torch.Tensor,
             n_small: torch.Tensor):
    """Vose pairing from precomputed queues -> (prob, alias), both (R, K).

    K sequential steps of row-parallel work. Each step pops one small
    slot, gives it its scaled weight as ``prob`` and the head large slot
    as ``alias``, charges the large slot ``1 − prob``, and demotes it to
    the small queue when its residual drops below 1. Every step follows
    the reference's arithmetic and masking exactly, so the result is
    bitwise the reference's ``run_vose`` (scatter or one-hot form) on the
    same inputs. The inputs are not modified.
    """
    R, K = scaled.shape
    dev = scaled.device
    rows = torch.arange(R, device=dev)
    scaled = scaled.clone()
    squeue = squeue.clone()
    n_large = (K - n_small).to(torch.int32)
    prob = torch.ones((R, K), dtype=torch.float32, device=dev)
    alias = torch.arange(K, dtype=torch.int32, device=dev).repeat(R, 1)
    s_head = torch.zeros(R, dtype=torch.int32, device=dev)
    l_head = torch.zeros(R, dtype=torch.int32, device=dev)
    s_tail = n_small.to(torch.int32).clone()

    def put(arr, idx, val, mask):
        idx = idx.long()
        arr[rows, idx] = torch.where(mask, val.to(arr.dtype), arr[rows, idx])

    for _ in range(K):
        has = (s_head < s_tail) & (l_head < n_large)
        s = squeue[rows, torch.clamp(s_head, 0, K - 1).long()]
        l = lqueue[rows, torch.clamp(l_head, 0, K - 1).long()]
        sval = scaled[rows, s.long()]
        put(prob, s, sval, has)
        put(alias, s, l, has)
        lval = scaled[rows, l.long()] - (1.0 - sval)
        put(scaled, l, lval, has)
        demote = has & (lval < 1.0)
        put(squeue, torch.clamp(s_tail, 0, K - 1), l, demote)
        inc, dem = has.to(torch.int32), demote.to(torch.int32)
        s_head += inc
        s_tail += dem
        l_head += dem
    return prob, alias


def proposal_weights(weights: torch.Tensor):
    """(q, scaled) of a weight matrix: q = w / Σ_k w (one PyTorch op per
    step, computed once) and scaled = q·K, the Vose build's input. Σ_k w
    is ``three_branch.row_sum``: on the card each row in an order its
    length fixes, so a window of rows builds the slice of the full
    tables, as the serving cache's head and tail do."""
    q = weights / row_sum(weights)[:, None]
    return q, q * weights.shape[1]


def build_alias_tables(weights: torch.Tensor) -> AliasTables:
    """Alias tables for q(k) ∝ weights[r][k], every row independently
    (plain PyTorch; ``kernels/sample_warp.py`` ``alias_tables`` builds the
    same with the ``vose_build`` kernel). Deterministic and
    row-independent: a window of rows builds the slice of the tables."""
    q, scaled = proposal_weights(weights.float())
    squeue, lqueue, n_small = alias_queues(scaled)
    prob, alias = run_vose(scaled, squeue, lqueue, n_small)
    return AliasTables(prob=prob, alias=alias, q=q)


# ---------------------------------------------------------------------------
# proposals
# ---------------------------------------------------------------------------

def build_doc_index(doc_ids: torch.Tensor, mask: torch.Tensor,
                    n_docs: int) -> DocIndex:
    """The static doc -> token index, built on the tokens' device."""
    real = (mask > 0).nonzero().squeeze(1)
    d = doc_ids[real].long()
    order = torch.sort(d, stable=True).indices
    perm = real[order].to(torch.int32)
    length = torch.bincount(d, minlength=n_docs).to(torch.int32)
    start = torch.zeros(n_docs, dtype=torch.int32, device=doc_ids.device)
    if n_docs > 1:
        start[1:] = torch.cumsum(length[:-1], dim=0)
    if perm.numel() == 0:                   # degenerate all-padding corpus
        perm = torch.zeros(1, dtype=torch.int32, device=doc_ids.device)
    return DocIndex(start=start, length=length, perm=perm)


def doc_proposals(u: torch.Tensor, topics: torch.Tensor,
                  doc_ids: torch.Tensor, index: DocIndex, *, n_topics: int,
                  alpha: float) -> torch.Tensor:
    """(C, n) int32 positional doc proposals from uniforms ``u`` (C, 3, n).

    P(t = k) = (D̂[d][k] + α) / (L_d + Kα), D̂ the iteration-start counts.
    """
    d = doc_ids.long()
    L = index.length[d]                                        # (n,) int32
    Lf = L.float()
    slot = torch.minimum((u[:, 0] * Lf).to(torch.int32),
                         torch.clamp(L - 1, min=0))
    pos = index.start[d][None, :] + slot
    pos = torch.clamp(pos, 0, index.perm.shape[0] - 1).long()
    t_pos = topics[index.perm[pos].long()]
    ka = torch.tensor(n_topics * alpha, dtype=torch.float32, device=u.device)
    p_unif = ka / (Lf + ka)            # tensor / tensor: one f32 division
    t_unif = torch.clamp((u[:, 2] * n_topics).to(torch.int32),
                         max=n_topics - 1)
    return torch.where((u[:, 1] < p_unif) | (L == 0), t_unif, t_pos)


def alias_draw(u: torch.Tensor, word_ids: torch.Tensor, prob: torch.Tensor,
               alias: torch.Tensor, *, n_topics: int) -> torch.Tensor:
    """Draw from per-word alias tables with uniforms ``u`` (C, 2, n): slot
    j = min(⌊u₀K⌋, K−1); keep j if u₁ < prob[v][j] else alias[v][j]."""
    j = torch.clamp((u[:, 0] * n_topics).to(torch.int32), max=n_topics - 1)
    v = word_ids.long()[None, :]
    keep = u[:, 1] < prob[v, j.long()]
    return torch.where(keep, j, alias[v, j.long()])


def word_proposals(u: torch.Tensor, word_ids: torch.Tensor,
                   tables: AliasTables) -> torch.Tensor:
    """(C, n) alias-table word proposals from uniforms ``u`` (C, 2, n)."""
    return alias_draw(u, word_ids, tables.prob, tables.alias,
                      n_topics=tables.prob.shape[1])


# ---------------------------------------------------------------------------
# the MH accept/reject chain
# ---------------------------------------------------------------------------

def mh_chain(s0, t_doc, t_word, u_acc, *, lookup_d: Callable,
             lookup_w: Callable, lookup_q: Callable, alpha: float,
             return_ratios: bool = False):
    """Run the proposal cycles per token given O(1) lookup closures.

    ``lookup_d(k)`` -> D[dᵢ][kᵢ] as float32, ``lookup_w(k)`` -> live
    Ŵ[vᵢ][kᵢ], ``lookup_q(k)`` -> table distribution q̃[vᵢ][kᵢ]. Returns
    (topics, accepted counts int32) and, with ``return_ratios``, the
    (C, 2, n) acceptance ratios.
    """
    n_cycles = t_doc.shape[0]
    s = s0
    n_acc = torch.zeros(s0.shape, dtype=torch.int32, device=s0.device)
    ratios = []
    for c in range(n_cycles):
        t = t_doc[c]
        num, den = lookup_w(t), lookup_w(s)
        acc = u_acc[c, 0] * den < num
        if return_ratios:
            ratios.append(num / den)
        n_acc += acc.to(torch.int32)
        s = torch.where(acc, t, s)

        t = t_word[c]
        num = (lookup_d(t) + alpha) * lookup_w(t) * lookup_q(s)
        den = (lookup_d(s) + alpha) * lookup_w(s) * lookup_q(t)
        acc = u_acc[c, 1] * den < num
        if return_ratios:
            ratios.append(num / den)
        n_acc += acc.to(torch.int32)
        s = torch.where(acc, t, s)
    if return_ratios:
        return s, n_acc, torch.stack(ratios).reshape(n_cycles, 2, -1)
    return s, n_acc


def row_lookups(doc: torch.Tensor, word: torch.Tensor, D: torch.Tensor,
                W_hat: torch.Tensor, q: torch.Tensor):
    """The (lookup_d, lookup_w, lookup_q) closures over rows D[doc],
    Ŵ[word] and q[word]."""
    d, v = doc.long(), word.long()
    return (lambda k: D[d, k.long()].float(),
            lambda k: W_hat[v, k.long()],
            lambda k: q[v, k.long()])


def warp_stats(mask: torch.Tensor | None, acc_any: torch.Tensor,
               new_topics: torch.Tensor, old_topics: torch.Tensor,
               n_cycles: int) -> WarpStats:
    """Per-iteration MH statistics over the real (unmasked) tokens."""
    f32 = torch.float32
    m = torch.ones_like(acc_any, dtype=f32) if mask is None \
        else (mask > 0).to(f32)
    denom = torch.clamp(m.sum(), min=1.0)
    return WarpStats(
        frac_accepted=(acc_any.to(f32) * m).sum() / denom,
        frac_unchanged=((new_topics == old_topics).to(f32) * m).sum() / denom,
        n_proposals=torch.tensor(float(2 * n_cycles), dtype=f32,
                                 device=acc_any.device))


def sample_warp(u_doc, u_word, u_acc, word_ids, doc_ids, topics, D, W_hat,
                tables: AliasTables, index: DocIndex, *, alpha: float,
                mask=None):
    """Full-batch warp sampler in plain PyTorch (the stepwise oracle).

    One iteration of the MH chain over every token with direct gathers.
    ``u_doc`` (C, 3, n), ``u_word`` and ``u_acc`` (C, 2, n) are the
    iteration's uniforms. Padding tokens (``mask == 0``) keep their topic
    and drop out of the stats. Returns (topics, WarpStats).
    """
    n_topics = W_hat.shape[1]
    t_doc = doc_proposals(u_doc, topics, doc_ids, index, n_topics=n_topics,
                          alpha=alpha)
    t_word = word_proposals(u_word, word_ids, tables)
    look_d, look_w, look_q = row_lookups(doc_ids, word_ids, D, W_hat,
                                         tables.q)
    s, n_acc = mh_chain(topics, t_doc, t_word, u_acc, lookup_d=look_d,
                        lookup_w=look_w, lookup_q=look_q, alpha=alpha)
    if mask is not None:
        real = mask > 0
        s = torch.where(real, s, topics)
        n_acc = torch.where(real, n_acc, 0)
    return s, warp_stats(mask, n_acc > 0, s, topics, u_acc.shape[0])
