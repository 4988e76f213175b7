"""ESCA: the two-branch sampler, Ŵ, count rebuilds and ±1 delta updates.

Port of ``src/repro/core/esca.py``. The two-branch draw (paper Eq 4,
ESCA's sampler, the baseline the three-branch sampler is measured
against) splits each token's mass (D[d] + α)∘Ŵ[v] into the S branch
D[d]∘Ŵ[v] and the Q branch α·Ŵ[v], draws x = u·(S + Q), and inverts the
CDF of the branch x lands in. It runs as plain PyTorch on the tensors'
device, a tile of tokens at a time (O(tile·K) memory), as the reference
runs it outside any Pallas kernel.

Counts stay int32. Every scatter goes through ``index_put_(...,
accumulate=True)``: integer adds commute, so the result is exact in any
order, on the card (atomics) as on the CPU.

Ŵ is one IEEE float32 division per entry, as in the reference, so it is
bitwise equal to the reference's on the same counts.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "SampleStats",
    "sample_two_branch",
    "two_branch_rows",
    "compute_w_hat",
    "compute_w_hat_from_colsum",
    "update_counts",
    "delta_update_counts",
    "delta_update_colsum",
    "init_topics",
    "init_counts",
    "scatter_moves",
]


def compute_w_hat(W: torch.Tensor, beta: float) -> torch.Tensor:
    """W_hat[v][k] = (W[v][k] + beta) / (sum_v W[v][k] + V*beta)   (Eq 1 part2)."""
    V = W.shape[0]
    colsum = W.sum(dim=0, dtype=torch.float32)              # exact: ints < 2^24
    return (W.float() + beta) / (colsum + V * beta)


def compute_w_hat_from_colsum(W: torch.Tensor, colsum: torch.Tensor,
                              beta: float,
                              n_words: int | None = None) -> torch.Tensor:
    """compute_w_hat with the maintained int32 column sum Σ_v W[v][k].

    Bit-identical to compute_w_hat (the float cast of an integer count
    below 2^24 is exact) while skipping its O(V·K) reduction.
    """
    V = W.shape[0] if n_words is None else n_words
    return (W.float() + beta) / (colsum.float() + V * beta)


class SampleStats(NamedTuple):
    """The two-branch sampler's statistics (Figs 3/12)."""
    frac_unchanged: torch.Tensor  # fraction of tokens keeping their topic
    frac_at_max: torch.Tensor     # fraction on their word's max topic
    frac_s_branch: torch.Tensor   # fraction drawn from the S branch


def _searchsorted_cdf(cdf: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per row, the first index k with cdf[k] > x, clamped to K − 1."""
    k = torch.searchsorted(cdf, x[:, None].contiguous(), right=True)
    return torch.clamp(k[:, 0], max=cdf.shape[-1] - 1).to(torch.int32)


def two_branch_rows(u: torch.Tensor, d_rows: torch.Tensor,
                    w_rows: torch.Tensor, alpha: float):
    """The two-branch draw of a tile of tokens (the reference's
    ``_sample_token`` over rows): D rows (C, K) int32, Ŵ rows (C, K) f32.

    S and Q are the last entries of the branches' float32 cumsums.
    Returns (topic int32, in_s bool, S, Q).
    """
    p_s = d_rows.float() * w_rows                       # D[d] o W_hat[v]
    p_q = alpha * w_rows                                # alpha o W_hat[v]
    cs = torch.cumsum(p_s, dim=1)
    cq = torch.cumsum(p_q, dim=1)
    s, q = cs[:, -1], cq[:, -1]
    x = u * (s + q)
    in_s = x < s
    topic = torch.where(in_s, _searchsorted_cdf(cs, x),
                        _searchsorted_cdf(cq, x - s))
    return topic, in_s, s, q


def sample_two_branch(u: torch.Tensor, word_ids: torch.Tensor,
                      doc_ids: torch.Tensor, old_topics: torch.Tensor,
                      D: torch.Tensor, W_hat: torch.Tensor, *, alpha: float,
                      tile_size: int = 8192):
    """New topics for every token by the two-branch draw (the dense O(N·K)
    ESCA baseline), ``u`` the (N,) uniform draw of this iteration.

    Tokens are taken ``tile_size`` at a time, so live memory is
    O(tile_size·K). ``D`` is the iteration-start matrix: the sampled
    token's own count is included (ESCA's form, which the paper
    inherits). ``frac_at_max`` counts tokens on their word's first
    maximal Ŵ topic (``torch.argmax`` returns the first of equal maxima,
    as ``jnp.argmax`` does). Returns (topics, SampleStats).
    """
    f32 = torch.float32
    n = u.shape[0]
    topics = torch.empty(n, dtype=torch.int32, device=u.device)
    in_s = torch.empty(n, dtype=torch.bool, device=u.device)
    for lo in range(0, n, tile_size):
        hi = min(lo + tile_size, n)
        topics[lo:hi], in_s[lo:hi], _, _ = two_branch_rows(
            u[lo:hi], D[doc_ids[lo:hi].long()], W_hat[word_ids[lo:hi].long()],
            alpha)
    max_topic = torch.argmax(W_hat, dim=-1).to(torch.int32)   # per word
    stats = SampleStats(
        frac_unchanged=(topics == old_topics).to(f32).mean(),
        frac_at_max=(topics == max_topic[word_ids.long()]).to(f32).mean(),
        frac_s_branch=in_s.to(f32).mean())
    return topics, stats


def scatter_moves(counts: torch.Tensor, rows: torch.Tensor | None,
                  old: torch.Tensor, new: torch.Tensor) -> None:
    """counts[rows, old] -= 1 ; counts[rows, new] += 1, in one scatter.

    ``rows=None`` moves a 1-d count vector (the column sum).
    """
    ones = torch.ones(old.shape[0], dtype=counts.dtype, device=counts.device)
    index = (torch.cat([old, new]).long(),)
    if rows is not None:
        index = (torch.cat([rows, rows]).long(),) + index
    counts.index_put_(index, torch.cat([-ones, ones]), accumulate=True)


def update_counts(word_ids: torch.Tensor, doc_ids: torch.Tensor,
                  topics: torch.Tensor, mask: torch.Tensor, *, n_docs: int,
                  n_words: int, n_topics: int):
    """Rebuild D (M,K) and W (V,K) from the token list; pads add zero."""
    w = mask.to(torch.int32)
    dev = topics.device
    D = torch.zeros((n_docs, n_topics), dtype=torch.int32, device=dev)
    W = torch.zeros((n_words, n_topics), dtype=torch.int32, device=dev)
    D.index_put_((doc_ids.long(), topics.long()), w, accumulate=True)
    W.index_put_((word_ids.long(), topics.long()), w, accumulate=True)
    return D, W


def delta_update_counts(D: torch.Tensor, W: torch.Tensor,
                        word_ids: torch.Tensor, doc_ids: torch.Tensor,
                        old_topics: torch.Tensor, new_topics: torch.Tensor,
                        mask: torch.Tensor):
    """Apply −1/+1 at the tokens whose topic changed, in place.

    Exactly equal to update_counts on new_topics whenever (D, W) were
    consistent with old_topics. Returns (D, W) for the reference's
    calling convention; the tensors passed in are the ones updated.
    """
    idx = ((new_topics != old_topics) & (mask > 0)).nonzero().squeeze(1)
    old, new = old_topics[idx], new_topics[idx]
    scatter_moves(D, doc_ids[idx], old, new)
    scatter_moves(W, word_ids[idx], old, new)
    return D, W


def delta_update_colsum(colsum: torch.Tensor, old_topics: torch.Tensor,
                        new_topics: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Maintain Ŵ's per-topic column sum under a topic delta, in place."""
    idx = ((new_topics != old_topics) & (mask > 0)).nonzero().squeeze(1)
    scatter_moves(colsum, None, old_topics[idx], new_topics[idx])
    return colsum


def init_topics(generator: torch.Generator, shape,
                n_topics: int) -> torch.Tensor:
    """Uniform random topics (paper Fig 2 step 1) on the generator's
    device."""
    return torch.randint(0, n_topics, shape, generator=generator,
                         device=generator.device, dtype=torch.int32)


def init_counts(generator: torch.Generator, word_ids: torch.Tensor,
                doc_ids: torch.Tensor, mask: torch.Tensor, *, n_docs: int,
                n_words: int, n_topics: int):
    """Random topic init (paper Fig 2 step 1) + initial count build.

    ``generator`` lives on the tokens' device (see
    ``lda.model.uniforms_generator``).
    """
    topics = init_topics(generator, word_ids.shape, n_topics)
    D, W = update_counts(word_ids, doc_ids, topics, mask, n_docs=n_docs,
                         n_words=n_words, n_topics=n_topics)
    return topics, D, W
