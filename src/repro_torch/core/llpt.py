"""Log-likelihood per token (paper Eq 5) -- the convergence metric.

    LLPT = 1/N * sum_n log2( sum_k theta[d][k] * phi[v][k] )
    theta[d][k] = (D[d][k] + alpha) / (len(d) + K*alpha)
    phi[v][k]   = (W[v][k] + beta) / (colsum_W[k] + V*beta)   (= W_hat)

Port of ``src/repro/core/llpt.py``: ``token_ll`` gives the per-token
values in tiles of ``tile_size`` tokens, ``reduce_ll`` the masked mean.
"""

from __future__ import annotations

import torch

__all__ = ["llpt", "token_ll", "reduce_ll"]


def token_ll(word_ids: torch.Tensor, doc_ids: torch.Tensor, D: torch.Tensor,
             W: torch.Tensor | None = None,
             colsum: torch.Tensor | None = None, *, alpha: float,
             beta: float | None = None, n_words: int | None = None,
             tile_size: int = 8192,
             phi: torch.Tensor | None = None) -> torch.Tensor:
    """(n,) per-token log2 p(token) — the summand of Eq 5.

    ``colsum`` is the float32 per-topic total Σ_v W[v][k] and ``n_words``
    the vocabulary size V of the phi denominator. A given ``phi`` (the
    frozen Ŵ of fold-in serving) takes the place of the one that ``W``,
    ``colsum``, ``beta`` and ``n_words`` make.
    """
    K = D.shape[1]
    doc_len = D.sum(dim=-1, dtype=torch.float32)                    # (M,)
    theta = (D.float() + alpha) / (doc_len[:, None] + K * alpha)
    if phi is None:
        phi = (W.float() + beta) / (colsum + n_words * beta)
    n = word_ids.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=D.device)
    for lo in range(0, n, tile_size):
        hi = min(lo + tile_size, n)
        p = (theta[doc_ids[lo:hi].long()] * phi[word_ids[lo:hi].long()]
             ).sum(dim=-1)
        out[lo:hi] = torch.log2(torch.clamp(p, min=1e-30))
    return out


def reduce_ll(ll: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean of per-token log likelihoods — Eq 5's 1/N Σ."""
    m = mask.float()
    return (ll * m).sum() / torch.clamp(m.sum(), min=1.0)


def llpt(word_ids: torch.Tensor, doc_ids: torch.Tensor, mask: torch.Tensor,
         D: torch.Tensor, W: torch.Tensor, *, alpha: float, beta: float,
         tile_size: int = 8192) -> torch.Tensor:
    V = W.shape[0]
    ll = token_ll(word_ids, doc_ids, D, W, W.sum(dim=0, dtype=torch.float32),
                  alpha=alpha, beta=beta, n_words=V, tile_size=tile_size)
    return reduce_ll(ll, mask)
