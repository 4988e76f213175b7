"""Plain-PyTorch oracles for the port's kernels (the correctness contracts).

Port of ``src/repro/kernels/ref.py``: each function states its kernel's
math with straight tensor operations.
"""

from __future__ import annotations

import torch

__all__ = ["sample_fused_ref", "sample_sparse_ref"]


def sample_fused_ref(u: torch.Tensor, d_rows: torch.Tensor,
                     w_rows: torch.Tensor, *, alpha: float):
    """Oracle for kernels/sample_fused.py (exact three-branch, combined CDF).

    ``d_rows`` (N, K) int32 and ``w_rows`` (N, K) float32 are the tokens'
    gathered D and Ŵ rows. Returns (topic int32, M, S', Q').
    """
    d = d_rows.float()
    w = w_rows
    k1 = torch.argmax(w, dim=1)                       # first max, int64
    a1 = w.gather(1, k1[:, None])[:, 0]
    b1 = d.gather(1, k1[:, None])[:, 0]
    m = a1 * (b1 + alpha)
    s_p = (d * w).sum(dim=1) - a1 * b1
    q_p = alpha * (w.sum(dim=1) - a1)
    x = u * (m + s_p + q_p)
    in_m = x < m
    k_iota = torch.arange(w.shape[1], device=w.device)[None, :]
    mass = torch.where(k_iota != k1[:, None], (d + alpha) * w, 0.0)
    cdf = torch.cumsum(mass, dim=1)
    hit = cdf > (x - m)[:, None]
    found = hit.any(dim=1)
    first = torch.argmax(hit.to(torch.uint8), dim=1)
    topic = torch.where(in_m, k1,
                        torch.where(found, first, w.shape[1] - 1))
    return topic.to(torch.int32), m, s_p, q_p


def sample_sparse_ref(u: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                      w_at_idx: torch.Tensor, k1: torch.Tensor,
                      a1: torch.Tensor, b1: torch.Tensor,
                      q_prime: torch.Tensor, *, alpha: float):
    """Oracle for kernels/sample_sparse.py (sparse-S' draw, O(L) per token).

    ``idx``/``val`` (N, L) are the unpacked D-row slots, ``w_at_idx`` Ŵ[v]
    at those slots; k1, a1, b1, Q' are per-token. Returns (topic, needs_q,
    S'); topic is -1 where needs_q (the draw fell into Q', which the
    caller finishes).

    A slot adds mass only if it is live: val > 0 and idx ≠ K1. The
    reference's oracle multiplies every slot, so an empty slot whose Ŵ
    gather is NaN (its wrapper's fill-mode gather at idx 0xFFFF) poisons
    S'; on finite inputs the two agree.
    """
    m = a1 * (b1 + alpha)
    live = (val > 0) & (idx != k1[:, None])
    p_s = torch.where(live, val.float() * w_at_idx, 0.0)
    s_p = p_s.sum(dim=1)
    x = u * (m + s_p + q_prime)
    in_m = x < m
    cdf = torch.cumsum(p_s, dim=1)
    hit = live & (cdf > (x - m)[:, None])
    found = hit.any(dim=1)
    slot = torch.argmax(hit.to(torch.uint8), dim=1)
    topic_s = idx.gather(1, slot[:, None])[:, 0]
    in_s = (~in_m) & found & (x < m + s_p)
    needs_q = (~in_m) & (~in_s)
    topic = torch.where(in_m, k1, torch.where(in_s, topic_s, -1))
    return topic.to(torch.int32), needs_q, s_p
