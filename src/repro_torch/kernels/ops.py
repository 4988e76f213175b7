"""Wrappers that put the kernels to work on whole token lists.

Port of ``src/repro/kernels/ops.py::sample_tokens``, the stepwise
``impl="kernel"`` sampler. The reference gathers rows in tiles for its
Pallas kernel; here the kernel gathers its own rows, so one call covers
every token.
"""

from __future__ import annotations

import torch

from repro_torch.core import three_branch
from repro_torch.kernels.sample_fused import sample_fused_rows

__all__ = ["sample_tokens"]


def sample_tokens(u: torch.Tensor, word_ids: torch.Tensor,
                  doc_ids: torch.Tensor, old_topics: torch.Tensor,
                  D: torch.Tensor, W_hat: torch.Tensor, *, alpha: float):
    """Exact three-branch draw for every token through the fused kernel.

    ``u`` is the (N,) uniform draw of this iteration. Returns (topics,
    stats) shaped like ``three_branch.sample``'s output.
    """
    f32 = torch.float32
    topics, m, s, q = sample_fused_rows(u, doc_ids, word_ids, D, W_hat,
                                        alpha=alpha)
    x = u * (m + s + q)
    in_m = x < m
    in_q = (~in_m) & (x >= m + s)                     # landed past S'
    k1 = torch.argmax(W_hat, dim=-1).to(torch.int32)[word_ids.long()]
    stats = three_branch.ThreeBranchStats(
        frac_skipped=in_m.to(f32).mean(),             # kernel = exact path
        frac_m_final=in_m.to(f32).mean(),
        frac_unchanged=(topics == old_topics).to(f32).mean(),
        frac_at_max=(topics == k1).to(f32).mean(),
        frac_q_branch=in_q.to(f32).mean(),
    )
    return topics, stats
