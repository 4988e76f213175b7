"""Mixture-of-Experts FFN with sort-based capacity dispatch, on one
device: port of the local path of ``src/repro/models/moe.py``.

* **Capacity**: no expert takes more than C slots a step (``_capacity``:
  lossless T·k while T·k ≤ 4,096, so decode never drops a request's
  token; ``capacity_factor``·T·k/E past it); overflow goes to the dump
  row.
* **Sort by expert**: one stable argsort turns the ragged expert groups
  into contiguous runs, and two static scatters fill ``(E, C+1, D)``
  buffers (slot C is the dump row); the three expert products are
  batched matmuls over E, as the reference's ``einsum``s are.
* The router's top-k keeps ``jax.lax.top_k``'s tie rule (the lower
  expert index first) through a stable descending sort; ``torch.topk``
  promises no order among equal values.
* Padded experts (``expert_pad_multiple``) are dead: their logits are
  -1e30 and they are never routed to. DeepSeek-style shared experts run
  as a dense SwiGLU beside the routed path.

The router is float32 at init in a model of any param dtype, as in the
reference. The reference's expert-parallel paths (``_expert_apply``,
``_a2a_routed`` and ``moe_ffn``'s ``shard_map`` branches) belong to the
sharded LM (ROADMAP.md Queue 1 #14c); one device runs the local path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

__all__ = ["init_moe", "moe_ffn", "router_load_stats", "router_top_k"]


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.padded_experts
    dt, dev = cfg.dtype, gen.device

    def expert_w(din, dout):
        w = torch.empty((e, din, dout), dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (w * din ** -0.5).to(dt)

    router = torch.empty((d, e), dtype=torch.float32, device=dev)
    router.normal_(generator=gen)
    p = {
        "router": router * 0.02,                           # router in f32
        "w_gate": expert_w(d, f),
        "w_up": expert_w(d, f),
        "w_down": expert_w(f, d),
    }
    if cfg.n_shared_experts:
        p["shared"] = layers.init_mlp(gen, d, cfg.n_shared_experts * f, dt,
                                      act="silu")
    return p


def _capacity(cfg: ModelConfig, t: int, k: int, e: int) -> int:
    """Expert capacity: cf·T·k/E for production sizes; lossless (T·k) for
    small batches — decode must never drop a request's token."""
    if t * k <= 4096:
        return t * k
    return max(int(cfg.capacity_factor * t * k / e), 8)


def router_top_k(xf: torch.Tensor, router: torch.Tensor, k: int,
                 e_total: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(probs of the top k, their experts), each (T, k): the router's
    float32 softmax over the live experts, ranked as ``jax.lax.top_k``
    ranks them (descending, the lower index first on a tie)."""
    logits = xf.float() @ router.float()                   # (T, E_pad)
    live = torch.arange(logits.shape[-1], device=xf.device) < e_total
    probs = torch.softmax(torch.where(live, logits, -1e30), dim=-1)
    w, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[:, :k], sel[:, :k]


def _dispatch_compute_combine(xf, router, w_gate, w_up, w_down, *,
                              cap: int, k: int, e_total: int):
    """Sort-based dispatch of T tokens' k assignments into (E, cap+1, D)
    buffers, the experts' SwiGLU, and the weighted combine. (The
    reference's shard offset ``e_base`` is 0 on one device: every
    assignment is local.)"""
    t, d = xf.shape
    e_loc = w_gate.shape[0]
    dev = xf.device
    w_topk, sel = router_top_k(xf, router, k, e_total)
    w_topk = w_topk / torch.sum(w_topk, dim=-1, keepdim=True)

    rel = sel.reshape(-1)                                  # (T·k,)
    order = torch.argsort(rel, stable=True)
    sorted_rel = rel[order]
    starts = torch.searchsorted(sorted_rel,
                                torch.arange(e_loc, device=dev))
    pos = torch.arange(t * k, device=dev) - starts[sorted_rel]
    keep = (sorted_rel < e_loc) & (pos < cap)
    slot = torch.where(keep, torch.clamp(pos, max=cap), cap)  # cap = dump row
    srel = torch.clamp(sorted_rel, max=e_loc - 1)
    tok_idx = order // k

    # every assignment past capacity writes the same zero row to (0, cap):
    # duplicate indices carry one value, so a scatter without accumulation
    # is deterministic (the reference's .at[].set(mode="drop"))
    vals = torch.where(keep[:, None], xf[tok_idx], 0)
    buf = xf.new_zeros((e_loc, cap + 1, d)).index_put(
        (torch.where(keep, srel, 0), slot), vals)
    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    out_slots = torch.bmm(h, w_down)

    gathered = out_slots[srel, slot] * keep[:, None].to(xf.dtype)
    contrib = xf.new_zeros((t * k, d)).index_put((order,), gathered)
    return torch.sum(contrib.reshape(t, k, d)
                     * w_topk[..., None].to(xf.dtype), dim=1)


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Routed FFN, the local path. x: (B, S, d) → (B, S, d)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    t = b * s
    cap = _capacity(cfg, t, k, e)
    y = _dispatch_compute_combine(
        x.reshape(t, d), p["router"], p["w_gate"], p["w_up"], p["w_down"],
        cap=cap, k=k, e_total=e).reshape(b, s, d)
    if "shared" in p:
        y = y + layers.mlp(p["shared"], x.reshape(t, d),
                           act="silu").reshape(b, s, d)
    return y


def router_load_stats(p: dict, x: torch.Tensor, cfg: ModelConfig) -> dict:
    """Instrumentation: per-expert load + overflow fraction (the MoE
    analogue of the paper's balance study)."""
    b, s, d = x.shape
    t = b * s
    _, sel = router_top_k(x.reshape(t, d), p["router"], cfg.moe_top_k,
                          cfg.n_experts)
    counts = torch.bincount(sel.reshape(-1), minlength=cfg.n_experts)
    cap = _capacity(cfg, t, cfg.moe_top_k, cfg.n_experts)
    overflow = torch.sum(torch.clamp(counts - cap, min=0)).float() \
        / (t * cfg.moe_top_k)
    imbalance = counts.max().float() / torch.clamp(counts.float().mean(),
                                                   min=1e-9)
    return {"counts": counts, "capacity": cap, "overflow_frac": overflow,
            "imbalance": imbalance}
