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
reference.

On a mesh (``runtime.sharding.use_rules``) whose ``model`` axis over 1
divides the padded expert stacks, ``moe_ffn`` picks the reference's
route as it does (its ``shard_map``, ``use_smap`` true):

* the ``ep`` policy with the rows split over every axis: all-to-all
  expert parallelism over ``model`` on the rank's own rows
  (``_a2a_routed``: bucket by owning rank with capacity ``cap_s``,
  all-to-all, ``_expert_apply`` with ``cap2``, all-to-all back, combine
  at the source);
* the ``dp`` and ``fsdp`` policies with the rows split over every axis:
  the reference's in-specs reshard them to the data shard's rows. With
  the sequence divisible by ``model`` an all-to-all gives each rank the
  data shard's rows on its sequence slice, ``_a2a_routed`` runs there on
  the rank's block of the (replicated, or fsdp-gathered) stacks, and
  another gives each rank back its own rows; else the rank gathers the
  data shard's rows, dispatches them to its experts
  (``_dispatch_compute_combine`` with ``e_base``) and the partial sums
  are reduce-scattered back to the rows' ranks. The stacks' gradients
  are zero outside the rank's block, and the policy's sum over every
  axis completes them, the router's too;
* otherwise (the rows replicated over ``model``), with the sequence
  divisible by it: the all-to-all route on this rank's sequence slice
  (the port's residual is replicated over ``model``, the reference's
  sequence-sharded inside ``shard_map``), the slices gathered back after;
* otherwise replicated-activation expert parallelism: every rank
  dispatches all its tokens to its own experts and the outputs are
  summed over ``model``.

A replicated router used on rank-different tokens gets its gradient
summed over ``model`` (``copy_to``). Decode's single position does not
divide ``model``, so a sharded decode takes the replicated-activation
route at B × 1, as the reference's choice does. Where the stacks do not
divide ``model`` (64 on 3) the reference runs the one-device dispatch
of the global batch, and so does the port (``_global_dispatch``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.sharding import (all_to_all, axes_index,
                                          batch_axes, copy_to,
                                          current_rules, gather_along,
                                          gather_rs, mesh_axis_size,
                                          reduce_from, reduce_scatter_along,
                                          scatter_along, swap_along)

__all__ = ["init_moe", "moe_ffn", "router_load_stats", "router_top_k"]


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.padded_experts
    dt, dev = cfg.dtype, gen.device

    def expert_w(din, dout):
        w = torch.empty((e, din, dout), dtype=torch.float32, device=dev)
        return (layers.trunc_normal_(w, gen) * din ** -0.5).to(dt)

    router = layers.normal_(torch.empty((d, e), dtype=torch.float32,
                                        device=dev), gen)
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
                              cap: int, k: int, e_total: int,
                              e_base: int = 0):
    """Sort-based dispatch of T tokens' k assignments into (E, cap+1, D)
    buffers for the experts [e_base, e_base + e_loc), the experts'
    SwiGLU, and the weighted combine; assignments to other ranks'
    experts fall into the dump row (on one device every one is local)."""
    t, d = xf.shape
    e_loc = w_gate.shape[0]
    dev = xf.device
    w_topk, sel = router_top_k(xf, router, k, e_total)
    w_topk = w_topk / torch.sum(w_topk, dim=-1, keepdim=True)

    rel = sel.reshape(-1) - e_base                         # (T·k,)
    mine = (rel >= 0) & (rel < e_loc)
    rel = torch.where(mine, rel, e_loc)                    # e_loc: foreign
    order = torch.argsort(rel, stable=True)
    sorted_rel = rel[order]
    starts = torch.searchsorted(sorted_rel,
                                torch.arange(e_loc, device=dev))
    # the foreign sentinel reads the last start, as jax's clamped gather
    # does (those rows are not kept)
    srel = torch.clamp(sorted_rel, max=e_loc - 1)
    pos = torch.arange(t * k, device=dev) - starts[srel]
    keep = (sorted_rel < e_loc) & (pos < cap)
    slot = torch.where(keep, torch.clamp(pos, max=cap), cap)  # cap = dump row
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


def _expert_apply(xf, rel_e, w_gate, w_up, w_down, cap: int):
    """The experts' FFN for rows already labelled with LOCAL expert ids.

    xf: (M, d); rel_e: (M,) in [0, e_loc] (e_loc: no expert). Returns
    (M, d), zeros for unlabelled rows and rows past capacity: the
    sort-based dispatch of ``_dispatch_compute_combine``."""
    m, d = xf.shape
    e_loc = w_gate.shape[0]
    dev = xf.device
    order = torch.argsort(rel_e, stable=True)
    sorted_rel = rel_e[order]
    starts = torch.searchsorted(sorted_rel, torch.arange(e_loc, device=dev))
    srel = torch.clamp(sorted_rel, max=e_loc - 1)
    pos = torch.arange(m, device=dev) - starts[srel]
    keep = (sorted_rel < e_loc) & (pos < cap)
    slot = torch.where(keep, torch.clamp(pos, max=cap), cap)
    vals = torch.where(keep[:, None], xf[order], 0)
    buf = xf.new_zeros((e_loc, cap + 1, d)).index_put(
        (torch.where(keep, srel, 0), slot), vals)
    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    out_slots = torch.bmm(h, w_down)
    gathered = out_slots[srel, slot] * keep[:, None].to(xf.dtype)
    return xf.new_zeros((m, d)).index_put((order,), gathered)


def _a2a_routed(x_loc, router, wg, wu, wd, *, cfg: ModelConfig, k: int,
                e_total: int, mesh) -> torch.Tensor:
    """All-to-all expert parallelism over ``model``.

    x_loc: this rank's tokens (B_loc, S_loc, d). Each rank routes its own
    tokens, buckets them by the rank owning the expert (capacity
    ``cap_s`` a destination, overflow to a dump slot), sends the buckets
    to their owners, runs its experts on what it received (capacity
    ``cap2`` an expert), sends the results back, and combines them at
    the source with the router's weights. The wire is 2·P·cap_s·d a
    layer, not the activations."""
    bl, sl, d = x_loc.shape
    t = bl * sl
    dev = x_loc.device
    xf = x_loc.reshape(t, d)
    e_loc = wg.shape[0]
    pm = router.shape[1] // e_loc                          # model extent

    w_topk, sel = router_top_k(xf, router, k, e_total)
    w_topk = (w_topk / torch.sum(w_topk, -1, keepdim=True)).reshape(-1)
    flat_e = sel.reshape(-1)                               # (t·k,)
    dest = flat_e // e_loc                                 # owning rank
    cap_s = max(int(cfg.capacity_factor * t * k / pm), 8)
    order = torch.argsort(dest, stable=True)
    sorted_dest = dest[order]
    starts = torch.searchsorted(sorted_dest, torch.arange(pm, device=dev))
    pos = torch.arange(t * k, device=dev) - starts[sorted_dest]
    keep = pos < cap_s
    slot = torch.where(keep, torch.clamp(pos, max=cap_s), cap_s)
    tok_idx = order // k

    send_x = xf.new_zeros((pm, cap_s + 1, d)).index_put(
        (sorted_dest, slot), torch.where(keep[:, None], xf[tok_idx], 0))
    send_e = torch.full((pm, cap_s + 1), e_loc, dtype=torch.long,
                        device=dev).index_put(
        (sorted_dest, slot), torch.where(keep, flat_e[order] % e_loc, e_loc))
    # the combine's bookkeeping stays at the source: the flat assignment
    # each sent row carries (t·k: none)
    src_asn = torch.full((pm, cap_s + 1), t * k, dtype=torch.long,
                         device=dev).index_put(
        (sorted_dest, slot), torch.where(keep, order, t * k))

    recv_x = all_to_all(send_x[:, :cap_s], mesh)
    recv_e = all_to_all(send_e[:, :cap_s].contiguous(), mesh)
    cap2 = max(int(cfg.capacity_factor * pm * cap_s / max(e_loc, 1)), 8)
    out = _expert_apply(recv_x.reshape(pm * cap_s, d),
                        recv_e.reshape(pm * cap_s), wg, wu, wd, cap2)
    back = all_to_all(out.reshape(pm, cap_s, d), mesh)
    # combine at the source: each assignment's result at its flat index
    # (the unsent ones in a dump row), then the k of a token summed in
    # order (the reference's scatter-add, made deterministic)
    asn = src_asn[:, :cap_s].reshape(-1)
    sent = asn < t * k
    w_asn = torch.where(sent, w_topk[torch.clamp(asn, max=t * k - 1)],
                        0.0).to(xf.dtype)
    contrib = xf.new_zeros((t * k + 1, d)).index_put(
        (asn,), back.reshape(-1, d) * w_asn[:, None])
    return contrib[:t * k].reshape(t, k, d).sum(dim=1).reshape(bl, sl, d)


def _routed_on_mesh(p: dict, x: torch.Tensor, cfg: ModelConfig,
                    rules) -> torch.Tensor:
    """The routed experts on a mesh whose ``model`` axis divides the
    padded expert stacks, by the reference's choice of route (see the
    module docstring). x: this rank's rows (B_loc, S, d)."""
    mesh = rules.mesh
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    pm = rules.model_size()
    m = mesh.axis_index("model")
    rows_on_model = "model" in rules.batch
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    if wg.shape[0] == cfg.padded_experts:     # dp, fsdp: the whole stacks
        el = wg.shape[0] // pm
        ws = (wg, wu, wd) if rows_on_model else \
            tuple(copy_to(w, mesh) for w in (wg, wu, wd))
        wg, wu, wd = (w[m * el:(m + 1) * el] for w in ws)
    if rows_on_model:
        if rules.policy == "ep":
            return _a2a_routed(x, p["router"], wg, wu, wd, cfg=cfg, k=k,
                               e_total=e, mesh=mesh)
        # dp, fsdp: the reference's shard_map reshards the rows to the
        # data shard's, its sequence over model (the a2a route) or whole
        # (replicated-activation); the router's gradient is each rank's
        # part, summed over every axis by the policy
        if s % pm == 0:
            xs = swap_along(x, mesh, "model", 1, 0)   # (P·B_loc, S/P, d)
            y = _a2a_routed(xs, p["router"], wg, wu, wd, cfg=cfg, k=k,
                            e_total=e, mesh=mesh)
            return swap_along(y, mesh, "model", 0, 1)
        xd = gather_rs(x, mesh, "model", 0)             # the shard's rows
        y = _dispatch_compute_combine(
            xd.reshape(-1, d), p["router"], wg, wu, wd,
            cap=_capacity(cfg, xd.shape[0] * s, k, e), k=k, e_total=e,
            e_base=m * wg.shape[0])
        return reduce_scatter_along(y.reshape(xd.shape), mesh, "model", 0)
    router = copy_to(p["router"], mesh)
    if s % pm == 0:
        y = _a2a_routed(scatter_along(x, mesh, "model", 1), router, wg, wu,
                        wd, cfg=cfg, k=k, e_total=e, mesh=mesh)
        return gather_along(y, mesh, "model", 1)
    rows = b * mesh_axis_size(mesh, rules.batch)           # the global rows
    t_loc = max(rows // mesh_axis_size(mesh, batch_axes(mesh)), 1) * s
    y = _dispatch_compute_combine(
        copy_to(x, mesh).reshape(b * s, d), router, wg, wu, wd,
        cap=_capacity(cfg, t_loc, k, e), k=k, e_total=e,
        e_base=m * wg.shape[0])
    return reduce_from(y.reshape(b, s, d), mesh)


def _global_dispatch(p: dict, x: torch.Tensor, cfg: ModelConfig,
                     rules) -> torch.Tensor:
    """The one-device dispatch over every row of the step, as the
    reference runs it where the padded stacks do not divide ``model``
    (``use_smap`` false: GSPMD's one dispatch of the global batch, its
    capacity from the global token count). Where that capacity holds
    every assignment the rank's own rows give the same result; else the
    rows are gathered over their axes, dispatched, and the rank's cut
    back."""
    mesh = rules.mesh
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    axes = tuple(a for a in rules.batch if mesh.shape[a] > 1)
    t = b * s * mesh_axis_size(mesh, axes)
    cap = _capacity(cfg, t, k, e)
    args = (p["router"], p["w_gate"], p["w_up"], p["w_down"])
    if not axes or cap >= t * k:
        return _dispatch_compute_combine(
            x.reshape(b * s, d), *args, cap=min(cap, b * s * k), k=k,
            e_total=e).reshape(b, s, d)
    xa = x
    for a in reversed(axes):                   # the innermost axis first
        xa = gather_rs(xa, mesh, a, 0)
    y = _dispatch_compute_combine(xa.reshape(-1, d), *args, cap=cap, k=k,
                                  e_total=e).reshape(xa.shape)
    i = axes_index(mesh, axes)
    return y[i * b:(i + 1) * b]


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Routed FFN. x: (B, S, d) → (B, S, d): the local path, or on a mesh
    the reference's route for it: expert parallelism over a ``model``
    axis that divides the padded stacks, else the dispatch of the
    global batch."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    t = b * s
    rules = current_rules()
    pm = 1 if rules is None else rules.model_size()
    if rules is not None and pm > 1 and cfg.padded_experts % pm == 0:
        y = _routed_on_mesh(p, x, cfg, rules)
    elif rules is not None and pm > 1:
        y = _global_dispatch(p, x, cfg, rules)
    else:
        cap = _capacity(cfg, t, k, e)
        y = _dispatch_compute_combine(
            x.reshape(t, d), p["router"], p["w_gate"], p["w_up"],
            p["w_down"], cap=cap, k=k, e_total=e).reshape(b, s, d)
    if "shared" in p:
        y = y + layers.mlp(p["shared"], x.reshape(t, d), act="silu",
                           d_ff=cfg.n_shared_experts * cfg.moe_d_ff
                           ).reshape(b, s, d)
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
