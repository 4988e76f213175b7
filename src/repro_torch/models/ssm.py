"""Mamba2 (SSD — state-space duality) blocks, chunk-parallel and recurrent:
port of ``src/repro/models/ssm.py``.

* Training and prefill run the SSD chunked algorithm: the sequence splits
  into chunks of ``chunk`` tokens (256); within a chunk the output is a
  masked, decay-weighted quadratic form, and across chunks a float32
  ``(B, H, N, P)`` state is carried. The reference's ``lax.scan`` over
  chunks is a loop over chunks here that carries the state; what a chunk
  computes from its own tokens alone (the quadratic form, its term of the
  state update) runs for every chunk at once, before the loop, and the
  state each chunk enters with is read after it. The decay is the
  reference's ``exp(min(cum_i − cum_j, 0))`` (``torch.minimum``, which
  splits the gradient at a tie as ``jnp.minimum`` does), with its causal
  mask and ``·dt_j`` weighting, all in float32.
* Decode is the one-token recurrence on the same state; the cache's
  state and conv rows are written in place.
* A is scalar a head (``a = −exp(a_log)``), the groups G share B and C
  over H/G heads, and a causal depthwise conv (width 4) fronts the SSM.

``a_log``, ``dt_bias`` and ``d_skip`` are float32 at init in a model of
any param dtype, as in the reference. The SSD products are the
reference's ``einsum``s outside any Pallas kernel, so they are
``torch.einsum`` here.

On a mesh whose rules put ``heads`` on ``model`` (the reference
constrains the SSD input so) the block's weights stay replicated and
each rank runs its ``n_ssm_heads / P`` heads. In training and prefill
the block's matmuls split as the reference's GSPMD splits them behind
that constraint: a rank computes ``w_in``'s columns of its channels (and
every group's B and C), the conv and SSD of its heads, the gated norm
over ``d_inner`` with its sum of squares summed over ``model``, and
``w_out`` on its channels' rows, summed over ``model``
(``_ssm_train_heads``); the replicated weights enter through
``copy_to``, so their gradients are summed over ``model``. Decode runs
the recurrence on the rank's block of the ``state`` cache for its heads
and gathers the heads' outputs over ``model`` before the skip, the
gated norm and ``w_out``, which every rank runs alike.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.sharding import (axes_index, copy_to,
                                          current_rules, gather_along,
                                          mesh_axis_size, reduce_from)

__all__ = ["init_ssm", "ssm_train", "init_ssm_cache", "ssm_decode"]


def init_ssm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    h, n, g = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_groups
    conv_dim = di + 2 * g * n
    dt, dev = cfg.dtype, gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    conv_w = layers.normal_(torch.empty((cfg.conv_width, conv_dim), **f32),
                            gen)
    return {
        # fused in_proj → [z, x_conv (B, C within), dt]
        "w_in": layers.init_linear(gen, d, 2 * di + 2 * g * n + h, dt),
        "conv_w": (conv_w * 0.1).to(dt),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=dev),
        "a_log": torch.zeros((h,), **f32),                 # A = -exp(a_log)
        "dt_bias": torch.log(torch.expm1(
            torch.full((h,), 0.01, **f32))),               # softplus⁻¹(0.01)
        "d_skip": torch.ones((h,), **f32),
        "norm": layers.init_norm(di, dt, dev),
        "w_out": layers.init_linear(gen, di, d, dt),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv. x: (B, L, C); w: (W, C); state: (B, W-1, C).
    Returns (silu(conv + b) in x's dtype, the last W-1 inputs)."""
    width = w.shape[0]
    if state is None:
        x_pad = F.pad(x, (0, 0, width - 1, 0))
    else:
        x_pad = torch.cat([state.to(x.dtype), x], dim=1)
    L = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):                                 # width=4: unrolled
        out = out + x_pad[:, i:i + L].float() * w[i].float()
    new_state = x_pad[:, -(width - 1):] if width > 1 else None
    return F.silu(out + b.float()).to(x.dtype), new_state


def _ssm_inputs(p, x, cfg):
    di = cfg.d_inner
    h, n, g = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_groups
    proj = layers.linear(p["w_in"], x)
    z = proj[..., :di]
    x_conv = proj[..., di:di + di + 2 * g * n]
    dt_raw = proj[..., -h:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    return z, x_conv, dt


def _rank_heads(cfg: ModelConfig):
    """(mesh, first head, heads) of this rank under the rules' "heads"
    (None, 0, n_ssm_heads where they are whole)."""
    h = cfg.n_ssm_heads
    rules = current_rules()
    e = None if rules is None else rules.spec((h,), ("heads",))[0]
    if e is None:
        return None, 0, h
    n = mesh_axis_size(rules.mesh, e)
    return rules.mesh, axes_index(rules.mesh, e) * (h // n), h // n


def ssm_train(p: dict, x: torch.Tensor, cfg: ModelConfig,
              chunk: int = 256) -> torch.Tensor:
    """Chunked SSD forward. x: (B, L, d_model) → (B, L, d_model)."""
    mesh, h0, hl = _rank_heads(cfg)
    if mesh is not None:
        return _ssm_train_heads(p, x, cfg, chunk, mesh, h0, hl)
    bsz, L, _ = x.shape
    di = cfg.d_inner
    h, n, g = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_groups
    pdim = cfg.ssm_head_dim
    z, x_conv, dt = _ssm_inputs(p, x, cfg)
    xc, _ = _causal_conv(x_conv, p["conv_w"], p["conv_b"])
    xs = xc[..., :di].reshape(bsz, L, h, pdim)
    rep = h // g                                           # heads per group
    Bm = xc[..., di:di + g * n].reshape(bsz, L, g, n) \
        .repeat_interleave(rep, dim=2)                     # (B, L, H, N)
    Cm = xc[..., di + g * n:].reshape(bsz, L, g, n) \
        .repeat_interleave(rep, dim=2)
    a = -torch.exp(p["a_log"])                             # (H,)
    dA = dt * a                                            # (B, L, H) ≤ 0
    y = _ssd(xs, Bm, Cm, dA, dt, chunk)
    y = y + xs.float() * p["d_skip"][None, None, :, None]
    y = y.reshape(bsz, L, di).to(x.dtype)
    y = layers.rms_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return layers.linear(p["w_out"], y)


def _ssm_train_heads(p: dict, x: torch.Tensor, cfg: ModelConfig,
                     chunk: int, mesh, h0: int, hl: int) -> torch.Tensor:
    """``ssm_train`` on this rank's heads ``[h0, h0 + hl)``, the block's
    matmuls split over ``model`` as the reference's GSPMD splits them
    behind its head-sharded SSD: ``w_in``'s columns of the rank's
    channels (its z, its x and dt, every group's B and C), the conv on
    those channels, the SSD, the gated norm over ``d_inner`` with its sum
    of squares summed over ``model``, and ``w_out``'s rows of the rank's
    channels summed over ``model``. The replicated weights enter through
    ``copy_to`` and are cut to the rank's columns there, so their
    gradients (each rank's columns, every rank's share of B and C) are
    summed over ``model``."""
    bsz, L, _ = x.shape
    di = cfg.d_inner
    h, n, g = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_groups
    pdim = cfg.ssm_head_dim
    dev = x.device
    c0, cl, gn = h0 * pdim, hl * pdim, g * n

    def span(lo, k):
        return torch.arange(lo, lo + k, device=dev)

    def mine(t, idx, dim=-1):
        return copy_to(t, mesh).index_select(dim, idx)

    cols = torch.cat([span(c0, cl), span(di + c0, cl), span(2 * di, 2 * gn),
                      span(2 * di + 2 * gn + h0, hl)])
    proj = copy_to(x, mesh) @ mine(p["w_in"]["w"], cols)
    if "b" in p["w_in"]:
        proj = proj + mine(p["w_in"]["b"], cols)
    z = proj[..., :cl]
    x_conv = proj[..., cl:2 * cl + 2 * gn]
    dt = F.softplus(proj[..., -hl:].float()
                    + mine(p["dt_bias"], span(h0, hl)).float())
    conv = torch.cat([span(c0, cl), span(di, 2 * gn)])
    xc, _ = _causal_conv(x_conv, mine(p["conv_w"], conv),
                         mine(p["conv_b"], conv))
    xs = xc[..., :cl].reshape(bsz, L, hl, pdim)
    rep = h // g
    Bm, Cm = (xc[..., cl + i * gn:cl + (i + 1) * gn].reshape(bsz, L, g, n)
              .repeat_interleave(rep, dim=2)[:, :, h0:h0 + hl]
              for i in (0, 1))
    heads = span(h0, hl)
    dA = dt * -torch.exp(mine(p["a_log"], heads))
    y = _ssd(xs, Bm, Cm, dA, dt, chunk)
    y = y + xs.float() * mine(p["d_skip"], heads)[None, None, :, None]
    y = y.reshape(bsz, L, cl).to(x.dtype)
    # the gated RMSNorm over d_inner: Σ of squares over every rank's
    # channels (summed forward and, as each rank's share, backward)
    v = (y * F.silu(z)).float()
    sq = copy_to(reduce_from(torch.sum(v * v, dim=-1, keepdim=True), mesh),
                 mesh)
    v = v * torch.rsqrt(sq / di + cfg.norm_eps)
    v = (v * mine(p["norm"]["scale"], span(c0, cl)).float()).to(x.dtype)
    # the ranks' partial products summed in float32 and rounded once, as
    # one device's matmul rounds its float32 accumulation once
    out = reduce_from(v.float() @ mine(p["w_out"]["w"], span(c0, cl),
                                       0).float(), mesh).to(x.dtype)
    return out + p["w_out"]["b"] if "b" in p["w_out"] else out


def _ssd(xs, Bm, Cm, dA, dt, chunk: int) -> torch.Tensor:
    """The chunked SSD of some heads: xs (B, L, H, P), B and C (B, L, H,
    N) a head, dA and dt (B, L, H) → y (B, L, H, P) float32, the skip
    term not added."""
    bsz, L, h, pdim = xs.shape
    n = Bm.shape[-1]
    dev = xs.device

    Q = min(chunk, L)
    n_chunks = -(-L // Q)
    pad = n_chunks * Q - L
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    iq = torch.arange(Q, device=dev)
    causal = iq[:, None] >= iq[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def to_chunks(t):                                      # (B, C, Q, ...)
        return t.reshape((bsz, n_chunks, Q) + t.shape[2:])

    xq = to_chunks(xs).float()                             # (B,C,Q,H,P)
    bq_h = to_chunks(Bm).float()                           # (B,C,Q,H,N)
    cq_h = to_chunks(Cm).float()
    daq, dtq = to_chunks(dA), to_chunks(dt)                # (B,C,Q,H)
    cum = torch.cumsum(daq, dim=2)
    total = cum[:, :, -1]                                  # (B,C,H)
    # ---- intra-chunk quadratic (masked decay attention), every chunk
    scores = torch.einsum("bcqhn,bckhn->bchqk", cq_h, bq_h)
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,C,Q,K,H) i−j
    decay = torch.exp(torch.minimum(decay, zero)).permute(0, 1, 4, 2, 3)
    w_ij = torch.where(causal, scores * decay, zero) \
        * dtq.permute(0, 1, 3, 2)[:, :, :, None, :]       # ·dt_j
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", w_ij, xq)
    # ---- each chunk's own term of the state update:
    # S' = exp(total)·S + Σ_j exp(total−cum_j)·dt_j·B_j⊗x_j
    wj = torch.exp(total[:, :, None] - cum) * dtq          # (B,C,Q,H)
    own = torch.einsum("bcqhn,bcqhp->bchnp", bq_h * wj[..., None], xq)
    carry = torch.exp(total)[..., None, None]              # (B,C,H,1,1)
    # ---- the loop over chunks carries the state; each chunk reads the
    # state it enters with: y_inter[i] = exp(cum_i) · C_i · state
    state = torch.zeros((bsz, h, n, pdim), dtype=torch.float32,
                        device=dev)
    entering = []
    for c in range(n_chunks):
        entering.append(state)
        state = state * carry[:, c] + own[:, c]
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", cq_h,
                           torch.stack(entering, dim=1)) \
        * torch.exp(cum)[..., None]
    return (y_inter + y_intra).reshape(bsz, n_chunks * Q, h, pdim)[:, :L]


def init_ssm_cache(cfg: ModelConfig, batch: int, device,
                   n_layers: int | None = None) -> dict:
    """The recurrent state (L, B, H, N, P) in float32 and the conv's last
    W-1 inputs (L, B, W-1, conv_dim) in the param dtype."""
    L = cfg.n_layers if n_layers is None else n_layers
    h, n, pdim = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "state": torch.zeros((L, batch, h, n, pdim), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((L, batch, cfg.conv_width - 1, conv_dim),
                            dtype=cfg.dtype, device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }


def ssm_decode(p: dict, x: torch.Tensor, state: torch.Tensor,
               conv_state: torch.Tensor, cfg: ModelConfig):
    """One-token recurrence. x: (B, 1, d); state (B, H, N, P) (on a mesh
    this rank's heads' block) and conv_state (B, W-1, conv_dim), both
    written in place. Returns (out, state, conv_state)."""
    bsz = x.shape[0]
    di = cfg.d_inner
    h, n, g = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_groups
    pdim = cfg.ssm_head_dim
    rep = h // g
    z, x_conv, dt = _ssm_inputs(p, x, cfg)
    xc, conv_new = _causal_conv(x_conv, p["conv_w"], p["conv_b"], conv_state)
    xs = xc[..., :di].reshape(bsz, h, pdim)
    Bm = xc[..., di:di + g * n].reshape(bsz, g, n).repeat_interleave(rep, 1)
    Cm = xc[..., di + g * n:].reshape(bsz, g, n).repeat_interleave(rep, 1)
    a = -torch.exp(p["a_log"])
    mesh, h0, hl = _rank_heads(cfg)
    if state.shape[1] != hl:
        raise ValueError(f"a state block of {state.shape[1]} heads; this "
                         f"rank runs {hl} of {h}")
    sl = slice(h0, h0 + hl)
    dA = torch.exp(dt[:, 0, sl] * a[sl])                   # (B,H)
    s_new = state * dA[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", Bm[:, sl].float() * dt[:, 0, sl][..., None],
        xs[:, sl].float())
    y = torch.einsum("bhn,bhnp->bhp", Cm[:, sl].float(), s_new)
    if mesh is not None:
        y = gather_along(y, mesh, "model", 1)
    y = y + xs.float() * p["d_skip"][None, :, None]
    y = y.reshape(bsz, 1, di).to(x.dtype)
    y = layers.rms_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
    state.copy_(s_new)
    conv_state.copy_(conv_new)
    return layers.linear(p["w_out"], y), state, conv_state
