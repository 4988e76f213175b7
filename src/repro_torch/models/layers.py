"""Shared building blocks: norms, RoPE, MLPs, embeddings, the chunked loss.

Port of ``src/repro/models/layers.py``. Params are plain dicts of tensors
with the reference's paths and weight layout: a linear's ``w`` is
``(d_in, d_out)`` and applies as ``x @ w``, so carrying weights across
the packages is a copy (``models/convert.py``). Init draws from an
explicit ``torch.Generator`` on the target device (the same schemes as
the reference: truncated normal scaled by ``d_in ** -0.5``, embeddings
normal × 0.02, zero biases, unit norm scales). Matmuls run in the param
dtype; norms, rope and the loss in float32, cast back as in the
reference. On the meta device (``generator(device, seed)`` gives a
stand-in there) init allocates nothing and draws nothing: the leaves'
shapes and dtypes only.

Under ``runtime.sharding.use_rules`` a layer whose weight is this rank's
tensor-parallel shard (its local width below the full one the caller
names) runs Megatron-style: ``mlp`` column-parallel then row-parallel
with one all-reduce over ``model``; ``embed`` vocab-parallel (the rows
outside this rank's block masked, then summed over ``model``); and
``cross_entropy_chunked`` over a vocab-sharded head, its logsumexp and
gold logit combined over ``model``. The loss's token count is summed
over the axes the batch rows are split over, so each rank's loss is its
share of the global mean.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.runtime.sharding import (copy_to, current_rules,
                                          gather_along, reduce_from)

__all__ = ["rms_norm", "layer_norm", "rope", "init_linear", "linear",
           "init_norm", "init_mlp", "mlp", "init_embed", "embed",
           "cross_entropy_chunked", "generator", "trunc_normal_",
           "normal_", "model_mesh"]


# -- init draws ----------------------------------------------------------------

class _ShapeOnly:
    """The generator of a meta-device init: it has a device, and the
    draws below skip meta tensors."""
    device = torch.device("meta")


def generator(device, seed: int):
    """``torch.Generator(device).manual_seed(seed)``; a stand-in on the
    meta device, where init only shapes the leaves."""
    if torch.device(device).type == "meta":
        return _ShapeOnly()
    return torch.Generator(device=device).manual_seed(seed)


def trunc_normal_(w: torch.Tensor, gen) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], in place (nothing on meta)."""
    if not w.is_meta:
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w


def normal_(w: torch.Tensor, gen) -> torch.Tensor:
    """Standard normal, in place (nothing on meta)."""
    if not w.is_meta:
        w.normal_(generator=gen)
    return w


def model_mesh(local: int, full: int | None):
    """The mesh when a width of ``local`` against the layer's ``full``
    means this rank holds a ``model``-axis shard under the current
    rules; else None (no rules, or a replicated weight)."""
    rules = current_rules()
    if rules is None or full is None or local == full:
        return None
    if local * rules.model_size() != full:
        raise ValueError(f"a local width of {local} is neither the full "
                         f"{full} nor its {rules.model_size()}-way shard")
    return rules.mesh


# -- norms -------------------------------------------------------------------

def init_norm(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    h = x.float()
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * p["scale"].float()).to(x.dtype)


def layer_norm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    h = x.float()
    mu = torch.mean(h, dim=-1, keepdim=True)
    var = torch.mean((h - mu) ** 2, dim=-1, keepdim=True)
    h = (h - mu) * torch.rsqrt(var + eps)
    out = h * p["scale"].float()
    if "bias" in p:
        out = out + p["bias"].float()
    return out.to(x.dtype)


# -- linear ------------------------------------------------------------------

def init_linear(gen: torch.Generator, d_in: int, d_out: int, dtype,
                bias: bool = False) -> dict:
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=gen.device)
    p = {"w": (trunc_normal_(w, gen) * d_in ** -0.5).to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# -- rotary ------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Apply rotary embedding. x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].float() * freqs             # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]                     # (..., S, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- mlp ---------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, d_ff: int, dtype,
             act: str = "silu") -> dict:
    if act == "silu":                                  # SwiGLU (llama family)
        return {"w_gate": init_linear(gen, d, d_ff, dtype)["w"],
                "w_up": init_linear(gen, d, d_ff, dtype)["w"],
                "w_down": init_linear(gen, d_ff, d, dtype)["w"]}
    return {"w_up": init_linear(gen, d, d_ff, dtype, bias=True),
            "w_down": init_linear(gen, d_ff, d, dtype, bias=True)}


def mlp(p: dict, x: torch.Tensor, act: str = "silu",
        d_ff: int | None = None) -> torch.Tensor:
    """The MLP; ``d_ff`` is the full hidden width, so that a rank holding
    a shard of it runs column- then row-parallel."""
    down = p["w_down"] if act == "silu" else p["w_down"]["w"]
    mesh = model_mesh(down.shape[0], d_ff)
    if mesh is not None:
        x = copy_to(x, mesh)
    if act == "silu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
        out = h @ p["w_down"]
        return out if mesh is None else reduce_from(out, mesh)
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(linear(p["w_up"], x), approximate="tanh")
    if mesh is None:
        return linear(p["w_down"], h)
    out = reduce_from(h @ p["w_down"]["w"], mesh)
    return out + p["w_down"]["b"] if "b" in p["w_down"] else out


# -- embedding / head ----------------------------------------------------------

def init_embed(gen: torch.Generator, vocab: int, d: int, dtype) -> dict:
    table = torch.empty((vocab, d), dtype=torch.float32, device=gen.device)
    return {"table": (normal_(table, gen) * 0.02).to(dtype)}


def embed(p: dict, tokens: torch.Tensor,
          vocab: int | None = None) -> torch.Tensor:
    """Rows of the table; ``vocab`` is the full (padded) vocab, so that a
    rank holding a block of rows looks up its own and sums over
    ``model``."""
    table = p["table"]
    mesh = model_mesh(table.shape[0], vocab)
    if mesh is None:
        return F.embedding(tokens.long(), table)
    n = table.shape[0]
    rel = tokens.long() - mesh.axis_index("model") * n
    mine = (rel >= 0) & (rel < n)
    h = F.embedding(torch.where(mine, rel, 0), table)
    return reduce_from(h * mine[..., None].to(h.dtype), mesh)


# -- loss ----------------------------------------------------------------------

def _chunk_nll(h: torch.Tensor, head_w: torch.Tensor, y: torch.Tensor,
               m: torch.Tensor) -> torch.Tensor:
    logits = (h @ head_w).float()                          # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.long()[..., None])[..., 0]
    return torch.sum((lse - gold) * m.float())


def _chunk_nll_vocab_parallel(h: torch.Tensor, head_w: torch.Tensor,
                              y: torch.Tensor, m: torch.Tensor,
                              mesh) -> torch.Tensor:
    """``_chunk_nll`` on this rank's block of the vocab: the blocks'
    logsumexps gathered and combined, the gold logit summed, over
    ``model``. The result is the same on every rank of the axis."""
    logits = (copy_to(h, mesh) @ head_w).float()           # (B, c, V/P)
    n = logits.shape[-1]
    lse = torch.logsumexp(gather_along(
        torch.logsumexp(logits, dim=-1)[..., None], mesh, "model", -1),
        dim=-1)
    rel = y.long() - mesh.axis_index("model") * n
    mine = (rel >= 0) & (rel < n)
    gold = torch.gather(logits, -1, torch.where(mine, rel, 0)[..., None])
    gold = reduce_from(gold[..., 0] * mine, mesh)
    return torch.sum((lse - gold) * m.float())


def cross_entropy_chunked(hidden: torch.Tensor, head_w: torch.Tensor,
                          labels: torch.Tensor, mask: torch.Tensor,
                          chunk: int = 256, unroll: bool = False,
                          vocab: int | None = None) -> torch.Tensor:
    """Mean CE without materializing full (B,S,V) logits.

    Walks seq chunks in order; per chunk the logits are (B, chunk, V) in
    float32. Under autograd each chunk is checkpointed, so the backward
    recomputes one chunk's logits at a time instead of holding them all.
    ``unroll`` is the reference's scan knob and changes nothing here.
    ``vocab`` is the head's full (padded) width: a narrower ``head_w`` is
    this rank's vocab block (the logsumexp runs over the padded vocab,
    as the reference's training loss does). Under rules the token count
    is summed over the batch's axes (outside autograd).
    """
    rules = current_rules()
    mesh = model_mesh(head_w.shape[1], vocab)
    b, s, _ = hidden.shape
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        args = (hidden[:, sl], head_w, labels[:, sl], mask[:, sl])
        fn = _chunk_nll
        if mesh is not None:
            fn, args = _chunk_nll_vocab_parallel, args + (mesh,)
        if torch.is_grad_enabled():
            nll = checkpoint(fn, *args, use_reentrant=False)
        else:
            nll = fn(*args)
        tot = tot + nll
        cnt = cnt + torch.sum(mask[:, sl])
    if rules is not None:
        cnt = rules.mesh.reduce(cnt, rules.batch)
    return tot / torch.clamp(cnt, min=1.0)
