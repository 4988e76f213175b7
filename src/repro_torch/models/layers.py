"""Shared building blocks: norms, RoPE, MLPs, embeddings, the chunked loss.

Port of ``src/repro/models/layers.py``. Params are plain dicts of tensors
with the reference's paths and weight layout: a linear's ``w`` is
``(d_in, d_out)`` and applies as ``x @ w``, so carrying weights across
the packages is a copy (``models/convert.py``). Init draws from an
explicit ``torch.Generator`` on the target device (the same schemes as
the reference: truncated normal scaled by ``d_in ** -0.5``, embeddings
normal × 0.02, zero biases, unit norm scales). Matmuls run in the param
dtype; norms, rope and the loss in float32, cast back as in the
reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["rms_norm", "layer_norm", "rope", "init_linear", "linear",
           "init_norm", "init_mlp", "mlp", "init_embed", "embed",
           "cross_entropy_chunked"]


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
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    p = {"w": (w * d_in ** -0.5).to(dtype)}
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


def mlp(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    if act == "silu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
        return h @ p["w_down"]
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(linear(p["w_up"], x), approximate="tanh")
    return linear(p["w_down"], h)


# -- embedding / head ----------------------------------------------------------

def init_embed(gen: torch.Generator, vocab: int, d: int, dtype) -> dict:
    table = torch.empty((vocab, d), dtype=torch.float32, device=gen.device)
    table.normal_(generator=gen)
    return {"table": (table * 0.02).to(dtype)}


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), p["table"])


# -- loss ----------------------------------------------------------------------

def _chunk_nll(h: torch.Tensor, head_w: torch.Tensor, y: torch.Tensor,
               m: torch.Tensor) -> torch.Tensor:
    logits = (h @ head_w).float()                          # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.long()[..., None])[..., 0]
    return torch.sum((lse - gold) * m.float())


def cross_entropy_chunked(hidden: torch.Tensor, head_w: torch.Tensor,
                          labels: torch.Tensor, mask: torch.Tensor,
                          chunk: int = 256, unroll: bool = False
                          ) -> torch.Tensor:
    """Mean CE without materializing full (B,S,V) logits.

    Walks seq chunks in order; per chunk the logits are (B, chunk, V) in
    float32. Under autograd each chunk is checkpointed, so the backward
    recomputes one chunk's logits at a time instead of holding them all.
    ``unroll`` is the reference's scan knob and changes nothing here.
    """
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
        if torch.is_grad_enabled():
            nll = checkpoint(_chunk_nll, *args, use_reentrant=False)
        else:
            nll = _chunk_nll(*args)
        tot = tot + nll
        cnt = cnt + torch.sum(mask[:, sl])
    return tot / torch.clamp(cnt, min=1.0)
