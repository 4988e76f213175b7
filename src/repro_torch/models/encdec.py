"""Encoder-decoder (whisper-base backbone; the conv/audio frontend is a
stub): port of ``src/repro/models/encdec.py``.

Inputs arrive as precomputed frame embeddings (B, S_enc, d). The encoder
is a pre-LN bidirectional transformer; the decoder has causal
self-attention, cross-attention over the encoder's output, GELU MLPs
and LayerNorm. Each block runs under ``torch.utils.checkpoint`` while
gradients are on, as the reference wraps every block in
``jax.checkpoint`` whatever ``cfg.remat`` says.

Decode keeps each decoder layer's self-attention K/V cache plus the
cross-attention K/V of the encoder output (``x_k``, ``x_v``).
``fill_cross_cache`` writes those from the frames: it runs ``encode``
and each decoder layer's ``wk`` and ``wv``. The reference has no such
step: its cache starts as zeros and nothing writes ``x_k``/``x_v``
(ROADMAP.md Queue 3), so its decode attends to zero rows and never sees
the encoder. With the reference's zero cache, the port's decode gives
the reference's logits; with the cache filled, it reproduces the train
path position by position.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.tree import stack_layers, unbind_layers

__all__ = ["init_encdec", "encdec_loss", "encode", "init_encdec_cache",
           "fill_cross_cache", "encdec_decode_step"]


def _init_enc_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt, dev = cfg.dtype, gen.device
    return {"ln1": layers.init_norm(cfg.d_model, dt, dev),
            "attn": attention.init_attn(gen, cfg),
            "ln2": layers.init_norm(cfg.d_model, dt, dev),
            "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dt,
                                   act="gelu")}


def _init_dec_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt, dev = cfg.dtype, gen.device
    return {"ln1": layers.init_norm(cfg.d_model, dt, dev),
            "attn": attention.init_attn(gen, cfg),
            "ln_x": layers.init_norm(cfg.d_model, dt, dev),
            # the same shapes as self-attention; K/V from the encoder
            "xattn": attention.init_attn(gen, cfg),
            "ln2": layers.init_norm(cfg.d_model, dt, dev),
            "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dt,
                                   act="gelu")}


def init_encdec(cfg: ModelConfig, seed: int, device: torch.device) -> dict:
    """Fresh params on ``device``, drawn from ``torch.Generator(seed)``."""
    gen = layers.generator(device, seed)
    return {
        "embed": layers.init_embed(gen, cfg.padded_vocab, cfg.d_model,
                                   cfg.dtype),
        "enc_blocks": stack_layers(lambda: _init_enc_block(gen, cfg),
                                   cfg.n_enc_layers),
        "dec_blocks": stack_layers(lambda: _init_dec_block(gen, cfg),
                                   cfg.n_layers),
        "enc_norm": layers.init_norm(cfg.d_model, cfg.dtype, device),
        "final_norm": layers.init_norm(cfg.d_model, cfg.dtype, device),
        "head": layers.init_linear(gen, cfg.d_model, cfg.padded_vocab,
                                   cfg.dtype),
    }


def _cross_kv(p, enc_h, cfg):
    b = enc_h.shape[0]
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    k = layers.linear(p["wk"], enc_h).reshape(b, -1, hkv, hd)
    v = layers.linear(p["wv"], enc_h).reshape(b, -1, hkv, hd)
    return k, v


def _cross_attn(p, x, enc_h, cfg):
    """Query from decoder x; K/V from encoder hidden."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = layers.linear(p["wq"], x).reshape(b, s, hkv, h // hkv, hd)
    k, v = _cross_kv(p, enc_h, cfg)
    out = attention.flash_attention(q, k, v, causal=False,
                                    unroll=cfg.scan_unroll)
    return layers.linear(p["wo"], out.reshape(b, s, h * hd))


def _run(block, p, h, *rest):
    if torch.is_grad_enabled():
        return checkpoint(block, p, h, *rest, use_reentrant=False)
    return block(p, h, *rest)


def _enc_block(p, hh, cfg):
    x = layers.layer_norm(p["ln1"], hh, cfg.norm_eps)
    hh = hh + attention.attn_train(p["attn"], x, cfg, causal=False)
    x = layers.layer_norm(p["ln2"], hh, cfg.norm_eps)
    return hh + layers.mlp(p["mlp"], x, act="gelu")


def _dec_block(p, hh, enc_h, cfg):
    x = layers.layer_norm(p["ln1"], hh, cfg.norm_eps)
    hh = hh + attention.attn_train(p["attn"], x, cfg, causal=True)
    x = layers.layer_norm(p["ln_x"], hh, cfg.norm_eps)
    hh = hh + _cross_attn(p["xattn"], x, enc_h, cfg)
    x = layers.layer_norm(p["ln2"], hh, cfg.norm_eps)
    return hh + layers.mlp(p["mlp"], x, act="gelu")


def encode(params: dict, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, S_enc, d) precomputed embeddings (stub frontend)."""
    h = frames.to(cfg.dtype)
    for p in unbind_layers(params["enc_blocks"], cfg.n_enc_layers):
        h = _run(_enc_block, p, h, cfg)
    return layers.layer_norm(params["enc_norm"], h, cfg.norm_eps)


def decode_hidden(params: dict, tokens: torch.Tensor, enc_h: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """The train path's decoder: final hidden states (B, S_dec, d)."""
    h = layers.embed(params["embed"], tokens)
    for p in unbind_layers(params["dec_blocks"], cfg.n_layers):
        h = _run(_dec_block, p, h, enc_h, cfg)
    return layers.layer_norm(params["final_norm"], h, cfg.norm_eps)


def encdec_loss(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """batch: {"frames" (B,S_enc,d), "tokens" (B,S_dec), "labels", "mask"}."""
    enc_h = encode(params, batch["frames"], cfg)
    h = decode_hidden(params, batch["tokens"], enc_h, cfg)
    return layers.cross_entropy_chunked(
        h, params["head"]["w"], batch["labels"], batch["mask"],
        chunk=min(256, h.shape[1]), unroll=cfg.scan_unroll)


# -- serving -------------------------------------------------------------------

def init_encdec_cache(cfg: ModelConfig, batch: int, max_len: int,
                      enc_len: int, device) -> dict:
    """Self-attention KV (L, B, max_len, Hkv, D) and the cross K/V (L, B,
    enc_len, Hkv, D), zeros, in the param dtype; ``length`` int32."""
    c = attention.init_attn_cache(cfg, batch, max_len, device)
    shape = (cfg.n_layers, batch, enc_len, cfg.n_kv_heads, cfg.head_dim_)
    c["x_k"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
    c["x_v"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
    return c


@torch.no_grad()
def fill_cross_cache(params: dict, cache: dict, frames: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """Encode ``frames`` (B, enc_len, d) and write every decoder layer's
    cross K/V of the encoder output into ``cache["x_k"]``/``["x_v"]`` in
    place. Returns the encoder output (what ``prefill`` returns)."""
    enc_h = encode(params, frames, cfg)
    want = tuple(cache["x_k"].shape[1:3])
    if tuple(enc_h.shape[:2]) != want:
        raise ValueError(f"frames give {tuple(enc_h.shape[:2])} (batch, "
                         f"enc_len); the cache holds {want}")
    for i, p in enumerate(unbind_layers(params["dec_blocks"], cfg.n_layers)):
        k, v = _cross_kv(p["xattn"], enc_h, cfg)
        cache["x_k"][i].copy_(k)
        cache["x_v"][i].copy_(v)
    return enc_h


@torch.no_grad()
def encdec_decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                       cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One decoder token against the cached self K/V (written in place)
    and the cached cross K/V. Returns (logits (B, V) float32, the cache
    with ``length`` advanced)."""
    h = layers.embed(params["embed"], tokens)
    length = cache["length"]
    hh, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    g = hh // hkv
    b = h.shape[0]
    for i, p in enumerate(unbind_layers(params["dec_blocks"], cfg.n_layers)):
        x = layers.layer_norm(p["ln1"], h, cfg.norm_eps)
        out, _, _ = attention.attn_decode(p["attn"], x, cache["k"][i],
                                          cache["v"][i], length, cfg)
        h = h + out
        x = layers.layer_norm(p["ln_x"], h, cfg.norm_eps)
        q = layers.linear(p["xattn"]["wq"], x).reshape(b, hkv, g, hd)
        s = (q.float() @ cache["x_k"][i].float().permute(0, 2, 3, 1)) \
            * (hd ** -0.5)                                 # (B,hkv,g,S_enc)
        probs = torch.softmax(s, dim=-1)
        out = probs @ cache["x_v"][i].float().permute(0, 2, 1, 3)
        h = h + layers.linear(p["xattn"]["wo"],
                              out.reshape(b, 1, hh * hd).to(x.dtype))
        x = layers.layer_norm(p["ln2"], h, cfg.norm_eps)
        h = h + layers.mlp(p["mlp"], x, act="gelu")
    h = layers.layer_norm(params["final_norm"], h, cfg.norm_eps)
    logits = (h[:, 0] @ params["head"]["w"]).float()
    keep = torch.arange(cfg.padded_vocab, device=logits.device) \
        < cfg.vocab_size
    new_cache = dict(cache)
    new_cache["length"] = length + 1
    return torch.where(keep, logits, -1e30), new_cache
