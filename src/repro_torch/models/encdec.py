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

On a process mesh (``runtime.sharding.use_rules``) the encoder, the
decoder's self-attention and the cross-attention run tensor-parallel
(``xattn/*``'s rules: ``wq``/``wk``/``wv`` columns, ``wo`` rows) in
the layout ``attention.layout`` picks: over heads where they divide the
axis, else sequence-parallel over the query's positions (whisper's 8
heads on 16), K and V whole; the GELU MLPs column- then row-parallel, each row-parallel bias
added once after the sum; the head is vocab-parallel. The cross cache's
sequence lies over ``model`` (``partition.cache_specs``; an encoder
length that does not divide it keeps it whole): ``fill_cross_cache``
writes each rank's block, and decode reads it with the distributed
flash-decode of ``attention.cached_attention``. Params stored in blocks
beyond that layout (fsdp, serving) are gathered on use, as in
``transformer.py``.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.tree import (stack_layers, tree_from_items,
                                     tree_items, unbind_layers)
from repro_torch.runtime.sharding import current_rules, use_rules

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


def init_encdec(cfg: ModelConfig, seed: int, device: torch.device,
                keep=None) -> dict:
    """Fresh params on ``device``, drawn from ``torch.Generator(seed)``.
    ``keep(path, tensor)`` cuts each leaf as it is drawn (a rank's shard,
    the same draws as the full init)."""
    gen = layers.generator(device, seed)
    cut = (lambda _path, t: t) if keep is None else keep

    def part(prefix, tree):
        return tree_from_items((f"{prefix}/{p}", cut(f"{prefix}/{p}", t))
                               for p, t in tree_items(tree))[prefix]

    def stack(prefix, make, n):
        return stack_layers(make, n, keep=None if keep is None else
                            (lambda p, t: keep(f"{prefix}/{p}", t)))

    return {
        "embed": part("embed", layers.init_embed(
            gen, cfg.padded_vocab, cfg.d_model, cfg.dtype)),
        "enc_blocks": stack("enc_blocks", lambda: _init_enc_block(gen, cfg),
                            cfg.n_enc_layers),
        "dec_blocks": stack("dec_blocks", lambda: _init_dec_block(gen, cfg),
                            cfg.n_layers),
        "enc_norm": part("enc_norm", layers.init_norm(cfg.d_model, cfg.dtype,
                                                      device)),
        "final_norm": part("final_norm", layers.init_norm(
            cfg.d_model, cfg.dtype, device)),
        "head": part("head", layers.init_linear(gen, cfg.d_model,
                                                cfg.padded_vocab, cfg.dtype)),
    }


def _cross_attn(p, x, enc_h, cfg):
    """Query from decoder x; K/V from encoder hidden, no rope. On a mesh
    the layout of ``attention.layout`` over the decoder's positions."""
    return attention.gqa(p, x, enc_h, cfg, False, None)


def _run(block, prefix, p, h, *rest):
    rules = current_rules()
    if torch.is_grad_enabled():
        return checkpoint(_under_rules, rules, block, prefix, p, h, *rest,
                          use_reentrant=False)
    return _under_rules(rules, block, prefix, p, h, *rest)


def _under_rules(rules, block, prefix, p, h, *rest):
    # the recompute may run on autograd's device thread: the rules come
    # along, and the block's params are gathered again
    with use_rules(rules):
        return block(layers.gather_params(p, prefix, "layer"), h, *rest)


def _enc_block(p, hh, cfg):
    x = layers.layer_norm(p["ln1"], hh, cfg.norm_eps)
    hh = hh + attention.attn_train(p["attn"], x, cfg, causal=False)
    x = layers.layer_norm(p["ln2"], hh, cfg.norm_eps)
    return hh + layers.mlp(p["mlp"], x, act="gelu", d_ff=cfg.d_ff)


def _dec_block(p, hh, enc_h, cfg):
    x = layers.layer_norm(p["ln1"], hh, cfg.norm_eps)
    hh = hh + attention.attn_train(p["attn"], x, cfg, causal=True)
    x = layers.layer_norm(p["ln_x"], hh, cfg.norm_eps)
    hh = hh + _cross_attn(p["xattn"], x, enc_h, cfg)
    x = layers.layer_norm(p["ln2"], hh, cfg.norm_eps)
    return hh + layers.mlp(p["mlp"], x, act="gelu", d_ff=cfg.d_ff)


def _stack(params, name, n):
    return unbind_layers(layers.gather_params(params[name], name, "stack"),
                         n)


def encode(params: dict, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, S_enc, d) precomputed embeddings (stub frontend)."""
    h = frames.to(cfg.dtype)
    for p in _stack(params, "enc_blocks", cfg.n_enc_layers):
        h = _run(_enc_block, "enc_blocks", p, h, cfg)
    return layers.layer_norm(layers.gather_params(params["enc_norm"],
                                                  "enc_norm"),
                             h, cfg.norm_eps)


def _embed(params, tokens, cfg):
    return layers.embed(layers.gather_params(params["embed"], "embed"),
                        tokens, vocab=cfg.padded_vocab)


def _head(params):
    return layers.gather_params(params["head"], "head")["w"]


def decode_hidden(params: dict, tokens: torch.Tensor, enc_h: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """The train path's decoder: final hidden states (B, S_dec, d)."""
    h = _embed(params, tokens, cfg)
    for p in _stack(params, "dec_blocks", cfg.n_layers):
        h = _run(_dec_block, "dec_blocks", p, h, enc_h, cfg)
    return _final_norm(params, h, cfg)


def _final_norm(params, h, cfg):
    return layers.layer_norm(layers.gather_params(params["final_norm"],
                                                  "final_norm"),
                             h, cfg.norm_eps)


def encdec_loss(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """batch: {"frames" (B,S_enc,d), "tokens" (B,S_dec), "labels", "mask"}."""
    enc_h = encode(params, batch["frames"], cfg)
    h = decode_hidden(params, batch["tokens"], enc_h, cfg)
    return layers.cross_entropy_chunked(
        h, _head(params), batch["labels"], batch["mask"],
        chunk=min(256, h.shape[1]), unroll=cfg.scan_unroll,
        vocab=cfg.padded_vocab)


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
    place (on a mesh: this rank's rows of the frames, and its blocks of
    the cache). Returns the encoder output (what ``prefill`` returns)."""
    enc_h = encode(params, frames, cfg)
    spec = attention.layer_spec("x_k")
    _, s_off, s_full, heads, h_off = attention.cache_block(
        spec, cache["x_k"].shape[1:])
    want = (cache["x_k"].shape[1], s_full)
    if tuple(enc_h.shape[:2]) != want:
        raise ValueError(f"frames give {tuple(enc_h.shape[:2])} (batch, "
                         f"enc_len); the cache holds {want}")
    s_loc, h_loc = cache["x_k"].shape[2:4]
    b = enc_h.shape[0]
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    for i, p in enumerate(_stack(params, "dec_blocks", cfg.n_layers)):
        p = layers.gather_params(p, "dec_blocks", "layer")["xattn"]
        k, v = (attention.whole_cols(p[n], enc_h, hkv * hd).reshape(
            b, -1, hkv, hd) for n in ("wk", "wv"))         # every head
        for name, t in (("x_k", k), ("x_v", v)):
            cache[name][i].copy_(t[:, s_off:s_off + s_loc,
                                   h_off:h_off + h_loc])
    return enc_h


@torch.no_grad()
def encdec_decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                       cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One decoder token against the cached self K/V (written in place)
    and the cached cross K/V. Returns (logits (B, V) float32, the cache
    with ``length`` advanced); on a mesh this rank's rows and its block
    of the vocab."""
    h = _embed(params, tokens, cfg)
    length = cache["length"]
    hh, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    g = hh // hkv
    b = h.shape[0]
    for i, p in enumerate(_stack(params, "dec_blocks", cfg.n_layers)):
        p = layers.gather_params(p, "dec_blocks", "layer")
        x = layers.layer_norm(p["ln1"], h, cfg.norm_eps)
        out, _, _ = attention.attn_decode(p["attn"], x, cache["k"][i],
                                          cache["v"][i], length, cfg,
                                          attention.layer_spec("k"))
        h = h + out
        x = layers.layer_norm(p["ln_x"], h, cfg.norm_eps)
        q = attention.whole_cols(p["xattn"]["wq"], x, hh * hd)
        out = attention.cached_attention(
            q.reshape(b, hkv, g, hd).float(), cache["x_k"][i],
            cache["x_v"][i], None, attention.layer_spec("x_k"))          # (B,hkv,g,D)
        h = h + attention.row_parallel_out(
            p["xattn"]["wo"], out.reshape(b, 1, hh * hd).to(x.dtype))
        x = layers.layer_norm(p["ln2"], h, cfg.norm_eps)
        h = h + layers.mlp(p["mlp"], x, act="gelu", d_ff=cfg.d_ff)
    h = _final_norm(params, h, cfg)
    logits = (h[:, 0] @ _head(params)).float()
    new_cache = dict(cache)
    new_cache["length"] = length + 1
    return layers.vocab_masked(logits, cfg), new_cache
