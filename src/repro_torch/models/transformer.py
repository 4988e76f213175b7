"""Decoder-only LM assembly, the dense family (and its embedding-input
variant): port of ``src/repro/models/transformer.py``.

* Params keep the reference's layout: the blocks' tensors are stacked on
  a leading ``n_layers`` axis (the reference's ``vmap``-ed init and
  layer ``scan``), so a stacked leaf carries across the packages as one
  copy. The forward ``unbind``s them once and loops over the layers; its
  backward stacks the layers' gradients back in one op.
* ``cfg.remat == "full"`` wraps each block in ``torch.utils.checkpoint``
  (``use_reentrant=False``), where the reference wraps it in
  ``jax.checkpoint``: activations are kept at layer boundaries only.
* Logits never materialize (B, S, V): the loss is seq-chunked
  (``layers.cross_entropy_chunked``).
* Decode writes the KV cache in place and returns it with ``length``
  advanced; logits past ``vocab_size`` are masked to -1e30.

``scan_unroll`` and ``seq_parallel`` change nothing here. MoE, SSM,
hybrid, MLA and encoder-decoder configs raise ``NotImplementedError``
naming ROADMAP.md Queue 1 #14b (``check_family``).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.tree import tree_map

__all__ = ["init_lm", "forward_train", "loss_fn", "init_cache",
           "decode_step", "prefill", "check_family"]


def check_family(cfg: ModelConfig) -> None:
    """Refuse the families the port does not run yet."""
    if cfg.is_encoder_decoder:
        what = "encoder-decoder"
    elif cfg.family in ("moe", "ssm", "hybrid") or cfg.n_experts:
        what = "moe" if cfg.n_experts else cfg.family
    elif cfg.attn_kind != "gqa":
        what = "MLA" if cfg.attn_kind == "mla" \
            else f"attn_kind={cfg.attn_kind!r}"
    else:
        return
    raise NotImplementedError(
        f"{cfg.name}: the {what} family is not ported yet (ROADMAP.md "
        "Queue 1 #14b); the port runs the dense decoder family (GQA "
        "attention, token or embedding inputs)")


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = cfg.dtype
    return {"ln1": layers.init_norm(cfg.d_model, dt, gen.device),
            "attn": attention.init_attn(gen, cfg),
            "ln2": layers.init_norm(cfg.d_model, dt, gen.device),
            "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dt,
                                   act=cfg.act)}


def _block_train(p: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = layers.rms_norm(p["ln1"], h, cfg.norm_eps)
    h = h + attention.attn_train(p["attn"], x, cfg)
    x = layers.rms_norm(p["ln2"], h, cfg.norm_eps)
    return h + layers.mlp(p["mlp"], x, act=cfg.act)


def _layers(blocks: dict, n_layers: int) -> list[dict]:
    """The stacked block params as one dict of views a layer."""
    per = tree_map(lambda t: t.unbind(0), blocks)
    return [tree_map(lambda parts, i=i: parts[i], per)
            for i in range(n_layers)]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_lm(cfg: ModelConfig, seed: int, device: torch.device) -> dict:
    """Fresh params on ``device``, drawn from ``torch.Generator(seed)``."""
    check_family(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params: dict = {}
    # embedding-input configs still embed text tokens at decode time, so
    # the table always exists
    params["embed"] = layers.init_embed(gen, cfg.padded_vocab, cfg.d_model,
                                        cfg.dtype)
    blocks = [_init_block(gen, cfg) for _ in range(cfg.n_layers)]
    params["blocks"] = tree_map(lambda *ts: torch.stack(ts), *blocks)
    del blocks
    params["final_norm"] = layers.init_norm(cfg.d_model, cfg.dtype, device)
    if not cfg.tie_embeddings or cfg.input_is_embeddings:
        params["head"] = layers.init_linear(gen, cfg.d_model,
                                            cfg.padded_vocab, cfg.dtype)
    return params


def head_w(params: dict, cfg: ModelConfig) -> torch.Tensor:
    if "head" in params:
        return params["head"]["w"]
    return params["embed"]["table"].T


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward_train(params: dict, inputs: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Token ids (B, S) — or embeddings (B, S, d) for stub frontends —
    → final hidden states (B, S, d)."""
    check_family(cfg)
    if cfg.input_is_embeddings:
        h = inputs.to(cfg.dtype)
    else:
        h = layers.embed(params["embed"], inputs)
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    for p in _layers(params["blocks"], cfg.n_layers):
        if remat:
            h = checkpoint(_block_train, p, h, cfg, use_reentrant=False)
        else:
            h = _block_train(p, h, cfg)
    return layers.rms_norm(params["final_norm"], h, cfg.norm_eps)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Next-token CE. batch: {"inputs", "labels", "mask"}."""
    h = forward_train(params, batch["inputs"], cfg)
    return layers.cross_entropy_chunked(
        h, head_w(params, cfg), batch["labels"], batch["mask"],
        chunk=min(256, h.shape[1]), unroll=cfg.scan_unroll)


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> dict:
    check_family(cfg)
    return attention.init_attn_cache(cfg, batch, max_len, device)


def _vocab_masked(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    keep = torch.arange(cfg.padded_vocab, device=logits.device) \
        < cfg.vocab_size
    return torch.where(keep, logits, -1e30)


@torch.no_grad()
def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One new token for every sequence. tokens: (B, 1) int (or (B, 1, d)
    embeddings for stub frontends). Writes the cache in place; returns
    (logits (B, V) float32, the cache with ``length`` advanced)."""
    check_family(cfg)
    if cfg.input_is_embeddings and tokens.ndim == 3:
        h = tokens.to(cfg.dtype)
    else:
        h = layers.embed(params["embed"], tokens)
    length = cache["length"]
    for i, p in enumerate(_layers(params["blocks"], cfg.n_layers)):
        x = layers.rms_norm(p["ln1"], h, cfg.norm_eps)
        out, _, _ = attention.attn_decode(p["attn"], x, cache["k"][i],
                                          cache["v"][i], length, cfg)
        h = h + out
        x = layers.rms_norm(p["ln2"], h, cfg.norm_eps)
        h = h + layers.mlp(p["mlp"], x, act=cfg.act)
    h = layers.rms_norm(params["final_norm"], h, cfg.norm_eps)
    logits = (h[:, 0] @ head_w(params, cfg)).float()
    return _vocab_masked(logits, cfg), {"k": cache["k"], "v": cache["v"],
                                        "length": length + 1}


@torch.no_grad()
def prefill(params: dict, tokens: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Inference prefill: full forward, returns last-position logits."""
    h = forward_train(params, tokens, cfg)
    return _vocab_masked((h[:, -1] @ head_w(params, cfg)).float(), cfg)
