"""Decoder-only LM assembly: dense, MoE, SSM and hybrid families, GQA or
MLA attention. Port of ``src/repro/models/transformer.py``.

* Params keep the reference's layout: the blocks' tensors are stacked on
  a leading ``n_layers`` axis (the reference's ``vmap``-ed init and
  layer ``scan``), so a stacked leaf carries across the packages as one
  copy. Init builds the stack one layer at a time
  (``tree.stack_layers``). The forward ``unbind``s the stack once and
  loops over the layers; its backward stacks the layers' gradients back.
* ``cfg.remat == "full"`` wraps each block in ``torch.utils.checkpoint``
  (``use_reentrant=False``), where the reference wraps it in
  ``jax.checkpoint``: activations are kept at layer boundaries only.
* A block is attention (GQA, or MLA when ``attn_kind == "mla"``) then an
  MLP or the MoE FFN (``n_experts``); or, for the ssm and hybrid
  families, one Mamba2 mixer.
* hybrid (zamba2) runs groups of ``attn_every`` ssm layers with ONE
  shared attention block (attention + MLP, its params reused) after each
  group, then the remainder layers; each use of the shared block is a
  checkpoint of its own, and autograd sums its gradient over the uses.
* Logits never materialize (B, S, V): the loss is seq-chunked
  (``layers.cross_entropy_chunked``).
* Decode writes every cache in place (KV, the compressed MLA cache, the
  SSM state and conv rows; hybrid: one KV slot a group for the shared
  block) and returns the cache with ``length`` advanced; logits past
  ``vocab_size`` are masked to -1e30.

``scan_unroll`` and ``seq_parallel`` change nothing here. The
encoder-decoder family is ``encdec.py``.

On a process mesh (``runtime.sharding.use_rules``) the dense, vlm and
MoE families with GQA attention train tensor-parallel: the residual
stream stays replicated over ``model`` (the reference's default
``seq_parallel=False``), each layer holds its shards of the rules'
layout (``train/partition.py``; ``init_lm(keep=)`` cuts them a layer at
a time from the one-device draws) and sums what it must over ``model``
(``layers.py``, ``attention.py``, ``moe.py``). A tied head is the
vocab-sharded embedding table. ``check_sharded`` refuses what waits for
ROADMAP.md Queue 1 #14c-2.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, layers, moe, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.tree import (stack_layers, tree_from_items,
                                     tree_items, unbind_layers)
from repro_torch.runtime.sharding import current_rules, use_rules

__all__ = ["init_lm", "forward_train", "loss_fn", "init_cache",
           "decode_step", "prefill", "check_family", "check_sharded"]

_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
_ATTN_KINDS = ("gqa", "mla", "none")


def check_family(cfg: ModelConfig, mesh=None) -> None:
    """Refuse a family or attention kind the reference does not have; on
    a mesh of more than one rank, also those whose sharded path waits
    for ROADMAP.md Queue 1 #14c-2 (ssm, hybrid, the encoder-decoder, MLA)."""
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family={cfg.family!r} is not one of the "
            f"reference's {_FAMILIES}")
    if cfg.attn_kind not in _ATTN_KINDS:
        raise NotImplementedError(
            f"{cfg.name}: attn_kind={cfg.attn_kind!r} is not one of the "
            f"reference's {_ATTN_KINDS}")
    if mesh is None or all(e == 1 for e in mesh.shape.values()):
        return
    what = None
    if cfg.is_encoder_decoder:
        what = "the encoder-decoder family"
    elif _is_ssm(cfg):
        what = f"the {cfg.family} family"
    elif cfg.attn_kind != "gqa":
        what = f"attn_kind={cfg.attn_kind!r}"
    if what:
        raise NotImplementedError(
            f"{cfg.name}: {what} on a mesh of {dict(mesh.shape)}: the port "
            "shards the dense and MoE families with GQA attention; the "
            "rest arrives with ROADMAP.md Queue 1 #14c-2")


def check_sharded(cfg: ModelConfig, mesh, policy: str) -> None:
    """``check_family`` on ``mesh``, then what the sharded train step
    refuses until ROADMAP.md Queue 1 #14c-2: the fsdp policy's
    gather-on-use, attention heads that do not divide the model axis
    (the reference's sequence-parallel fallback splits a head), the dp
    policy's MoE on a model axis over 1, and expert stacks that do not
    divide it."""
    check_family(cfg, mesh)
    pm = mesh.shape.get("model", 1)
    later = "waits for ROADMAP.md Queue 1 #14c-2"
    if policy not in ("tp", "dp", "ep", "fsdp"):
        raise ValueError(f"policy {policy!r}: one of tp, dp, ep, fsdp")
    if policy == "fsdp":
        raise NotImplementedError(
            f"policy 'fsdp' (params gathered on use) {later}")
    if pm == 1:
        return
    hd = cfg.head_dim_
    if policy == "tp" and ((cfg.n_heads * hd) % pm == 0
                           or (cfg.n_kv_heads * hd) % pm == 0) and (
            cfg.n_heads % pm or cfg.n_kv_heads % pm):
        raise NotImplementedError(
            f"{cfg.name}: {cfg.n_heads} query and {cfg.n_kv_heads} KV heads "
            f"on a model axis of {pm}: the reference's layout splits a head "
            f"there, and its sequence-parallel attention {later}")
    if cfg.n_experts and cfg.padded_experts % pm:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.padded_experts} expert stacks on a model "
            f"axis of {pm} {later}")
    if cfg.n_experts and policy == "dp":
        raise NotImplementedError(
            f"{cfg.name}: the dp policy's MoE on a model axis of {pm} (the "
            f"reference reshards the rows to the all-to-all route) {later}")


def _is_ssm(cfg: ModelConfig) -> bool:
    return cfg.family in ("ssm", "hybrid")


def _is_hybrid(cfg: ModelConfig) -> bool:
    return cfg.family == "hybrid" and bool(cfg.attn_every)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = cfg.dtype
    p = {"ln1": layers.init_norm(cfg.d_model, dt, gen.device)}
    if _is_ssm(cfg):
        p["ssm"] = ssm.init_ssm(gen, cfg)
        return p
    if cfg.attn_kind == "mla":
        p["attn"] = attention.init_mla(gen, cfg)
    else:
        p["attn"] = attention.init_attn(gen, cfg)
    p["ln2"] = layers.init_norm(cfg.d_model, dt, gen.device)
    if cfg.n_experts:
        p["moe"] = moe.init_moe(gen, cfg)
    else:
        p["mlp"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dt,
                                   act=cfg.act)
    return p


def _init_shared_attn(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """zamba2's shared transformer block (attn + mlp, params reused)."""
    dt = cfg.dtype
    return {"ln1": layers.init_norm(cfg.d_model, dt, gen.device),
            "attn": attention.init_attn(gen, cfg),
            "ln2": layers.init_norm(cfg.d_model, dt, gen.device),
            "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dt,
                                   act=cfg.act)}


def _ffn(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.n_experts:
        return moe.moe_ffn(p["moe"], x, cfg)
    return layers.mlp(p["mlp"], x, act=cfg.act, d_ff=cfg.d_ff)


def _block_train(p: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = layers.rms_norm(p["ln1"], h, cfg.norm_eps)
    if _is_ssm(cfg):
        return h + ssm.ssm_train(p["ssm"], x, cfg)
    if cfg.attn_kind == "mla":
        h = h + attention.mla_train(p["attn"], x, cfg)
    else:
        h = h + attention.attn_train(p["attn"], x, cfg)
    x = layers.rms_norm(p["ln2"], h, cfg.norm_eps)
    return h + _ffn(p, x, cfg)


def _shared_attn_train(p: dict, h: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    x = layers.rms_norm(p["ln1"], h, cfg.norm_eps)
    h = h + attention.attn_train(p["attn"], x, cfg)
    x = layers.rms_norm(p["ln2"], h, cfg.norm_eps)
    return h + layers.mlp(p["mlp"], x, act=cfg.act)


def _hybrid_split(cfg: ModelConfig) -> tuple[int, int]:
    groups = cfg.n_layers // cfg.attn_every
    rem = cfg.n_layers - groups * cfg.attn_every
    return groups, rem


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_lm(cfg: ModelConfig, seed: int, device: torch.device,
            keep=None) -> dict:
    """Fresh params on ``device``, drawn from ``torch.Generator(seed)``.
    Weights are drawn in float32 a tensor at a time and cast, so the peak
    is the model in its param dtype plus one layer. On the meta device
    only the shapes are made. ``keep(path, tensor)`` cuts each leaf as
    it is drawn (a rank's shard, the same draws as the full init)."""
    check_family(cfg)
    gen = layers.generator(device, seed)
    cut = (lambda _path, t: t) if keep is None else keep

    def part(prefix, tree):
        return tree_from_items((f"{prefix}/{p}", cut(f"{prefix}/{p}", t))
                               for p, t in tree_items(tree))[prefix]

    params: dict = {}
    # embedding-input configs still embed text tokens at decode time, so
    # the table always exists
    params["embed"] = part("embed", layers.init_embed(
        gen, cfg.padded_vocab, cfg.d_model, cfg.dtype))
    params["blocks"] = stack_layers(
        lambda: _init_block(gen, cfg), cfg.n_layers,
        keep=None if keep is None else
        (lambda p, t: keep(f"blocks/{p}", t)))
    if _is_hybrid(cfg):
        params["shared_attn"] = part("shared_attn",
                                     _init_shared_attn(gen, cfg))
    params["final_norm"] = part("final_norm", layers.init_norm(
        cfg.d_model, cfg.dtype, device))
    if not cfg.tie_embeddings or cfg.input_is_embeddings:
        params["head"] = part("head", layers.init_linear(
            gen, cfg.d_model, cfg.padded_vocab, cfg.dtype))
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
        h = layers.embed(params["embed"], inputs, vocab=cfg.padded_vocab)
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    rules = current_rules()

    def run(block, p, x):
        if remat and rules is not None:
            # the recompute may run on autograd's device thread, which
            # does not see this thread's rules: it takes them along
            return checkpoint(_under_rules, rules, block, p, x, cfg,
                              use_reentrant=False)
        if remat:
            return checkpoint(block, p, x, cfg, use_reentrant=False)
        return block(p, x, cfg)

    per = unbind_layers(params["blocks"], cfg.n_layers)
    if _is_hybrid(cfg):
        groups, _ = _hybrid_split(cfg)
        for g in range(groups):
            for p in per[g * cfg.attn_every:(g + 1) * cfg.attn_every]:
                h = run(_block_train, p, h)
            h = run(_shared_attn_train, params["shared_attn"], h)
        per = per[groups * cfg.attn_every:]                # the remainder
    for p in per:
        h = run(_block_train, p, h)
    return layers.rms_norm(params["final_norm"], h, cfg.norm_eps)


def _under_rules(rules, block, p, x, cfg):
    with use_rules(rules):
        return block(p, x, cfg)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Next-token CE. batch: {"inputs", "labels", "mask"}."""
    h = forward_train(params, batch["inputs"], cfg)
    return layers.cross_entropy_chunked(
        h, head_w(params, cfg), batch["labels"], batch["mask"],
        chunk=min(256, h.shape[1]), unroll=cfg.scan_unroll,
        vocab=cfg.padded_vocab)


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> dict:
    check_family(cfg)
    if cfg.family == "ssm":
        return ssm.init_ssm_cache(cfg, batch, device)
    if cfg.family == "hybrid":
        groups, _ = _hybrid_split(cfg)
        c = ssm.init_ssm_cache(cfg, batch, device)
        c.update(attention.init_attn_cache(cfg, batch, max_len, device,
                                           n_layers=groups))
        return c
    if cfg.attn_kind == "mla":
        return attention.init_mla_cache(cfg, batch, max_len, device)
    return attention.init_attn_cache(cfg, batch, max_len, device)


def _vocab_masked(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    keep = torch.arange(cfg.padded_vocab, device=logits.device) \
        < cfg.vocab_size
    return torch.where(keep, logits, -1e30)


def _block_decode(p: dict, h: torch.Tensor, cache: dict, i: int,
                  length: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Layer ``i``, one token; its cache rows written in place."""
    x = layers.rms_norm(p["ln1"], h, cfg.norm_eps)
    if _is_ssm(cfg):
        out, _, _ = ssm.ssm_decode(p["ssm"], x, cache["state"][i],
                                   cache["conv"][i], cfg)
        return h + out
    if cfg.attn_kind == "mla":
        out, _, _ = attention.mla_decode(p["attn"], x, cache["c_kv"][i],
                                         cache["k_rope"][i], length, cfg)
    else:
        out, _, _ = attention.attn_decode(p["attn"], x, cache["k"][i],
                                          cache["v"][i], length, cfg)
    h = h + out
    x = layers.rms_norm(p["ln2"], h, cfg.norm_eps)
    return h + _ffn(p, x, cfg)


def _shared_attn_decode(p: dict, h: torch.Tensor, cache: dict, g: int,
                        length: torch.Tensor,
                        cfg: ModelConfig) -> torch.Tensor:
    """The shared block after group ``g``, on that group's KV slot."""
    x = layers.rms_norm(p["ln1"], h, cfg.norm_eps)
    out, _, _ = attention.attn_decode(p["attn"], x, cache["k"][g],
                                      cache["v"][g], length, cfg)
    h = h + out
    x = layers.rms_norm(p["ln2"], h, cfg.norm_eps)
    return h + layers.mlp(p["mlp"], x, act=cfg.act)


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
    per = unbind_layers(params["blocks"], cfg.n_layers)
    for i, p in enumerate(per):
        h = _block_decode(p, h, cache, i, length, cfg)
        if _is_hybrid(cfg) and (i + 1) % cfg.attn_every == 0:
            # the end of group g: its KV slot for the shared block
            g = (i + 1) // cfg.attn_every - 1
            h = _shared_attn_decode(params["shared_attn"], h, cache, g,
                                    length, cfg)
    h = layers.rms_norm(params["final_norm"], h, cfg.norm_eps)
    logits = (h[:, 0] @ head_w(params, cfg)).float()
    new_cache = dict(cache)
    new_cache["length"] = length + 1
    return _vocab_masked(logits, cfg), new_cache


@torch.no_grad()
def prefill(params: dict, tokens: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Inference prefill: full forward, returns last-position logits."""
    h = forward_train(params, tokens, cfg)
    return _vocab_masked((h[:, -1] @ head_w(params, cfg)).float(), cfg)
