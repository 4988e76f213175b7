"""Model registry: uniform entry points over the zoo's families.

Port of ``src/repro/models/registry.py``. ``get_model(cfg, device)``
gives train, serve and launch code five family-agnostic callables on
one device:

  init(seed)                → params
  loss(params, batch)       → scalar CE
  make_cache(batch, max_len)→ decode cache
  decode(params, cache, tok)→ (logits, cache)
  prefill(params, tokens)   → last-position logits

plus ``input_specs`` — the batch's shapes and dtypes as meta-device
tensors (the reference's ``ShapeDtypeStruct`` stand-ins, zero
allocation) —, ``param_shapes``, the params' tree the same way (the
reference's ``jax.eval_shape`` of ``init``), and ``reduced_config``,
with the reference's arithmetic.
Every family of the zoo runs: the decoder-only ones through
``transformer.py``, the encoder-decoder through ``encdec.py`` (its
``make_cache(batch, max_len, enc_len=None)``; ``prefill`` is ``encode``,
as in the reference, and ``encdec.fill_cross_cache`` writes the cross
K/V a decode reads).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.tree import tree_from_items, tree_items
from repro_torch.runtime.device import resolve_device

__all__ = ["ModelApi", "get_model", "input_specs", "param_shapes",
           "cache_shapes", "make_rank_cache", "init_rank_params",
           "reduced_config"]


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    device: torch.device
    init: Callable                   # (seed) → params on ``device``
    loss: Callable                   # (params, batch) → scalar
    make_cache: Callable             # (batch, max_len) → cache
    decode: Callable                 # (params, cache, tokens) → (logits, c)
    prefill: Callable                # (params, tokens) → last logits


def get_model(cfg: ModelConfig, device=None) -> ModelApi:
    """The model's entry points on ``device`` (None: the CUDA card;
    "meta": a plan, shapes only, as ``launch/dryrun.py`` runs it)."""
    transformer.check_family(cfg)
    dev = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    if cfg.is_encoder_decoder:
        return ModelApi(
            cfg=cfg, device=dev,
            init=lambda seed=0: encdec.init_encdec(cfg, seed, dev),
            loss=lambda p, b: encdec.encdec_loss(p, b, cfg),
            make_cache=lambda batch, max_len, enc_len=None:
                encdec.init_encdec_cache(cfg, batch, max_len,
                                         enc_len or max_len, dev),
            decode=lambda p, c, t: encdec.encdec_decode_step(p, c, t, cfg),
            prefill=lambda p, b: encdec.encode(p, b, cfg),
        )
    return ModelApi(
        cfg=cfg, device=dev,
        init=lambda seed=0: transformer.init_lm(cfg, seed, dev),
        loss=lambda p, b: transformer.loss_fn(p, b, cfg),
        make_cache=lambda batch, max_len: transformer.init_cache(
            cfg, batch, max_len, dev),
        decode=lambda p, c, t: transformer.decode_step(p, c, t, cfg),
        prefill=lambda p, t: transformer.prefill(p, t, cfg),
    )


def param_shapes(cfg: ModelConfig) -> dict:
    """The params' tree as meta-device tensors (shapes and dtypes, no
    allocation, no draws): what the partition rules read."""
    meta = torch.device("meta")
    if cfg.is_encoder_decoder:
        return encdec.init_encdec(cfg, 0, meta)
    return transformer.init_lm(cfg, 0, meta)


def init_rank_params(api: ModelApi, mesh, specs: dict, seed: int) -> dict:
    """This rank's blocks under ``specs`` (a tree of PartitionSpec) of
    the init of ``seed``: each leaf cut as it is drawn, from the same
    draws as ``api.init(seed)``; a stacked leaf split on its layer dim
    is cut once its stack is whole."""
    from repro_torch.runtime.sharding import shard_leaf
    spec_of = dict(tree_items(specs))
    init = encdec.init_encdec if api.cfg.is_encoder_decoder \
        else transformer.init_lm
    whole = set()

    def keep(path, t):
        spec = tuple(spec_of[path])
        if len(spec) > t.ndim and spec[0] is not None:
            whole.add(path)
            return t
        return shard_leaf(t, spec, mesh)

    return tree_from_items(
        (path, shard_leaf(t, spec_of[path], mesh) if path in whole else t)
        for path, t in tree_items(init(api.cfg, seed, api.device,
                                       keep=keep)))


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                 enc_len: int | None = None) -> dict:
    """The decode cache's tree as meta-device tensors (``make_cache``'s
    shapes and dtypes, nothing allocated)."""
    meta = torch.device("meta")
    if cfg.is_encoder_decoder:
        return encdec.init_encdec_cache(cfg, batch, max_len,
                                        enc_len or max_len, meta)
    return transformer.init_cache(cfg, batch, max_len, meta)


def make_rank_cache(api: ModelApi, mesh, specs: dict, batch: int,
                    max_len: int, enc_len: int | None = None) -> dict:
    """This rank's blocks of a fresh decode cache under ``specs``
    (``partition.cache_specs`` of ``cache_shapes``), zeros on
    ``api.device``: only the blocks are allocated."""
    from repro_torch.runtime.sharding import mesh_axis_size
    spec_of = dict(tree_items(specs))

    def block(path, t):
        spec = tuple(spec_of[path]) + (None,) * t.ndim
        shape = [d // mesh_axis_size(mesh, e) for d, e in zip(t.shape, spec)]
        return torch.zeros(shape, dtype=t.dtype, device=api.device)

    return tree_from_items((path, block(path, t)) for path, t in
                           tree_items(cache_shapes(api.cfg, batch, max_len,
                                                   enc_len)))


# ---------------------------------------------------------------------------
# input specs (shape stand-ins; also the data-pipeline contract)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, seq_len: int, global_batch: int,
                kind: str) -> dict[str, torch.Tensor]:
    """Meta-device tensors with one step's batch shapes and dtypes.

    train: {"inputs", "labels", "mask"} (+frames/tokens split for enc-dec);
    prefill: {"inputs"}; decode: {"tokens"} — the KV cache is state, built
    separately.
    """
    def f(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    b, s = global_batch, seq_len
    tok = torch.int32
    if cfg.is_encoder_decoder:
        sd = min(cfg.dec_len, s)
        if kind == "train":
            return {"frames": f((b, s, cfg.d_model), torch.bfloat16),
                    "tokens": f((b, sd), tok),
                    "labels": f((b, sd), tok),
                    "mask": f((b, sd), tok)}
        if kind == "prefill":
            return {"frames": f((b, s, cfg.d_model), torch.bfloat16)}
        return {"tokens": f((b, 1), tok)}
    if cfg.input_is_embeddings:                      # vlm stub frontend
        if kind == "train":
            return {"inputs": f((b, s, cfg.d_model), torch.bfloat16),
                    "labels": f((b, s), tok),
                    "mask": f((b, s), tok)}
        if kind == "prefill":
            return {"inputs": f((b, s, cfg.d_model), torch.bfloat16)}
        return {"tokens": f((b, 1), tok)}
    if kind == "train":
        return {"inputs": f((b, s), tok), "labels": f((b, s), tok),
                "mask": f((b, s), tok)}
    if kind == "prefill":
        return {"inputs": f((b, s), tok)}
    return {"tokens": f((b, 1), tok)}


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (per-arch shape checks)."""
    small = dict(
        n_layers=max(2, (cfg.attn_every or 0) + 1 if cfg.family == "hybrid"
                     else 2),
        d_model=64, d_ff=128, vocab_size=256, vocab_pad_multiple=64)
    if cfg.family == "hybrid":
        small["attn_every"] = 2
        small["n_layers"] = 5      # 2 groups of 2 + remainder 1
    if cfg.attn_kind == "mla":
        small.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                     qk_rope_dim=8, v_head_dim=16)
    heads = dict(n_heads=4, n_kv_heads=max(1, 4 * cfg.n_kv_heads
                                           // max(cfg.n_heads, 1)),
                 head_dim=16)
    small.update(heads)
    if cfg.n_experts:
        small.update(n_experts=8, moe_top_k=2, moe_d_ff=32,
                     n_shared_experts=min(cfg.n_shared_experts, 1),
                     expert_pad_multiple=4)
    if cfg.family in ("ssm", "hybrid"):
        small.update(ssm_state=16, ssm_head_dim=16)
    if cfg.is_encoder_decoder:
        small.update(n_enc_layers=2, dec_len=32)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
