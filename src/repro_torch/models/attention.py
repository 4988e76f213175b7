"""Attention: blockwise flash attention for train and prefill, GQA and
MLA, one-token decode against a KV cache.

Port of ``src/repro/models/attention.py`` (``flash_attention``; GQA:
``init_attn``, ``attn_train``, ``init_attn_cache``, ``attn_decode``;
MLA: ``init_mla``, ``mla_train``, ``init_mla_cache``, ``mla_decode``):

* train and prefill run the reference's **blockwise streaming softmax**:
  an outer loop over query blocks (``q_block=512``), an inner loop over
  KV blocks (``kv_block=1024``) with a running max and denominator in
  float32, the kv padding and causal masks written as ``_NEG``. The
  scores are float32 products of float32 copies of q and k, as the
  reference takes them; no library attention stands in. Every block
  pair is computed, the masked ones too, as in the reference;
* GQA never repeats KV heads: q is grouped ``(B, Sq, Hkv, G, D)`` and
  each KV head meets its ``G`` query heads in one matmul;
* decode writes the new K and V at ``length`` (clamped to the cache as
  ``dynamic_update_slice`` clamps) in place, and attends with float32
  scores masked to positions ``<= length``;
* MLA (minicpm3) caches the *compressed* ``c_kv`` plus the shared
  ``k_rope`` and expands K and V from them every step; its train path
  goes through ``flash_attention`` with Dk = qk_nope + qk_rope ≠ Dv.

On a mesh (``runtime.sharding.use_rules``) whose ``model`` axis holds a
shard of ``wq``/``wk``/``wv`` (their columns: whole heads) and of
``wo`` (its rows), ``attn_train`` runs Megatron-style on the rank's
``n_heads/P`` query and ``n_kv_heads/P`` KV heads, GQA groups intact,
and sums ``wo``'s output over ``model``: where the reference's
``constrain_alt`` asks GSPMD for head-sharded attention. Heads that do
not divide the axis (the reference's fallback to sequence-parallel
attention) wait for ROADMAP.md Queue 1 #14c-2 and are refused before a
step is built (``transformer.check_sharded``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.sharding import copy_to, reduce_from

__all__ = ["init_attn", "attn_train", "init_attn_cache", "attn_decode",
           "init_mla", "mla_train", "init_mla_cache", "mla_decode",
           "flash_attention"]

_NEG = -1e30


# ---------------------------------------------------------------------------
# blockwise flash attention (grouped heads, causal or full)
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_block: int = 512, kv_block: int = 1024,
                    unroll: bool = False) -> torch.Tensor:
    """Streaming-softmax attention.

    q: (B, Sq, Hkv, G, Dk); k: (B, Skv, Hkv, Dk); v: (B, Skv, Hkv, Dv).
    Returns (B, Sq, Hkv, G, Dv) in v's dtype. ``unroll`` is the
    reference's scan knob and changes nothing here. (The reference's
    ``q_offset``, which no caller sets, is left out.)
    """
    b, sq, hkv, g, d = q.shape
    dv = v.shape[-1]
    skv = k.shape[1]
    q_block = min(q_block, sq)
    kv_block = min(kv_block, skv)
    nq = -(-sq // q_block)
    nkv = -(-skv // kv_block)
    qp = nq * q_block - sq
    kp = nkv * kv_block - skv
    if qp:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, qp))
    if kp:
        k = F.pad(k, (0, 0, 0, 0, 0, kp))
        v = F.pad(v, (0, 0, 0, 0, 0, kp))
    scale = d ** -0.5
    dev = q.device
    # (B, Hkv, G, S, D), (B, Hkv, D, S) and (B, Hkv, S, Dv), in float32
    qf = q.float().permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 3, 1)
    vf = v.float().permute(0, 2, 1, 3)
    outs = []
    for qi in range(nq):
        qb = qf[:, :, :, qi * q_block:(qi + 1) * q_block].reshape(
            b, hkv, g * q_block, d)
        q_pos = qi * q_block + torch.arange(q_block, device=dev)
        acc = torch.zeros((b, hkv, g, q_block, dv), dtype=torch.float32,
                          device=dev)
        m_run = torch.full((b, hkv, g, q_block), _NEG, dtype=torch.float32,
                           device=dev)
        l_run = torch.zeros((b, hkv, g, q_block), dtype=torch.float32,
                            device=dev)
        for ki in range(nkv):
            kb = kf[..., ki * kv_block:(ki + 1) * kv_block]
            vb = vf[:, :, ki * kv_block:(ki + 1) * kv_block]
            s = (qb @ kb).view(b, hkv, g, q_block, kv_block) * scale
            k_pos = ki * kv_block + torch.arange(kv_block, device=dev)
            mask = k_pos[None, :] < skv                    # kv padding
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            s = torch.where(mask, s, _NEG)
            m_new = torch.maximum(m_run, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + torch.sum(p, dim=-1)
            pv = (p.view(b, hkv, g * q_block, kv_block) @ vb).view(
                b, hkv, g, q_block, dv)
            acc = acc * corr[..., None] + pv
            m_run = m_new
        out = acc / torch.clamp(l_run[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))            # (B,q,hkv,g,d)
    out = torch.cat(outs, dim=1)
    return out[:, :sq].to(v.dtype)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def init_attn(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.head_dim_
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    dt = cfg.dtype
    return {
        "wq": layers.init_linear(gen, d, h * hd, dt, bias=cfg.qkv_bias),
        "wk": layers.init_linear(gen, d, hkv * hd, dt, bias=cfg.qkv_bias),
        "wv": layers.init_linear(gen, d, hkv * hd, dt, bias=cfg.qkv_bias),
        "wo": layers.init_linear(gen, h * hd, d, dt),
    }


def _split_heads(x, n_heads, hd):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, hd)


def attn_train(p: dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor | None = None,
               causal: bool = True) -> torch.Tensor:
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    g = h // hkv
    mesh = layers.model_mesh(p["wq"]["w"].shape[1], h * hd)
    if mesh is not None:                   # this rank's heads
        pm = mesh.shape["model"]
        h, hkv = h // pm, hkv // pm
        x = copy_to(x, mesh)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q = _split_heads(layers.linear(p["wq"], x), h, hd)
    k = _split_heads(layers.linear(p["wk"], x), hkv, hd)
    v = _split_heads(layers.linear(p["wv"], x), hkv, hd)
    q = layers.rope(q, positions, cfg.rope_theta)
    k = layers.rope(k, positions, cfg.rope_theta)
    qg = q.reshape(b, s, hkv, g, hd)
    out = flash_attention(qg, k, v, causal=causal, unroll=cfg.scan_unroll)
    if mesh is None:
        return layers.linear(p["wo"], out.reshape(b, s, h * hd))
    return reduce_from(out.reshape(b, s, h * hd) @ p["wo"]["w"], mesh)


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                    device, n_layers: int | None = None) -> dict:
    """KV cache: (L, B, S, Hkv, D) in the param dtype, ``length`` int32."""
    L = cfg.n_layers if n_layers is None else n_layers
    shape = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "length": torch.zeros((), dtype=torch.int32, device=device)}


def attn_decode(p: dict, x: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, length: torch.Tensor,
                cfg: ModelConfig):
    """One-token decode. x: (B, 1, d); caches (B, S, Hkv, D), written in
    place at ``length``. Returns (out, k_cache, v_cache)."""
    b = x.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    g = h // hkv
    s_max = k_cache.shape[1]
    pos = length.reshape(1, 1).expand(b, 1)
    q = _split_heads(layers.linear(p["wq"], x), h, hd)
    k = _split_heads(layers.linear(p["wk"], x), hkv, hd)
    v = _split_heads(layers.linear(p["wv"], x), hkv, hd)
    q = layers.rope(q, pos, cfg.rope_theta)
    k = layers.rope(k, pos, cfg.rope_theta)
    # dynamic_update_slice clamps the start so the update fits
    at = torch.clamp(length.long(), 0, s_max - 1).reshape(1)
    k_cache.index_copy_(1, at, k.to(k_cache.dtype))
    v_cache.index_copy_(1, at, v.to(v_cache.dtype))
    qg = q.reshape(b, hkv, g, hd).float()
    scores = (qg @ k_cache.float().permute(0, 2, 3, 1)) * (hd ** -0.5)
    mask = torch.arange(s_max, device=x.device) <= length   # self included
    scores = torch.where(mask, scores, _NEG)                # (B,hkv,g,S)
    probs = torch.softmax(scores, dim=-1)
    out = probs @ v_cache.float().permute(0, 2, 1, 3)       # (B,hkv,g,D)
    out = out.reshape(b, 1, h * hd).to(x.dtype)
    return layers.linear(p["wo"], out), k_cache, v_cache


# ---------------------------------------------------------------------------
# MLA (minicpm3 / deepseek-style multi-head latent attention)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    qn, qr, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt, dev = cfg.dtype, gen.device
    return {
        "w_dq": layers.init_linear(gen, d, cfg.q_lora_rank, dt),
        "q_norm": layers.init_norm(cfg.q_lora_rank, dt, dev),
        "w_uq": layers.init_linear(gen, cfg.q_lora_rank, h * (qn + qr), dt),
        "w_dkv": layers.init_linear(gen, d, cfg.kv_lora_rank, dt),
        "kv_norm": layers.init_norm(cfg.kv_lora_rank, dt, dev),
        "w_kr": layers.init_linear(gen, d, qr, dt),
        "w_uk": layers.init_linear(gen, cfg.kv_lora_rank, h * qn, dt),
        "w_uv": layers.init_linear(gen, cfg.kv_lora_rank, h * vdim, dt),
        "wo": layers.init_linear(gen, h * vdim, d, dt),
    }


def _mla_qkv(p, x, cfg, positions):
    b, s, _ = x.shape
    h = cfg.n_heads
    qn, qr = cfg.qk_nope_dim, cfg.qk_rope_dim
    cq = layers.rms_norm(p["q_norm"], layers.linear(p["w_dq"], x),
                         cfg.norm_eps)
    q = layers.linear(p["w_uq"], cq).reshape(b, s, h, qn + qr)
    q_nope, q_rope = q[..., :qn], q[..., qn:]
    q_rope = layers.rope(q_rope, positions, cfg.rope_theta)
    c_kv = layers.rms_norm(p["kv_norm"], layers.linear(p["w_dkv"], x),
                           cfg.norm_eps)
    k_rope = layers.rope(layers.linear(p["w_kr"], x)[:, :, None, :],
                         positions, cfg.rope_theta)       # (B,S,1,qr) shared
    return q_nope, q_rope, c_kv, k_rope


def _mla_expand_kv(p, c_kv, k_rope, cfg, n_heads):
    b, s, _ = c_kv.shape
    qn, vd = cfg.qk_nope_dim, cfg.v_head_dim
    k_nope = layers.linear(p["w_uk"], c_kv).reshape(b, s, n_heads, qn)
    v = layers.linear(p["w_uv"], c_kv).reshape(b, s, n_heads, vd)
    k = torch.cat([k_nope, k_rope.expand(b, s, n_heads, k_rope.shape[-1])],
                  dim=-1)
    return k, v


def mla_train(p: dict, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor | None = None) -> torch.Tensor:
    b, s, _ = x.shape
    h = cfg.n_heads
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, positions)
    k, v = _mla_expand_kv(p, c_kv, k_rope, cfg, h)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = flash_attention(q[:, :, :, None, :], k, v, causal=True,
                          unroll=cfg.scan_unroll)
    return layers.linear(p["wo"], out.reshape(b, s, h * cfg.v_head_dim))


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   device) -> dict:
    """Compressed cache: c_kv (L,B,S,r_kv) + shared k_rope (L,B,S,qr)."""
    L = cfg.n_layers
    return {
        "c_kv": torch.zeros((L, batch, max_len, cfg.kv_lora_rank),
                            dtype=cfg.dtype, device=device),
        "k_rope": torch.zeros((L, batch, max_len, cfg.qk_rope_dim),
                              dtype=cfg.dtype, device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }


def mla_decode(p: dict, x: torch.Tensor, ckv_cache: torch.Tensor,
               krope_cache: torch.Tensor, length: torch.Tensor,
               cfg: ModelConfig):
    """One-token decode. x: (B, 1, d); ckv_cache (B, S, r_kv) and
    krope_cache (B, S, qr), written in place at ``length``. Returns (out,
    ckv_cache, krope_cache)."""
    b = x.shape[0]
    h = cfg.n_heads
    s_max = ckv_cache.shape[1]
    pos = length.reshape(1, 1).expand(b, 1)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, pos)
    # dynamic_update_slice clamps the start so the update fits
    at = torch.clamp(length.long(), 0, s_max - 1).reshape(1)
    ckv_cache.index_copy_(1, at, c_kv.to(ckv_cache.dtype))
    krope_cache.index_copy_(1, at, k_rope[:, :, 0].to(krope_cache.dtype))
    k, v = _mla_expand_kv(p, ckv_cache, krope_cache[:, :, None, :], cfg, h)
    q = torch.cat([q_nope, q_rope], dim=-1).float()        # (B,1,H,Dk)
    scores = (q.reshape(b, h, 1, -1) @ k.float().permute(0, 2, 3, 1)) \
        * (q.shape[-1] ** -0.5)                            # (B,H,1,S)
    mask = torch.arange(s_max, device=x.device) <= length
    probs = torch.softmax(torch.where(mask, scores, _NEG), dim=-1)
    out = probs @ v.float().permute(0, 2, 1, 3)            # (B,H,1,Dv)
    out = out.reshape(b, 1, h * cfg.v_head_dim).to(x.dtype)
    return layers.linear(p["wo"], out), ckv_cache, krope_cache
