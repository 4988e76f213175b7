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
column block of ``wq``/``wk``/``wv`` and a row block of ``wo``, train and
prefill take the layout the reference's ``constrain_alt`` picks for q, k
and v (``layout``; the explicit collectives GSPMD derives there):

* "heads": query and KV heads divide the axis. Megatron: the rank runs
  its ``n_heads/P`` query and ``n_kv_heads/P`` KV heads, GQA groups
  intact, and ``wo``'s output is summed over ``model``;
* "q_heads": query heads divide, KV heads do not (8 KV heads on 16). q
  stays the rank's heads; k and v are gathered whole (the gradient
  reduce-scattered back) and each local query head reads its own KV
  head, a block starting inside a group if it must (``local_groups``);
* "seq": query heads do not divide (56 on 16), so a head's columns lie
  on two ranks, and the sequence does. Each rank computes its column
  block of q, k and v on every position; q moves to the rank's sequence
  block with every column (an all-to-all over ``model``), k and v are
  gathered whole, ``flash_attention`` runs the block with its causal
  offset, and the output moves back to the column block for the
  row-parallel ``wo`` (another all-to-all);
* "whole": neither divides (``safe_spec`` replicates): every rank runs
  the whole attention on gathered columns and cuts ``wo``'s input to
  its rows.

Rope rotates whole heads, so it runs after the move. A projection whose
columns do not divide the axis stays replicated and enters the layout
as it is. MLA runs the same layouts with ``w_uq``, ``w_uk`` and ``w_uv``
column-sharded and ``w_dkv``/``w_kr`` replicated: ``q_norm`` normalises
over the whole ``q_lora_rank``, so the rank's block of it is gathered
first.

Decode on a mesh is the distributed flash-decode that XLA inserts for
the reference: the cache's blocks follow ``partition.cache_specs``
(sequence over ``model``, batch over the data axes, or at batch 1 the
heads over them). Each rank computes its column block of q, k and v,
gathers the columns over ``model`` (B × 1 × H·D), writes the new K and
V only where its sequence block holds position ``min(length, S−1)``,
attends over its own block to a float32 partial (running max,
denominator, weighted V; a block wholly past ``length`` weighs zero),
combines the partials over the sequence's axes (a max, then one sum),
gathers the heads its block holds over their axes, and runs ``wo``
row-parallel on its rows (``cached_attention``; a rank's rows of ``wo``
may begin inside a head).
MLA expands K and V from its block of the compressed cache with
``w_uk``/``w_uv`` gathered over ``model``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.sharding import (axes_index, copy_to,
                                          current_rules, gather_along,
                                          gather_leaf, gather_rs,
                                          mesh_axis_size, reduce_from,
                                          scatter_along, swap_along)

__all__ = ["init_attn", "attn_train", "init_attn_cache", "attn_decode",
           "init_mla", "mla_train", "init_mla_cache", "mla_decode",
           "flash_attention", "cached_attention", "cache_block",
           "write_position", "row_parallel_out", "layer_spec", "layout",
           "col_mesh", "q_layout", "kv_layout", "attn_out", "local_groups",
           "whole_cols", "gqa"]

_NEG = -1e30


# ---------------------------------------------------------------------------
# blockwise flash attention (grouped heads, causal or full)
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_block: int = 512, kv_block: int = 1024,
                    unroll: bool = False, q_offset: int = 0) -> torch.Tensor:
    """Streaming-softmax attention.

    q: (B, Sq, Hkv, G, Dk); k: (B, Skv, Hkv, Dk); v: (B, Skv, Hkv, Dv).
    Returns (B, Sq, Hkv, G, Dv) in v's dtype. ``unroll`` is the
    reference's scan knob and changes nothing here. ``q_offset`` is the
    position of q's first row (the causal mask's; a sequence block of a
    sequence-parallel rank), as the reference's.
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
        q_pos = q_offset + qi * q_block + torch.arange(q_block, device=dev)
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


# -- layouts of attention on a model axis ---------------------------------------

def col_mesh(p: dict, full: int, rows: bool = False):
    """The mesh where linear ``p``'s weight is this rank's ``model``
    block of its columns (``rows``: its rows) out of ``full``; else
    None."""
    return layers.model_mesh(p["w"].shape[0 if rows else 1], full)


def layout(n_heads: int, n_kv_heads: int, s: int, pm: int) -> str:
    """How attention runs on a model axis of ``pm`` (the reference's
    ``constrain_alt`` choice, the most sharded entries): "heads" (query
    and KV heads split over it, Megatron), "q_heads" (query heads split,
    every KV head read whole), "seq" (the query's sequence split with
    every head: a head's columns are split), or "whole" (neither
    divides: every rank runs the whole attention)."""
    if n_heads % pm == 0:
        return "heads" if n_kv_heads % pm == 0 else "q_heads"
    return "seq" if s % pm == 0 else "whole"


def q_layout(t: torch.Tensor, split: bool, mode: str, mesh
             ) -> tuple[torch.Tensor, int]:
    """A query's columns (B, S, C/P where ``split``, else whole and
    replicated) in ``mode``'s layout, and the position of its first row:
    "seq" moves the rank's column block to its sequence block with every
    column (an all-to-all over ``model``); "whole" gathers the columns."""
    if mode == "seq":
        q0 = mesh.axis_index("model") * (t.shape[1] // mesh.shape["model"])
        return (swap_along(t, mesh, "model", 1, -1) if split
                else scatter_along(t, mesh, "model", 1)), q0
    if mode == "whole":
        return (gather_along(t, mesh, "model", -1) if split else t), 0
    return t, 0                                # the rank's heads


def kv_layout(t: torch.Tensor, split: bool, mode: str, mesh
              ) -> torch.Tensor:
    """A key's or value's columns, whole on every position, where the
    ranks' queries read them differently ("seq", "q_heads": the
    gradient summed over ``model``); "whole" gathers them as the query's;
    "heads" keeps the rank's."""
    if mode in ("seq", "q_heads"):
        return gather_rs(t, mesh, "model", -1) if split \
            else copy_to(t, mesh)
    if mode == "whole":
        return gather_along(t, mesh, "model", -1) if split else t
    return t


def attn_out(p: dict, out: torch.Tensor, mode: str, mesh,
             full: int) -> torch.Tensor:
    """``wo`` (``full`` input rows) on the attention's output in
    ``mode``'s layout: back to the rank's column block (every position)
    for a row-parallel ``wo`` and summed over ``model``, or whole for a
    replicated one."""
    split = col_mesh(p, full, rows=True) is not None
    if mode == "seq":
        out = swap_along(out, mesh, "model", -1, 1) if split \
            else gather_along(out, mesh, "model", 1)
    elif mode == "whole" and split:
        out = scatter_along(out, mesh, "model", -1)
    if not split:
        return layers.linear(p, out)
    # a bias of the row-parallel wo is added once, after the sum
    y = reduce_from(out @ p["w"], mesh)
    return y + p["b"] if "b" in p else y


def local_groups(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 h0: int, g: int):
    """The rank's query heads ``[h0, h0 + Hl)`` (q: (B, S, Hl, D)) with
    the KV heads they read (k, v: every KV head), grouped for
    ``flash_attention``: whole groups where the block holds them, else a
    group of one a query head (a block may start inside a group)."""
    b, s, hl, d = q.shape
    if h0 % g == 0 and hl % g == 0:
        kv = slice(h0 // g, (h0 + hl) // g)
        return q.reshape(b, s, hl // g, g, d), k[:, :, kv], v[:, :, kv]
    idx = torch.div(h0 + torch.arange(hl, device=q.device), g,
                    rounding_mode="floor")
    return q.reshape(b, s, hl, 1, d), k[:, :, idx], v[:, :, idx]


def gqa(p: dict, x: torch.Tensor, kv_x: torch.Tensor, cfg: ModelConfig,
        causal: bool, positions: torch.Tensor | None) -> torch.Tensor:
    """GQA attention of ``x``'s queries over ``kv_x``'s keys and values
    (the same tensor for self-attention, the encoder's output for
    cross-attention), rope at ``positions`` (None: none), through
    ``wo``; on a mesh in ``layout``'s layout over the query's
    positions."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    g = h // hkv
    meshes = [col_mesh(p[n], f) for n, f in (("wq", h * hd),
                                             ("wk", hkv * hd),
                                             ("wv", hkv * hd))]
    mesh = next((m for m in meshes + [col_mesh(p["wo"], h * hd, rows=True)]
                 if m is not None), None)
    mode, q0 = "heads", 0
    if mesh is None:
        q, k, v = (layers.linear(p[n], t) for n, t in (("wq", x),
                                                       ("wk", kv_x),
                                                       ("wv", kv_x)))
        hq, hk = h, hkv
    else:
        pm = mesh.shape["model"]
        mode = layout(h, hkv, s, pm)
        xc = copy_to(x, mesh)
        kc = xc if kv_x is x else copy_to(kv_x, mesh)
        q, k, v = (layers.linear(p[n], c if m is not None else t)
                   for n, m, c, t in zip(("wq", "wk", "wv"), meshes,
                                         (xc, kc, kc), (x, kv_x, kv_x)))
        q, q0 = q_layout(q, meshes[0] is not None, mode, mesh)
        k = kv_layout(k, meshes[1] is not None, mode, mesh)
        v = kv_layout(v, meshes[2] is not None, mode, mesh)
        hq = h // pm if mode in ("heads", "q_heads") else h
        hk = hkv // pm if mode == "heads" else hkv
    sq = q.shape[1]
    q, k, v = (_split_heads(t, n, hd) for t, n in ((q, hq), (k, hk),
                                                   (v, hk)))
    if positions is not None:
        q = layers.rope(q, positions[..., q0:q0 + sq], cfg.rope_theta)
        k = layers.rope(k, positions, cfg.rope_theta)
    if mode == "q_heads":
        q, k, v = local_groups(q, k, v, mesh.axis_index("model") * hq, g)
    else:
        q = q.reshape(b, sq, hk, g, hd)
    out = flash_attention(q, k, v, causal=causal, unroll=cfg.scan_unroll,
                          q_offset=q0).reshape(b, sq, hq * hd)
    if mesh is None:
        return layers.linear(p["wo"], out)
    return attn_out(p["wo"], out, mode, mesh, h * hd)


def attn_train(p: dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor | None = None,
               causal: bool = True) -> torch.Tensor:
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return gqa(p, x, x, cfg, causal, positions)


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                    device, n_layers: int | None = None) -> dict:
    """KV cache: (L, B, S, Hkv, D) in the param dtype, ``length`` int32."""
    L = cfg.n_layers if n_layers is None else n_layers
    shape = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "length": torch.zeros((), dtype=torch.int32, device=device)}


def layer_spec(name: str):
    """The per-layer spec of cache leaf ``name`` under the current rules'
    ``cache`` (its first entry, the layer stack's, dropped); None on one
    device."""
    rules = current_rules()
    if rules is None or not rules.cache:
        return None
    return tuple(rules.cache[name])[1:]


def cache_block(spec, shape) -> tuple:
    """Where this rank's block of a per-layer cache leaf ``(B, S, ...)``
    sits under ``spec`` (the layer's entries of ``cache_specs``; None:
    one device): (sequence axes, first position, full length, head
    axes, first head). Axes are None where the dim is whole."""
    s_loc = shape[1]
    if spec is None:
        return None, 0, s_loc, None, 0
    mesh = current_rules().mesh
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    seq, heads = spec[1], spec[2] if len(shape) > 3 else None
    s_off = axes_index(mesh, seq) * s_loc if seq else 0
    h_off = axes_index(mesh, heads) * shape[2] if heads else 0
    return seq, s_off, s_loc * mesh_axis_size(mesh, seq), heads, h_off


def write_position(cache: torch.Tensor, new: torch.Tensor,
                   length: torch.Tensor, spec) -> None:
    """Write ``new`` (B, 1, ...) into ``cache`` (B, S_loc, ...) at the
    clamped ``length`` (as ``dynamic_update_slice`` clamps), in place,
    only where this rank's sequence block holds that position; ``new``
    carries every head, and the block's heads are cut from it."""
    _, s_off, s_full, heads, h_off = cache_block(spec, cache.shape)
    s_loc = cache.shape[1]
    if heads:
        new = new[:, :, h_off:h_off + cache.shape[2]]
    at = torch.clamp(length.long(), 0, s_full - 1) - s_off
    idx = torch.clamp(at, 0, s_loc - 1).reshape(1)
    if spec is None or s_loc == s_full:
        cache.index_copy_(1, idx, new.to(cache.dtype))
        return
    mine = (at >= 0) & (at < s_loc)
    cache.index_copy_(1, idx, torch.where(mine, new.to(cache.dtype),
                                          cache.index_select(1, idx)))


def cached_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor | None,
                     spec) -> torch.Tensor:
    """One query a sequence against a cache: q (B, Hkv, G, Dk) float32,
    every KV head's group; caches (B, S_loc, H_loc, D) this rank's block
    under ``spec`` (None: one device, the whole cache); positions past
    ``length`` masked (None: none). Returns (B, Hkv, G, Dv) float32 for
    every head.

    One device (or a sequence held whole): the reference's float32
    softmax. A sequence split over axes: the distributed flash-decode,
    each block's partial combined over those axes; a block wholly past
    ``length`` has denominator and weighted V zero and a max of -1e30,
    which its factor ``exp(m - M)`` turns to 0."""
    seq, s_off, _, heads, h_off = cache_block(spec, k_cache.shape)
    if heads:
        q = q[:, h_off:h_off + k_cache.shape[2]]
    scores = (q @ k_cache.float().permute(0, 2, 3, 1)) \
        * (q.shape[-1] ** -0.5)                            # (B,H,G,S_loc)
    valid = None
    if length is not None:
        valid = s_off + torch.arange(k_cache.shape[1],
                                     device=q.device) <= length
        scores = torch.where(valid, scores, _NEG)
    vf = v_cache.float().permute(0, 2, 1, 3)               # (B,H,S_loc,Dv)
    if not seq:
        out = torch.softmax(scores, dim=-1) @ vf
    else:
        mesh = current_rules().mesh
        m = torch.amax(scores, dim=-1)                     # (B,H,G)
        p = torch.exp(scores - m[..., None])
        if valid is not None:
            p = torch.where(valid, p, 0.0)
        big = mesh.reduce(m, seq, op="max")
        c = torch.exp(m - big)
        part = torch.cat([(p @ vf) * c[..., None],
                          (torch.sum(p, dim=-1) * c)[..., None]], dim=-1)
        part = mesh.reduce(part, seq)
        out = part[..., :-1] / part[..., -1:]
    if heads:
        mesh = current_rules().mesh
        e = [None] * out.ndim
        e[1] = heads
        out = gather_leaf(out, e, mesh)
    return out


def row_parallel_out(p: dict, out: torch.Tensor) -> torch.Tensor:
    """``wo`` on every head's output (B, 1, H·D): one device, or where
    ``wo`` is a row shard the rank's heads summed over ``model``."""
    mesh = layers.model_mesh(p["w"].shape[0], out.shape[-1])
    if mesh is None:
        return layers.linear(p, out)
    n = p["w"].shape[0]
    blk = out[..., mesh.axis_index("model") * n:][..., :n]
    y = reduce_from(blk @ p["w"], mesh)
    return y + p["b"] if "b" in p else y


def whole_cols(p: dict, x: torch.Tensor, full: int) -> torch.Tensor:
    """``linear(p, x)`` with every column: a rank's column block gathered
    over ``model`` (no gradient: decode)."""
    y = layers.linear(p, x)
    mesh = col_mesh(p, full)
    return y if mesh is None else gather_along(y, mesh, "model", -1)


def attn_decode(p: dict, x: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, length: torch.Tensor,
                cfg: ModelConfig, spec=None):
    """One-token decode. x: (B, 1, d); caches (B, S, Hkv, D), written in
    place at ``length``. On a mesh the caches are this rank's blocks
    under ``spec`` (the layer's entries of ``cache_specs``) and the
    weights its tensor-parallel shards: q, k and v are gathered by
    columns (a head's columns may lie on two ranks). Returns (out,
    k_cache, v_cache)."""
    b = x.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    g = h // hkv
    pos = length.reshape(1, 1).expand(b, 1)
    q = _split_heads(whole_cols(p["wq"], x, h * hd), h, hd)
    k = _split_heads(whole_cols(p["wk"], x, hkv * hd), hkv, hd)
    v = _split_heads(whole_cols(p["wv"], x, hkv * hd), hkv, hd)
    q = layers.rope(q, pos, cfg.rope_theta)
    k = layers.rope(k, pos, cfg.rope_theta)
    write_position(k_cache, k, length, spec)
    write_position(v_cache, v, length, spec)
    out = cached_attention(q.reshape(b, hkv, g, hd).float(), k_cache,
                           v_cache, length, spec)         # (B,hkv,g,D)
    out = out.reshape(b, 1, h * hd).to(x.dtype)
    return row_parallel_out(p["wo"], out), k_cache, v_cache


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
    """The query's columns (B, S, H·(qn+qr), on a mesh this rank's block
    where ``w_uq`` is a column shard), whether they are split, and the
    shared c_kv and k_rope. On a mesh ``w_dq`` may be a column shard:
    q_norm's input is gathered whole first."""
    m_dq = layers.model_mesh(p["w_dq"]["w"].shape[1], cfg.q_lora_rank)
    m_uq = col_mesh(p["w_uq"], cfg.n_heads * (cfg.qk_nope_dim
                                              + cfg.qk_rope_dim))
    if m_dq is None:
        cq = layers.linear(p["w_dq"], x)
    else:
        cq = gather_along(layers.linear(p["w_dq"], copy_to(x, m_dq)), m_dq,
                          "model", -1)
    cq = layers.rms_norm(p["q_norm"], cq, cfg.norm_eps)
    if m_uq is not None:
        cq = copy_to(cq, m_uq)
    q = layers.linear(p["w_uq"], cq)
    c_kv = layers.rms_norm(p["kv_norm"], layers.linear(p["w_dkv"], x),
                           cfg.norm_eps)
    k_rope = layers.rope(layers.linear(p["w_kr"], x)[:, :, None, :],
                         positions, cfg.rope_theta)       # (B,S,1,qr) shared
    return q, m_uq is not None, c_kv, k_rope


def _mla_heads(q, cfg, positions):
    """Query columns of whole heads (B, S, Hl·(qn+qr)) → heads with the
    rope part rotated at ``positions``."""
    b, s, _ = q.shape
    qn, qr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = q.reshape(b, s, -1, qn + qr)
    return torch.cat([q[..., :qn], layers.rope(q[..., qn:], positions,
                                               cfg.rope_theta)], dim=-1)


def _mla_kv_cols(p, c_kv, cfg):
    """(k_nope, v) columns from the shared c_kv, each this rank's block
    where ``w_uk``/``w_uv`` are column shards (c_kv enters them through
    ``copy_to``), and whether each is split."""
    h = cfg.n_heads
    out = []
    for n, full in (("w_uk", h * cfg.qk_nope_dim),
                    ("w_uv", h * cfg.v_head_dim)):
        m = col_mesh(p[n], full)
        out += [layers.linear(p[n], c_kv if m is None else copy_to(c_kv, m)),
                m is not None]
    return out


def _mla_expand_kv(k_nope, v, k_rope, cfg):
    """K (nope and the shared rope part) and V of whole heads from their
    columns (B, S, Hl·qn) and (B, S, Hl·vd)."""
    b, s, _ = k_nope.shape
    k_nope = k_nope.reshape(b, s, -1, cfg.qk_nope_dim)
    n = k_nope.shape[2]
    k = torch.cat([k_nope, k_rope.expand(b, s, n, k_rope.shape[-1])],
                  dim=-1)
    return k, v.reshape(b, s, n, cfg.v_head_dim)


def mla_train(p: dict, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor | None = None) -> torch.Tensor:
    b, s, _ = x.shape
    h = cfg.n_heads
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, split_q, c_kv, k_rope = _mla_qkv(p, x, cfg, positions)
    k_nope, split_k, v, split_v = _mla_kv_cols(p, c_kv, cfg)
    mesh = next((m for m in (col_mesh(p["w_uq"], h * (cfg.qk_nope_dim
                                                      + cfg.qk_rope_dim)),
                             col_mesh(p["w_uk"], h * cfg.qk_nope_dim),
                             col_mesh(p["w_uv"], h * cfg.v_head_dim),
                             col_mesh(p["wo"], h * cfg.v_head_dim,
                                      rows=True)) if m is not None), None)
    mode, q0 = "heads", 0
    if mesh is not None:
        mode = layout(h, h, s, mesh.shape["model"])
        q, q0 = q_layout(q, split_q, mode, mesh)
        k_nope = kv_layout(k_nope, split_k, mode, mesh)
        v = kv_layout(v, split_v, mode, mesh)
        # the shared rope key: every rank's heads read it
        k_rope = copy_to(k_rope, mesh) if mode in ("heads", "seq") \
            else k_rope
    sq = q.shape[1]
    q = _mla_heads(q, cfg, positions[..., q0:q0 + sq])
    k, v = _mla_expand_kv(k_nope, v, k_rope, cfg)
    out = flash_attention(q[:, :, :, None, :], k, v, causal=True,
                          unroll=cfg.scan_unroll, q_offset=q0)
    out = out.reshape(b, sq, -1)
    if mesh is None:
        return layers.linear(p["wo"], out)
    return attn_out(p["wo"], out, mode, mesh, h * cfg.v_head_dim)


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
               cfg: ModelConfig, spec=None):
    """One-token decode. x: (B, 1, d); ckv_cache (B, S, r_kv) and
    krope_cache (B, S, qr), written in place at ``length``; on a mesh
    this rank's blocks under ``spec`` (``c_kv``'s layer entries of
    ``cache_specs``), the query gathered by columns. Returns (out,
    ckv_cache, krope_cache)."""
    b = x.shape[0]
    h = cfg.n_heads
    pos = length.reshape(1, 1).expand(b, 1)
    q, split_q, c_kv, k_rope = _mla_qkv(p, x, cfg, pos)
    if split_q:                                            # every head
        q = gather_along(q, current_rules().mesh, "model", -1)
    q = _mla_heads(q, cfg, pos)                            # (B,1,H,Dk)
    write_position(ckv_cache, c_kv, length, spec)
    write_position(krope_cache, k_rope[:, :, 0], length, spec)
    up = {}                                # w_uk, w_uv: every column
    for n, full in (("w_uk", h * cfg.qk_nope_dim),
                    ("w_uv", h * cfg.v_head_dim)):
        w = p[n]["w"]
        m = layers.model_mesh(w.shape[1], full)
        up[n] = w if m is None else gather_along(w, m, "model", 1)
    k, v = _mla_expand_kv(ckv_cache @ up["w_uk"], ckv_cache @ up["w_uv"],
                          krope_cache[:, :, None, :], cfg)
    out = cached_attention(q.float().reshape(b, h, 1, -1), k, v, length,
                           spec)                           # (B,H,1,Dv)
    out = out.reshape(b, 1, h * cfg.v_head_dim).to(x.dtype)
    return row_parallel_out(p["wo"], out), ckv_cache, krope_cache
