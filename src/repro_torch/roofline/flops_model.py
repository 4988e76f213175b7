"""Analytic per-cell cost model (per device): FLOPs, HBM bytes, wire bytes.

Port of ``src/repro/roofline/flops_model.py``, whole: arithmetic over
``ModelConfig`` and ``Shape`` whose numbers equal the reference's for
every config, shape, mesh, policy and ``rs_per_micro``
(``tests/test_torch_roofline.py``). The text below is the reference's;
in the port, "HLO" reads as the meta-device pass of
``roofline/analysis.py``, which runs every layer and micro-batch (no
loop is counted once there), and the hardware is ``analysis.H100``.

Why this exists: XLA's HloCostAnalysis counts a while-loop body ONCE, so any
scan-based model (layers, microbatches, flash blocks, SSD chunks) under-
reports FLOPs/bytes/collectives by the trip counts. The dry-run therefore
reports BOTH the raw HLO counters and this analytic model; a calibration
test (tests/test_roofline.py) pins the model against a fully-unrolled small
arch where HloCostAnalysis is exact.

Conventions:
  * FLOPs: one fused multiply-add = 2 FLOPs; causal attention counts the
    triangular half; remat=full recomputes the block fwd (factor 4 vs 3).
  * HBM bytes: weights are re-read per microbatch (scan streams them);
    activations modeled at layer boundaries; optimizer traffic is the f32
    master/m/v read+write on the ZeRO shard.
  * wire bytes: Megatron-style 2 activation all-reduces per TP layer per
    direction; ZeRO-1 grad reduce-scatter per microbatch + one param
    all-gather per step; MoE all-to-all for dispatch+combine; ring factors
    (g−1)/g applied. Reported per device.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

__all__ = ["analytic_cell", "CellCost"]


@dataclasses.dataclass(frozen=True)
class CellCost:
    flops: float            # per device per step (expected-in-HLO, w/ remat)
    model_flops: float      # per device "useful" 6·N·D (or 2·N·D serve)
    hbm_bytes: float        # per device per step
    wire_bytes: float       # per device per step
    detail: dict

    def terms(self, hw) -> dict:
        return {"compute_s": self.flops / hw.peak_flops,
                "memory_s": self.hbm_bytes / hw.hbm_bw,
                "collective_s": self.wire_bytes / hw.link_bw}


def _attn_quad_flops(cfg: ModelConfig, b: int, s: int, causal=True) -> float:
    """QKᵀ + PV per layer, fwd."""
    if cfg.family == "ssm":
        return 0.0
    if cfg.attn_kind == "mla":
        dk = cfg.qk_nope_dim + cfg.qk_rope_dim
        dv = cfg.v_head_dim
        per = 2.0 * b * s * s * cfg.n_heads * (dk + dv)
    else:
        per = 4.0 * b * s * s * cfg.n_heads * cfg.head_dim_
    return per * (0.5 if causal else 1.0)


def _ssd_quad_flops(cfg: ModelConfig, b: int, s: int, chunk=256) -> float:
    q = min(chunk, s)
    h, n, p = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    # intra-chunk CBᵀ + (w·X); inter-chunk state outer products
    intra = 2.0 * b * s * q * h * (n + p) * 0.5
    inter = 4.0 * b * s * h * n * p
    return intra + inter


def _n_attn_layers(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // max(cfg.attn_every, 1)
    if cfg.is_encoder_decoder:
        return cfg.n_enc_layers + 2 * cfg.n_layers     # self + cross
    return cfg.n_layers


def analytic_cell(cfg: ModelConfig, shape, mesh_shape: dict,
                  n_micro: int = 1, policy: str = "tp",
                  rs_per_micro: bool = True) -> CellCost:
    n_chips = 1
    for v in mesh_shape.values():
        n_chips *= v
    tp = mesh_shape.get("model", 1) if policy == "tp" else 1
    dp = n_chips // tp
    fsdp = policy == "fsdp"
    ep = policy == "ep"
    b, s = shape.global_batch, shape.seq_len
    n_active = cfg.active_param_count()
    table = cfg.padded_vocab * cfg.d_model
    # head matmul always computes d×V per token; the embed *gather* does not
    n_head = table
    n_tables_stored = 1 if (cfg.tie_embeddings
                            and not cfg.input_is_embeddings) else 2
    n_block = max(n_active - n_tables_stored * table, 1)
    act_bytes_tok = cfg.d_model * 2                # bf16 hidden per token

    if shape.kind == "train":
        toks = b * s
        if cfg.is_encoder_decoder:
            # encoder blocks see s frames; decoder blocks see dec_len tokens
            d = cfg.d_model
            enc_p = cfg.n_enc_layers * (4 * d * d + 2 * d * cfg.d_ff)
            dec_p = cfg.n_layers * (8 * d * d + 2 * d * cfg.d_ff)
            f_enc = enc_p / max(enc_p + dec_p, 1)
            toks_dec = b * min(cfg.dec_len, s)
            block_toks = f_enc * toks + (1 - f_enc) * toks_dec
            quad = (_attn_quad_flops(cfg, b, s, causal=False)
                    * cfg.n_enc_layers
                    + _attn_quad_flops(cfg, b, min(cfg.dec_len, s))
                    * cfg.n_layers
                    + 2.0 * b * min(cfg.dec_len, s) * s * cfg.n_heads
                    * cfg.head_dim_ * cfg.n_layers)      # cross-attn
        else:
            toks_dec = toks
            block_toks = toks
            quad = _attn_quad_flops(cfg, b, s) * _n_attn_layers(cfg)
            if cfg.family in ("ssm", "hybrid"):
                quad += _ssd_quad_flops(cfg, b, s) * cfg.n_layers
        # blocks are rematted (fwd+recompute+bwd = 4×fwd-flops of 2·N·T);
        # the loss head is not (fwd+bwd = 6·N_head·T)
        remat = 8.0 if cfg.remat == "full" else 6.0
        flops = (remat * n_block * block_toks + 6.0 * n_head * toks_dec
                 + (remat / 2) * quad) / n_chips
        model_flops = (6.0 * n_block * block_toks + 6.0 * n_head * toks_dec
                       + 3 * quad) / n_chips
        # HBM: weights ×3 passes ×n_micro on the local shard; activations at
        # layer boundaries ×(fwd+bwd+remat≈4); optimizer f32 r/w; grads f32
        w_local = 2.0 * n_active / tp
        act = 4.0 * cfg.n_layers * toks * act_bytes_tok / n_chips
        opt = 2.0 * 12.0 * n_active / n_chips       # m,v,master r+w (ZeRO)
        hbm = 3.0 * w_local * n_micro + act + opt
        # wire: TP layer syncs + ZeRO RS/AG + MoE. Megatron-AR accounting
        # (2× act bytes per block sync, 2 blocks, fwd+bwd); SP measured
        # wire-NEGATIVE under GSPMD (§Perf B1 refuted), so no SP discount.
        act_local = toks * act_bytes_tok / dp
        tp_ar = (4.0 * 2.0 * cfg.n_layers * act_local
                 * (tp - 1) / tp) if tp > 1 else 0.0
        if cfg.n_experts and tp > 1:
            # a2a-EP moves the routed-FFN sync off the activation path:
            # only the attention(+shared) block syncs remain (≈ half)
            tp_ar *= 0.5
        rs_mult = n_micro if rs_per_micro else 1     # §Perf iteration 3
        # grads reshard in bf16 (cast to f32 happens after the RS)
        zero_rs = 2.0 * n_active / tp * (dp - 1) / dp * rs_mult
        if fsdp:
            # weights all-gathered per pass (fwd, remat-recompute, bwd):
            # each chip receives the full bf16 params 3x per microbatch
            tp_ar = 3.0 * 2.0 * n_active * (dp - 1) / dp * n_micro
        zero_ag = 2.0 * n_active / tp * (dp - 1) / dp            # bf16 params
        a2a = 0.0
        if cfg.n_experts:
            pm_eff = mesh_shape.get("model", 1) if (tp > 1 or ep) else 1
            a2a = 3.0 * 2.0 * (toks / (dp if not ep else n_chips)) \
                * cfg.moe_top_k * cfg.d_model * 2 * (pm_eff - 1) / pm_eff
        wire = tp_ar + zero_rs + zero_ag + a2a
        detail = {"quad_flops": quad / n_chips, "tp_ar": tp_ar,
                  "zero_rs": zero_rs, "zero_ag": zero_ag, "moe_a2a": a2a,
                  "weights_hbm": 3 * w_local * n_micro, "act_hbm": act,
                  "opt_hbm": opt}
    elif shape.kind == "prefill":
        toks = b * s
        if cfg.is_encoder_decoder:                 # prefill = encode
            quad = _attn_quad_flops(cfg, b, s, causal=False) \
                * cfg.n_enc_layers
        else:
            quad = _attn_quad_flops(cfg, b, s) * _n_attn_layers(cfg)
        if cfg.family in ("ssm", "hybrid"):
            quad += _ssd_quad_flops(cfg, b, s) * cfg.n_layers
        # head only computes the last position's logits at prefill
        flops = (2.0 * n_block * toks + 2.0 * n_head * b + quad) / n_chips
        model_flops = flops
        w_local = 2.0 * n_active / tp
        act = 2.0 * cfg.n_layers * toks * act_bytes_tok / n_chips
        hbm = w_local + act
        act_local = toks * act_bytes_tok / dp
        wire = (2.0 * 2.0 * cfg.n_layers * act_local
                * (tp - 1) / tp) if tp > 1 else 0.0
        if cfg.n_experts and tp > 1:
            wire *= 0.5                                # a2a-EP (see train)
        if cfg.n_experts:
            wire += 2.0 * (toks / dp) * cfg.moe_top_k * cfg.d_model * 2 \
                * (tp - 1) / tp
        detail = {"quad_flops": quad / n_chips}
    else:                                           # decode: one token
        flops_tok = 2.0 * (n_block + n_head) * b
        # attention cache read flops: scores + PV over S per layer
        if cfg.family == "hybrid":
            n_attn = cfg.n_layers // max(cfg.attn_every, 1)
            cache_flops = 4.0 * b * s * cfg.n_heads * cfg.head_dim_ * n_attn
            cache_bytes = (2.0 * b * s * cfg.n_kv_heads * cfg.head_dim_
                           * 2 * n_attn)
            ssm_state = 4.0 * b * cfg.n_ssm_heads * cfg.ssm_state \
                * cfg.ssm_head_dim * cfg.n_layers
            cache_flops += ssm_state
            cache_bytes += ssm_state                # f32 state r/w ≈ flops sz
        elif cfg.family == "ssm":
            ssm_state = 4.0 * b * cfg.n_ssm_heads * cfg.ssm_state \
                * cfg.ssm_head_dim * cfg.n_layers
            cache_flops = ssm_state
            cache_bytes = 2.0 * ssm_state
        elif cfg.attn_kind == "mla":
            r = cfg.kv_lora_rank + cfg.qk_rope_dim
            # compressed cache re-expansion each step (the MLA trade)
            cache_flops = (2.0 * b * s * r * cfg.n_heads
                           * (cfg.qk_nope_dim + cfg.v_head_dim)
                           + 4.0 * b * s * cfg.n_heads
                           * (cfg.qk_nope_dim + cfg.qk_rope_dim))
            cache_bytes = 2.0 * b * s * r
        else:
            n_attn = _n_attn_layers(cfg) if not cfg.is_encoder_decoder \
                else cfg.n_layers * 2
            cache_flops = 4.0 * b * s * cfg.n_heads * cfg.head_dim_ * n_attn
            cache_bytes = (2.0 * b * s * cfg.n_kv_heads * cfg.head_dim_
                           * 2 * n_attn)
        flops = (flops_tok + cache_flops) / n_chips
        model_flops = 2.0 * n_active * b / n_chips
        hbm = 2.0 * n_active / tp + cache_bytes / n_chips \
            + b * cfg.n_layers * act_bytes_tok / n_chips
        # decode TP: 2 tiny ARs per layer + partial-softmax combine
        wire = (4.0 * cfg.n_layers * (b / dp) * act_bytes_tok
                * (tp - 1) / tp) if tp > 1 else 0.0
        detail = {"cache_flops": cache_flops / n_chips,
                  "cache_bytes": cache_bytes / n_chips}
    return CellCost(flops=flops, model_flops=model_flops, hbm_bytes=hbm,
                    wire_bytes=wire, detail=detail)
