"""One config dataclass for the whole LM zoo: the port's copy of
``src/repro/models/config.py``.

The same fields, defaults and derived properties. ``dtype`` returns a
``torch.dtype``. ``scan_unroll`` and ``seq_parallel`` are knobs of the
reference's dry-run and GSPMD lowering: the port accepts them and they
change nothing here.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["ModelConfig"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int | None = None    # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    attn_kind: str = "gqa"         # gqa | mla | none
    # MLA (minicpm3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0              # per-expert hidden (fine-grained)
    capacity_factor: float = 1.25
    # expert stacks pad to this multiple so they shard over the model axis
    # (Megatron-style padding; dead experts are never routed to)
    expert_pad_multiple: int = 16

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    conv_width: int = 4
    attn_every: int = 0            # hybrid: shared attn block cadence

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    dec_len: int = 448             # decoder length for train/prefill shapes

    input_is_embeddings: bool = False  # vlm/audio frontend stubs
    act: str = "silu"              # silu (swiglu) | gelu (plain mlp)

    param_dtype: str = "bfloat16"
    # vocab padding multiple for clean model-axis sharding (Megatron-style)
    vocab_pad_multiple: int = 2048
    # unroll the layer scan (dry-run calibration only: XLA HloCostAnalysis
    # counts while bodies once, so rolled scans under-report FLOPs)
    scan_unroll: bool = False
    remat: str = "full"            # full | none
    seq_parallel: bool = False     # SP residual: measured wire-NEGATIVE
                                   # under GSPMD (§Perf B1, refuted) — off

    # -- derived -----------------------------------------------------------

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def dtype(self):
        return getattr(torch, self.param_dtype)

    @property
    def padded_experts(self) -> int:
        if not self.n_experts:
            return 0
        return _round_up(self.n_experts, self.expert_pad_multiple)

    @property
    def d_inner(self) -> int:      # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (DESIGN.md §7)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True                # all 10 archs have an AR decoder

    def param_count(self) -> int:
        """Analytic parameter count (roofline MODEL_FLOPS uses this)."""
        d, v = self.d_model, self.padded_vocab
        n = v * d                                   # embed
        if not self.tie_embeddings:
            n += v * d                              # head
        if self.family in ("ssm", "hybrid"):
            di, ns, g = self.d_inner, self.ssm_state, self.ssm_groups
            per = d * (2 * di + 2 * g * ns + self.n_ssm_heads) \
                + di * d + self.conv_width * (di + 2 * g * ns) \
                + 2 * self.n_ssm_heads + di + 2 * d
            n += self.n_layers * per
            if self.attn_every:                     # one shared attn block
                hd = self.head_dim_
                n += d * (self.n_heads + 2 * self.n_kv_heads) * hd \
                    + self.n_heads * hd * d + 2 * d \
                    + 3 * d * self.d_ff             # its mlp
        else:
            hd = self.head_dim_
            if self.attn_kind == "mla":
                attn = d * self.q_lora_rank \
                    + self.q_lora_rank * self.n_heads * (
                        self.qk_nope_dim + self.qk_rope_dim) \
                    + d * (self.kv_lora_rank + self.qk_rope_dim) \
                    + self.kv_lora_rank * self.n_heads * (
                        self.qk_nope_dim + self.v_head_dim) \
                    + self.n_heads * self.v_head_dim * d
            else:
                attn = d * (self.n_heads + 2 * self.n_kv_heads) * hd \
                    + self.n_heads * hd * d
            if self.n_experts:
                ff = self.padded_experts * 3 * d * self.moe_d_ff \
                    + self.n_shared_experts * 3 * d * self.moe_d_ff \
                    + d * self.padded_experts
            else:
                mult = 3 if self.act == "silu" else 2
                ff = mult * d * self.d_ff
            n += self.n_layers * (attn + ff + 2 * d)
            if self.is_encoder_decoder:
                # encoder blocks + decoder cross-attn
                enc = self.n_enc_layers * (attn + 2 * d * self.d_ff + 2 * d)
                n += enc + self.n_layers * (attn + d)
        return int(n)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: routed top-k + shared only)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        routed_all = self.n_layers * self.padded_experts * 3 * self.d_model \
            * self.moe_d_ff
        routed_active = self.n_layers * self.moe_top_k * 3 * self.d_model \
            * self.moe_d_ff
        return int(full - routed_all + routed_active)
