"""deepseek-moe-16b — fine-grained MoE [arXiv:2401.06066].

28L d_model=2048 16H (kv=16, MHA) vocab 102400; 64 routed experts top-6 +
2 shared, per-expert d_ff=1408. (Paper's layer-0 dense FFN simplified to
MoE-everywhere; noted in DESIGN.md.) The paper-representative hillclimb
cell: power-law expert load == power-law word load.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=102_400,
    n_experts=64, n_shared_experts=2, moe_top_k=6, moe_d_ff=1408,
)
