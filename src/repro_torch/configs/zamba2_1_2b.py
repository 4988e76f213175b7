"""zamba2-1.2b — Mamba2 backbone + ONE shared attention block applied every
6 mamba layers (params reused across applications) [arXiv:2411.15242].

38L d_model=2048, ssm_state=64 (d_inner 4096 -> 64 SSM heads), shared block:
32H MHA (kv=32, head_dim 64) + d_ff=8192 MLP, vocab 32000. Sub-quadratic:
runs long_500k (the 6 shared-attn KV caches shard seq over 'model').
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32_000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
    attn_every=6,
)
