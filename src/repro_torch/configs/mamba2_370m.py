"""mamba2-370m — SSD state-space model [arXiv:2405.21060].

48L d_model=1024, attention-free, ssm_state=128, vocab 50280. d_inner =
2*d_model = 2048, head_dim 64 -> 32 SSM heads. Runs long_500k (linear-time).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=32, n_kv_heads=32,
    d_ff=0, vocab_size=50_280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
    attn_kind="none", tie_embeddings=True,
)
