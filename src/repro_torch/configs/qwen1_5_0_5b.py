"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B]. 24L d_model=1024 16H (kv=16),
d_ff=2816, vocab 151936 (divisible by 16*128 -> shards cleanly), QKV bias."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab_size=151_936,
    qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=True,
)
