"""deepseek-coder-33b [arXiv:2401.14196] — llama-arch scale stressor.

62L d_model=7168 56H (GQA kv=8, head_dim 128) d_ff=19200 vocab 32256.
Requires ZeRO-1 + gradient accumulation + full remat to fit train_4k on a
v5e-256 slice (16 GB/chip).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=19_200, vocab_size=32_256,
    rope_theta=100_000.0,
)
