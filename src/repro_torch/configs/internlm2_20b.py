"""internlm2-20b [arXiv:2403.17297]. 48L d_model=6144 48H (GQA kv=8,
head_dim 128) d_ff=16384 vocab 92544. kv=8 < model-axis 16 -> KV replicates
over half the tensor axis (collective-bound candidate; DESIGN.md §7)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16_384, vocab_size=92_544,
    rope_theta=1_000_000.0,
)
