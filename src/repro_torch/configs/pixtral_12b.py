"""pixtral-12b [hf:mistralai/Pixtral-12B-2409] — vision-language backbone.

The decoder is mistral-nemo-style: 40L d_model=5120 32H (GQA kv=8,
head_dim=128 -> attn dim 4096) d_ff=14336 vocab 131072. The pixtral-ViT
frontend is a STUB per the assignment: input_specs() provides precomputed
patch embeddings (B, S, d_model); training consumes embeddings directly.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    head_dim=128, d_ff=14_336, vocab_size=131_072,
    rope_theta=1_000_000_000.0, input_is_embeddings=True,
)
