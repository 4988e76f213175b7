"""whisper-base [arXiv:2212.04356] — encoder-decoder; conv frontend STUB.

6L enc + 6L dec, d_model=512 8H (MHA) d_ff=2048 vocab 51865, GELU+LayerNorm.
input_specs() provides precomputed frame embeddings (B, S_enc, d). The
assigned 4k/32k shapes exceed whisper's native 1500-frame window — run as a
config-stress deviation (DESIGN.md §7). Decoder length: 448 tokens (native).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab_size=51_865,
    is_encoder_decoder=True, n_enc_layers=6, dec_len=448,
    act="gelu", input_is_embeddings=True,
)
