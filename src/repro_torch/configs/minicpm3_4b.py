"""minicpm3-4b [hf:openbmb/MiniCPM3-4B] — MLA (multi-head latent attention).

62L d_model=2560 40H d_ff=6400 vocab 73448. MLA ranks follow the release:
q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v_head=64 — decode caches
the COMPRESSED c_kv+k_rope (the technique's point; DESIGN.md §7).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab_size=73_448,
    attn_kind="mla", q_lora_rank=768, kv_lora_rank=256,
    qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
)
