"""granite-moe-3b-a800m [hf:ibm-granite]. 32L d_model=1536 24H (GQA kv=8),
40 experts top-8, per-expert d_ff=512 (fine-grained), vocab 49155.
(The assignment line lists both "40e top-8" and "32 experts"; we follow the
config field: 40 experts.)"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab_size=49_155,
    n_experts=40, n_shared_experts=0, moe_top_k=8, moe_d_ff=512,
)
