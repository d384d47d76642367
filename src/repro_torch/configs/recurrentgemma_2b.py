"""RecurrentGemma-2B — Griffin hybrid: RG-LRU + local attention, 1:2 ratio.

[arXiv:2402.19427] 26L d_model=2560 10H (GQA kv=1, i.e. MQA) d_ff=7680
vocab=256000. Block pattern repeats (rglru, rglru, attn) — two recurrent
blocks per local-attention block; local attention window 2048.
"""
from repro_torch.configs.base import ARCHS, ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-2b",
    family="hybrid",
    source="arXiv:2402.19427",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    block_pattern=("rglru", "rglru", "attn"),
    rglru_width=2560,
    conv1d_width=4,
    sliding_window=2048,          # local attention — natively sub-quadratic
    long_context_window=2048,
    activation="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
    attn_logit_softcap=0.0,
    rope_theta=10000.0,
)

ARCHS.register(CONFIG.arch_id)(CONFIG)
