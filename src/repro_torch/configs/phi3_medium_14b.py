"""Phi-3-Medium-14B — RoPE + SwiGLU + GQA dense decoder.

[arXiv:2404.14219] 40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
"""
from repro_torch.configs.base import ARCHS, ModelConfig

CONFIG = ModelConfig(
    arch_id="phi3-medium-14b",
    family="dense",
    source="arXiv:2404.14219",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100_352,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
)

ARCHS.register(CONFIG.arch_id)(CONFIG)
