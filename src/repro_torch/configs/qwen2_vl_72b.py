"""Qwen2-VL-72B — M-RoPE decoder with dynamic-resolution vision input.

[arXiv:2409.12191] 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
Backbone only: the ViT encoder is a stub — input_specs() provides precomputed
patch embeddings (vision_embed_dim=1280 -> linear projector -> d_model) that
are spliced over the first `max_patches` positions; M-RoPE assigns
(temporal, height, width) rotary components to those positions.
"""
from repro_torch.configs.base import ARCHS, ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-72b",
    family="vlm",
    source="arXiv:2409.12191",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152_064,
    mrope=True,
    qkv_bias=True,
    vision_embed_dim=1280,
    max_patches=1024,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
)

ARCHS.register(CONFIG.arch_id)(CONFIG)
