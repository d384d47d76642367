"""MusicGen-Large — decoder-only transformer over EnCodec audio tokens.

[arXiv:2306.05284] 48L d_model=2048 32H (GQA kv=32, i.e. MHA) d_ff=8192
vocab=2048. Backbone only: the EnCodec conv codec is a stub — input_specs()
provides the 4 codebook token streams (delay-pattern interleave), embeddings
are summed over codebooks and there is one output head per codebook.
"""
from repro_torch.configs.base import ARCHS, ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen-large",
    family="audio",
    source="arXiv:2306.05284",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    num_codebooks=4,
    activation="gelu",
    norm="layernorm",
    rope_theta=10000.0,           # sinusoidal in the paper; RoPE-adapted here
)

ARCHS.register(CONFIG.arch_id)(CONFIG)
