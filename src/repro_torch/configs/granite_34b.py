"""Granite-34B-Code — deep llama-arch MQA code model.

[arXiv:2405.04324] 88L d_model=6144 48H (GQA kv=1, i.e. MQA) d_ff=24576
vocab=49152.
"""
from repro_torch.configs.base import ARCHS, ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-34b",
    family="dense",
    source="arXiv:2405.04324",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49_152,
    activation="gelu",            # granite-34b-code uses gpt-bigcode-style MLP
    norm="layernorm",
    tie_embeddings=True,
    rope_theta=10000.0,
)

ARCHS.register(CONFIG.arch_id)(CONFIG)
