"""Qwen1.5-MoE-A2.7B — 4 shared + 60 routed experts, top-4.

[hf:Qwen/Qwen1.5-MoE-A2.7B] 24L d_model=2048 16H (kv=16, MHA) expert
d_ff=1408 vocab=151936, MoE 60e top-4 + 4 shared experts (shared width 5632).
"""
from repro_torch.configs.base import ARCHS, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="qwen2-moe-a2.7b",
    family="moe",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151_936,
    qkv_bias=True,
    moe=MoEConfig(
        num_experts=60,
        num_experts_per_tok=4,
        expert_d_ff=1408,
        num_shared_experts=4,
        shared_d_ff=5632,
    ),
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
)

ARCHS.register(CONFIG.arch_id)(CONFIG)
