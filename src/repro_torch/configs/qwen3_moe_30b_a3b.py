"""Qwen3-30B-A3B — fine-grained MoE, 128 experts top-8, no shared expert.

[hf:Qwen/Qwen3-30B-A3B] 48L d_model=2048 32H (GQA kv=4) expert d_ff=768
vocab=151936. head_dim=128 (decoupled from d_model).
"""
from repro_torch.configs.base import ARCHS, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-30b-a3b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151_936,
    moe=MoEConfig(
        num_experts=128,
        num_experts_per_tok=8,
        expert_d_ff=768,
        num_shared_experts=0,
    ),
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
)

ARCHS.register(CONFIG.arch_id)(CONFIG)
