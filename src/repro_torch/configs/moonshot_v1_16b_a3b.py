"""Moonlight-16B-A3B (kimi/moonshot) — DeepSeek-V3-style MoE, 64 experts top-6.

[hf:moonshotai/Moonlight-16B-A3B] 48L d_model=2048 16H (kv=16, MHA)
expert d_ff=1408 vocab=163840, MoE 64e top-6, 2 shared experts.

NOTE: the assignment table labels this arch "[dense]" but its spec carries
"MoE 64e top-6"; the underlying model card is a MoE, so we implement it as
MoE (see DESIGN.md §5 for the discrepancy note).
"""
from repro_torch.configs.base import ARCHS, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="moonshot-v1-16b-a3b",
    family="moe",
    source="hf:moonshotai/Moonlight-16B-A3B",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163_840,
    moe=MoEConfig(
        num_experts=64,
        num_experts_per_tok=6,
        expert_d_ff=1408,
        num_shared_experts=2,
        shared_d_ff=2816,
    ),
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=50_000.0,
)

ARCHS.register(CONFIG.arch_id)(CONFIG)
