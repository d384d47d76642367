"""Mamba2-1.3B — attention-free SSD (state-space duality) stack.

[arXiv:2405.21060] 48L d_model=2048 vocab=50280, ssm_state=128, attn-free.
"""
from repro_torch.configs.base import ARCHS, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="mamba2-1.3b",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=48,
    d_model=2048,
    num_heads=1,          # unused — attention-free
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,               # no MLP blocks: SSD block carries expansion
    vocab_size=50_280,
    ssm=SSMConfig(
        state_dim=128,
        head_dim=64,
        expand=2,
        conv_width=4,
        chunk_size=256,
        ngroups=1,
    ),
    activation="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
)

ARCHS.register(CONFIG.arch_id)(CONFIG)
