"""H2O-Danube-1.8B — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818] 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.
"""
from repro_torch.configs.base import ARCHS, ModelConfig

CONFIG = ModelConfig(
    arch_id="h2o-danube-1.8b",
    family="dense",
    source="arXiv:2401.16818",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32_000,
    sliding_window=4096,          # Mistral-style SWA — sub-quadratic decode
    long_context_window=4096,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
)

ARCHS.register(CONFIG.arch_id)(CONFIG)
