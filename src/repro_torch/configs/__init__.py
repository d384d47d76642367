"""Configs: ``FedConfig``, the paper's three tasks, the simulation scenarios
and the ten assigned architectures (copies of the JAX package's, equal field
for field)."""
from repro_torch.configs.base import (ARCHS, SHAPES, FedConfig, MeshConfig,
                                      ModelConfig, MoEConfig, ShapeConfig,
                                      SSMConfig, reduced)
from repro_torch.configs.paper_tasks import (FEMNIST, PAPER_TASKS, SHAKESPEARE,
                                             SYNTHETIC_1_1, PaperTaskConfig)
from repro_torch.configs.shapes import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                        PREFILL_32K, TRAIN_4K)
from repro_torch.configs.scenarios import (FEMNIST_64, SCENARIOS,
                                           SYNTHETIC_1M, SYNTHETIC_256,
                                           SYNTHETIC_BURST, SYNTHETIC_DIURNAL,
                                           SYNTHETIC_TRACE)

# importing each module registers its CONFIG into ARCHS
from repro_torch.configs import (granite_34b,  # noqa: F401
                                 h2o_danube_1_8b, mamba2_1_3b,
                                 moonshot_v1_16b_a3b, musicgen_large,
                                 phi3_medium_14b, qwen2_moe_a2_7b,
                                 qwen2_vl_72b, qwen3_moe_30b_a3b,
                                 recurrentgemma_2b)

ALL_ARCH_IDS = tuple(ARCHS.names())


def get_arch(arch_id: str) -> ModelConfig:
    return ARCHS[arch_id]


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


__all__ = ["FedConfig", "PaperTaskConfig", "PAPER_TASKS", "SYNTHETIC_1_1",
           "FEMNIST", "SHAKESPEARE", "SCENARIOS", "SYNTHETIC_256",
           "FEMNIST_64", "SYNTHETIC_BURST", "SYNTHETIC_DIURNAL",
           "SYNTHETIC_TRACE", "SYNTHETIC_1M", "ARCHS", "ALL_ARCH_IDS",
           "ModelConfig", "MoEConfig", "SSMConfig", "get_arch", "reduced",
           "SHAPES", "ShapeConfig", "MeshConfig", "ALL_SHAPES", "TRAIN_4K",
           "PREFILL_32K", "DECODE_32K", "LONG_500K", "get_shape"]
