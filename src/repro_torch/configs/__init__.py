"""Configs: ``FedConfig``, the paper's three tasks, the simulation scenarios
and the ten assigned architectures (copies of the JAX package's, equal field
for field)."""
from repro_torch.configs.base import (ARCHS, FedConfig, ModelConfig,
                                      MoEConfig, SSMConfig, reduced)
from repro_torch.configs.paper_tasks import (FEMNIST, PAPER_TASKS, SHAKESPEARE,
                                             SYNTHETIC_1_1, PaperTaskConfig)
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


__all__ = ["FedConfig", "PaperTaskConfig", "PAPER_TASKS", "SYNTHETIC_1_1",
           "FEMNIST", "SHAKESPEARE", "SCENARIOS", "SYNTHETIC_256",
           "FEMNIST_64", "SYNTHETIC_BURST", "SYNTHETIC_DIURNAL",
           "SYNTHETIC_TRACE", "SYNTHETIC_1M", "ARCHS", "ALL_ARCH_IDS",
           "ModelConfig", "MoEConfig", "SSMConfig", "get_arch", "reduced"]
