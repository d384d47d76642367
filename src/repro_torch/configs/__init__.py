"""Configs: ``FedConfig``, the paper's three tasks, the simulation scenarios
and the architectures the serving path runs (copies of the JAX package's,
equal field for field)."""
from repro_torch.configs.base import ARCHS, FedConfig, ModelConfig, reduced
from repro_torch.configs.paper_tasks import (FEMNIST, PAPER_TASKS, SHAKESPEARE,
                                             SYNTHETIC_1_1, PaperTaskConfig)
from repro_torch.configs.scenarios import (FEMNIST_64, SCENARIOS,
                                           SYNTHETIC_1M, SYNTHETIC_256,
                                           SYNTHETIC_BURST, SYNTHETIC_DIURNAL,
                                           SYNTHETIC_TRACE)

# importing each module registers its CONFIG into ARCHS
from repro_torch.configs import (h2o_danube_1_8b, mamba2_1_3b,  # noqa: F401
                                 recurrentgemma_2b)


def get_arch(arch_id: str) -> ModelConfig:
    return ARCHS[arch_id]


__all__ = ["FedConfig", "PaperTaskConfig", "PAPER_TASKS", "SYNTHETIC_1_1",
           "FEMNIST", "SHAKESPEARE", "SCENARIOS", "SYNTHETIC_256",
           "FEMNIST_64", "SYNTHETIC_BURST", "SYNTHETIC_DIURNAL",
           "SYNTHETIC_TRACE", "SYNTHETIC_1M", "ARCHS", "ModelConfig",
           "get_arch", "reduced"]
