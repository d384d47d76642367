"""Configs: ``FedConfig``, the paper's three tasks and the simulation
scenarios (copies of the JAX package's, equal field for field)."""
from repro_torch.configs.base import FedConfig
from repro_torch.configs.paper_tasks import (FEMNIST, PAPER_TASKS, SHAKESPEARE,
                                             SYNTHETIC_1_1, PaperTaskConfig)
from repro_torch.configs.scenarios import (FEMNIST_64, SCENARIOS,
                                           SYNTHETIC_256, SYNTHETIC_BURST,
                                           SYNTHETIC_DIURNAL, SYNTHETIC_TRACE)

__all__ = ["FedConfig", "PaperTaskConfig", "PAPER_TASKS", "SYNTHETIC_1_1",
           "FEMNIST", "SHAKESPEARE", "SCENARIOS", "SYNTHETIC_256",
           "FEMNIST_64", "SYNTHETIC_BURST", "SYNTHETIC_DIURNAL",
           "SYNTHETIC_TRACE"]
