"""Configs: ``FedConfig`` and the paper's three tasks (copies of the JAX
package's, equal field for field)."""
from repro_torch.configs.base import FedConfig
from repro_torch.configs.paper_tasks import (FEMNIST, PAPER_TASKS, SHAKESPEARE,
                                             SYNTHETIC_1_1, PaperTaskConfig)

__all__ = ["FedConfig", "PaperTaskConfig", "PAPER_TASKS", "SYNTHETIC_1_1",
           "FEMNIST", "SHAKESPEARE"]
