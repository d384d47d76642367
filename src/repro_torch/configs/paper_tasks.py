"""The paper's own three federated tasks (§6.1 / Appendix B.1).

Synthetic-1-1 -> 3-layer MLP; FEMNIST -> 2-conv CNN; Shakespeare -> LSTM.
Hyperparameters follow Appendix B.4 (grid-search selected values).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.configs.base import FedConfig
from repro_torch.utils.registry import Registry

PAPER_TASKS: Registry = Registry("paper task")


@dataclasses.dataclass(frozen=True)
class PaperTaskConfig:
    name: str
    model: str                     # mlp | cnn | lstm
    input_shape: Tuple[int, ...]
    num_classes: int
    hidden: Tuple[int, ...]
    num_clients: int = 10
    samples_per_client: int = 256  # power-law scaled
    fed: FedConfig = FedConfig()


SYNTHETIC_1_1 = PaperTaskConfig(
    name="synthetic-1-1",
    model="mlp",
    input_shape=(60,),
    num_classes=10,
    hidden=(64, 32),
    fed=FedConfig(lam=5.0, eps=5.0, gamma_bar=3.0, kappa=1.0,
                  local_lr=0.01, local_momentum=0.5, k_initial=10),
)

FEMNIST = PaperTaskConfig(
    name="femnist",
    model="cnn",
    input_shape=(28, 28, 1),
    num_classes=62,
    hidden=(32, 64),               # conv channels
    fed=FedConfig(lam=1.0, eps=1.0, gamma_bar=3.0, kappa=0.05,
                  local_lr=0.01, local_momentum=0.5, k_initial=10),
)

SHAKESPEARE = PaperTaskConfig(
    name="shakespeare",
    model="lstm",
    input_shape=(80,),             # sequence of char ids
    num_classes=90,                # char vocabulary
    hidden=(64, 64),               # embed dim, lstm hidden
    fed=FedConfig(lam=5.0, eps=10.0, gamma_bar=3.0, kappa=1.0,
                  local_lr=0.1, local_momentum=0.5, k_initial=10),
)

for _t in (SYNTHETIC_1_1, FEMNIST, SHAKESPEARE):
    PAPER_TASKS.register(_t.name)(_t)
