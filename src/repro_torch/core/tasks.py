"""The task substrate: one local-training abstraction for the models the
port can federate.

A :class:`LocalTask` owns model init, the local loss, evaluation metrics,
the per-client data sampler, the dataset loaders (the whole roster, or one
client at a time for the population engine) and the footprint estimates of
the memory-budget planner; the client, the cohort engine and the simulator
are generic over it. This slice has :class:`PaperTask` — the
paper's MLP/CNN/LSTM over its three datasets. The assigned-architecture
task of the JAX package is a later slice of the port.

Batches are ``(inputs, targets)`` tensor pairs on the run's device; the data
layer stays numpy (byte-equal to the reference) and :meth:`to_device` moves
a batch across.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.configs.paper_tasks import PAPER_TASKS, PaperTaskConfig
from repro_torch.data.pipeline import (MiniBatcher, _synthetic_alpha_beta,
                                       load_task_datasets)
from repro_torch.data.synthetic import (generate_synthetic,
                                        generate_synthetic_client)
from repro_torch.models import small
from repro_torch.utils.device import as_tensor

PyTree = Any
Batch = Tuple[Any, Any]          # (inputs, targets)


class LocalTask:
    """Protocol of the task substrate.

    * ``init(generator, device)`` — fresh parameter tree.
    * ``loss(params, batch, prox=None)`` — scalar local loss (Eq. 2's
      objective); ``prox=(mu, anchor)`` adds the FedProx term.
    * ``eval_metrics(params, batch)`` — ``(accuracy, loss)`` tensors.
    * ``load_data(fed, seed)`` — ``(per-client datasets, eval batch)``, numpy.
    * ``load_population_data(fed, seed)`` — ``(client_data_fn, eval
      batch)`` for the population engine: ``client_data_fn(idx)`` makes
      client ``idx``'s dataset from ``(seed, idx)`` alone.
    * ``make_batcher(dataset, batch_size, seed)`` — the per-client sampler
      (``next()`` / ``next_stacked(k)``).
    * ``num_samples(dataset)`` — FedAvg weighting.
    * ``batch_bytes(fed)`` / ``activation_bytes(fed)`` — one step's batch
      and one client's activation estimate, for the memory-budget planner
      (``repro_torch.core.budget``).
    """

    kind = "task"

    @property
    def name(self) -> str:
        raise NotImplementedError

    @property
    def fed(self) -> FedConfig:
        raise NotImplementedError

    def init(self, generator: torch.Generator, device) -> PyTree:
        raise NotImplementedError

    def loss(self, params: PyTree, batch: Batch, prox=None):
        raise NotImplementedError

    def eval_metrics(self, params: PyTree, batch: Batch):
        raise NotImplementedError

    def load_data(self, fed: FedConfig, seed: int):
        raise NotImplementedError

    def load_population_data(self, fed: FedConfig, seed: int):
        """The population engine materializes clients lazily, so no list
        of ``fed.num_clients`` datasets may exist: a task without a
        per-client generator cannot run a population."""
        raise NotImplementedError(
            f"task {self.name!r} has no lazy per-client data generator; "
            f"population mode needs load_population_data")

    def make_batcher(self, dataset, batch_size: int, seed: int):
        raise NotImplementedError

    def num_samples(self, dataset) -> int:
        raise NotImplementedError

    def batch_bytes(self, fed: FedConfig) -> int:
        raise NotImplementedError

    def activation_bytes(self, fed: FedConfig) -> int:
        raise NotImplementedError

    @staticmethod
    def to_device(batch, device: torch.device) -> Batch:
        x, y = batch
        return as_tensor(x, device), as_tensor(y, device)


@dataclasses.dataclass(frozen=True)
class PaperTask(LocalTask):
    """The paper's own tasks (Synthetic-1-1 / FEMNIST / Shakespeare)."""

    cfg: PaperTaskConfig

    kind = "paper"

    @property
    def name(self) -> str:
        return self.cfg.name

    @property
    def fed(self) -> FedConfig:
        return self.cfg.fed

    def init(self, generator, device) -> PyTree:
        return small.init_task_model(self.cfg, generator, device)

    def loss(self, params, batch, prox=None):
        return small.task_loss(self.cfg, params, batch, prox=prox)

    def eval_metrics(self, params, batch):
        return (small.task_accuracy(self.cfg, params, batch),
                small.task_loss(self.cfg, params, batch))

    def load_data(self, fed: FedConfig, seed: int):
        return load_task_datasets(self.cfg, seed=seed)

    def load_population_data(self, fed: FedConfig, seed: int):
        """Synthetic tasks only: client ``idx``'s rows come from ``(seed,
        idx)`` (``data.synthetic.generate_synthetic_client``), so a
        million-client population allocates nothing until a client first
        checks in. The eval batch is eight held-out pseudo-clients drawn
        with the salted seed ``seed + 61_981``, O(1) in the population."""
        if not self.cfg.name.startswith("synthetic"):
            return super().load_population_data(fed, seed)
        alpha, beta = _synthetic_alpha_beta(self.cfg.name)
        cfg = self.cfg

        def client_data(idx: int):
            return generate_synthetic_client(
                idx, alpha, beta, cfg.input_shape[0], cfg.num_classes,
                cfg.samples_per_client, seed)

        held_out = generate_synthetic(
            alpha, beta, num_clients=8, dim=cfg.input_shape[0],
            num_classes=cfg.num_classes,
            base_samples=cfg.samples_per_client, seed=seed + 61_981)
        eval_batch = (np.concatenate([x for x, _ in held_out]),
                      np.concatenate([y for _, y in held_out]))
        return client_data, eval_batch

    def make_batcher(self, dataset, batch_size: int, seed: int):
        return MiniBatcher(dataset, batch_size, seed=seed)

    def num_samples(self, dataset) -> int:
        return len(dataset[0])

    def batch_bytes(self, fed: FedConfig) -> int:
        feat = 1
        for d in self.cfg.input_shape:
            feat *= d
        # f32 features + integer labels
        return fed.local_batch_size * (feat * 4 + 8)

    def activation_bytes(self, fed: FedConfig) -> int:
        width = sum(self.cfg.hidden) + self.cfg.num_classes
        # forward + backward intermediates, the reference's 8x allowance
        return fed.local_batch_size * width * 4 * 8


def as_task(obj) -> LocalTask:
    """Coerce a task handle — a ``LocalTask``, a ``PaperTaskConfig`` or a
    paper-task name — to a :class:`LocalTask`."""
    if isinstance(obj, LocalTask):
        return obj
    if isinstance(obj, PaperTaskConfig):
        return PaperTask(cfg=obj)
    if isinstance(obj, str) and obj in PAPER_TASKS:
        return PaperTask(cfg=PAPER_TASKS[obj])
    raise TypeError(f"cannot interpret {obj!r} as a LocalTask (this slice of "
                    "the port has the paper tasks only; the architecture "
                    "tasks are ROADMAP.md A18)")
