"""The task substrate: one local-training abstraction for every model the
port can federate.

A :class:`LocalTask` owns model init, the local loss, evaluation metrics,
the per-client data sampler, the dataset loaders (the whole roster, or one
client at a time for the population engine) and the footprint estimates of
the memory-budget planner; the client, the cohort engine and the simulator
are generic over it. Two implementations, as in the JAX package:

* :class:`PaperTask` — the paper's MLP/CNN/LSTM over its three datasets;
* :class:`ArchTask` — an assigned :class:`~repro_torch.configs.base.
  ModelConfig` architecture (``models.model.forward``) over synthetic Zipf
  token streams (``data.pipeline.TokenBatcher``), reduced by default.

Batches are ``(inputs, targets)`` pairs on the run's device, where
``inputs`` is a tensor (paper tasks) or a dict of tensors (``{"tokens":
...}`` for the arch tasks); the data layer stays numpy (byte-equal to the
reference) and :meth:`LocalTask.to_device` moves a batch across.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import (ARCHS, FedConfig, ModelConfig,
                                      ShapeConfig, reduced)
from repro_torch.configs.paper_tasks import PAPER_TASKS, PaperTaskConfig
from repro_torch.configs.scenarios import (ARCH_FED_BASELINE, SCENARIOS,
                                           ArchScenarioConfig)
from repro_torch.configs.shapes import TRAIN_4K
from repro_torch.data.pipeline import (MiniBatcher, TokenBatcher,
                                       _synthetic_alpha_beta,
                                       load_task_datasets)
from repro_torch.data.synthetic import (generate_synthetic,
                                        generate_synthetic_client)
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import small
from repro_torch.utils import pytree as pt
from repro_torch.utils.device import as_tensor

PyTree = Any
Batch = Tuple[Any, Any]          # (inputs, targets)


def _prox_term(params: PyTree, prox: Optional[Tuple[float, PyTree]]):
    """FedProx proximal penalty (Eq. 39), ``0.5 * mu * ||p - anchor||^2``
    summed leaf by leaf in the reference's leaf order."""
    if prox is None:
        return 0.0
    mu, anchor = prox
    sq = sum(torch.sum(torch.square(a - b)) for a, b in zip(
        pt.tree_leaves(params), pt.tree_leaves(anchor)))
    return 0.5 * mu * sq


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
        """A numpy ``(inputs, targets)`` batch on ``device``; ``inputs`` may
        be a dict of arrays (the arch tasks' token dicts)."""
        x, y = batch
        if isinstance(x, dict):
            x = {k: as_tensor(v, device) for k, v in x.items()}
        else:
            x = as_tensor(x, device)
        return x, as_tensor(y, device)


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


@dataclasses.dataclass(frozen=True)
class ArchTask(LocalTask):
    """An assigned :class:`ModelConfig` architecture behind the substrate:
    ``models.model.forward`` train steps over synthetic Zipf token streams.
    Use :func:`arch_task` to build the reduced smoke variant."""

    cfg: ModelConfig
    shape: ShapeConfig
    q_chunk: int = 32
    kv_chunk: int = 32
    #: a scenario's FedConfig (``configs.scenarios`` arch scenarios); None
    #: means the arch baseline, ``configs.scenarios.ARCH_FED_BASELINE``
    fed_cfg: Optional[FedConfig] = None

    kind = "arch"

    @property
    def name(self) -> str:
        return f"arch:{self.cfg.arch_id}"

    @property
    def fed(self) -> FedConfig:
        return self.fed_cfg if self.fed_cfg is not None else ARCH_FED_BASELINE

    def init(self, generator, device) -> PyTree:
        """Params drawn from ``generator`` on its device, then moved to
        ``device``."""
        return pt.tree_map(lambda t: t.to(device),
                           M.init_model(generator, self.cfg))

    def _logits_labels(self, params, batch):
        """Logits, the MoE aux loss and the labels in the logits' layout:
        an audio model's (B, Q, S) labels become (B, S, Q), as its logits
        are (B, S, Q, V)."""
        inputs, labels = batch
        logits, aux, _ = M.forward(params, inputs["tokens"], self.cfg,
                                   patch_embeds=inputs.get("patch_embeds"),
                                   remat=False, q_chunk=self.q_chunk,
                                   kv_chunk=self.kv_chunk)
        if self.cfg.family == "audio":
            labels = labels.permute(0, 2, 1)
        return logits, aux, labels

    def loss(self, params, batch, prox=None):
        logits, aux, labels = self._logits_labels(params, batch)
        return L.cross_entropy(logits, labels) + aux + _prox_term(params,
                                                                   prox)

    def eval_metrics(self, params, batch):
        logits, aux, labels = self._logits_labels(params, batch)
        acc = torch.mean((torch.argmax(logits, dim=-1) == labels).float())
        return acc, L.cross_entropy(logits, labels) + aux

    def load_data(self, fed: FedConfig, seed: int):
        """Client i's "dataset" is its stream id: the sampler is generative,
        seeded per client by :meth:`make_batcher`. The eval batch is one
        draw of the stream seeded ``seed + 131_071``."""
        eval_batch = TokenBatcher(self.cfg, self.shape,
                                  seed=seed + 131_071).next()
        return list(range(fed.num_clients)), eval_batch

    def load_population_data(self, fed: FedConfig, seed: int):
        _, eval_batch = self.load_data(
            dataclasses.replace(fed, num_clients=1), seed)
        return (lambda idx: idx), eval_batch

    def make_batcher(self, dataset, batch_size: int, seed: int):
        """The batch is ``shape.global_batch x shape.seq_len`` tokens;
        ``batch_size`` (the paper tasks' knob) is ignored, as in the
        reference."""
        return TokenBatcher(self.cfg, self.shape, seed=seed)

    def num_samples(self, dataset) -> int:
        return self.shape.global_batch

    def batch_bytes(self, fed: FedConfig) -> int:
        """int32 tokens and labels (one stream per codebook for audio),
        plus a vlm's f32 patch embeddings."""
        b, s = self.shape.global_batch, self.shape.seq_len
        ncb = self.cfg.num_codebooks if self.cfg.family == "audio" else 1
        n = 2 * b * ncb * s * 4
        if self.cfg.family == "vlm" and self.cfg.max_patches:
            n += (b * min(self.cfg.max_patches, s)
                  * self.cfg.vision_embed_dim * 4)
        return n

    def activation_bytes(self, fed: FedConfig) -> int:
        """The reference's estimate: twelve f32 residual-stream tensors per
        layer, forward and backward, plus the (B, S, V) logits pair."""
        b, s = self.shape.global_batch, self.shape.seq_len
        per_layer = b * s * self.cfg.d_model * 4 * 12
        logits = 2 * b * s * self.cfg.vocab_size * 4
        return per_layer * self.cfg.num_layers + logits


def _arch_config(arch) -> ModelConfig:
    """The registered config of an arch id (``KeyError`` for an unknown one,
    as the registry raises), or of a ``ModelConfig``'s id; an unregistered
    ``ModelConfig`` is taken as it is."""
    if isinstance(arch, ModelConfig):
        return ARCHS[arch.arch_id] if arch.arch_id in ARCHS else arch
    return ARCHS[arch]


def arch_task(arch_id, *, seq_len: int = 64, global_batch: int = 4,
              num_layers: int = 2, d_model: int = 256,
              full_scale: bool = False,
              fed: Optional[FedConfig] = None) -> ArchTask:
    """An :class:`ArchTask` for a registered architecture (an id, or its
    ``ModelConfig``).

    The default is the reduced smoke scale of the reference's
    ``launch/train.py``: ``configs.reduced`` (<=2 layers, d_model<=512),
    dense MoE dispatch, f32, seq_len 64 x batch 4. ``full_scale=True``
    keeps the assigned config as it is.
    """
    cfg = _arch_config(arch_id)
    if not full_scale:
        cfg = reduced(cfg, num_layers=num_layers, d_model=d_model)
        if cfg.moe is not None:
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, impl="dense"))
        cfg = dataclasses.replace(cfg, dtype="float32")
    shape = dataclasses.replace(TRAIN_4K, seq_len=seq_len,
                                global_batch=global_batch)
    return ArchTask(cfg=cfg, shape=shape, fed_cfg=fed)


def as_task(obj) -> LocalTask:
    """Coerce a task handle to a :class:`LocalTask`: a ``LocalTask`` (as it
    is), a ``PaperTaskConfig``, a ``ModelConfig`` (reduced), an
    ``ArchScenarioConfig``, a registered paper-task or scenario name, or,
    as the last resort, an arch id."""
    if isinstance(obj, LocalTask):
        return obj
    if isinstance(obj, PaperTaskConfig):
        return PaperTask(cfg=obj)
    if isinstance(obj, ModelConfig):
        return arch_task(obj)
    if isinstance(obj, ArchScenarioConfig):
        return arch_task(obj.arch_id, seq_len=obj.seq_len,
                         global_batch=obj.global_batch,
                         num_layers=obj.num_layers, d_model=obj.d_model,
                         fed=obj.fed)
    if isinstance(obj, str):
        if obj in PAPER_TASKS:
            return as_task(PAPER_TASKS[obj])
        if obj in SCENARIOS:
            return as_task(SCENARIOS[obj])
        return arch_task(obj)
    raise TypeError(f"cannot interpret {type(obj).__name__} as a LocalTask "
                    "(expected LocalTask, PaperTaskConfig, ModelConfig, "
                    "ArchScenarioConfig, or a registered name)")
