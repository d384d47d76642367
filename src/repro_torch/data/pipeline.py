"""Batching / sampling utilities and the large-arch token pipeline."""
from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.paper_tasks import PaperTaskConfig
from repro_torch.data.femnist import generate_femnist
from repro_torch.data.shakespeare import generate_shakespeare
from repro_torch.data.synthetic import generate_synthetic, train_test_split

Dataset = Tuple[np.ndarray, np.ndarray]


def _synthetic_alpha_beta(name: str) -> Tuple[float, float]:
    """Heterogeneity knobs from the paper's naming convention:
    "synthetic-<alpha>-<beta>" (e.g. "synthetic-1-1", "synthetic-0-0").
    Scenario names without the two-number suffix ("synthetic-256") use the
    paper's default (1, 1)."""
    parts = name.split("-")
    if len(parts) == 3:
        try:
            return float(parts[1]), float(parts[2])
        except ValueError:
            pass
    return 1.0, 1.0


def load_task_datasets(task: PaperTaskConfig, seed: int = 0):
    """Returns (per-client train datasets, global test set).

    Dispatches on the task-name prefix so scaled scenario variants of a
    paper task ("synthetic-256", "femnist-64", ...) reuse its generator.
    """
    if task.name.startswith("synthetic"):
        alpha, beta = _synthetic_alpha_beta(task.name)
        ds = generate_synthetic(alpha, beta, task.num_clients,
                                task.input_shape[0], task.num_classes,
                                task.samples_per_client, seed)
    elif task.name.startswith("femnist"):
        ds = generate_femnist(task.num_clients, task.num_classes,
                              task.samples_per_client, seed=seed)
    elif task.name.startswith("shakespeare"):
        ds = generate_shakespeare(task.num_clients, task.samples_per_client,
                                  seed=seed)
    else:
        raise ValueError(task.name)
    return train_test_split(ds, test_frac=0.1, seed=seed)


class MiniBatcher:
    """Deterministic with-replacement mini-batch sampler per client."""

    def __init__(self, dataset: Dataset, batch_size: int, seed: int):
        self.x, self.y = dataset
        self.batch_size = min(batch_size, len(self.x))
        self.rng = np.random.default_rng(seed)

    def next(self) -> Dataset:
        idx = self.rng.integers(0, len(self.x), size=self.batch_size)
        return self.x[idx], self.y[idx]

    def next_stacked(self, k: int) -> Dataset:
        """k mini-batches stacked along a leading step axis: (k, bs, ...).

        One ``(k, bs)`` draw consumes the PCG64 stream element-wise, so the
        indices AND the generator state afterwards are identical to k
        successive :meth:`next` calls (pinned by tests/test_cohort.py) —
        the loop and cohort client engines see byte-identical data while
        the cohort pays one RNG call and one gather instead of k."""
        idx = self.rng.integers(0, len(self.x), size=(k, self.batch_size))
        return self.x[idx], self.y[idx]


def dirichlet_partition(x: np.ndarray, y: np.ndarray, num_clients: int,
                        alpha: float = 0.5, seed: int = 0) -> List[Dataset]:
    """Label-skew non-IID partition of a centralized dataset."""
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    client_idx: List[List[int]] = [[] for _ in range(num_clients)]
    for c in classes:
        idx = np.flatnonzero(y == c)
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(num_clients, alpha))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for ci, part in enumerate(np.split(idx, cuts)):
            client_idx[ci].extend(part.tolist())
    out = []
    for ci in range(num_clients):
        sel = np.asarray(client_idx[ci], int)
        rng.shuffle(sel)
        out.append((x[sel], y[sel]))
    return out


# ---------------------------------------------------------------------------
# Token pipeline for the assigned large architectures
# ---------------------------------------------------------------------------


def _zipf_probs(vocab_size: int) -> np.ndarray:
    """Zipf over the vocab — realistic skew for embedding-gather patterns."""
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = ranks ** -1.1
    return probs / probs.sum()


def synthetic_token_stream(cfg: ModelConfig, shape: ShapeConfig, *,
                           num_batches: int = 1, seed: int = 0
                           ) -> Iterator[dict]:
    """Zipf-distributed synthetic token batches matching input_specs()."""
    rng = np.random.default_rng(seed)
    v = cfg.vocab_size
    probs = _zipf_probs(v)
    for _ in range(num_batches):
        if cfg.family == "audio":
            toks = rng.choice(v, p=probs,
                              size=(shape.global_batch, cfg.num_codebooks,
                                    shape.seq_len))
        else:
            toks = rng.choice(v, p=probs, size=(shape.global_batch, shape.seq_len))
        batch = {"tokens": toks.astype(np.int32)}
        if shape.kind == "train":
            batch["labels"] = np.roll(batch["tokens"], -1, axis=-1)
        if cfg.family == "vlm" and cfg.max_patches:
            npatch = min(cfg.max_patches, shape.seq_len)
            batch["patch_embeds"] = rng.normal(
                0, 1, (shape.global_batch, npatch, cfg.vision_embed_dim)
            ).astype(np.float32)
        yield batch


class TokenBatcher:
    """Per-client token-stream sampler for the arch tasks, with the
    :class:`MiniBatcher` interface the client engines rely on.

    Batches are the substrate's ``(inputs, targets)`` pairs: ``inputs`` is
    a dict (``tokens`` plus ``patch_embeds`` for VLM fronts) so stacked
    cohort layouts treat paper rows and multimodal token batches alike.
    ``next_stacked(k)`` draws exactly ``k`` successive :meth:`next`
    batches, so the generator state afterwards is identical to k ``next``
    calls — the loop / cohort / sharded engines cannot fork a client's
    data stream (same contract MiniBatcher pins in tests/test_cohort.py).
    """

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int):
        self.cfg = cfg
        self.shape = shape
        self.rng = np.random.default_rng(seed)
        self._probs = _zipf_probs(cfg.vocab_size)

    def next(self):
        cfg, shape = self.cfg, self.shape
        if cfg.family == "audio":
            size = (shape.global_batch, cfg.num_codebooks, shape.seq_len)
        else:
            size = (shape.global_batch, shape.seq_len)
        toks = self.rng.choice(cfg.vocab_size, p=self._probs,
                               size=size).astype(np.int32)
        inputs = {"tokens": toks}
        if cfg.family == "vlm" and cfg.max_patches:
            npatch = min(cfg.max_patches, shape.seq_len)
            inputs["patch_embeds"] = self.rng.normal(
                0, 1, (shape.global_batch, npatch, cfg.vision_embed_dim)
            ).astype(np.float32)
        return inputs, np.roll(toks, -1, axis=-1)

    def next_stacked(self, k: int):
        """k batches stacked along a leading step axis, leafwise."""
        draws = [self.next() for _ in range(k)]
        inputs = {key: np.stack([d[0][key] for d in draws])
                  for key in draws[0][0]}
        return inputs, np.stack([d[1] for d in draws])
