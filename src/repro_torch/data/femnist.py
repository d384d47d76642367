"""FEMNIST-like synthetic federated image data.

The container is offline, so we generate a *distribution-matched stand-in*:
62-class 28x28 images where each class is a distinct smooth template
(deterministic per class) plus per-writer (client) style shift — mimicking
FEMNIST's writer-partitioned non-IID structure. Classes are assigned to
clients with a Dirichlet prior to reproduce label skew.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

Dataset = Tuple[np.ndarray, np.ndarray]


def _class_template(cls: int, size: int = 28) -> np.ndarray:
    """A deterministic smooth pattern per class (sum of oriented gaussians)."""
    rng = np.random.default_rng(1000 + cls)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64) / size - 0.5
    img = np.zeros((size, size))
    for _ in range(3):
        cx, cy = rng.uniform(-0.3, 0.3, 2)
        sx, sy = rng.uniform(0.05, 0.2, 2)
        th = rng.uniform(0, np.pi)
        xr = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
        yr = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th)
        img += np.exp(-(xr ** 2 / (2 * sx ** 2) + yr ** 2 / (2 * sy ** 2)))
    return img / img.max()


def generate_femnist(num_clients: int = 10, num_classes: int = 62,
                     samples_per_client: int = 256, dirichlet_alpha: float = 0.5,
                     noise: float = 0.35, seed: int = 0) -> List[Dataset]:
    rng = np.random.default_rng(seed)
    templates = np.stack([_class_template(c) for c in range(num_classes)])
    datasets = []
    for i in range(num_clients):
        # label skew: Dirichlet class mixture per client (writer)
        probs = rng.dirichlet(np.full(num_classes, dirichlet_alpha))
        n = int(rng.lognormal(np.log(samples_per_client), 0.4))
        n = max(96, n)
        ys = rng.choice(num_classes, size=n, p=probs)
        # writer style: per-client contrast/shift/noise level
        contrast = rng.uniform(0.7, 1.3)
        shift = rng.uniform(-0.1, 0.1)
        xs = templates[ys] * contrast + shift
        xs = xs + rng.normal(0, noise, xs.shape)
        xs = np.clip(xs, 0, 1).astype(np.float32)[..., None]   # NHWC
        datasets.append((xs, ys.astype(np.int32)))
    return datasets
