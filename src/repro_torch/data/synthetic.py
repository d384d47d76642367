"""Synthetic-alpha-beta federated dataset (Li et al. [22] construction).

Client i draws model (W_i, b_i): u_i ~ N(0, alpha); W_i ~ N(u_i, 1),
b_i ~ N(u_i, 1). Inputs x ~ N(v_i, Sigma) where v_i[j] ~ N(B_i, 1),
B_i ~ N(0, beta) and Sigma is diagonal with Sigma_jj = j^{-1.2}.
Labels y = argmax(softmax(W_i x + b_i)). (alpha, beta) = (1, 1) in the paper;
sample counts per client follow a power law.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

Dataset = Tuple[np.ndarray, np.ndarray]


def generate_synthetic(alpha: float = 1.0, beta: float = 1.0,
                       num_clients: int = 10, dim: int = 60,
                       num_classes: int = 10, base_samples: int = 256,
                       seed: int = 0) -> List[Dataset]:
    rng = np.random.default_rng(seed)
    # power-law sample counts (paper: "number of samples follows a power law")
    raw = rng.lognormal(mean=np.log(base_samples), sigma=0.7, size=num_clients)
    counts = np.maximum(64, raw.astype(int))
    sigma = np.diag(np.arange(1, dim + 1, dtype=np.float64) ** -1.2)

    datasets = []
    for i in range(num_clients):
        u = rng.normal(0.0, alpha)
        b_loc = rng.normal(0.0, beta)
        w = rng.normal(u, 1.0, size=(dim, num_classes))
        b = rng.normal(u, 1.0, size=(num_classes,))
        v = rng.normal(b_loc, 1.0, size=(dim,))
        x = rng.multivariate_normal(v, sigma, size=int(counts[i]))
        logits = x @ w + b
        y = np.argmax(logits, axis=-1)
        datasets.append((x.astype(np.float32), y.astype(np.int32)))
    return datasets


#: seed-sequence salt for the per-client lazy generator below — keeps the
#: per-index streams disjoint from every other derived stream in the repo
_CLIENT_SALT = 0x5EED_C11E


def generate_synthetic_client(client_id: int, alpha: float = 1.0,
                              beta: float = 1.0, dim: int = 60,
                              num_classes: int = 10,
                              base_samples: int = 256,
                              seed: int = 0) -> Dataset:
    """One client's Synthetic-alpha-beta dataset, derived from
    ``(seed, client_id)`` alone.

    The population engine (DESIGN.md §12) materializes clients lazily on
    first contact, in arrival order — so a client's data cannot come from
    a shared sequential stream (as :func:`generate_synthetic` draws it) or
    the draws would depend on *which other* clients happened to arrive
    first. Deriving each client's generator from ``(seed, client_id)``
    makes the dataset a pure function of the index: any subset of a
    million-client population can materialize in any order and always see
    the same rows.
    """
    rng = np.random.default_rng([seed, _CLIENT_SALT, int(client_id)])
    raw = rng.lognormal(mean=np.log(base_samples), sigma=0.7)
    count = max(64, int(raw))
    sigma = np.diag(np.arange(1, dim + 1, dtype=np.float64) ** -1.2)
    u = rng.normal(0.0, alpha)
    b_loc = rng.normal(0.0, beta)
    w = rng.normal(u, 1.0, size=(dim, num_classes))
    b = rng.normal(u, 1.0, size=(num_classes,))
    v = rng.normal(b_loc, 1.0, size=(dim,))
    x = rng.multivariate_normal(v, sigma, size=count)
    logits = x @ w + b
    y = np.argmax(logits, axis=-1)
    return x.astype(np.float32), y.astype(np.int32)


def train_test_split(datasets: List[Dataset], test_frac: float = 0.1,
                     seed: int = 0):
    """Paper 6.1: 'sample 10% of each dataset randomly for testing'."""
    rng = np.random.default_rng(seed)
    train, test_x, test_y = [], [], []
    for x, y in datasets:
        idx = rng.permutation(len(x))
        n_test = max(1, int(len(x) * test_frac))
        te, tr = idx[:n_test], idx[n_test:]
        train.append((x[tr], y[tr]))
        test_x.append(x[te])
        test_y.append(y[te])
    return train, (np.concatenate(test_x), np.concatenate(test_y))
