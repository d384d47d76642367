"""Shakespeare-like synthetic federated character-LM data.

Offline stand-in for LEAF Shakespeare: each client is a "role" with its own
character-level Markov source (distinct transition matrix, shared alphabet of
90 symbols) — naturally non-IID next-character prediction, like dialog lines
partitioned per role. Sequences are length-80 windows, label = next char.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

Dataset = Tuple[np.ndarray, np.ndarray]
VOCAB = 90
SEQ_LEN = 80


def _role_source(rng: np.random.Generator, vocab: int, order_bias: float):
    """Sparse stochastic matrix: each char strongly prefers ~6 successors."""
    trans = rng.dirichlet(np.full(vocab, 0.05), size=vocab)
    # mix with a shared "English-like" backbone so roles overlap partially
    backbone = rng.dirichlet(np.full(vocab, 0.3))
    return (1 - order_bias) * trans + order_bias * backbone[None, :]


def generate_shakespeare(num_clients: int = 10, samples_per_client: int = 256,
                         seed: int = 0) -> List[Dataset]:
    rng = np.random.default_rng(seed)
    backbone_rng = np.random.default_rng(seed + 777)
    shared = backbone_rng.dirichlet(np.full(VOCAB, 0.3))
    datasets = []
    for i in range(num_clients):
        role_rng = np.random.default_rng(seed * 1009 + i)
        trans = _role_source(role_rng, VOCAB, order_bias=0.3)
        n = max(96, int(rng.lognormal(np.log(samples_per_client), 0.4)))
        text_len = n + SEQ_LEN + 1
        chars = np.empty(text_len, np.int32)
        chars[0] = role_rng.integers(VOCAB)
        for t in range(1, text_len):
            chars[t] = role_rng.choice(VOCAB, p=trans[chars[t - 1]])
        xs = np.lib.stride_tricks.sliding_window_view(chars[:-1], SEQ_LEN)[:n]
        ys = chars[SEQ_LEN:SEQ_LEN + n]
        datasets.append((xs.astype(np.int32), ys.astype(np.int32)))
    del shared
    return datasets
