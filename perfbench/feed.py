"""Seeded token batches, made by the benchmark and handed to both the port
and the plain reference.

Each client reads its own stream, drawn from ``(seed, client)``; the
evaluation batch is a stream of its own. Token ids follow a Zipf law over
the vocabulary (the exponent is the traffic file's), and each row's labels
are its tokens shifted left by one, the last label wrapping to the row's
first token, as the port's arch task trains. A stream has the port's
batcher interface (``next()``, ``next_stacked(k)``), so the port's clients
read it in place of their own.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

_EVAL_STREAM = -1
_SALT = 0x5EED


def zipf_probs(vocab: int, exponent: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -exponent
    return p / p.sum()


class TokenStream:
    """One stream of ``(inputs, labels)`` batches of ``rows x seq`` tokens."""

    def __init__(self, seed: int, stream: int, vocab: int, rows: int,
                 seq: int, exponent: float):
        self.rng = np.random.default_rng([int(seed), _SALT, stream + 1])
        self.cdf = np.cumsum(zipf_probs(vocab, exponent))
        self.vocab, self.rows, self.seq = vocab, rows, seq

    def next(self) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        u = self.rng.random((self.rows, self.seq))
        toks = np.minimum(np.searchsorted(self.cdf, u, side="right"),
                          self.vocab - 1).astype(np.int32)
        return {"tokens": toks}, np.roll(toks, -1, axis=-1)

    def next_stacked(self, k: int):
        """k batches stacked along a leading step axis, as k ``next()``."""
        draws = [self.next() for _ in range(k)]
        return ({"tokens": np.stack([d[0]["tokens"] for d in draws])},
                np.stack([d[1] for d in draws]))


def client_stream(seed: int, client: int, cfg: dict, traffic: dict
                  ) -> TokenStream:
    return TokenStream(seed, client, cfg["vocab_size"], traffic["rows"],
                       traffic["seq_len"], traffic["zipf_exponent"])


def eval_stream(seed: int, cfg: dict, traffic: dict) -> TokenStream:
    return TokenStream(seed, _EVAL_STREAM, cfg["vocab_size"],
                       traffic["rows"], traffic["seq_len"],
                       traffic["zipf_exponent"])
