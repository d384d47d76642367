"""The AsyncFedED rule followed exactly over a pool of deltas.

When every delta is one of a pool's vectors P_1 .. P_J, every model the
server holds is x_1 + sum_j c_j P_j, and the rule needs nothing but the
coefficients c: the distance of two models is sqrt(dc' G dc) and a
delta's norm sqrt(G_jj), with G the pool's Gram matrix, taken here in
float64. So the reference follows every update of a run in float64, with
no rounding of its own in the models, and rebuilds the final model once.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from perfbench.reference.rule import RuleParams, Server

_BLOCK = 1 << 24


def gram(pool: torch.Tensor) -> np.ndarray:
    """(J, J) float64 Gram matrix of the pool's rows, summed in blocks."""
    g = torch.zeros((pool.shape[0],) * 2, dtype=torch.float64,
                    device=pool.device)
    for lo in range(0, pool.shape[1], _BLOCK):
        blk = pool[:, lo:lo + _BLOCK].double()
        g += blk @ blk.T
    return g.cpu().numpy()


def server(g: np.ndarray, rp: RuleParams) -> Server:
    def dist(a, b):
        d = a - b
        return float(np.sqrt(max(d @ g @ d, 0.0)))

    def step(x, eta, j):
        y = x.copy()
        y[j] += eta
        return y

    return Server(np.zeros(g.shape[0]), rp, dist,
                  lambda j: float(np.sqrt(g[j, j])), step)


def model_gap(program: Dict[tuple, torch.Tensor], x1: Dict[tuple, torch.Tensor],
              pool_leaves, coeffs: np.ndarray) -> float:
    """||program - reference|| over ||reference - x_1||, the reference's
    final model x_1 + sum_j c_j P_j built leaf by leaf in float64."""
    num = den = 0.0
    for k, p in program.items():
        ref = x1[k].double().clone()
        for j, c in enumerate(coeffs):
            ref += float(c) * pool_leaves[j][k].double()
        num += float(torch.sum(torch.square(p.double() - ref)))
        den += float(torch.sum(torch.square(ref - x1[k].double())))
    return (num / den) ** 0.5 if den > 0 else float("inf")
