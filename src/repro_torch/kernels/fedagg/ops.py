"""Public wrappers over the fedagg sweeps.

Two API levels:

* **flat** (``flat_aggregate`` / ``flat_aggregate_displacement``) — operate
  on already-padded flat f32 vectors. This is the hot path of the flat-state
  server (``AsyncFedEDServer(backend="pallas")``), which keeps the global
  model flattened permanently so no per-step tree walk happens.
* **tree** (``asyncfeded_aggregate_pallas``) — a drop-in replacement for
  ``repro_torch.core.aggregation.asyncfeded_aggregate`` that flattens and
  unflattens at the boundary. Used by tests and one-off callers.

gamma and eta are computed on the device between the two sweeps, so one
aggregation queues its work without waiting on the host.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.aggregation import AggregationResult, gamma_eta_from_sq
from repro_torch.kernels.fedagg import fedagg
from repro_torch.utils import pytree as pt

PyTree = Any
_BLOCK = fedagg.BLOCK


def pad_flat_vector(vec: torch.Tensor) -> torch.Tensor:
    """Zero-pad a flat (n,) vector to the BLOCK multiple. Zeros contribute 0
    to every norm the kernels emit and are sliced off after the AXPY, so
    padding is value-transparent."""
    pad = (-vec.shape[0]) % _BLOCK
    return torch.nn.functional.pad(vec, (0, pad)) if pad else vec


def flat_aggregate(x_t: torch.Tensor, x_stale: torch.Tensor,
                   delta: torch.Tensor, *, lam: float, eps: float,
                   cap: float = 0.0):
    """One Eq.(5-7) step on padded flat vectors: a norms sweep, gamma/eta on
    the device, an AXPY sweep. Returns (new_vec, gamma, eta, dist, dnorm)."""
    sq = fedagg.fedagg_norms(x_t, x_stale, delta)
    gamma, eta, dist, dnorm = gamma_eta_from_sq(sq[0], sq[1], lam, eps, cap)
    new = fedagg.fedagg_axpy(x_t, delta, eta)
    return new, gamma, eta, dist, dnorm


def flat_aggregate_displacement(x_t: torch.Tensor, disp: torch.Tensor,
                                delta: torch.Tensor, zeros: torch.Tensor, *,
                                lam: float, eps: float, cap: float = 0.0):
    """Displacement-GMIS variant: the stale model is never materialized;
    ``disp`` = x_t - x_{t-tau} is maintained incrementally, so one norms
    sweep over (disp, zeros, delta) yields both Eq.(6) norms, then one AXPY
    sweep applies Eq.(5). Returns (new_vec, gamma, eta, dist, dnorm)."""
    sq = fedagg.fedagg_norms(disp, zeros, delta)
    gamma, eta, dist, dnorm = gamma_eta_from_sq(sq[0], sq[1], lam, eps, cap)
    new = fedagg.fedagg_axpy(x_t, delta, eta)
    return new, gamma, eta, dist, dnorm


def asyncfeded_aggregate_pallas(x_t: PyTree, x_stale: PyTree, delta: PyTree,
                                *, lam: float, eps: float,
                                cap: float = 0.0) -> AggregationResult:
    """Tree entry point over the flat sweeps."""
    pad = lambda t: pad_flat_vector(pt.tree_flatten_to_vector(t))
    new_flat, gamma, eta, dist, dnorm = flat_aggregate(
        pad(x_t), pad(x_stale), pad(delta), lam=lam, eps=eps, cap=cap)
    new = pt.tree_unflatten_from_vector(new_flat[:pt.tree_size(x_t)], x_t)
    return AggregationResult(new, gamma, eta, dist, dnorm)
