"""AsyncFedED aggregation math — Eq.(5), (6), (7) of the paper.

    gamma(i, tau) = ||x_t - x_{t-tau}|| / ||Delta_i||            (Eq. 6)
    eta_{g,i}     = lambda / (gamma + eps)                       (Eq. 7)
    x_{t+1}       = x_t + eta_{g,i} * Delta_i                    (Eq. 5)

Two execution paths:
* plain torch on trees (this module) — the reference, works on any tree;
* the flat-state kernels (``repro_torch.kernels.fedagg``) — one sweep for the
  norms and one for the AXPY over a padded flat vector.

Every scalar stays a 0-d f32 tensor on the parameters' device, so a step
never waits on the host. ``lam / x`` is written as a true division of two
f32 tensors: PyTorch computes ``float / tensor`` as a reciprocal times the
float, which rounds differently from the reference's division.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.utils import pytree as pt

PyTree = Any
_TINY = 1e-12


class AggregationResult(NamedTuple):
    params: PyTree
    gamma: torch.Tensor       # staleness of this update (Eq. 6)
    eta: torch.Tensor         # global lr applied (Eq. 7)
    dist: torch.Tensor        # ||x_t - x_{t-tau}||
    delta_norm: torch.Tensor  # ||Delta_i||


def _gamma(dist: torch.Tensor, dnorm: torch.Tensor,
           cap: float) -> torch.Tensor:
    """Eq.(6) with the edge rules: a server that has not moved
    (dist <= _TINY) gives gamma = 0; a zero delta gives dist/_TINY;
    ``cap`` > 0 clamps gamma (Assumption 4's bound)."""
    gamma = dist / torch.clamp_min(dnorm, _TINY)
    gamma = torch.where(dist <= _TINY, torch.zeros_like(gamma), gamma)
    if cap > 0.0:
        gamma = torch.clamp_max(gamma, cap)
    return gamma


def staleness(x_t: PyTree, x_stale: PyTree, delta: PyTree,
              cap: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Eq.(6). Returns (gamma, dist, delta_norm)."""
    dist = pt.tree_dist(x_t, x_stale)
    dnorm = pt.tree_norm(delta)
    return _gamma(dist, dnorm, cap), dist, dnorm


def adaptive_lr(gamma: torch.Tensor, lam: float, eps: float) -> torch.Tensor:
    """Eq.(7). Maximum value lam/eps (at gamma = 0)."""
    return torch.full_like(gamma, lam) / (gamma + eps)


def gamma_eta_from_sq(dist_sq: torch.Tensor, dn_sq: torch.Tensor, lam: float,
                      eps: float, cap: float = 0.0):
    """Eq.(6)+(7) from *squared* norms — the form the fedagg kernels emit.
    Returns (gamma, eta, dist, dnorm) with the edge rules of
    :func:`staleness`."""
    dist = torch.sqrt(torch.clamp_min(dist_sq, 0.0))
    dnorm = torch.sqrt(torch.clamp_min(dn_sq, 0.0))
    gamma = _gamma(dist, dnorm, cap)
    return gamma, adaptive_lr(gamma, lam, eps), dist, dnorm


def sequential_batch_schedule(dist0_sq, dn_sq, cross, gram, *, lam: float,
                              eps: float, cap: float = 0.0, scales=None):
    """Host-side O(B^2) recursion that makes the batched kernel path
    *sequentially equivalent* to B one-at-a-time Eq.(5-7) steps.

    Applying update i after updates 0..i-1 moves the server to
    ``x + sum_{k<i} eta_k d_k``, so its staleness distance expands to

        dist_i^2 = ||x - xs_i||^2 + 2 sum_{k<i} eta_k <x - xs_i, d_k>
                   + || sum_{k<i} eta_k d_k ||^2

    — every term a scalar already emitted by ``fedagg_norms_batched``
    (dist0_sq, cross C[i,k], Gram G). The recursion resolves eta_0..eta_{B-1}
    in order from those B^2 scalars with no further passes over the
    parameter vector; accumulated in f64 to keep the expansion stable.

    ``scales`` (optional, shape (B,)) are norm-screening multipliers on the
    raw deltas: update i effectively applies ``etas[i] * d_i`` with
    ``etas[i]`` already folded with its scale — 0 for a rejected update
    (it moves nothing, gamma reported NaN), ``thr/||d_i||`` for a clipped
    one. Since ``||s d|| = s ||d||`` and every cross/Gram term is linear
    per delta, screening is exact inside the same B^2 scalars.

    Returns (etas, gammas, dists, dnorms) as f32 numpy arrays of shape (B,)
    — etas are the effective multipliers on the RAW deltas (what the apply
    sweep uses), dnorms the raw kernel-emitted norms.
    """
    d0 = np.asarray(dist0_sq, np.float64)
    dn = np.sqrt(np.maximum(np.asarray(dn_sq, np.float64), 0.0))
    c = np.asarray(cross, np.float64)
    g = np.asarray(gram, np.float64)
    b = d0.shape[0]
    sc = (np.ones(b) if scales is None
          else np.asarray(scales, np.float64))
    etas = np.zeros(b)
    gammas = np.zeros(b)
    dists = np.zeros(b)
    cdot = np.zeros(b)       # cdot[j] = sum_{k applied} eta_k C[j, k]
    gdot = np.zeros(b)       # gdot[j] = sum_{k applied} eta_k G[j, k]
    s = 0.0                  # || sum_{k applied} eta_k d_k ||^2
    for i in range(b):
        dist = np.sqrt(max(d0[i] + 2.0 * cdot[i] + s, 0.0))
        if sc[i] == 0.0:     # rejected: contributes nothing to the model
            etas[i], gammas[i], dists[i] = 0.0, float("nan"), dist
            continue
        dn_i = dn[i] * sc[i]             # staleness of the CLIPPED delta
        gamma = 0.0 if dist <= _TINY else dist / max(dn_i, _TINY)
        if cap > 0.0:
            gamma = min(gamma, cap)
        eta = lam / (gamma + eps) * sc[i]     # effective, on the raw delta
        s += 2.0 * eta * gdot[i] + eta * eta * g[i, i]
        cdot += eta * c[:, i]
        gdot += eta * g[:, i]
        etas[i], gammas[i], dists[i] = eta, gamma, dist
    f32 = lambda v: v.astype(np.float32)
    return f32(etas), f32(gammas), f32(dists), f32(dn)


def asyncfeded_aggregate(x_t: PyTree, x_stale: PyTree, delta: PyTree, *,
                         lam: float, eps: float,
                         cap: float = 0.0) -> AggregationResult:
    """One server step: Eq.(6) -> Eq.(7) -> Eq.(5)."""
    gamma, dist, dnorm = staleness(x_t, x_stale, delta, cap)
    eta = adaptive_lr(gamma, lam, eps)
    new = pt.tree_axpy(eta, delta, x_t)
    return AggregationResult(new, gamma, eta, dist, dnorm)


def asyncfeded_aggregate_with_dist(x_t: PyTree, dist: torch.Tensor,
                                   delta: PyTree, *, lam: float, eps: float,
                                   cap: float = 0.0) -> AggregationResult:
    """Variant for the displacement GMIS: ``dist`` = ||x_t - x_{t-tau}|| is
    already known, so the stale model itself is not needed."""
    dnorm = pt.tree_norm(delta)
    gamma = _gamma(dist, dnorm, cap)
    eta = adaptive_lr(gamma, lam, eps)
    new = pt.tree_axpy(eta, delta, x_t)
    return AggregationResult(new, gamma, eta, dist, dnorm)


def asyncfeded_aggregate_per_leaf(x_t: PyTree, x_stale: PyTree,
                                  delta: PyTree, *, lam: float, eps: float,
                                  cap: float = 0.0) -> AggregationResult:
    """Per-leaf staleness: each leaf gets its own Eq.(6) gamma and Eq.(7)
    eta, so the fresh leaves of an otherwise stale update keep their
    weight. The returned gamma and eta are parameter-count-weighted means
    over the leaves; dist and delta_norm are the whole tree's."""
    news, gammas, etas, sizes = [], [], [], []
    for x, xs, d in zip(pt.tree_leaves(x_t), pt.tree_leaves(x_stale),
                        pt.tree_leaves(delta)):
        dist = torch.sqrt(torch.sum(torch.square(x.float() - xs.float())))
        dn = torch.sqrt(torch.sum(torch.square(d.float())))
        g = _gamma(dist, dn, cap)
        eta = adaptive_lr(g, lam, eps)
        news.append((x.float() + eta * d.float()).to(x.dtype))
        gammas.append(g)
        etas.append(eta)
        sizes.append(float(x.numel()))
    new = pt.tree_unflatten(pt.tree_structure(x_t), news)
    sizes = torch.tensor(sizes, dtype=torch.float32,
                         device=gammas[0].device)
    wmean = lambda v: torch.sum(torch.stack(v) * sizes) / torch.sum(sizes)
    return AggregationResult(new, wmean(gammas), wmean(etas),
                             pt.tree_dist(x_t, x_stale), pt.tree_norm(delta))
