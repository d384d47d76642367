"""Public wrappers over the fedagg sweeps.

Two API levels:

* **flat** (``flat_aggregate``, ``flat_aggregate_batched`` and their
  displacement and int8 twins) — operate on already-padded flat f32
  vectors. This is the hot path of the flat-state server
  (``AsyncFedEDServer(backend="pallas")``), which keeps the global model
  flattened permanently so no per-step tree walk happens.
* **tree** (``asyncfeded_aggregate_pallas``,
  ``asyncfeded_aggregate_batched_pallas``) — drop-in replacements for
  ``repro_torch.core.aggregation.asyncfeded_aggregate`` that flatten and
  unflatten at the boundary. Used by tests and one-off callers.

For one arrival gamma and eta are computed on the device between the two
sweeps, so an aggregation queues its work without waiting on the host. A
burst waits once: the sequential-equivalence schedule runs on the host
between its two sweeps.
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.aggregation import (AggregationResult, gamma_eta_from_sq,
                                          sequential_batch_schedule)
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


def flat_aggregate_batched(x_t: torch.Tensor, x_stales: torch.Tensor,
                           deltas: torch.Tensor, *, lam: float, eps: float,
                           cap: float = 0.0, screen=None):
    """B concurrent arrivals in two sweeps, sequential-equivalent to B
    one-at-a-time :func:`flat_aggregate` calls (see
    ``aggregation.sequential_batch_schedule``).

    x_t (n,), x_stales (B, n), deltas (B, n) f32 or bf16, n a BLOCK
    multiple. One norms-batched launch; one copy of its four outputs,
    packed in one buffer, to the host; the schedule in f64 on the host;
    one copy of the etas back; one apply-batched launch. Returns (new_vec,
    etas, gammas, dists, dnorms, scales): the per-update scalars as f32
    numpy arrays in arrival order, etas the effective multipliers on the
    raw deltas.

    ``screen`` (optional) is a norm-screening decider, typically
    ``NormScreen.decide_batch``, called with the kernel-emitted raw delta
    norms in arrival order; it returns per-update scale factors (1 accept,
    (0,1) clip, 0 reject) folded into the schedule. ``scales`` is None when
    ``screen`` is.
    """
    etas, gammas, dists, dnorms, scales = _burst_schedule(
        fedagg.norms_batched_packed(x_t, x_stales, deltas), deltas.shape[0],
        lam, eps, cap, screen)
    new = fedagg.fedagg_apply_batched(
        x_t, deltas, torch.from_numpy(etas).to(x_t.device))
    return new, etas, gammas, dists, dnorms, scales


def _burst_schedule(packed: torch.Tensor, b: int, lam: float, eps: float,
                    cap: float, screen):
    """The host step of a burst drain: one copy of the batched norms'
    packed outputs to the host, the optional screen on the raw delta norms,
    and the f64 schedule. Returns (etas, gammas, dists, dnorms, scales)."""
    d0, dn_sq, cross, gram = fedagg.split_batched(packed.cpu().numpy(), b)
    scales = None
    if screen is not None:
        dns = np.sqrt(np.maximum(np.asarray(dn_sq, np.float64), 0.0))
        scales = screen(dns.astype(np.float32))
    etas, gammas, dists, dnorms = sequential_batch_schedule(
        d0, dn_sq, cross, gram, lam=lam, eps=eps, cap=cap, scales=scales)
    return etas, gammas, dists, dnorms, scales


def flat_aggregate_q(x_t: torch.Tensor, x_stale: torch.Tensor,
                     q: torch.Tensor, scales: torch.Tensor, *, lam: float,
                     eps: float, cap: float = 0.0):
    """:func:`flat_aggregate` with the delta in int8 wire form (``q`` (n,),
    ``scales`` (n // QBLOCK,)), dequantized inside the sweeps. The emitted
    dnorm is the dequantized delta's norm, exactly what the AXPY applies."""
    sq = fedagg.fedagg_norms_q(x_t, x_stale, q, scales)
    gamma, eta, dist, dnorm = gamma_eta_from_sq(sq[0], sq[1], lam, eps, cap)
    new = fedagg.fedagg_axpy_q(x_t, q, scales, eta)
    return new, gamma, eta, dist, dnorm


def flat_aggregate_displacement_q(x_t: torch.Tensor, disp: torch.Tensor,
                                  q: torch.Tensor, scales: torch.Tensor,
                                  zeros: torch.Tensor, *, lam: float,
                                  eps: float, cap: float = 0.0):
    """Displacement-GMIS variant of :func:`flat_aggregate_q`."""
    sq = fedagg.fedagg_norms_q(disp, zeros, q, scales)
    gamma, eta, dist, dnorm = gamma_eta_from_sq(sq[0], sq[1], lam, eps, cap)
    new = fedagg.fedagg_axpy_q(x_t, q, scales, eta)
    return new, gamma, eta, dist, dnorm


def flat_aggregate_batched_q(x_t: torch.Tensor, x_stales: torch.Tensor,
                             qs: torch.Tensor, qscales: torch.Tensor, *,
                             lam: float, eps: float, cap: float = 0.0,
                             screen=None):
    """The int8 twin of :func:`flat_aggregate_batched`: B int8 arrivals
    (``qs`` (B, n), ``qscales`` (B, n // QBLOCK)) drained in the same five
    steps, the deltas dequantized inside both sweeps. The screen sees the
    kernel-emitted norms of the DEQUANTIZED deltas, and its clip scales
    fold into the etas exactly. Same return signature as the f32 path."""
    etas, gammas, dists, dnorms, scales = _burst_schedule(
        fedagg.norms_batched_packed(x_t, x_stales, qs, qscales), qs.shape[0],
        lam, eps, cap, screen)
    new = fedagg.fedagg_apply_batched_q(
        x_t, qs, qscales, torch.from_numpy(etas).to(x_t.device))
    return new, etas, gammas, dists, dnorms, scales


def asyncfeded_aggregate_pallas(x_t: PyTree, x_stale: PyTree, delta: PyTree,
                                *, lam: float, eps: float,
                                cap: float = 0.0) -> AggregationResult:
    """Tree entry point over the flat sweeps."""
    pad = lambda t: pad_flat_vector(pt.tree_flatten_to_vector(t))
    new_flat, gamma, eta, dist, dnorm = flat_aggregate(
        pad(x_t), pad(x_stale), pad(delta), lam=lam, eps=eps, cap=cap)
    new = pt.tree_unflatten_from_vector(new_flat[:pt.tree_size(x_t)], x_t)
    return AggregationResult(new, gamma, eta, dist, dnorm)


def asyncfeded_aggregate_batched_pallas(
        x_t: PyTree, x_stales: Sequence[PyTree], deltas: Sequence[PyTree], *,
        lam: float, eps: float, cap: float = 0.0
) -> Tuple[PyTree, Any, Any, Any, Any]:
    """Batched tree entry point: stacks B (stale, delta) pairs and drains
    them through the batched sweeps. Returns (new_params, etas, gammas,
    dists, dnorms)."""
    spec = pt.FlatSpec(x_t, block=_BLOCK)
    xs = torch.stack([spec.flatten(t) for t in x_stales])
    d = torch.stack([spec.flatten(t) for t in deltas])
    new_flat, etas, gammas, dists, dnorms, _ = flat_aggregate_batched(
        spec.flatten(x_t), xs, d, lam=lam, eps=eps, cap=cap)
    return spec.unflatten(new_flat), etas, gammas, dists, dnorms
