"""Model-sharded twins of the flat aggregation entry points (``ops.py``).

Eq. (5-7) is elementwise work plus Euclidean norms over one padded flat
vector, so it shards along the ``model`` axis with one reduction per
aggregation: the squared-norm partials. The flat state is a tuple of S
contiguous shards (``sharding/specs.py``), shard ``s`` on the mesh's
``s``-th device. Each entry point

1. runs the unsharded sweep of ``fedagg.py`` on every shard, on that
   shard's device (its hand-written kernel on CUDA, its plain version on
   the CPU: nothing falls back from one to the other), so a sweep is S
   launches;
2. sums the partials in fixed shard order, 0 to S - 1, on the home device
   (shard 0's): the JAX package's ``psum``, with no float atomics and no
   ``torch.distributed``;
3. derives gamma and eta from the sums (``gamma_eta_from_sq`` on the
   device, or the burst schedule on the host), and applies each shard's
   AXPY or apply on its own device.

A single arrival keeps ``ops.flat_aggregate``'s property that nothing waits
on the host. A burst copies the summed packed partials to the host once and
each device's etas back once. Per-shard sums reorder the float reduction
against the unsharded sweep, so the scalars agree with it to float
tolerance, not bitwise; with S = 1 they are the unsharded ones. Each shard
of the new vector equals the unsharded AXPY or apply of that shard at the
same eta(s) to the bit: both are elementwise.

Signatures are the ``ops.py`` twins', with every flat vector, stack and
scale vector given as its shard tuple; the new vector comes back as a
shard tuple.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from repro_torch.core.aggregation import gamma_eta_from_sq
from repro_torch.kernels.fedagg import fedagg
from repro_torch.kernels.fedagg.ops import _burst_schedule
from repro_torch.launch.mesh import on_device

Shards = Tuple[torch.Tensor, ...]


def _psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-shard partials summed in shard order on shard 0's device."""
    home = parts[0].device
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p.to(home)
    return acc


def _per_device(t: torch.Tensor, shards: Shards) -> Dict[torch.device,
                                                         torch.Tensor]:
    """One copy of ``t`` per distinct device of ``shards``."""
    out: Dict[torch.device, torch.Tensor] = {}
    for s in shards:
        if s.device not in out:
            out[s.device] = t.to(s.device)
    return out


def _single(norms, axpy, x_t: Shards, norm_args, axpy_args, lam, eps, cap):
    parts = []
    for i, x in enumerate(x_t):
        with on_device(x.device):
            parts.append(norms(*(a[i] for a in norm_args)))
    sq = _psum(parts)
    gamma, eta, dist, dnorm = gamma_eta_from_sq(sq[0], sq[1], lam, eps, cap)
    etas = _per_device(eta, x_t)
    new = []
    for i, x in enumerate(x_t):
        with on_device(x.device):
            new.append(axpy(x, *(a[i] for a in axpy_args), etas[x.device]))
    return tuple(new), gamma, eta, dist, dnorm


def flat_aggregate(x_t: Shards, x_stale: Shards, delta: Shards, *,
                   lam: float, eps: float, cap: float = 0.0):
    """Sharded twin of ``ops.flat_aggregate``: per shard a norms sweep, one
    fixed-order sum, gamma and eta on the home device, per shard an AXPY.
    Returns (new_vec shards, gamma, eta, dist, dnorm)."""
    return _single(fedagg.fedagg_norms, fedagg.fedagg_axpy, x_t,
                   (x_t, x_stale, delta), (delta,), lam, eps, cap)


def flat_aggregate_displacement(x_t: Shards, disp: Shards, delta: Shards,
                                zeros: Shards, *, lam: float, eps: float,
                                cap: float = 0.0):
    """Sharded twin of ``ops.flat_aggregate_displacement``."""
    return _single(fedagg.fedagg_norms, fedagg.fedagg_axpy, x_t,
                   (disp, zeros, delta), (delta,), lam, eps, cap)


def flat_aggregate_q(x_t: Shards, x_stale: Shards, q: Shards,
                     scales: Shards, *, lam: float, eps: float,
                     cap: float = 0.0):
    """Sharded twin of ``ops.flat_aggregate_q``: each shard's int8 payload
    with the scales of its own q blocks (``specs.split_scales``)."""
    return _single(fedagg.fedagg_norms_q, fedagg.fedagg_axpy_q, x_t,
                   (x_t, x_stale, q, scales), (q, scales), lam, eps, cap)


def flat_aggregate_displacement_q(x_t: Shards, disp: Shards, q: Shards,
                                  scales: Shards, zeros: Shards, *,
                                  lam: float, eps: float, cap: float = 0.0):
    """Sharded twin of ``ops.flat_aggregate_displacement_q``."""
    return _single(fedagg.fedagg_norms_q, fedagg.fedagg_axpy_q, x_t,
                   (disp, zeros, q, scales), (q, scales), lam, eps, cap)


def _batched(x_t: Shards, stacks, apply, b: int, lam, eps, cap, screen):
    parts = []
    for i, x in enumerate(x_t):
        with on_device(x.device):
            parts.append(fedagg.norms_batched_packed(
                x, *(s[i] for s in stacks)))
    etas, gammas, dists, dnorms, scales = _burst_schedule(
        _psum(parts), b, lam, eps, cap, screen)
    etas_on = _per_device(torch.from_numpy(etas), x_t)
    new = []
    for i, x in enumerate(x_t):
        with on_device(x.device):
            new.append(apply(x, *(s[i] for s in stacks[1:]),
                             etas_on[x.device]))
    return tuple(new), etas, gammas, dists, dnorms, scales


def flat_aggregate_batched(x_t: Shards, x_stales: Shards, deltas: Shards, *,
                           lam: float, eps: float, cap: float = 0.0,
                           screen=None):
    """Sharded twin of ``ops.flat_aggregate_batched``: B arrivals, per
    shard a batched norms launch over its ``(B, n / S)`` rows, the packed
    partials summed in shard order and copied to the host once, the
    schedule (and the optional screen, on the summed norms) on the host,
    one copy of the etas per device, per shard an apply. Same return
    signature, the new vector as shards."""
    return _batched(x_t, (x_stales, deltas), fedagg.fedagg_apply_batched,
                    deltas[0].shape[0], lam, eps, cap, screen)


def flat_aggregate_batched_q(x_t: Shards, x_stales: Shards, qs: Shards,
                             qscales: Shards, *, lam: float, eps: float,
                             cap: float = 0.0, screen=None):
    """Sharded twin of ``ops.flat_aggregate_batched_q``: the int8 rows and
    their scale rows split together; the screen sees the summed norms of
    the dequantized deltas."""
    return _batched(x_t, (x_stales, qs, qscales),
                    fedagg.fedagg_apply_batched_q, qs[0].shape[0], lam, eps,
                    cap, screen)
