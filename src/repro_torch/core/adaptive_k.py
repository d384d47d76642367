"""Adaptive number of local epochs — Eq.(8) of the paper.

    K_{i,n+1} = K_{i,n} + floor((gamma_bar - gamma(i, tau_n)) * kappa)

A per-client integrator that drives every client's staleness gamma toward the
set-point gamma_bar regardless of device speed: if updates arrive fresher
than gamma_bar, the client is allowed more local epochs (bigger ||Delta||,
fewer round-trips); staler than gamma_bar -> fewer epochs.
"""
from __future__ import annotations

import math


def update_k(k: int, gamma: float, gamma_bar: float, kappa: float,
             k_min: int = 1, k_max: int = 10_000) -> int:
    """One controller step. E[.] is the floor function (paper notation).
    A non-finite gamma (a diverged/corrupted model yields NaN or inf
    Euclidean distances) leaves K unchanged instead of crashing the
    controller — the integrator must survive adversarial runs."""
    if not math.isfinite(gamma):
        return int(min(max(k, k_min), k_max))
    delta = math.floor((gamma_bar - gamma) * kappa)
    return int(min(max(k + delta, k_min), k_max))


class AdaptiveK:
    """Tracks K_{i,n} per client (Algorithm 1's server-side bookkeeping)."""

    def __init__(self, k_initial: int, gamma_bar: float, kappa: float,
                 k_min: int = 1, k_max: int = 10_000):
        self.k_initial = int(k_initial)
        self.gamma_bar = float(gamma_bar)
        self.kappa = float(kappa)
        self.k_min, self.k_max = int(k_min), int(k_max)
        self._k: dict = {}

    def get(self, client_id) -> int:
        return self._k.get(client_id, self.k_initial)

    def observe(self, client_id, gamma: float) -> int:
        """Record the staleness of client's n-th update; returns K_{i,n+1}."""
        new_k = update_k(self.get(client_id), gamma, self.gamma_bar,
                         self.kappa, self.k_min, self.k_max)
        self._k[client_id] = new_k
        return new_k
