"""The AsyncFedED rule in plain form (Chen et al., 2022).

For each update, in the order the server drains them:

    gamma = ||x_t - x_stale|| / ||Delta||     (Eq. 6; 0 where x has not moved)
    eta   = lambda / (gamma + eps)            (Eq. 7)
    x     = x + eta Delta                     (Eq. 5)
    K     = clamp(K + floor((gamma_bar - gamma) kappa), k_min, k_max)  (Eq. 8)

``x_stale`` is the global model of the update's snapshot iteration, kept by
a ring of the last ``depth`` versions; an older iteration reads the oldest
version kept. A drain of several updates applies them one after another and
keeps only the drain's final model in the ring; every drained client is
handed that model, its iteration and its own K. The iteration counts
updates: each one advances it by one, and an update's lag is the iteration
at its turn less its snapshot.

The rule works on any space with two operations: the distance between two
models and the norm of a delta, and the step ``x + eta Delta``.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Sequence, Tuple

_TINY = 1e-12


@dataclasses.dataclass
class Record:
    iteration: int
    client_id: int
    lag: int
    gamma: float
    eta: float
    k_next: int
    delta_norm: float


@dataclasses.dataclass
class RuleParams:
    lam: float
    eps: float
    gamma_bar: float
    kappa: float
    k_initial: int
    k_min: int
    k_max: int
    staleness_cap: float
    gmis_depth: int

    @classmethod
    def of(cls, fed: dict) -> "RuleParams":
        return cls(*(fed[f.name] for f in dataclasses.fields(cls)))


def gamma_eta(dist: float, dnorm: float, rp: RuleParams) -> Tuple[float, float]:
    gamma = 0.0 if dist <= _TINY else dist / max(dnorm, _TINY)
    if rp.staleness_cap > 0.0:
        gamma = min(gamma, rp.staleness_cap)
    return gamma, rp.lam / (gamma + rp.eps)


def k_next(k: int, gamma: float, rp: RuleParams) -> int:
    if not math.isfinite(gamma):
        return int(min(max(k, rp.k_min), rp.k_max))
    step = math.floor((rp.gamma_bar - gamma) * rp.kappa)
    return int(min(max(k + step, rp.k_min), rp.k_max))


class Server:
    """The rule over a space given by ``dist(a, b)``, ``norm(d)`` and
    ``step(x, eta, d)``."""

    def __init__(self, x1: Any, rp: RuleParams, dist: Callable,
                 norm: Callable, step: Callable):
        self.rp, self.dist, self.norm, self.step = rp, dist, norm, step
        self.x, self.t = x1, 1
        self.ring: "OrderedDict[int, Any]" = OrderedDict({1: x1})
        self.k: Dict[int, int] = {}
        self.clamps = 0

    def stale(self, iteration: int):
        if iteration in self.ring:
            return self.ring[iteration]
        self.clamps += 1
        return next(iter(self.ring.values()))

    def drain(self, updates: Sequence[Tuple[int, int, Any]],
              k_of: Callable[[int, float, int], int] = None) -> List[Record]:
        """Apply ``(client, snapshot iteration, delta)`` updates in order.
        ``k_of(client, gamma, k_rule)`` may choose the K the server keeps
        (a judge adopts the program's verified K); by default the rule's."""
        out = []
        x = self.x
        for client, snap, delta in updates:
            dn = self.norm(delta)
            gamma, eta = gamma_eta(self.dist(x, self.stale(snap)), dn,
                                   self.rp)
            x = self.step(x, eta, delta)
            lag = self.t - snap
            self.t += 1
            kn = k_next(self.k.get(client, self.rp.k_initial), gamma, self.rp)
            if k_of is not None:
                kn = k_of(client, gamma, kn)
            self.k[client] = kn
            out.append(Record(self.t, client, lag, gamma, eta, kn, dn))
        self.x = x
        self.ring[self.t] = x
        while len(self.ring) > self.rp.gmis_depth:
            self.ring.popitem(last=False)
        return out
