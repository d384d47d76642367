"""GMIS — Global Model Iteration Sequence (paper Algorithm 1).

The server stores past global-model versions so that when an update built on
snapshot iteration ``t - tau`` arrives, it can compute the Euclidean distance
||x_t - x_{t-tau}|| for Eq.(6).

Two modes:

* ``RingGMIS`` — the paper's store, bounded to ``depth`` versions
  (Assumption 4 bounds staleness anyway). Falls back to the oldest retained
  version if an older index is requested (and reports the clamp). It holds
  references: whatever is appended must never be written in place later,
  which is why the flat server's AXPY writes a new vector.
* ``DisplacementGMIS`` — O(num_clients) memory: per outstanding client
  snapshot it accumulates the server's displacement d_i = x_t - x_{t_i},
  updated with each aggregation (d_i += eta * Delta). ||d_i|| is exactly
  ||x_t - x_{t-tau}|| with no model copies.

A flat tensor is a one-leaf tree, so the flat server stores flat vectors in
either mode with no change here.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Tuple

import torch

from repro_torch.utils import pytree as pt

PyTree = Any


class RingGMIS:
    def __init__(self, depth: int = 64):
        assert depth >= 1
        self.depth = depth
        self._store: OrderedDict[int, PyTree] = OrderedDict()

    def append(self, iteration: int, params: PyTree) -> None:
        self._store[iteration] = params
        while len(self._store) > self.depth:
            self._store.popitem(last=False)

    def get(self, iteration: int) -> Tuple[PyTree, int]:
        """Returns (params, actual_iteration) — clamped to oldest retained."""
        if iteration in self._store:
            return self._store[iteration], iteration
        if not self._store:
            raise RuntimeError(
                "RingGMIS.get on an empty store: no global-model version "
                "has been appended yet — seed the ring with the initial "
                "params (append(t, params)) before serving lookups")
        oldest = next(iter(self._store))
        return self._store[oldest], oldest

    def register_snapshot(self, client_id, iteration: int) -> None:
        pass  # ring mode needs no per-client state

    def on_aggregate(self, eta, delta: PyTree) -> None:
        pass

    def release(self, client_id) -> None:
        pass

    def distance_from(self, client_id, iteration: int,
                      current: PyTree) -> torch.Tensor:
        stale, _ = self.get(iteration)
        return pt.tree_dist(current, stale)

    @property
    def num_stored(self) -> int:
        return len(self._store)


class DisplacementGMIS:
    """O(clients) memory: tracks x_t - x_{snapshot_i} per outstanding client."""

    def __init__(self):
        self._disp: dict = {}          # client_id -> displacement tree
        self._iter: dict = {}

    def append(self, iteration: int, params: PyTree) -> None:
        pass  # no copies stored

    def register_snapshot(self, client_id, iteration: int,
                          params: PyTree) -> None:
        self._disp[client_id] = pt.tree_zeros_like(params)
        self._iter[client_id] = iteration

    def on_aggregate(self, eta, delta: PyTree) -> None:
        """Every server update moves x_t by eta*delta — fold into every
        outstanding displacement."""
        for cid in self._disp:
            self._disp[cid] = pt.tree_axpy(eta, delta, self._disp[cid])

    def release(self, client_id) -> None:
        self._disp.pop(client_id, None)
        self._iter.pop(client_id, None)

    def distance_from(self, client_id, iteration: int,
                      current: PyTree) -> torch.Tensor:
        return pt.tree_norm(self._disp[client_id])

    def displacement(self, client_id) -> PyTree:
        """Raw displacement accumulator x_t - x_{snapshot}. The flat server
        feeds it straight into the fedagg norms sweep."""
        return self._disp[client_id]

    @property
    def num_stored(self) -> int:
        return len(self._disp)
