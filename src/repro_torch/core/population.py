"""Million-client population engine.

The roster path (``FedConfig.population == "off"``) builds a
:class:`~repro_torch.core.client.Client` per population member at
construction: O(num_clients) memory and start-up work. The population engine
replaces the roster with a *distribution*: the behavior model samples WHO
checks in and WHEN from population parameters (arrival rate, diurnal phase,
churn), and only clients that actually make contact ever exist.

:class:`PopulationState` is the active-set table behind that sampling:

* a compact ``index_of`` map from population index to a table slot, plus
  stacked numpy arrays (``rounds``, ``snapshot_iter``, ``in_flight``,
  ``ewma`` / ``ewma_set``) indexed by slot — per-client scalar state for
  every client that has EVER checked in, grown geometrically;
* lazily materialized :class:`Client` objects (datasets + batcher PCG64
  streams), each a pure function of ``(seed, index)`` via the task's
  ``load_population_data`` hook and the per-index batcher seed
  ``seed * 10_007 + index`` — so clients may materialize in ANY arrival
  order and always carry identical state. A client's batches reach the
  device only when it trains;
* :class:`EwmaStore`, a MutableMapping view over the ``ewma`` column that
  the norm screen (``repro_torch.core.screening``) uses as its per-client
  baseline store.

Memory and per-drain work scale with the number of *contacted* clients
(bounded by arrival_rate x max_time), never with ``fed.num_clients``.

Two population modes share every draw and every code path:

* ``"table"``        — the lazy engine above;
* ``"materialized"`` — the same arrival process with every client
  materialized up front: the equivalence reference (at N <= 256 the two
  modes give the same event trace).

A numpy-only copy of the JAX package's ``repro/core/population.py`` over
the port's ``Client``; the tests hold the two to the same tables.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, MutableMapping

import numpy as np

from repro_torch.configs.base import FedConfig
from repro_torch.core.client import Client

__all__ = ["PopulationState", "EwmaStore"]

#: initial slot capacity of the active-set table (grown 2x on demand)
_INITIAL_CAPACITY = 64


class EwmaStore(MutableMapping):
    """MutableMapping view over the population table's EWMA column.

    Injected into :class:`~repro_torch.core.screening.NormScreen` as the
    per-client baseline store, so screening state is a stacked array
    indexed by the active-set table instead of a free-growing dict.

    Keys are population indices; setting a baseline for an index not yet
    in the table allocates its slot (first-contact clients are screened
    before any other per-client state exists — a never-materialized index
    must NOT KeyError, it must bootstrap). Non-index keys (the screen's
    ``client_id=None`` degenerate mode, FedBuff's ``-1`` flush records)
    fall back to a small overflow dict rather than corrupting the table.
    """

    def __init__(self, pop: "PopulationState"):
        self._pop = pop
        self._extra: Dict[Any, float] = {}

    def _is_index(self, key) -> bool:
        return (isinstance(key, (int, np.integer)) and not isinstance(
            key, bool) and 0 <= key < self._pop.fed.num_clients)

    def __getitem__(self, key) -> float:
        if not self._is_index(key):
            return self._extra[key]
        slot = self._pop.index_of.get(int(key))
        if slot is None or not self._pop.ewma_set[slot]:
            raise KeyError(key)
        return float(self._pop.ewma[slot])

    def __setitem__(self, key, value) -> None:
        if not self._is_index(key):
            self._extra[key] = float(value)
            return
        slot = self._pop.slot(int(key))
        self._pop.ewma[slot] = float(value)
        self._pop.ewma_set[slot] = True

    def __delitem__(self, key) -> None:
        if not self._is_index(key):
            del self._extra[key]
            return
        slot = self._pop.index_of.get(int(key))
        if slot is None or not self._pop.ewma_set[slot]:
            raise KeyError(key)
        self._pop.ewma_set[slot] = False

    def __iter__(self) -> Iterator:
        yield from self._extra
        for idx, slot in self._pop.index_of.items():
            if self._pop.ewma_set[slot]:
                yield idx

    def __len__(self) -> int:
        return len(self._extra) + int(np.count_nonzero(self._pop.ewma_set))


class _Excluded:
    """Live ``in`` view of the indices the arrival sampler must skip:
    permanently dropped-out clients and clients already in flight. A view
    (not a set copy) so ``sample_index`` always sees current state without
    an O(active) rebuild per check-in."""

    def __init__(self, pop: "PopulationState"):
        self._pop = pop

    def __contains__(self, idx) -> bool:
        if idx in self._pop.dropped:
            return True
        slot = self._pop.index_of.get(idx)
        return slot is not None and bool(self._pop.in_flight[slot])


class PopulationState:
    """The active-set table: compact per-contacted-client state plus lazy
    client materialization (module docstring)."""

    def __init__(self, task, fed: FedConfig, *, seed: int, device=None,
                 capacity: int = _INITIAL_CAPACITY):
        """``device`` is where the materialized clients train (the
        ``Client`` default: CUDA, raising when there is none)."""
        self.task = task
        self.fed = fed
        self.seed = seed
        self.device = device
        #: lazy per-index dataset generator + the run's eval batch
        self.client_data: Callable[[int], Any]
        self.client_data, self.eval_batch = task.load_population_data(
            fed, seed)
        cap = max(1, int(capacity))
        #: population index -> table slot, insertion == first-contact order
        self.index_of: Dict[int, int] = {}
        # stacked per-slot state ------------------------------------------
        self.pop_index = np.full(cap, -1, np.int64)    # slot -> pop index
        self.rounds = np.zeros(cap, np.int64)          # dispatches so far
        self.snapshot_iter = np.zeros(cap, np.int64)   # iter at dispatch
        self.in_flight = np.zeros(cap, bool)
        self.ewma = np.zeros(cap, np.float64)          # norm-screen EWMAs
        self.ewma_set = np.zeros(cap, bool)
        #: permanently departed population indices (dropout permanence:
        #: the arrival sampler never re-admits them)
        self.dropped: set = set()
        self._clients: Dict[int, Client] = {}
        self.excluded = _Excluded(self)
        # telemetry
        self.checkins = 0
        self.skipped_checkins = 0
        self.sessions = 0
        self.max_in_flight = 0

    # ------------------------------------------------------------- slots --
    @property
    def contacted(self) -> int:
        """Distinct clients that have ever checked in."""
        return len(self.index_of)

    @property
    def capacity(self) -> int:
        return len(self.pop_index)

    def _grow(self) -> None:
        cap = self.capacity
        new = 2 * cap
        for name in ("pop_index", "rounds", "snapshot_iter", "in_flight",
                     "ewma", "ewma_set"):
            arr = getattr(self, name)
            grown = np.zeros(new, arr.dtype)
            grown[:cap] = arr
            setattr(self, name, grown)
        self.pop_index[cap:] = -1

    def slot(self, idx: int) -> int:
        """The table slot of population index ``idx``, allocated on first
        contact (slot numbers are dense in first-contact order)."""
        slot = self.index_of.get(idx)
        if slot is None:
            slot = len(self.index_of)
            if slot >= self.capacity:
                self._grow()
            self.index_of[idx] = slot
            self.pop_index[slot] = idx
        return slot

    def client(self, idx: int) -> Client:
        """Materialize (or fetch) population index ``idx``'s Client. Pure
        in ``(seed, idx)``: dataset rows come from the task's per-index
        generator and the batcher seed is the roster derivation
        ``seed * 10_007 + idx``, so arrival order cannot change what any
        client computes."""
        c = self._clients.get(idx)
        if c is None:
            self.slot(idx)
            c = Client(idx, self.task, self.client_data(idx), self.fed,
                       seed=self.seed, device=self.device)
            self._clients[idx] = c
        return c

    def materialize_all(self, behavior=None) -> None:
        """Eagerly materialize the whole population — the ``materialized``
        equivalence reference. Same per-index derivations as the lazy
        path, just computed up front (O(num_clients) on purpose)."""
        for i in range(self.fed.num_clients):
            self.client(i)
            if behavior is not None:
                behavior._step(i)

    # ------------------------------------------------------ state updates --
    def mark_dispatch(self, idx: int, snapshot_iter: int) -> None:
        slot = self.slot(idx)
        self.in_flight[slot] = True
        self.rounds[slot] += 1
        self.snapshot_iter[slot] = snapshot_iter
        self.sessions += 1
        flying = int(np.count_nonzero(self.in_flight))
        if flying > self.max_in_flight:
            self.max_in_flight = flying

    def mark_returned(self, idx: int) -> None:
        """Session over: the client goes back to the anonymous pool (it
        may be drawn again by a later check-in)."""
        slot = self.index_of.get(idx)
        if slot is not None:
            self.in_flight[slot] = False

    def mark_dropped(self, idx: int) -> None:
        """Dropout permanence: the index never re-enters the pool."""
        self.mark_returned(idx)
        self.dropped.add(idx)

    # ----------------------------------------------------------- plumbing --
    def screen_store(self) -> EwmaStore:
        return EwmaStore(self)

    def table(self) -> Dict[int, dict]:
        """Canonical snapshot of the active-set table, keyed by population
        index in first-contact order — what the engine-equivalence and
        table-vs-materialized suites compare. Only contacted rows appear
        (a materialized run restricts to rows with any activity via
        ``rounds > 0`` upstream in the tests)."""
        out = {}
        for idx, slot in self.index_of.items():
            out[idx] = {
                "slot": slot,
                "rounds": int(self.rounds[slot]),
                "snapshot_iter": int(self.snapshot_iter[slot]),
                "in_flight": bool(self.in_flight[slot]),
                "dropped": idx in self.dropped,
                "ewma": (float(self.ewma[slot])
                         if self.ewma_set[slot] else None),
            }
        return out

    def stats(self) -> dict:
        return {
            "num_clients": self.fed.num_clients,
            "contacted": self.contacted,
            "materialized": len(self._clients),
            "capacity": self.capacity,
            "checkins": self.checkins,
            "skipped_checkins": self.skipped_checkins,
            "sessions": self.sessions,
            "max_in_flight": self.max_in_flight,
            "dropped": len(self.dropped),
        }
