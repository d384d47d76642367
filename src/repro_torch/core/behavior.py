"""Pluggable client-behavior models: who arrives when (DESIGN.md §9).

The paper's environment (§B.2 — lognormal device heterogeneity, TCP
transmission, random suspension) used to be hard-wired into the simulator.
It is now one model among several behind a single interface, so the same
protocol/server/engine stack can run under any arrival dynamics — which is
where async FL methods actually differentiate (Fraboni et al. 2022).

A behavior model owns the simulator's timing RNG outright. ``dispatch``
answers, for one client handed ``k`` local steps at virtual time ``now``:
*how long until its update lands* — or ``None`` if the client churns out
permanently. Every model shares two knobs: ``churn_prob`` (per round, the
client goes offline for an exponential extra gap before its update lands)
and ``dropout_prob`` (per round, the client leaves for good). Both default
to 0 and make **zero** RNG draws when 0, so the ``paper`` model with
default knobs replays the pre-refactor generator stream byte-for-byte
(pinned by tests/test_event_runtime.py).

Models:

* ``paper``         — exact §B.2 semantics (the default).
* ``trace``         — replayable per-client round-duration traces.
* ``poisson-burst`` — arrivals cluster on a global Poisson burst process.
* ``diurnal``       — sinusoidal time-of-day rate modulation.

**Population mode** (DESIGN.md §12): with ``population=True`` the model
additionally owns the *check-in process* — WHO arrives from a population
of ``fed.num_clients`` potential clients, at what rate. ``next_checkin``
samples the next check-in time (a Poisson process at ``arrival_rate``,
modulated per model: diurnal thinning, burst-epoch snapping),
``sample_index`` draws the arriving population index, and
``session_continue`` decides whether a drained client starts another
round or returns to the pool. Per-client quantities (device step time,
trace rows) derive lazily from ``(seed, index)`` instead of eager
``num_clients``-sized draws, so a million-client population allocates
nothing for clients that never check in.
"""
from __future__ import annotations

import bisect
import math
from typing import Dict, Optional, Sequence, Union

import numpy as np

from repro_torch.configs.base import FedConfig

#: seconds per local SGD step on the nominal client (pre-refactor
#: ``FederatedSimulation.BASE_STEP_TIME``)
BASE_STEP_TIME = 0.05
#: max suspension hang ~ U(0, HANG_SCALE * step_time * K) (pre-refactor
#: ``FederatedSimulation.HANG_SCALE``)
HANG_SCALE = 30.0
#: salt for the population sampler's private stream (check-in gaps, index
#: draws, session draws) — disjoint from the timing RNG
_POP_SALT = 424_243
#: salt for per-index lazy step-time derivation in population mode
_STEP_SALT = 0x57E9_71AE
#: salt for per-index lazy trace synthesis in population mode
_TRACE_SALT = 0x7124_CE5A
#: rejection-sampling cap for ``sample_index`` — only reachable when
#: nearly the whole population is dropped out or in flight (tiny N)
_SAMPLE_TRIES = 1000


class ClientBehavior:
    """Base class: per-client device speeds + the shared churn/dropout
    knobs. Subclasses implement :meth:`duration`."""

    name = "base"

    def __init__(self, fed: FedConfig, *, seed: int, model_bytes: int,
                 heterogeneity: float = 0.6, churn_prob: float = 0.0,
                 dropout_prob: float = 0.0, churn_scale: float = 10.0,
                 population: bool = False, arrival_rate: float = 0.0,
                 session_stay_prob: float = 0.0):
        self.fed = fed
        self.model_bytes = model_bytes
        self.heterogeneity = heterogeneity
        self.churn_prob = float(churn_prob)
        self.dropout_prob = float(dropout_prob)
        self.churn_scale = float(churn_scale)
        self.population = bool(population)
        self.arrival_rate = float(arrival_rate)
        self.session_stay_prob = float(session_stay_prob)
        self._seed = seed
        # Same seed derivation as the pre-refactor simulator, so the paper
        # model's generator stream is byte-identical to the old
        # ``FederatedSimulation.rng``.
        self.rng = np.random.default_rng(seed + 99_991)
        if self.population:
            # population mode: NO O(num_clients) eager draws. Step times
            # derive lazily per index (pure in (seed, index), so clients
            # materializing in any arrival order see the same speed), and
            # the check-in process runs on its own stream.
            if self.arrival_rate <= 0:
                raise ValueError("population mode needs arrival_rate > 0")
            self.step_time = None
            self._lazy_step: Dict[int, float] = {}
            self.pop_rng = np.random.default_rng(seed + _POP_SALT)
        else:
            # heterogeneity: per-client step time, fixed for the run (the
            # old simulator drew this vector first, before any
            # per-dispatch draw)
            self.step_time = (BASE_STEP_TIME
                              * self.rng.lognormal(0.0, heterogeneity,
                                                   fed.num_clients))

    def _step(self, client_id: int) -> float:
        """Per-client device step time: eager array in roster mode, lazy
        memoized per-index draw in population mode."""
        if self.step_time is not None:
            return self.step_time[client_id]
        st = self._lazy_step.get(client_id)
        if st is None:
            r = np.random.default_rng([self._seed, _STEP_SALT,
                                       int(client_id)])
            st = BASE_STEP_TIME * r.lognormal(0.0, self.heterogeneity)
            self._lazy_step[client_id] = st
        return st

    # --- §B.2 primitives shared by several models -------------------------
    def _tx_time(self) -> float:
        """TCP transmission: model_bytes / speed * coef, coef ~ N(1, 0.2)
        truncated at 0.1."""
        coef = max(0.1, self.rng.normal(1.0, 0.2))
        return self.model_bytes / (self.fed.transmission_mbps * 1e6 / 8) * coef

    def _hang_time(self, k: int) -> float:
        """Suspension: with prob P the client hangs for a random time w.r.t.
        the round's maximum running time."""
        if self.rng.random() < self.fed.suspension_prob:
            return self.rng.uniform(0.0, HANG_SCALE * BASE_STEP_TIME * k)
        return 0.0

    # --- the interface ----------------------------------------------------
    def duration(self, client_id: int, k: int, now: float) -> float:
        """Wall time from dispatch at ``now`` until the update arrives."""
        raise NotImplementedError

    def dispatch(self, client_id: int, k: int, now: float) -> Optional[float]:
        """One fan-out: duration until arrival, or ``None`` if the client
        drops out permanently. Churn/dropout draw from the RNG only when
        their knobs are nonzero (paper-stream preservation).

        The dropout draw happens BEFORE the duration draw: a permanently
        departed client must not consume trace-cursor entries or
        timing-RNG draws, or every surviving client's replay stream
        desynchronizes from a dropout-free run of the same trace. With
        default knobs (dropout = churn = 0) neither guard draws, so the
        paper model's byte-identical stream is unaffected by the order."""
        if self.dropout_prob and self.rng.random() < self.dropout_prob:
            return None
        dur = self.duration(client_id, k, now)
        if self.churn_prob and self.rng.random() < self.churn_prob:
            dur += self.rng.exponential(self.churn_scale * BASE_STEP_TIME * k)
        return dur

    # --- population check-in process (population mode only) ---------------
    def checkin_rate(self, t: float) -> float:
        """Instantaneous check-in rate (clients per unit virtual time) at
        time ``t``. Constant by default; models override to modulate."""
        return self.arrival_rate

    def peak_checkin_rate(self) -> float:
        """Upper bound on :meth:`checkin_rate` over all ``t`` — the
        thinning envelope for :meth:`next_checkin`."""
        return self.arrival_rate

    def next_checkin(self, now: float) -> float:
        """Sample the next check-in time strictly after ``now``.

        Inhomogeneous Poisson process via thinning (Lewis & Shedler):
        candidate gaps are exponential at the peak rate; a candidate at
        ``t`` is accepted with probability ``checkin_rate(t) / peak``.
        For constant-rate models the acceptance test always passes (one
        uniform draw per event, kept so every model shares one draw
        discipline — table and materialized modes replay identically)."""
        peak = self.peak_checkin_rate()
        t = now
        while True:
            t += self.pop_rng.exponential(1.0 / peak)
            if self.pop_rng.random() * peak <= self.checkin_rate(t):
                return t

    def sample_index(self, excluded) -> Optional[int]:
        """Draw the arriving population index uniformly from indices not
        in ``excluded`` (permanently dropped out, or already in flight).

        Rejection sampling: O(1) expected work while the excluded fraction
        is small — the population regime, where the in-flight cohort is a
        vanishing fraction of ``num_clients``. Returns ``None`` after
        ``_SAMPLE_TRIES`` consecutive rejections (pool effectively
        exhausted at tiny N); the caller skips that check-in."""
        n = self.fed.num_clients
        for _ in range(_SAMPLE_TRIES):
            idx = int(self.pop_rng.integers(n))
            if idx not in excluded:
                return idx
        return None

    def session_continue(self, client_id: int) -> bool:
        """After a client's upload drains: ``True`` to immediately start
        another round, ``False`` to return to the anonymous pool. Makes
        zero draws when ``session_stay_prob`` is 0."""
        if not self.session_stay_prob:
            return False
        return bool(self.pop_rng.random() < self.session_stay_prob)


class PaperBehavior(ClientBehavior):
    """Exact §B.2 semantics — download tx + suspension hang + K local steps
    + upload tx, with the pre-refactor draw order per dispatch:
    normal (download), random [+ uniform] (hang), normal (upload)."""

    name = "paper"

    def duration(self, client_id: int, k: int, now: float) -> float:
        # grouping matters: the legacy loop computed
        # tx + (hang + k*step + tx), and float addition isn't associative —
        # byte-equivalence includes the sum order
        down = self._tx_time()
        return down + (self._hang_time(k) + k * self._step(client_id)
                       + self._tx_time())


class TraceBehavior(ClientBehavior):
    """Replayable round-duration traces: client ``i``'s n-th dispatch takes
    ``trace_i[n % len]`` seconds regardless of K — a pure replay of
    recorded wall times (adaptive K changes *what* trains, not *when* it
    lands). ``trace`` may be one shared sequence (each client cycles it
    with its own counter), a mapping client_id -> sequence, or ``None`` —
    then a deterministic lognormal trace of ``trace_len`` durations per
    client is synthesized from the seed, so runs replay exactly."""

    name = "trace"

    def __init__(self, fed: FedConfig, *,
                 trace: Union[None, Sequence[float],
                              Dict[int, Sequence[float]]] = None,
                 trace_len: int = 64, trace_scale: float = 1.0, **kw):
        super().__init__(fed, **kw)
        self.trace_scale = float(trace_scale)
        self._trace_len = int(trace_len)
        self._shared: Optional[list] = None
        self._synth = trace is None
        if trace is None:
            if self.population:
                # lazy: per-index traces synthesized on first contact from
                # (seed, index) — no O(num_clients * trace_len) table
                self._trace = {}
            else:
                base = self.fed.k_initial * self.step_time  # (C,) nominal
                noise = self.rng.lognormal(0.0, 0.5,
                                           (fed.num_clients, self._trace_len))
                self._trace = {i: (base[i] * noise[i]).tolist()
                               for i in range(fed.num_clients)}
        elif isinstance(trace, dict):
            self._trace = {int(c): list(map(float, t))
                           for c, t in trace.items()}
        else:
            self._shared = list(map(float, trace))
            self._trace = ({} if self.population
                           else {i: self._shared
                                 for i in range(fed.num_clients)})
        self._pos: Dict[int, int] = {}

    def _trace_for(self, client_id: int) -> Sequence[float]:
        t = self._trace.get(client_id)
        if t is None:
            if self._shared is not None:
                t = self._shared
            elif self.population and self._synth:
                r = np.random.default_rng([self._seed, _TRACE_SALT,
                                           int(client_id)])
                t = (self.fed.k_initial * self._step(client_id)
                     * r.lognormal(0.0, 0.5, self._trace_len)).tolist()
            else:
                raise KeyError(client_id)
            self._trace[client_id] = t
        return t

    def duration(self, client_id: int, k: int, now: float) -> float:
        t = self._trace_for(client_id)
        i = self._pos.get(client_id, 0)
        self._pos[client_id] = i + 1
        return t[i % len(t)] * self.trace_scale


class PoissonBurstBehavior(ClientBehavior):
    """Clustered arrivals: a global Poisson process of burst epochs (mean
    gap ``burst_gap``); a client that finishes computing waits for the next
    epoch and lands shortly after it (``jitter``-mean exponential), so
    updates arrive in dense clusters separated by quiet gaps — the regime
    where windowed draining through the batched fedagg kernel wins."""

    name = "poisson-burst"

    def __init__(self, fed: FedConfig, *, burst_gap: float = 1.0,
                 jitter: float = 0.01, **kw):
        super().__init__(fed, **kw)
        self.burst_gap = float(burst_gap)
        self.jitter = float(jitter)
        self._epochs = [0.0]

    def _next_epoch_after(self, t: float) -> float:
        while self._epochs[-1] < t:
            self._epochs.append(self._epochs[-1]
                                + self.rng.exponential(self.burst_gap))
        return self._epochs[bisect.bisect_left(self._epochs, t)]

    def duration(self, client_id: int, k: int, now: float) -> float:
        ready = now + k * self._step(client_id) + self._tx_time()
        epoch = self._next_epoch_after(ready)
        return (epoch - now) + self.rng.exponential(self.jitter)

    def next_checkin(self, now: float) -> float:
        """Check-ins cluster on the same global burst epochs as uploads: a
        homogeneous Poisson candidate snaps forward to the next burst
        epoch plus a small exponential jitter."""
        cand = now + self.pop_rng.exponential(1.0 / self.arrival_rate)
        epoch = self._next_epoch_after(cand)
        return epoch + self.pop_rng.exponential(self.jitter)


class DiurnalBehavior(ClientBehavior):
    """Time-varying rates: device throughput is modulated by a sinusoidal
    day profile ``r(t) = 1 + amplitude * sin(2 pi t / period)`` — clients
    run faster (arrivals denser) at the peak and slower at the trough, so
    the arrival density the auto-window controller sees drifts over time."""

    name = "diurnal"

    def __init__(self, fed: FedConfig, *, period: float = 20.0,
                 amplitude: float = 0.8, phase: float = 0.0, **kw):
        super().__init__(fed, **kw)
        assert 0.0 <= amplitude < 1.0, amplitude
        self.period = float(period)
        self.amplitude = float(amplitude)
        self.phase = float(phase)

    def rate(self, t: float) -> float:
        return 1.0 + self.amplitude * math.sin(
            2.0 * math.pi * (t + self.phase) / self.period)

    def duration(self, client_id: int, k: int, now: float) -> float:
        down = self._tx_time()
        compute = (self._hang_time(k) + k * self._step(client_id))
        return (down + compute / self.rate(now) + self._tx_time())

    def checkin_rate(self, t: float) -> float:
        """Check-in density follows the same day profile as throughput."""
        return self.arrival_rate * self.rate(t)

    def peak_checkin_rate(self) -> float:
        return self.arrival_rate * (1.0 + self.amplitude)


class FlashCrowdBehavior(ClientBehavior):
    """Synchronized arrival waves: clients compute at their natural §B.2
    pace but their uploads all land within ``crowd_span`` seconds of the
    next global wave boundary (period ``wave_period``) — think a push
    notification waking a fleet at once. Inter-arrival density alternates
    between near-zero gaps inside a crowd and a near-full period of
    silence between crowds, the exact regime the auto-window controller's
    inter-arrival EWMA is worst at tracking (DESIGN.md §11)."""

    name = "flash-crowd"

    def __init__(self, fed: FedConfig, *, wave_period: float = 0.5,
                 crowd_span: float = 0.005, **kw):
        super().__init__(fed, **kw)
        assert wave_period > 0 and crowd_span >= 0, (wave_period, crowd_span)
        self.wave_period = float(wave_period)
        self.crowd_span = float(crowd_span)

    def duration(self, client_id: int, k: int, now: float) -> float:
        natural = (self._tx_time() + k * self._step(client_id)
                   + self._tx_time())
        ready = now + natural
        wave = math.ceil(ready / self.wave_period) * self.wave_period
        return (wave - now) + self.rng.uniform(0.0, self.crowd_span)


class StragglerTailBehavior(ClientBehavior):
    """Heavy-tailed stragglers: most rounds run at the natural §B.2 pace,
    but with probability ``tail_prob`` a round's duration is multiplied by
    ``1 + Pareto(tail_alpha)`` — an unbounded tail (infinite variance for
    ``tail_alpha <= 2``). A handful of extreme stragglers keeps arriving
    with enormous staleness long after the window controller's EWMA has
    settled on the fast majority's cadence (DESIGN.md §11)."""

    name = "straggler-tail"

    def __init__(self, fed: FedConfig, *, tail_alpha: float = 1.5,
                 tail_prob: float = 0.1, **kw):
        super().__init__(fed, **kw)
        assert tail_alpha > 0 and 0.0 <= tail_prob <= 1.0, (tail_alpha,
                                                            tail_prob)
        self.tail_alpha = float(tail_alpha)
        self.tail_prob = float(tail_prob)

    def duration(self, client_id: int, k: int, now: float) -> float:
        base = (self._tx_time() + k * self._step(client_id)
                + self._tx_time())
        if self.rng.random() < self.tail_prob:
            base *= 1.0 + self.rng.pareto(self.tail_alpha)
        return base


#: behavior name -> class; ``configs.base.CLIENT_BEHAVIORS`` mirrors the
#: keys so FedConfig can fail fast without importing this module.
BEHAVIORS = {cls.name: cls for cls in
             (PaperBehavior, TraceBehavior, PoissonBurstBehavior,
              DiurnalBehavior, FlashCrowdBehavior, StragglerTailBehavior)}


def make_behavior(name: str, fed: FedConfig, *, seed: int, model_bytes: int,
                  heterogeneity: float = 0.6, **kwargs) -> ClientBehavior:
    """Build a behavior model by name. ``kwargs`` are model-specific knobs
    (merged from ``FedConfig.behavior_params`` and the simulator's
    ``behavior_kwargs`` by the caller)."""
    try:
        cls = BEHAVIORS[name]
    except KeyError:
        raise ValueError(f"unknown client_behavior {name!r}: expected one "
                         f"of {tuple(BEHAVIORS)}") from None
    return cls(fed, seed=seed, model_bytes=model_bytes,
               heterogeneity=heterogeneity, **kwargs)
