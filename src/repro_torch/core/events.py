"""Discrete-event runtime layer: virtual clock, typed arrival events, the
burst-drain loop, and the batch-window policies (DESIGN.md §9).

This module is pure scheduling — no models, no servers, no RNG of its own.
The simulator (repro.core.simulator) composes it with a client-behavior
model (repro.core.behavior) that decides *when* updates land and a server
that decides *what* an arrival does.

The drain loop reproduces the pre-refactor ``FederatedSimulation._run_async``
semantics exactly (pinned by tests/test_event_runtime.py): events pop in
(time, seq) order; with a positive window every arrival landing within the
window of the first one joins the same batch and the clock advances to the
last drained arrival; with a zero window every arrival is its own batch —
even exact-tie arrival times drain one at a time, preserving the paper's
one-aggregation-per-arrival semantics.

Window policies:

* :class:`FixedWindow` — the constant ``batch_window`` knob.
* :class:`AutoWindow` — burst-window autotuning (``batch_window="auto"``):
  picks the window online from the observed inter-arrival density (§9's
  control law), targeting the batched fedagg kernel's free-batch knee
  (DESIGN.md §4.3's B-dependent VMEM row schedule).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, List, Optional, Sequence, Union


#: payload sentinel marking a population *check-in* event (DESIGN.md §12):
#: an anonymous client from the population contacts the server to start a
#: round. The arriving population index is drawn at fire time by the
#: population engine — scheduled check-ins carry no client identity, so
#: their ``client_id`` is -1. The event loop treats them like any other
#: arrival; only the simulator's population handler interprets the payload.
CHECKIN = object()


@dataclasses.dataclass(order=True)
class Arrival:
    """A client update landing at the server at virtual ``time``.

    Ordering is (time, seq): ``seq`` is the queue's monotonically increasing
    push counter, so simultaneous arrivals drain in dispatch order and the
    payload never participates in comparisons.
    """
    time: float
    seq: int
    client_id: int = dataclasses.field(compare=False)
    payload: Any = dataclasses.field(compare=False)


class EventQueue:
    """Min-heap of :class:`Arrival` events keyed on (time, seq)."""

    def __init__(self):
        self._heap: List[Arrival] = []
        self._seq = 0

    def push(self, time: float, client_id: int, payload: Any) -> Arrival:
        ev = Arrival(time, self._seq, client_id, payload)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Arrival:
        return heapq.heappop(self._heap)

    def peek_time(self) -> float:
        return self._heap[0].time

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


class VirtualClock:
    """Monotonic virtual time. The sync round loop advances it by the
    straggler-bound round duration; the async loop advances it to each
    drained arrival."""

    def __init__(self):
        self.now = 0.0

    def advance(self, dt: float) -> float:
        assert dt >= 0.0, dt
        self.now += dt
        return self.now

    def advance_to(self, t: float) -> float:
        self.now = max(self.now, t)
        return self.now


# ------------------------------------------------------------ window policy --

class WindowController:
    """Decides, per drained batch, how long the server keeps the drain open
    after the first arrival. ``window()`` is sampled once when a batch's
    first event pops; ``observe()`` feeds the batch's arrival times back so
    adaptive policies stay causal (batch k's window depends only on
    arrivals through batch k-1)."""

    def window(self) -> float:
        raise NotImplementedError

    def observe(self, times: Sequence[float]) -> None:
        pass

    def observe_gamma(self, gammas: Sequence[float]) -> None:
        """Staleness feedback: the simulator feeds each drained batch's
        ``gamma`` values (Eq. 6) back after aggregation. Default: ignored
        — only gamma-aware policies react."""

    def stats(self) -> dict:
        return {}


class FixedWindow(WindowController):
    """The constant ``batch_window`` knob (0 = paper semantics)."""

    def __init__(self, window: float):
        assert window >= 0.0, window
        self._window = float(window)

    def window(self) -> float:
        return self._window

    def stats(self) -> dict:
        return {"policy": "fixed", "window": self._window}


class AutoWindow(WindowController):
    """Burst-window autotuning from observed inter-arrival density.

    Control law (DESIGN.md §9): two EWMAs of the global inter-arrival gap —
    a fast one ``g_f`` (recent density) and a slow one ``g_s`` (the long-run
    average). When the recent stream is at least ``burstiness`` times denser
    than the long-run average (``g_s / g_f >= burstiness``), arrivals are
    clustering and the window opens wide enough to span ~``target_batch``
    expected arrivals (``target_batch * g_f``), clamped to ``w_max``;
    otherwise it stays 0, adding zero staleness in the steady regime.
    ``target_batch`` is clamped to the server's ``batch_limit()`` — the
    batched fedagg kernel's free-batch knee, beyond which the B-dependent
    VMEM row schedule starts halving rows per grid step (§4.3).

    **Gamma-aware control** (``gamma_threshold``): a wide drain window is
    itself a staleness source — every update in the window aggregates
    against the window's final model. When the EWMA of observed staleness
    ``gamma`` (fed back by the simulator after each drain via
    :meth:`observe_gamma`) drifts above ``gamma_threshold``, the opened
    window shrinks proportionally (``threshold / ewma``), trading kernel
    batching back for freshness until gamma recovers. ``None`` (default)
    disables the term — the pre-existing control law is unchanged.
    """

    def __init__(self, target_batch: int = 8, burstiness: float = 1.5,
                 alpha_fast: float = 0.4, alpha_slow: float = 0.05,
                 w_max: float = 1.0, warmup: int = 8,
                 batch_limit: Optional[int] = None,
                 gamma_threshold: Optional[float] = None,
                 gamma_alpha: float = 0.2):
        if batch_limit is not None:
            target_batch = max(1, min(target_batch, batch_limit))
        self.target_batch = int(target_batch)
        self.burstiness = float(burstiness)
        self.alpha_fast = float(alpha_fast)
        self.alpha_slow = float(alpha_slow)
        self.w_max = float(w_max)
        self.warmup = int(warmup)
        self.gamma_threshold = (None if gamma_threshold is None
                                else float(gamma_threshold))
        self.gamma_alpha = float(gamma_alpha)
        self._fast: Optional[float] = None
        self._slow: Optional[float] = None
        self._last: Optional[float] = None
        self._gamma: Optional[float] = None
        self._n = 0
        self._opened = 0
        self._shrunk = 0
        self._decisions = 0
        self._last_window = 0.0

    def window(self) -> float:
        self._decisions += 1
        if self._n < self.warmup or not self._fast:
            self._last_window = 0.0
            return 0.0
        if self._slow / self._fast >= self.burstiness:
            self._last_window = min(self.target_batch * self._fast,
                                    self.w_max)
            self._opened += 1
            if (self.gamma_threshold is not None
                    and self._gamma is not None
                    and self._gamma > self.gamma_threshold):
                self._last_window *= self.gamma_threshold / self._gamma
                self._shrunk += 1
        else:
            self._last_window = 0.0
        return self._last_window

    def observe(self, times: Sequence[float]) -> None:
        for t in times:
            if self._last is not None:
                gap = t - self._last
                if self._fast is None:
                    self._fast = self._slow = gap
                else:
                    self._fast += self.alpha_fast * (gap - self._fast)
                    self._slow += self.alpha_slow * (gap - self._slow)
            self._last = t
            self._n += 1

    def observe_gamma(self, gammas: Sequence[float]) -> None:
        for g in gammas:
            g = float(g)
            if g != g:                 # NaN: baselines without a gamma
                continue
            if self._gamma is None:
                self._gamma = g
            else:
                self._gamma += self.gamma_alpha * (g - self._gamma)

    def stats(self) -> dict:
        return {"policy": "auto", "target_batch": self.target_batch,
                "arrivals_seen": self._n, "decisions": self._decisions,
                "opened": self._opened, "shrunk": self._shrunk,
                "gap_fast": self._fast, "gap_slow": self._slow,
                "gamma_ewma": self._gamma,
                "gamma_threshold": self.gamma_threshold,
                "last_window": self._last_window}


def make_window_controller(batch_window: Union[float, str], *,
                           batch_limit: Optional[int] = None,
                           **auto_kwargs) -> WindowController:
    """``batch_window`` as configured: a number -> :class:`FixedWindow`;
    ``"auto"`` -> :class:`AutoWindow` (clamped to the server's drain
    ``batch_limit``, extra knobs forwarded)."""
    if isinstance(batch_window, str):
        if batch_window != "auto":
            raise ValueError(f"unknown batch_window {batch_window!r}")
        return AutoWindow(batch_limit=batch_limit, **auto_kwargs)
    return FixedWindow(float(batch_window))


# -------------------------------------------------------------- drain loop --

class EventLoop:
    """The async drain loop, extracted from the monolithic simulator.

    Pops arrivals in virtual-time order, groups each first arrival with
    everything landing within the controller's window, and hands the batch
    to ``handle_batch(now, batch)`` with ``now`` advanced to the last
    drained arrival. The handler re-arms the loop by pushing follow-up
    arrivals onto :attr:`queue`. Events popping after ``max_time`` end the
    run (they are discarded, exactly like the pre-refactor loop).
    """

    def __init__(self, controller: WindowController, max_time: float):
        self.controller = controller
        self.max_time = float(max_time)
        self.queue = EventQueue()
        self.clock = VirtualClock()
        self.drains = 0
        self._stopped = False

    def stop(self) -> None:
        """Request an early stop: the drain loop exits before popping the
        next event (the current batch's handler completes). Used by the
        simulator's ``max_updates`` cutoff."""
        self._stopped = True

    def run(self, handle_batch: Callable[[float, List[Arrival]], None]
            ) -> float:
        """Drain until the queue empties, virtual time runs out, or
        :meth:`stop` is called; returns the final clock reading clamped
        to ``max_time``."""
        while self.queue and not self._stopped:
            ev = self.queue.pop()
            self.clock.advance_to(ev.time)
            if ev.time > self.max_time:
                break
            batch = [ev]
            window = self.controller.window()
            if window > 0:
                # Burst drain: everything landing within `window` of this
                # arrival joins the batch; the clock advances to the last
                # drained arrival. A zero window never peeks the queue, so
                # exact-tie arrivals still drain one at a time.
                horizon = min(ev.time + window, self.max_time)
                while self.queue and self.queue.peek_time() <= horizon:
                    batch.append(self.queue.pop())
                self.clock.advance_to(batch[-1].time)
            self.controller.observe([b.time for b in batch])
            self.drains += 1
            handle_batch(self.clock.now, batch)
        return min(self.clock.now, self.max_time)
