"""Discrete-event simulation of asynchronous federated training.

Layers, composed here:

* **task substrate** (repro_torch.core.tasks) — *what* the clients train;
* **event runtime** (repro_torch.core.events) — virtual clock, arrival
  events, the drain loop and its batch-window policies;
* **client behavior** (repro_torch.core.behavior) — *when* updates land:
  ``paper`` reproduces the paper's §B.2 environment (lognormal device
  heterogeneity, TCP transmission, random suspension);
* **protocol** (repro_torch.core.server / client) — what an arrival does.

The event runtime, the behaviors and the data are numpy copies of the JAX
package's, so a seed gives the same event trace in both packages as long as
the adaptive K of every update agrees. The initial model cannot be drawn
as the reference draws it (``jax.random``): parity runs pass the
reference's params as ``init_params``; otherwise a ``torch.Generator``
seeded with ``seed`` draws them.

This slice runs the asynchronous roster loop with the per-client ``loop``
engine, burst windows and compressed deltas. Synchronous rounds, the
population engine, the cohort engines and the adversary are later slices
and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core import tasks as tasks_mod
from repro_torch.core.behavior import make_behavior
from repro_torch.core.client import Client
from repro_torch.core.events import EventLoop, make_window_controller
from repro_torch.core.server import ClientUpdate, ServerReply, make_server
from repro_torch.utils import pytree as pt
from repro_torch.utils.device import resolve_device

PyTree = Any


@dataclasses.dataclass
class EvalPoint:
    time: float
    iteration: int
    accuracy: float
    loss: float


@dataclasses.dataclass
class SimResult:
    algorithm: str
    points: List[EvalPoint]
    history: list
    total_updates: int
    #: server drain calls (== aggregations for window 0)
    total_drains: int = 0
    #: norm-screening counters; None when screening is off
    screen: Optional[dict] = None

    def max_accuracy(self, within_time: Optional[float] = None) -> float:
        pts = [p for p in self.points
               if within_time is None or p.time <= within_time]
        return max((p.accuracy for p in pts), default=0.0)

    def time_to_accuracy(self, target: float) -> float:
        for p in self.points:
            if p.accuracy >= target:
                return p.time
        return float("inf")

    def summary(self) -> dict:
        """The scalar row every benchmark driver reports."""
        out = {
            "algorithm": self.algorithm,
            "final_acc": float(self.points[-1].accuracy),
            "max_acc": float(self.max_accuracy()),
            "t90": float(self.time_to_accuracy(0.9 * self.max_accuracy())),
            "updates": self.total_updates,
            "drains": self.total_drains,
        }
        # mean staleness over FINITE gammas only (rejected arrivals record
        # gamma = NaN)
        gammas = [h.gamma for h in self.history if math.isfinite(h.gamma)]
        if gammas:
            out["mean_gamma"] = float(sum(gammas) / len(gammas))
        if self.screen is not None:
            out["screen"] = self.screen
        return out


def _check_supported(fed: FedConfig) -> None:
    for field, default, item in (("population", "off", "A15"),
                                 ("client_engine", "loop", "A14"),
                                 ("attack", "none", "A13")):
        if getattr(fed, field) != default:
            raise NotImplementedError(
                f"FedConfig.{field}={getattr(fed, field)!r} is not ported "
                f"yet (ROADMAP.md {item})")


class FederatedSimulation:
    def __init__(self, task, fed: FedConfig,
                 algorithm: str = "asyncfeded", seed: int = 0,
                 heterogeneity: float = 0.6,
                 server_kwargs: Optional[dict] = None,
                 batch_window: Optional[Any] = None,
                 behavior: Optional[str] = None,
                 behavior_kwargs: Optional[dict] = None, *,
                 device=None, init_params: Optional[PyTree] = None):
        """``device`` defaults to CUDA (raising when there is none);
        ``init_params`` is a tree of tensors to start from instead of the
        seeded init (it is moved to ``device``)."""
        _check_supported(fed)
        self.device = resolve_device(device)
        self.task = tasks_mod.as_task(task)
        self.fed = fed
        self.algorithm = algorithm
        self.batch_window = (fed.batch_window if batch_window is None
                             else batch_window)
        train_sets, eval_batch = self.task.load_data(fed, seed=seed)
        self.eval_batch = self.task.to_device(eval_batch, self.device)
        if init_params is None:
            init_params = self.task.init(torch.Generator().manual_seed(seed),
                                         self.device)
        params = pt.tree_map(lambda t: t.to(self.device), init_params)
        self.model_bytes = pt.tree_bytes(params)
        kw = dict(server_kwargs or {})
        if algorithm.startswith("asyncfeded"):
            kw.setdefault("backend", fed.backend)
        self.server = make_server(algorithm, params, fed, **kw)
        if not self.server.is_async:
            raise NotImplementedError(
                "synchronous rounds are not ported yet (ROADMAP.md A10)")
        self.clients = [Client(i, self.task, train_sets[i], fed, seed=seed,
                               device=self.device)
                        for i in range(fed.num_clients)]
        bkw = dict(fed.behavior_params)
        bkw.setdefault("churn_prob", fed.churn_prob)
        bkw.setdefault("dropout_prob", fed.dropout_prob)
        bkw.update(behavior_kwargs or {})
        self.behavior = make_behavior(
            behavior or fed.client_behavior, fed, seed=seed,
            model_bytes=self.model_bytes, heterogeneity=heterogeneity, **bkw)
        self.prox_mu = 0.0
        #: the last run's window controller (events.WindowController)
        self.window_controller = None
        self._max_updates: Optional[int] = None

    # --------------------------------------------------------------- eval --
    def _eval_point(self, time: float) -> EvalPoint:
        with torch.no_grad():
            acc, loss = self.task.eval_metrics(self.server.params,
                                               self.eval_batch)
        return EvalPoint(time, self.server.t, float(acc), float(loss))

    # ------------------------------------------------------- local training --
    def _dispatch(self, loop: EventLoop, now: float,
                  jobs: List[Tuple[Client, ServerReply]]) -> int:
        """Train a fan-out, then arm one arrival per client. Each update is
        put in wire form at emission, after training and before the queue.
        Behavior draws happen after training, in job order, as in the
        reference. Returns the number of updates dispatched (dropped-out
        clients count too)."""
        updates: List[ClientUpdate] = [
            c.run_local(r.params, r.k_next, r.iteration, self.prox_mu)[0]
            for c, r in jobs]
        for (c, reply), upd in zip(jobs, updates):
            upd = c.compress_update(upd)
            delay = self.behavior.dispatch(c.client_id, reply.k_next, now)
            if delay is not None:
                loop.queue.push(now + delay, c.client_id, upd)
            else:
                c.release_residual()   # permanent dropout: session over
        return len(jobs)

    # ---------------------------------------------------------------- run --
    def run(self, max_time: float = 300.0, eval_every: int = 5,
            max_updates: Optional[int] = None) -> SimResult:
        """Run until virtual ``max_time`` — or until ``max_updates``
        aggregated updates, whichever comes first."""
        self._max_updates = max_updates
        points = [self._eval_point(0.0)]
        auto_kw = {}
        if self.fed.window_gamma_threshold > 0:
            auto_kw["gamma_threshold"] = self.fed.window_gamma_threshold
        self.window_controller = make_window_controller(
            self.batch_window, batch_limit=self.server.batch_limit(),
            **auto_kw)
        loop = EventLoop(self.window_controller, max_time)
        # initial seeding: every client fans out at once
        self._dispatch(loop, 0.0, [(c, self.server.on_connect(c.client_id))
                                   for c in self.clients])
        updates = 0

        def handle(now: float, batch) -> None:
            nonlocal updates
            n_hist = len(self.server.history)
            replies = self.server.on_update_batch(
                [ev.payload for ev in batch])
            self.window_controller.observe_gamma(
                [h.gamma for h in self.server.history[n_hist:]])
            # one eval per drained batch even when it spans several
            # eval_every boundaries
            if updates // eval_every != (updates + len(batch)) // eval_every:
                points.append(self._eval_point(now))
            updates += self._dispatch(
                loop, now, [(self.clients[ev.client_id], reply)
                            for ev, reply in zip(batch, replies)])
            if self._max_updates is not None and updates >= self._max_updates:
                loop.stop()

        end = loop.run(handle)
        self.server.finalize(end)
        points.append(self._eval_point(end))
        return SimResult(self.algorithm, points, self.server.history,
                         updates, loop.drains, self.server.screen_stats())
