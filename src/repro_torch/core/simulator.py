"""Discrete-event simulation of asynchronous federated training.

Layers, composed here:

* **task substrate** (repro_torch.core.tasks) — *what* the clients train:
  the paper's three models, or an assigned architecture (``ArchTask``),
  whose eval batch is a token dict;
* **event runtime** (repro_torch.core.events) — virtual clock, arrival
  events, the drain loop and its batch-window policies;
* **client behavior** (repro_torch.core.behavior) — *when* updates land:
  ``paper`` reproduces the paper's §B.2 environment (lognormal device
  heterogeneity, TCP transmission, random suspension);
* **protocol** (repro_torch.core.server / client / cohort) — what an
  arrival does: aggregation through either server backend, local training
  through the per-client loop or the cohort engine, with cohort fan-outs
  planned against the memory budget (repro_torch.core.budget).

The event runtime, the behaviors and the data are numpy copies of the JAX
package's, so a seed gives the same event trace in both packages as long as
the adaptive K of every update agrees. The initial model cannot be drawn
as the reference draws it (``jax.random``): parity runs pass the
reference's params as ``init_params``; otherwise a ``torch.Generator``
seeded with ``seed`` draws them.

The port runs the asynchronous roster loop, burst windows, compressed
deltas and the adversary, the synchronous rounds of FedAvg/FedProx (whose
round lasts as long as its slowest client), the ``loop`` and ``cohort``
client engines and the pod engine ``cohort_sharded`` (the cohort engine
over the ``pod`` axis of a mesh, ``launch/mesh.py``), the model-sharded
flat server (``FedConfig.model_shards``), and the population engine
(``FedConfig.population``: clients check in from a distribution and
materialize on first contact).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core import budget as budget_mod
from repro_torch.core import cohort
from repro_torch.core import population as population_mod
from repro_torch.core import screening
from repro_torch.core import tasks as tasks_mod
from repro_torch.core.adversary import make_adversary
from repro_torch.core.behavior import make_behavior
from repro_torch.core.client import Client
from repro_torch.core.events import (CHECKIN, EventLoop, VirtualClock,
                                     make_window_controller)
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
    #: server drain calls (== aggregations for window 0; == rounds for
    #: synchronous servers)
    total_drains: int = 0
    #: the memory plan the last cohort fan-out ran under
    #: (budget.CohortPlan.to_dict()); None when no cohort fan-out happened
    plan: Optional[dict] = None
    #: norm-screening counters; None when screening is off
    screen: Optional[dict] = None
    #: adversary stats (attack name, corrupted client ids, applications);
    #: None for benign runs
    attack: Optional[dict] = None
    #: population-engine counters (population.PopulationState.stats());
    #: None for roster runs
    population: Optional[dict] = None

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
        if self.plan is not None:
            out["plan"] = self.plan
        if self.screen is not None:
            out["screen"] = self.screen
        if self.attack is not None:
            out["attack"] = self.attack
        if self.population is not None:
            out["population"] = self.population
        return out

    def to_json(self) -> dict:
        """JSON-serializable record: the summary plus the accuracy curve."""
        out = self.summary()
        out["curve"] = [(p.time, p.accuracy) for p in self.points]
        return out


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
        self.device = resolve_device(device)
        self.task = tasks_mod.as_task(task)
        self.fed = fed
        self.algorithm = algorithm
        self.batch_window = (fed.batch_window if batch_window is None
                             else batch_window)
        # population engine: no roster and no O(num_clients) work in this
        # constructor; clients materialize on first contact from (seed,
        # index)
        self._population: Optional[population_mod.PopulationState] = None
        if fed.population != "off":
            self._population = population_mod.PopulationState(
                self.task, fed, seed=seed, device=self.device)
            eval_batch = self._population.eval_batch
        else:
            train_sets, eval_batch = self.task.load_data(fed, seed=seed)
        self.eval_batch = self.task.to_device(eval_batch, self.device)
        if init_params is None:
            init_params = self.task.init(torch.Generator().manual_seed(seed),
                                         self.device)
        params = pt.tree_map(lambda t: t.to(self.device), init_params)
        self.model_bytes = pt.tree_bytes(params)
        kw = dict(server_kwargs or {})
        if (algorithm.startswith("asyncfeded")
                and algorithm != "asyncfeded-perleaf"):
            # per-leaf staleness only exists on the pytree backend
            kw.setdefault("backend", fed.backend)
        self.server = make_server(algorithm, params, fed, **kw)
        if self._population is not None:
            self.clients = []
            if self.server.screen is not None and fed.population == "table":
                # the norm screen's per-client EWMA baselines live in the
                # active-set table (the materialized reference keeps the
                # default dict: same mapping, same traces)
                self.server.screen = screening.make_screen(
                    fed, store=self._population.screen_store())
        else:
            self.clients = [Client(i, self.task, train_sets[i], fed,
                                   seed=seed, device=self.device)
                            for i in range(fed.num_clients)]
        bkw = dict(fed.behavior_params)
        bkw.setdefault("churn_prob", fed.churn_prob)
        bkw.setdefault("dropout_prob", fed.dropout_prob)
        bkw.update(behavior_kwargs or {})
        if self._population is not None:
            bkw.setdefault("population", True)
            bkw.setdefault("arrival_rate", fed.arrival_rate)
            bkw.setdefault("session_stay_prob", fed.session_stay_prob)
        self.behavior = make_behavior(
            behavior or fed.client_behavior, fed, seed=seed,
            model_bytes=self.model_bytes, heterogeneity=heterogeneity, **bkw)
        if self._population is not None and fed.population == "materialized":
            self._population.materialize_all(self.behavior)
        # None for benign configs: no extra RNG stream exists
        self.adversary = make_adversary(fed, seed=seed)
        self.prox_mu = fed.fedprox_mu if algorithm == "fedprox" else 0.0
        #: the last run's window controller (events.WindowController)
        self.window_controller = None
        #: the last cohort fan-out's memory plan (budget.CohortPlan)
        self.cohort_plan = None
        self._max_updates: Optional[int] = None

    # --------------------------------------------------------------- eval --
    def _eval_point(self, time: float) -> EvalPoint:
        with torch.no_grad():
            acc, loss = self.task.eval_metrics(self.server.params,
                                               self.eval_batch)
        return EvalPoint(time, self.server.t, float(acc), float(loss))

    def _plan_dict(self) -> Optional[dict]:
        return None if self.cohort_plan is None else self.cohort_plan.to_dict()

    def _attack_dict(self) -> Optional[dict]:
        return None if self.adversary is None else self.adversary.stats()

    # ------------------------------------------------------- local training --
    def _run_locals(self, jobs: List[Tuple[Client, ServerReply]]
                    ) -> List[ClientUpdate]:
        """Train every ``(client, reply)`` job, in job order.

        ``FedConfig.client_engine`` picks the engine: the per-client loop,
        or the cohort engine, which trains a fan-out of two or more clients
        stacked (repro_torch.core.cohort). A cohort fan-out is planned
        against ``FedConfig.memory_budget_mb`` first (repro_torch.core.
        budget): the plan clamps the vmap width, splits the steps, or sends
        the fan-out to the loop when even a 2-client chunk overflows. Both
        engines draw the same batches in the same order, so the event trace
        does not depend on the engine."""
        if self.fed.client_engine in cohort.COHORT_ENGINES and len(jobs) > 1:
            ks = [r.k_next for _, r in jobs]
            plan = budget_mod.plan_cohort(
                self.task, self.fed, clients=len(jobs), k=max(ks),
                param_bytes=self.model_bytes, prox_mu=self.prox_mu,
                ragged=len(set(ks)) > 1, device=self.device)
            self.cohort_plan = plan
            if plan.engine != "loop":
                # run_cohort collapses one shared snapshot object (every
                # server path hands a burst the same model) to a view
                out = cohort.run_cohort(
                    self.task, [c for c, _ in jobs],
                    [r.params for _, r in jobs], ks,
                    [r.iteration for _, r in jobs], prox_mu=self.prox_mu,
                    per_client_params=True, engine=plan.engine, plan=plan)
                return [u for u, _ in out]
        return [c.run_local(r.params, r.k_next, r.iteration,
                            self.prox_mu)[0] for c, r in jobs]

    def _dispatch(self, loop: EventLoop, now: float,
                  jobs: List[Tuple[Client, ServerReply]]) -> int:
        """Train a fan-out, then arm one arrival per client. A byzantine
        client's delta is corrupted at emission, after training; then each
        update is put in wire form, so the wire carries what the attacker
        emitted. Behavior draws happen after training, in job order, as in
        the reference. Returns the number of updates dispatched
        (dropped-out clients count too)."""
        for (c, reply), upd in zip(jobs, self._run_locals(jobs)):
            if self.adversary is not None:
                upd = self.adversary.corrupt(upd)
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
        aggregated updates (rounds, for a synchronous server), whichever
        comes first."""
        self._max_updates = max_updates
        if self._population is not None:
            if not self.server.is_async:
                raise ValueError(
                    "population mode drives the async drain loop; "
                    "synchronous aggregators need population='off'")
            return self._run_population(max_time, eval_every)
        if self.server.is_async:
            return self._run_async(max_time, eval_every)
        return self._run_sync(max_time, eval_every)

    def _run_async(self, max_time: float, eval_every: int) -> SimResult:
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
                         updates, loop.drains, self._plan_dict(),
                         self.server.screen_stats(), self._attack_dict())

    def _dispatch_population(self, loop: EventLoop, now: float,
                             jobs: List[Tuple[Client, ServerReply]]) -> None:
        """Population-mode fan-out: :meth:`_dispatch` plus the active-set
        bookkeeping. A dropout is permanent (the arrival sampler never
        re-admits the index); a live dispatch marks the index in flight, so
        a check-in cannot start a second session for it."""
        pop = self._population
        for (c, reply), upd in zip(jobs, self._run_locals(jobs)):
            if self.adversary is not None:
                upd = self.adversary.corrupt(upd)
            upd = c.compress_update(upd)
            delay = self.behavior.dispatch(c.client_id, reply.k_next, now)
            if delay is None:
                pop.mark_dropped(c.client_id)
                c.release_residual()
                self.server.on_disconnect(c.client_id)
            else:
                pop.mark_dispatch(c.client_id, reply.iteration)
                loop.queue.push(now + delay, c.client_id, upd)

    def _run_population(self, max_time: float, eval_every: int) -> SimResult:
        """The population drain loop.

        Two event species share one queue: *uploads* (a dispatched client's
        update landing, as in :meth:`_run_async`) and *check-ins* (the
        ``events.CHECKIN`` sentinel: an anonymous client of the population
        contacting the server). Each drained check-in schedules the next,
        so one check-in is pending at any time and the queue holds O(in
        flight) events, never O(num_clients).

        Per drained batch, in event order: uploads aggregate through
        ``on_update_batch`` and each drained client draws
        ``session_continue`` (another round, or back to the pool); then each
        check-in draws its population index (skipping dropped and
        in-flight indices) and connects. Both groups fan out as ONE job, so
        the cohort engine trains admissions and continuations together.
        Every per-index draw derives from (seed, index), so the lazy table
        and the materialized reference give the same trace."""
        pop = self._population
        beh = self.behavior
        points = [self._eval_point(0.0)]
        auto_kw = {}
        if self.fed.window_gamma_threshold > 0:
            auto_kw["gamma_threshold"] = self.fed.window_gamma_threshold
        self.window_controller = make_window_controller(
            self.batch_window, batch_limit=self.server.batch_limit(),
            **auto_kw)
        loop = EventLoop(self.window_controller, max_time)
        loop.queue.push(beh.next_checkin(0.0), -1, CHECKIN)
        updates = 0

        def handle(now: float, batch) -> None:
            nonlocal updates
            uploads = [ev for ev in batch if ev.payload is not CHECKIN]
            checkins = [ev for ev in batch if ev.payload is CHECKIN]
            # chain the check-in process first, so an empty drain cannot
            # stall the run
            for ev in checkins:
                loop.queue.push(beh.next_checkin(ev.time), -1, CHECKIN)
            jobs: List[Tuple[Client, ServerReply]] = []
            if uploads:
                n_hist = len(self.server.history)
                replies = self.server.on_update_batch(
                    [ev.payload for ev in uploads])
                self.window_controller.observe_gamma(
                    [h.gamma for h in self.server.history[n_hist:]])
                before = updates
                updates += len(uploads)
                if before // eval_every != updates // eval_every:
                    points.append(self._eval_point(now))
                for ev, reply in zip(uploads, replies):
                    if beh.session_continue(ev.client_id):
                        # stays in flight: a check-in of this batch cannot
                        # draw the index into a second session
                        jobs.append((pop.client(ev.client_id), reply))
                    else:
                        pop.mark_returned(ev.client_id)
                        pop.client(ev.client_id).release_residual()
                        self.server.on_disconnect(ev.client_id)
            for ev in checkins:
                pop.checkins += 1
                idx = beh.sample_index(pop.excluded)
                if idx is None:          # pool exhausted (tiny N only)
                    pop.skipped_checkins += 1
                    continue
                jobs.append((pop.client(idx), self.server.on_connect(idx)))
            if jobs:
                self._dispatch_population(loop, now, jobs)
            if self._max_updates is not None and updates >= self._max_updates:
                loop.stop()

        end = loop.run(handle)
        self.server.finalize(end)
        points.append(self._eval_point(end))
        return SimResult(self.algorithm, points, self.server.history,
                         updates, loop.drains, self._plan_dict(),
                         self.server.screen_stats(), self._attack_dict(),
                         pop.stats())

    def _run_sync(self, max_time: float, eval_every: int) -> SimResult:
        """Synchronous rounds: the whole surviving roster trains from one
        reply; the round lasts as long as its slowest client."""
        points = [self._eval_point(0.0)]
        clock = VirtualClock()
        roster = list(self.clients)
        rounds = 0
        while clock.now < max_time and roster:
            reply0 = self.server.on_connect(0)
            updates = self._run_locals([(c, reply0) for c in roster])
            if self.adversary is not None:
                updates = [self.adversary.corrupt(u) for u in updates]
            durations = [self.behavior.dispatch(c.client_id, reply0.k_next,
                                                clock.now)
                         for c in roster]
            # a dropped client's update still aggregates (it uploaded, then
            # left), but it joins no later round
            roster = [c for c, d in zip(roster, durations) if d is not None]
            live = [d for d in durations if d is not None]
            if not live:                   # every client dropped out
                break
            clock.advance(max(live))       # the straggler sets the round
            self.server.round(updates)
            rounds += 1
            if rounds % max(1, eval_every // 2) == 0 or clock.now >= max_time:
                points.append(self._eval_point(min(clock.now, max_time)))
            if self._max_updates is not None and rounds >= self._max_updates:
                break
        self.server.finalize(min(clock.now, max_time))
        return SimResult(self.algorithm, points, self.server.history,
                         rounds, rounds, self._plan_dict(),
                         self.server.screen_stats(), self._attack_dict())


def run_comparison(task, algorithms: List[str],
                   fed: Optional[FedConfig] = None, max_time: float = 300.0,
                   seeds: Tuple[int, ...] = (0,), eval_every: int = 5,
                   suspension_prob: Optional[float] = None, *,
                   heterogeneity: float = 0.6,
                   server_kwargs: Optional[dict] = None,
                   batch_window: Optional[Any] = None,
                   behavior_kwargs: Optional[dict] = None,
                   device=None, init_params: Optional[PyTree] = None
                   ) -> Dict[str, List[SimResult]]:
    """Fig. 2/3 comparison: the same task, clients and clock across algorithms.

    ``heterogeneity``, ``server_kwargs`` (e.g. ``{"backend": "pallas"}``),
    ``batch_window``, ``behavior_kwargs``, ``device`` and ``init_params``
    are passed to every :class:`FederatedSimulation`."""
    task = tasks_mod.as_task(task)
    fed = fed or task.fed
    if suspension_prob is not None:
        fed = dataclasses.replace(fed, suspension_prob=suspension_prob)
    out: Dict[str, List[SimResult]] = {}
    for alg in algorithms:
        runs = []
        for seed in seeds:
            sim = FederatedSimulation(
                task, fed, algorithm=alg, seed=seed,
                heterogeneity=heterogeneity, server_kwargs=server_kwargs,
                batch_window=batch_window, behavior_kwargs=behavior_kwargs,
                device=device, init_params=init_params)
            runs.append(sim.run(max_time=max_time, eval_every=eval_every))
        out[alg] = runs
    return out
