"""The port's population engine (``repro_torch.core.population`` and the
simulator's population mode) against its materialized reference and
against the JAX package's engine, as ``tests/test_population.py`` holds the
reference:

* **table == materialized** at N = 256 on both server backends: the same
  event trace, eval curve, population counters and per-client table (slot
  numbers aside); and both equal the reference's trace and table from the
  reference's initial params;
* **engine invariance**: loop and cohort engines give the same trace,
  table, sampler state and batcher states;
* **dropout permanence** at 100,000 clients, and the sampler's exclusions;
* **EwmaStore** (the norm screen's per-client store in the table) and a
  FedBuff flush with a first-contact client;
* **SYNTHETIC_1M** builds in O(contacted) work, runs, and gives the
  reference's trace; a synchronous aggregator under a population raises.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as C
from repro.configs.scenarios import SYNTHETIC_1M as J1M
from repro.core import population as jpopulation
from repro.core import tasks as jtasks
from repro.core.simulator import FederatedSimulation as JSim
from repro_torch import configs as TC
from repro_torch.convert import params_from_numpy
from repro_torch.core import tasks as tasks_mod
from repro_torch.core.behavior import ClientBehavior
from repro_torch.core.population import EwmaStore, PopulationState
from repro_torch.core.screening import NormScreen
from repro_torch.core.simulator import FederatedSimulation


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: its steps are small, and
    with pytest-xdist's workers sharing the cores, every worker's default
    pool of one thread per core spins at each op's barrier. Restored after,
    for the other modules of the worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MODEL_BYTES = 10_000


def pop_setup(n, *, package=TC, population="table", arrival_rate=30.0,
              backend="pytree", engine="cohort", behavior="diurnal",
              stay=0.25, samples=32, **fed_kw):
    """A SYNTHETIC_1_1 clone at population scale ``n``."""
    base = package.SYNTHETIC_1_1
    fed = dataclasses.replace(
        base.fed, num_clients=n, population=population,
        arrival_rate=arrival_rate, session_stay_prob=stay,
        backend=backend, client_engine=engine, client_behavior=behavior,
        batch_window="auto", **fed_kw)
    task = dataclasses.replace(base, num_clients=n,
                               samples_per_client=samples, fed=fed)
    return task, fed


def trace(res):
    return [dataclasses.astuple(r) for r in res.history]


def key(res):
    return [(r.iteration, r.client_id, r.lag, r.k_used, r.k_next)
            for r in res.history]


def evals(res):
    return [dataclasses.astuple(p) for p in res.points]


def table_rows(sim, *, drop=("slot",), active_only=False):
    out = {}
    for idx, row in sim._population.table().items():
        if active_only and row["rounds"] == 0:
            continue
        out[idx] = {k: v for k, v in row.items() if k not in drop}
    return out


COUNTERS = ("checkins", "skipped_checkins", "sessions", "max_in_flight",
            "dropped")


@pytest.mark.parametrize("backend", ["pytree", "pallas"])
def test_table_equals_materialized_and_reference_n256(backend):
    jtask, jfed = pop_setup(256, package=C, backend=backend,
                            arrival_rate=40.0)
    jsim = JSim(jtask, jfed, "asyncfeded", seed=3)
    init = jax.tree.map(np.asarray, jsim.server.params)
    jres = jsim.run(max_time=1.5, eval_every=25)
    results = {}
    for mode in ("table", "materialized"):
        task, fed = pop_setup(256, population=mode, backend=backend,
                              arrival_rate=40.0)
        sim = FederatedSimulation(
            task, fed, "asyncfeded", seed=3, device="cpu",
            init_params=params_from_numpy(init, device="cpu"))
        results[mode] = (sim, sim.run(max_time=1.5, eval_every=25))
    (sim_t, res_t), (sim_m, res_m) = results["table"], results[
        "materialized"]
    assert res_t.total_updates >= 10
    assert trace(res_t) == trace(res_m)
    assert evals(res_t) == evals(res_m)
    for k in COUNTERS:
        assert res_t.population[k] == res_m.population[k], k
    assert (table_rows(sim_t, active_only=True)
            == table_rows(sim_m, active_only=True))
    assert (res_t.population["materialized"]
            == res_t.population["contacted"] < 256)
    assert res_m.population["materialized"] == 256
    # the reference: trace, counters and table (slots included)
    assert key(res_t) == key(jres)
    np.testing.assert_allclose([r.gamma for r in res_t.history],
                               [r.gamma for r in jres.history], rtol=1e-3,
                               atol=1e-6)
    np.testing.assert_allclose([p.accuracy for p in res_t.points],
                               [p.accuracy for p in jres.points], atol=0.01)
    assert res_t.population == jres.population
    jrows = jsim._population.table()
    rows = sim_t._population.table()
    assert list(rows) == list(jrows)
    for idx in rows:
        a, b = dict(rows[idx]), dict(jrows[idx])
        ea, eb = a.pop("ewma"), b.pop("ewma")
        assert a == b and (ea is None) == (eb is None)


def test_equivalence_with_screen_churn_dropout():
    """table == materialized with norm screening (EwmaStore against the
    screen's dict), churn, dropout and bursty arrivals on the flat server.
    (The burst gap is 0.1 s: at the default gap the reference's version of
    this test drains nothing in 2 virtual seconds.)"""
    results = {}
    for mode in ("table", "materialized"):
        task, fed = pop_setup(
            96, population=mode, backend="pallas",
            behavior="poisson-burst", arrival_rate=35.0,
            screen="reject", churn_prob=0.05, dropout_prob=0.05,
            behavior_params=(("burst_gap", 0.1),))
        sim = FederatedSimulation(task, fed, "asyncfeded", seed=11,
                                  device="cpu")
        results[mode] = (sim, sim.run(max_time=2.0, eval_every=25))
    (sim_t, res_t), (sim_m, res_m) = results["table"], results[
        "materialized"]
    assert trace(res_t) == trace(res_m) and res_t.total_updates > 0
    assert sim_t._population.dropped == sim_m._population.dropped
    assert res_t.population["dropped"] > 0 and res_t.screen["clients"] > 0
    assert (table_rows(sim_t, drop=("slot", "ewma"), active_only=True)
            == table_rows(sim_m, drop=("slot", "ewma"), active_only=True))
    assert sim_t.server.screen.stats() == sim_m.server.screen.stats()
    assert isinstance(sim_t.server.screen._baseline, EwmaStore)


def _engine_run(engine, seed=5):
    task, fed = pop_setup(64, engine=engine, arrival_rate=30.0,
                          churn_prob=0.05, dropout_prob=0.1)
    sim = FederatedSimulation(task, fed, "asyncfeded", seed=seed,
                              device="cpu")
    return sim, sim.run(max_time=2.0, eval_every=25)


def test_loop_vs_cohort_engine():
    (sim_a, res_a), (sim_b, res_b) = _engine_run("loop"), _engine_run(
        "cohort")
    assert key(res_a) == key(res_b)
    assert table_rows(sim_a, drop=()) == table_rows(sim_b, drop=())
    assert sim_a._population.dropped == sim_b._population.dropped
    assert (sim_a.behavior.pop_rng.bit_generator.state
            == sim_b.behavior.pop_rng.bit_generator.state)
    ca, cb = sim_a._population._clients, sim_b._population._clients
    assert set(ca) == set(cb) and len(ca) > 0
    for idx in ca:
        assert (ca[idx].batcher.rng.bit_generator.state
                == cb[idx].batcher.rng.bit_generator.state), idx
    assert res_a.plan is None and res_b.plan["engine"] == "cohort"


def test_dropped_never_redispatched_at_scale():
    n = 100_000
    task, fed = pop_setup(n, arrival_rate=30.0, dropout_prob=0.3, stay=0.5)
    sim = FederatedSimulation(task, fed, "asyncfeded", seed=7, device="cpu")
    log = []
    orig = sim.behavior.dispatch

    def spy(client_id, k, now):
        out = orig(client_id, k, now)
        log.append((client_id, out is None))
        return out

    sim.behavior.dispatch = spy
    res = sim.run(max_time=3.0, eval_every=100)
    pop = sim._population
    dead = set()
    for cid, dropped_now in log:
        assert cid not in dead, f"client {cid} re-admitted after drop"
        if dropped_now:
            dead.add(cid)
    assert dead == pop.dropped and len(dead) >= 3
    for cid in dead:
        assert cid in pop.excluded
        assert not pop.in_flight[pop.index_of[cid]]
    assert res.population["contacted"] < 1_000
    assert res.population["materialized"] == res.population["contacted"]
    assert sim.clients == []


def test_sampler_respects_excluded():
    fed = dataclasses.replace(
        TC.SYNTHETIC_1_1.fed, num_clients=4, population="table",
        arrival_rate=5.0)
    beh = ClientBehavior(fed, seed=0, model_bytes=MODEL_BYTES,
                         population=True, arrival_rate=5.0)
    assert beh.sample_index(frozenset({0, 1, 3})) == 2
    assert beh.sample_index(frozenset({0, 1, 2, 3})) is None


class TestEwmaStore:
    @pytest.fixture()
    def pop(self):
        task, fed = pop_setup(32)
        return PopulationState(tasks_mod.as_task(task), fed, seed=0,
                               device="cpu")

    def test_never_materialized_index_contract(self, pop):
        store = pop.screen_store()
        with pytest.raises(KeyError):
            store[7]
        assert store.get(7) is None
        store[7] = 1.5
        assert store[7] == 1.5
        assert 7 in pop.index_of and pop.ewma_set[pop.index_of[7]]
        del store[7]
        assert store.get(7) is None
        assert 7 in pop.index_of

    def test_overflow_keys(self, pop):
        store = pop.screen_store()
        store[-1] = 2.0
        store[None] = 3.0
        store[True] = 9.0                    # bool is NOT index 1
        assert store[-1] == 2.0 and store[None] == 3.0 and store[True] == 9.0
        assert pop.contacted == 0
        assert len(store) == 3 and set(store) == {-1, None, True}

    def test_warmup_prune_in_place(self, pop):
        screen = NormScreen("reject", k=3.0, alpha=0.2, warmup=4,
                            store=pop.screen_store())
        for cid, norm in ((20, 100.0), (1, 1.0), (2, 1.1), (3, 0.9)):
            screen.observe(norm, client_id=cid)
        assert screen._baseline.get(20) is None
        assert screen._baseline.get(1) is not None
        assert 20 in pop.index_of and not pop.ewma_set[pop.index_of[20]]
        verdict, _ = screen.observe(1.0, client_id=77)
        assert verdict == "accept"
        assert screen._baseline.get(77) is not None
        assert 77 not in pop._clients


def test_state_copy_equals_reference():
    """The numpy copy of PopulationState: the same operations give the
    reference's table, counters, capacity growth, exclusions and clients'
    data and streams."""
    task, fed = pop_setup(1_000)
    jtask, jfed = pop_setup(1_000, package=C)
    a = PopulationState(tasks_mod.as_task(task), fed, seed=4, device="cpu",
                        capacity=2)
    b = jpopulation.PopulationState(jtasks.as_task(jtask), jfed, seed=4,
                                    capacity=2)
    for pop in (a, b):
        for i, idx in enumerate((5, 900, 17, 5, 333, 42, 17)):
            pop.client(idx)
            pop.mark_dispatch(idx, i + 1)
            if i % 3 == 2:
                pop.mark_returned(idx)
        pop.mark_dropped(900)
        pop.screen_store()[42] = 0.5
        pop.checkins = 9
    assert a.table() == b.table() and a.stats() == b.stats()
    assert a.capacity == b.capacity == 8
    for idx in (5, 900, 17, 333, 42, 7):
        assert (idx in a.excluded) == (idx in b.excluded)
    for idx in a._clients:
        ca, cb = a._clients[idx], b._clients[idx]
        np.testing.assert_array_equal(ca.batcher.x, cb.batcher.x)
        np.testing.assert_array_equal(ca.batcher.y, cb.batcher.y)
        assert (ca.batcher.rng.bit_generator.state
                == cb.batcher.rng.bit_generator.state)
    for x, y in zip(a.eval_batch, b.eval_batch):
        np.testing.assert_array_equal(x, y)


def test_fedbuff_finalize_partial_buffer_population():
    task, fed = pop_setup(64, arrival_rate=30.0, screen="reject",
                          fedbuff_size=50)
    sim = FederatedSimulation(task, fed, "fedbuff", seed=2, device="cpu")
    res = sim.run(max_time=1.5, eval_every=25)
    flush = [r for r in res.history if r.client_id == -1]
    assert len(flush) == 1 and res.total_updates >= 1
    assert -1 not in sim._population.index_of
    assert isinstance(sim.server.screen._baseline, EwmaStore)


def test_synchronous_aggregator_raises():
    task, fed = pop_setup(16)
    sim = FederatedSimulation(task, fed, "fedavg", device="cpu")
    with pytest.raises(ValueError, match="population"):
        sim.run(max_time=1.0)


def test_million_clients_lazy_and_equal_to_reference():
    """SYNTHETIC_1M as configured: no roster, no 1M-wide array, and the
    reference's trace and counters from the reference's init."""
    jsim = JSim(J1M, J1M.fed, "asyncfeded", seed=0)
    init = jax.tree.map(np.asarray, jsim.server.params)
    jres = jsim.run(max_time=0.5, eval_every=50)
    sim = FederatedSimulation(TC.SYNTHETIC_1M, TC.SYNTHETIC_1M.fed,
                              "asyncfeded", seed=0, device="cpu",
                              init_params=params_from_numpy(init,
                                                            device="cpu"))
    pop = sim._population
    assert pop.fed.num_clients == 1_000_000
    assert sim.clients == [] and pop.contacted == 0
    assert sim.behavior.step_time is None
    res = sim.run(max_time=0.5, eval_every=50)
    stats = res.population
    assert 0 < stats["contacted"] <= stats["checkins"]
    assert stats["contacted"] < 10_000 and stats["capacity"] < 10_000
    assert key(res) == key(jres) and stats == jres.population
    assert res.plan == jres.plan
