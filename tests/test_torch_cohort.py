"""The port's cohort engine (``repro_torch.core.cohort``) against its own
per-client loop and against the reference's cohort engine.

* Engine level: ``run_cohort`` equals ``[run_local ...]`` to the reference's
  cohort-vs-loop tolerance (``tests/test_cohort.py``: rtol 2e-5, atol 1e-7
  on deltas) with ragged K, uniform K, the FedProx anchor, per-client
  params, an empty cohort and the momentum carry over two fan-outs, on
  the MLP and the LSTM; and it equals the reference's ``run_cohort`` on the
  same inputs to 1e-4 of each delta's scale (the packages sum in other
  orders). The batcher streams end in the same state.
* The CNN: under vmap its convolutions become grouped ones, whose sums
  differ from the loop's by ulps, so a max-pool window whose two largest
  inputs lie closer than that routes its gradient elsewhere. Its test
  holds every client whose pools route alike in both forms to the same
  tolerances.
* Memory plans: width chunks and K segments give the unconstrained
  dispatch's deltas.
* Delta rows are views of one stacked tensor: writing one row in place,
  or taking every update through the adversary, compression and both
  server backends, leaves the other rows unchanged.
* Simulator: ``client_engine="cohort"`` gives the loop engine's event
  trace on both server backends, and the scaled scenarios as configured
  (synthetic-burst, synthetic-256, femnist-64 cut to 8 clients) give the
  reference's trace from the reference's initial params, gamma to rtol
  1e-3 and accuracy to 0.01, as ``tests/test_torch_simulator.py`` holds
  the loop engine.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as C
from repro.core import cohort as jcohort
from repro.core.client import Client as JClient
from repro.core.simulator import FederatedSimulation as JSim
from repro.models import small as jsmall
from repro_torch import configs as TC
from repro_torch.convert import params_from_numpy
from repro_torch.core import cohort
from repro_torch.core.adversary import make_adversary
from repro_torch.core.budget import CohortPlan
from repro_torch.core.client import Client
from repro_torch.core.server import AsyncFedEDServer
from repro_torch.core.simulator import FederatedSimulation
from repro_torch.data.pipeline import load_task_datasets
from repro_torch.models.small import CNN
from repro_torch.utils import pytree as pt
from torch_threads import one_torch_thread  # noqa: F401


TASKS = ["synthetic-1-1", "shakespeare"]


def jparams(name, seed=0):
    return jsmall.init_task_model(jax.random.PRNGKey(seed),
                                  C.PAPER_TASKS[name])


def tparams(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def make_clients(name, n, seed=0, package="torch"):
    task = (TC if package == "torch" else C).PAPER_TASKS[name]
    train, _ = load_task_datasets(task, seed=seed)
    if package == "torch":
        return [Client(i, task, train[i], task.fed, seed=seed, device="cpu")
                for i in range(n)]
    return [JClient(i, task, train[i], task.fed, seed=seed)
            for i in range(n)]


def assert_close(a, b, rtol=2e-5, atol=1e-7):
    for x, y in zip(pt.tree_leaves(a), pt.tree_leaves(b)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=rtol,
                                   atol=atol)


def assert_close_ref(t_delta, j_delta, params):
    """The port against the reference: 1e-4 of the delta's scale plus a
    few ulps of the params' largest entry (a delta is x_K - x_0)."""
    for t, j, q in zip(pt.tree_leaves(t_delta), jax.tree.leaves(j_delta),
                       jax.tree.leaves(params)):
        tol = (1e-4 * float(np.abs(np.asarray(j)).max())
               + 2.0 ** -18 * float(np.abs(np.asarray(q)).max()))
        assert float(np.abs(t.numpy() - np.asarray(j)).max()) <= tol


def same_meta(u1, u2):
    return ((u1.client_id, u1.k_used, u1.snapshot_iter, u1.num_samples)
            == (u2.client_id, u2.k_used, u2.snapshot_iter, u2.num_samples))


def test_bucket_size():
    assert [cohort.bucket_size(n) for n in (1, 2, 3, 5, 8, 9, 64)] == \
        [jcohort.bucket_size(n) for n in (1, 2, 3, 5, 8, 9, 64)] == \
        [1, 2, 4, 8, 8, 16, 64]
    with pytest.raises(ValueError):
        cohort.bucket_size(0)


# (ks per client, prox_mu) per case; the LSTM keeps K small
CASES = {"ragged": ([3, 7, 5, 1, 4], 0.0), "uniform": ([6, 6, 6], 0.0),
         "fedprox": ([2, 4, 3], 0.1)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", TASKS)
def test_cohort_equals_loop_and_reference(name, case):
    """Two fan-outs (the second carries the momentum of the first) through
    the port's cohort engine, its loop and the reference's cohort engine,
    from the same params and the same data."""
    ks, mu = CASES[case]
    if name == "shakespeare":
        ks = [max(1, k // 3) for k in ks]
    n = len(ks)
    p = jparams(name)
    tp = tparams(p)
    loop_c = make_clients(name, n)
    coh_c = make_clients(name, n)
    ref_c = make_clients(name, n, package="jax")
    for rnd in (1, 2):
        loop = [c.run_local(tp, k, rnd, mu) for c, k in zip(loop_c, ks)]
        coh = cohort.run_cohort(TC.PAPER_TASKS[name], coh_c, tp, ks,
                                [rnd] * n, prox_mu=mu)
        ref = jcohort.run_cohort(C.PAPER_TASKS[name], ref_c, p, ks,
                                 [rnd] * n, prox_mu=mu)
        for (u1, l1), (u2, l2), (u3, l3) in zip(loop, coh, ref):
            assert same_meta(u1, u2) and same_meta(u2, u3)
            assert_close(u1.delta, u2.delta)
            assert_close_ref(u2.delta, u3.delta, p)
            assert abs(l1 - l2) < 1e-5 and abs(l2 - l3) < 1e-4
    for a, b, c in zip(loop_c, coh_c, ref_c):
        assert a.round_idx == b.round_idx == c.round_idx == 2
        assert_close(a._mu, b._mu)
        assert (a.batcher.rng.bit_generator.state
                == b.batcher.rng.bit_generator.state
                == c.batcher.rng.bit_generator.state)


def _pool_routes(params, x):
    """The argmax indices of the FEMNIST CNN's two max-pools on batch
    ``x`` (NHWC): where each pooled window sends its gradient."""
    h1 = torch.relu(CNN._conv(params["conv1"], x.permute(0, 3, 1, 2)))
    p1, i1 = F.max_pool2d(h1, 2, return_indices=True)
    _, i2 = F.max_pool2d(torch.relu(CNN._conv(params["conv2"], p1)), 2,
                         return_indices=True)
    return i1, i2


def test_cnn_cohort_equals_loop_where_pools_route_alike():
    """One local step of eight FEMNIST clients, cohort against loop and
    against the reference's cohort. Every client whose max-pools route
    alike in the stacked and the per-client forward agrees to the
    tolerances above; the losses agree for all of them. (The batches hold
    windows whose two largest inputs are closer than the ulps the grouped
    convolution moves: those route elsewhere, as a client started a few
    ulps away would.)"""
    n, ks = 8, [1] * 8
    p = jparams("femnist")
    tp = tparams(p)
    loop_c, coh_c = make_clients("femnist", n), make_clients("femnist", n)
    ref_c = make_clients("femnist", n, package="jax")
    xs = torch.as_tensor(np.stack([c.batcher.next_stacked(1)[0][0]
                                   for c in make_clients("femnist", n)]))
    stacked = pt.tree_map(lambda t: t.expand(n, *t.shape), tp)
    routes = torch.func.vmap(_pool_routes)(stacked, xs)
    alike = [i for i in range(n)
             if all(torch.equal(r[i], s)
                    for r, s in zip(routes, _pool_routes(tp, xs[i])))]
    assert len(alike) >= 2
    loop = [c.run_local(tp, 1, 1) for c in loop_c]
    coh = cohort.run_cohort(TC.FEMNIST, coh_c, tp, ks, [1] * n)
    ref = jcohort.run_cohort(C.FEMNIST, ref_c, p, ks, [1] * n)
    for i in range(n):
        (u1, l1), (u2, l2), (u3, _) = loop[i], coh[i], ref[i]
        assert abs(l1 - l2) < 1e-5
        if i in alike:
            assert_close(u1.delta, u2.delta)
            assert_close_ref(u2.delta, u3.delta, p)


def test_per_client_params():
    """Distinct snapshots are stacked instead of shared."""
    p = tparams(jparams("synthetic-1-1"))
    bumped = pt.tree_map(lambda t: t + 0.01, p)
    loop_c = make_clients("synthetic-1-1", 2, seed=4)
    coh_c = make_clients("synthetic-1-1", 2, seed=4)
    loop = [loop_c[0].run_local(p, 3, 1), loop_c[1].run_local(bumped, 3, 1)]
    coh = cohort.run_cohort(TC.SYNTHETIC_1_1, coh_c, [p, bumped], [3, 3],
                            [1, 1], per_client_params=True)
    for (u1, _), (u2, _) in zip(loop, coh):
        assert_close(u1.delta, u2.delta)


def test_empty_cohort_and_engines():
    assert cohort.run_cohort(TC.SYNTHETIC_1_1, [], [], [], []) == []
    clients = make_clients("synthetic-1-1", 2)
    p = tparams(jparams("synthetic-1-1"))
    # the pod engine (A17, ported) on one device: the cohort engine's rows
    same = make_clients("synthetic-1-1", 2)
    got = cohort.run_cohort(TC.SYNTHETIC_1_1, clients, p, [2, 2], [1, 1],
                            engine="cohort_sharded")
    want = cohort.run_cohort(TC.SYNTHETIC_1_1, same, p, [2, 2], [1, 1])
    for (u1, l1), (u2, l2) in zip(got, want):
        assert same_meta(u1, u2) and l1 == l2
        assert_close(u1.delta, u2.delta, rtol=0.0, atol=0.0)
    with pytest.raises(ValueError, match="engine"):
        cohort.run_cohort(TC.SYNTHETIC_1_1, clients, p, [2, 2], [1, 1],
                          engine="loop")


@pytest.mark.parametrize("width,k_chunk", [(2, 16), (4, 2), (2, 1)])
def test_plans_equal_unconstrained(width, k_chunk):
    """Width chunks and K segments (the carry threaded between segments)
    give the single dispatch's deltas, momentum and losses."""
    ks = [3, 7, 5, 1, 4]
    p = tparams(jparams("synthetic-1-1"))
    plan = CohortPlan("cohort", width, k_chunk, 0, 0, 1, "test")
    full_c = make_clients("synthetic-1-1", 5)
    plan_c = make_clients("synthetic-1-1", 5)
    for rnd in (1, 2):
        full = cohort.run_cohort(TC.SYNTHETIC_1_1, full_c, p, ks, [rnd] * 5)
        cut = cohort.run_cohort(TC.SYNTHETIC_1_1, plan_c, p, ks, [rnd] * 5,
                                plan=plan)
        for (u1, l1), (u2, l2) in zip(full, cut):
            assert_close(u1.delta, u2.delta)
            assert abs(l1 - l2) < 1e-5
    for a, b in zip(full_c, plan_c):
        assert_close(a._mu, b._mu)


class TestAliasing:
    """The delta rows of one fan-out are views of one stacked tensor."""

    def _fan_out(self):
        p = tparams(jparams("synthetic-1-1"))
        clients = make_clients("synthetic-1-1", 5)
        out = cohort.run_cohort(TC.SYNTHETIC_1_1, clients, p,
                                [3, 7, 5, 1, 4], [1] * 5)
        return p, clients, [u for u, _ in out]

    @staticmethod
    def _copy(upds):
        return [pt.tree_map(torch.clone, u.delta) for u in upds]

    def test_rows_are_disjoint(self):
        _, _, upds = self._fan_out()
        before = self._copy(upds)
        for leaf in pt.tree_leaves(upds[2].delta):
            leaf.mul_(-3.0).add_(1.0)
        for i, u in enumerate(upds):
            if i != 2:
                assert all(torch.equal(a, b) for a, b in zip(
                    pt.tree_leaves(u.delta), pt.tree_leaves(before[i])))

    @pytest.mark.parametrize("backend", ["pytree", "pallas"])
    @pytest.mark.parametrize("mode", ["off", "int8"])
    def test_pipeline_leaves_rows_unchanged(self, backend, mode):
        """Every row through the adversary (sign-flip on some clients),
        compression and a burst drain of the server: no row of the fan-out
        changes."""
        p, clients, upds = self._fan_out()
        before = self._copy(upds)
        fed = dataclasses.replace(TC.SYNTHETIC_1_1.fed, backend=backend,
                                  delta_compression=mode, attack="sign-flip",
                                  attack_frac=0.4, num_clients=5)
        adv = make_adversary(fed, seed=0)
        server = AsyncFedEDServer(p, fed, backend=backend)
        wire = []
        for c, u in zip(clients, upds):
            server.on_connect(c.client_id)
            c.fed = fed
            wire.append(c.compress_update(adv.corrupt(u)))
        server.on_update_batch(wire)
        server.on_update(wire[0])
        for u, b in zip(upds, before):
            assert all(torch.equal(x, y) for x, y in zip(
                pt.tree_leaves(u.delta), pt.tree_leaves(b)))


def trace(res):
    return [(h.iteration, h.client_id, h.lag, h.k_next) for h in res.history]


@pytest.mark.parametrize("backend", ["pytree", "pallas"])
def test_simulator_cohort_equals_loop(backend):
    """A burst window drives both fan-out sites: the seeding (uniform K)
    and the burst re-dispatch (ragged K once adaptive K diverges)."""
    task = TC.SYNTHETIC_1_1
    fed_l = dataclasses.replace(task.fed, backend=backend)
    fed_c = dataclasses.replace(fed_l, client_engine="cohort")
    r1 = FederatedSimulation(task, fed_l, "asyncfeded", seed=3,
                             batch_window=0.05, device="cpu").run(max_time=4.0)
    r2 = FederatedSimulation(task, fed_c, "asyncfeded", seed=3,
                             batch_window=0.05, device="cpu").run(max_time=4.0)
    assert r1.total_updates == r2.total_updates > 20
    assert trace(r1) == trace(r2)
    assert len({h.k_next for h in r1.history}) > 1
    np.testing.assert_allclose([h.gamma for h in r1.history],
                               [h.gamma for h in r2.history],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose([p.accuracy for p in r1.points],
                               [p.accuracy for p in r2.points], rtol=1e-4)
    assert r1.plan is None and r2.plan["engine"] == "cohort"


def test_fedavg_rounds_cohort_equals_loop():
    task = TC.SYNTHETIC_1_1
    fed_c = dataclasses.replace(task.fed, client_engine="cohort")
    r1 = FederatedSimulation(task, task.fed, "fedavg", seed=1,
                             device="cpu").run(max_time=25.0)
    r2 = FederatedSimulation(task, fed_c, "fedavg", seed=1,
                             device="cpu").run(max_time=25.0)
    assert r1.total_updates == r2.total_updates >= 2
    np.testing.assert_allclose([p.accuracy for p in r1.points],
                               [p.accuracy for p in r2.points], rtol=1e-4)
    np.testing.assert_allclose([p.loss for p in r1.points],
                               [p.loss for p in r2.points], rtol=1e-4)


# scenario, FedConfig changes, update cap
SCENARIOS = {"synthetic-burst": ({}, 60), "synthetic-256": ({}, 300),
             "femnist-64": ({"num_clients": 8}, 12)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_trace_equals_reference(name):
    """The scenarios as the repo ships them (cohort engine; femnist-64 cut
    to 8 of its 64 clients: the reference's CPU compile of a 64-client CNN
    fan-out takes minutes) give the reference's trace, drains and plan."""
    change, cap = SCENARIOS[name]
    fed = dataclasses.replace(C.SCENARIOS[name].fed, **change)
    assert fed.client_engine == "cohort"
    jsim = JSim(C.SCENARIOS[name], fed, "asyncfeded", seed=0)
    init = jax.tree.map(np.asarray, jsim.server.params)
    jres = jsim.run(max_time=1e9, max_updates=cap)
    tsim = FederatedSimulation(TC.SCENARIOS[name], fed, "asyncfeded", seed=0,
                               device="cpu",
                               init_params=params_from_numpy(init,
                                                             device="cpu"))
    tres = tsim.run(max_time=1e9, max_updates=cap)
    key = lambda h: [(r.iteration, r.client_id, r.lag, r.k_used, r.k_next)
                     for r in h]
    assert key(tres.history) == key(jres.history)
    assert (tres.total_updates, tres.total_drains) == (jres.total_updates,
                                                       jres.total_drains)
    assert tres.plan == jres.plan and tres.plan["engine"] == "cohort"
    np.testing.assert_allclose([r.gamma for r in tres.history],
                               [r.gamma for r in jres.history], rtol=1e-3,
                               atol=1e-6)
    np.testing.assert_allclose([p.accuracy for p in tres.points],
                               [p.accuracy for p in jres.points], atol=0.01)
