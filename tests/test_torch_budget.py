"""The port's memory planner (``repro_torch.core.budget``) and footprint law
(``repro_torch.configs.shapes``) against the reference's.

* The law and the task estimators equal the reference's, number for
  number.
* ``plan_cohort`` gives the reference's plan (``to_dict()`` equal) over a
  grid of budgets, client counts and step counts, ragged and uniform, with
  and without FedProx, compressed deltas and the per-device divisors.
* A budgeted simulation walks the ladder's rungs and gives the
  unconstrained run's event trace.
"""
import dataclasses

import pytest
import torch

from repro import configs as C
from repro.configs import shapes as jshapes
from repro.core import budget as jbudget
from repro.core import tasks as jtasks
from repro_torch import configs as TC
from repro_torch.configs import shapes
from repro_torch.core import budget, tasks
from repro_torch.core.simulator import FederatedSimulation
from torch_threads import one_torch_thread  # noqa: F401


NAMES = ["synthetic-1-1", "femnist", "shakespeare"]
#: parameter bytes of the three paper models (f32)
PARAM_BYTES = {"synthetic-1-1": 6_314 * 4, "femnist": 213_310 * 4,
               "shakespeare": 77_658 * 4}


def test_constants_and_law():
    assert shapes.PARAM_STATE_COPIES == jshapes.PARAM_STATE_COPIES
    assert shapes.DELTA_SCALE_BLOCK == jshapes.DELTA_SCALE_BLOCK
    for p in (4, 25_256, 853_240, 1 << 30):
        for mode in ("off", "bf16", "int8"):
            assert (shapes.delta_wire_bytes(p, mode)
                    == jshapes.delta_wire_bytes(p, mode))
        for args in ((1, 0, 1, 1), (3_136, 8_000, 64, 10), (40, 7, 2, 16)):
            for kw in ({}, {"delta_bytes": p // 4},
                       {"model_shards": 4}, {"delta_bytes": 7,
                                             "model_shards": 2}):
                assert (shapes.cohort_footprint_bytes(p, *args, **kw)
                        == jshapes.cohort_footprint_bytes(p, *args, **kw))


@pytest.mark.parametrize("name", NAMES)
def test_task_estimators(name):
    t, j = tasks.as_task(TC.PAPER_TASKS[name]), jtasks.as_task(
        C.PAPER_TASKS[name])
    for bs in (1, 32, 100):
        fed = dataclasses.replace(TC.PAPER_TASKS[name].fed,
                                  local_batch_size=bs)
        jfed = dataclasses.replace(C.PAPER_TASKS[name].fed,
                                   local_batch_size=bs)
        assert t.batch_bytes(fed) == j.batch_bytes(jfed)
        assert t.activation_bytes(fed) == j.activation_bytes(jfed)


def _grid(name):
    full = jbudget.plan_cohort(
        C.PAPER_TASKS[name], C.PAPER_TASKS[name].fed, clients=64, k=10,
        param_bytes=PARAM_BYTES[name]).full_bytes
    # from unlimited down past the 2-client, 1-step chunk, in steps of 10%
    return [0, full, full + 1, full - 1] + [max(1, int(full * 0.9 ** s))
                                            for s in range(1, 120)]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("prox_mu", [0.0, 0.1])
def test_plan_equals_reference(name, ragged, prox_mu):
    task, jtask = TC.PAPER_TASKS[name], C.PAPER_TASKS[name]
    rungs = set()
    for mode in ("off", "int8"):
        fed = dataclasses.replace(task.fed, client_engine="cohort",
                                  delta_compression=mode)
        jfed = dataclasses.replace(jtask.fed, client_engine="cohort",
                                   delta_compression=mode)
        for budget_bytes in _grid(name):
            for clients, k in ((2, 1), (5, 3), (64, 10), (256, 7)):
                kw = dict(clients=clients, k=k,
                          param_bytes=PARAM_BYTES[name], prox_mu=prox_mu,
                          ragged=ragged, budget_bytes=budget_bytes)
                plan = budget.plan_cohort(task, fed, **kw)
                assert plan.to_dict() == jbudget.plan_cohort(
                    jtask, jfed, **kw).to_dict(), kw
                rungs.add(plan.reason)
    # every rung of the ladder was reached: fits, width clamp, K split
    # (not under FedProx), loop
    assert "fits" in rungs
    assert any(r.startswith("vmap width clamped") for r in rungs)
    assert any("microbatches" in r for r in rungs) == (prox_mu == 0)
    assert any("per-client loop" in r for r in rungs)


def test_plan_divisors_equal_reference():
    """Pods and model shards divide the per-device charge as in the
    reference (the port runs neither yet; the planner takes them as
    overrides)."""
    task, jtask = TC.SYNTHETIC_1_1, C.SYNTHETIC_1_1
    for pods in (1, 2, 8):
        for shards in (1, 2, 4):
            for b in (0, 400_000, 2_000_000, 20_000_000):
                kw = dict(clients=64, k=10, param_bytes=25_256,
                          budget_bytes=b, pods=pods, model_shards=shards)
                assert (budget.plan_cohort(task, task.fed, **kw).to_dict()
                        == jbudget.plan_cohort(jtask, jtask.fed,
                                               **kw).to_dict())


def test_sharded_engine_raises_naming_a17():
    """The pod engine (A17) is ported: its plan divides by the pods its
    mesh gives, the reference's plan at that pod count (one CPU device: 1
    pod; under the device hook: the bucket's power of two, at most the
    device count)."""
    from repro_torch.launch import mesh
    fed = dataclasses.replace(TC.SYNTHETIC_1_1.fed,
                              client_engine="cohort_sharded")
    jfed = dataclasses.replace(C.SYNTHETIC_1_1.fed,
                               client_engine="cohort_sharded")
    kw = dict(clients=5, k=2, param_bytes=25_256, budget_bytes=40_000)
    for repeat, pods in ((1, 1), (4, 4), (16, 8)):
        with mesh.repeat_devices(repeat):
            got = budget.plan_cohort(TC.SYNTHETIC_1_1, fed, device="cpu",
                                     **kw)
        assert got.to_dict() == jbudget.plan_cohort(
            C.SYNTHETIC_1_1, jfed, pods=pods, **kw).to_dict()


def test_budget_from_config():
    fed = dataclasses.replace(TC.SYNTHETIC_1_1.fed, client_engine="cohort",
                              memory_budget_mb=0.5)
    plan = budget.plan_cohort(TC.SYNTHETIC_1_1, fed, clients=64, k=10,
                              param_bytes=25_256)
    assert plan.budget_bytes == 2 ** 19 and plan.constrained
    assert plan.est_bytes <= plan.budget_bytes < plan.full_bytes


def trace(res):
    return [(h.iteration, h.client_id, h.lag, h.k_next) for h in res.history]


@pytest.mark.parametrize("backend", ["pytree", "pallas"])
def test_budgeted_runs_equal_unconstrained(backend):
    """synthetic-1-1 with 10 clients and a 0.05 s window under three
    budgets: each lands its seeding fan-out on one lower rung (width
    clamp, K split, loop) and every run gives the unconstrained trace."""
    task = TC.SYNTHETIC_1_1
    fed0 = dataclasses.replace(task.fed, client_engine="cohort",
                               backend=backend, num_clients=10)
    free = FederatedSimulation(task, fed0, seed=2, batch_window=0.05,
                               device="cpu").run(max_time=3.0)
    assert free.plan["reason"] == "fits"
    bb, ab = (tasks.as_task(task).batch_bytes(fed0),
              tasks.as_task(task).activation_bytes(fed0))
    one = shapes.cohort_footprint_bytes(25_256, bb, ab, 1, 10)
    one_step = shapes.cohort_footprint_bytes(25_256, bb, ab, 1, 1)
    for budget_bytes, rung in ((4 * one, "vmap width clamped to 4"),
                               (2 * one_step + 1, "K-scan split"),
                               (one_step, "falling back")):
        fed = dataclasses.replace(fed0, memory_budget_mb=budget_bytes
                                  / 2 ** 20)
        sim = FederatedSimulation(task, fed, seed=2, batch_window=0.05,
                                  device="cpu")
        plans = []
        plan_fn = budget.plan_cohort

        def spy(*a, **kw):
            plans.append(plan_fn(*a, **kw))
            return plans[-1]

        budget.plan_cohort = spy
        try:
            res = sim.run(max_time=3.0)
        finally:
            budget.plan_cohort = plan_fn
        assert rung in plans[0].reason, plans[0]
        assert trace(res) == trace(free)
