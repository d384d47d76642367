"""The architecture task through the port's event runtime against the JAX
package's: the contract of the reference's ``TestArchRuntime`` and
``TestArchWrapper`` (``tests/test_tasks.py``).

* Each client engine of the port gives the trace of the same engine of the
  reference from the reference's initial params (the loop and the cohort
  engine; the pod engine in ``test_torch_cohort_sharded.py``): the reference's tiny
  h2o-danube-1.8b (1 layer, d_model 64, 16 tokens, batch 2, three clients,
  K 2, six updates). Traces ``(iteration, client_id, lag, k_next)`` equal,
  gamma, eta and the eval losses at rtol 1e-4, atol 1e-5. A tiny
  mamba2-1.3b (its SSD scans vmapped over the clients) gives the loop
  engine's run on the cohort engine, to the same tolerances (its loss and
  gradients are held to the reference's in ``test_torch_arch_task.py``;
  the reference's CPU compile of its cohort costs 12 s here).
* A forced 1 MiB budget gives the reference's plan dict and the
  unconstrained run's trace; FedBuff's ``finalize`` flushes a partial
  buffer on the arch path; ``run_arch_federated`` returns the reference's
  keys; the three registered arch scenarios run as configured, cut by
  ``max_updates``.
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro.core import budget as jbudget
from repro.core import tasks as jtasks
from repro.core.simulator import FederatedSimulation as JSim
from repro.launch import train as jtrain
from repro_torch import configs as TC
from repro_torch.convert import params_from_numpy
from repro_torch.core import budget, tasks
from repro_torch.core.simulator import FederatedSimulation
from repro_torch.launch import train
from torch_threads import one_torch_thread  # noqa: F401


#: (arch, seq_len): the reference's tiny arch, and mamba2 over two of its
#: reduced 32-step chunks
TINY = {"h2o-danube-1.8b": 16, "mamba2-1.3b": 64}
UPDATES = 6
RUNS = [("h2o-danube-1.8b", "loop"), ("h2o-danube-1.8b", "cohort")]


def trace(res):
    return [(h.iteration, h.client_id, h.lag, h.k_next) for h in res.history]


def tiny(package, arch):
    return package.arch_task(arch, seq_len=TINY[arch], global_batch=2,
                             num_layers=1, d_model=64)


def fed_of(task, engine, budget_mb=0.0, **over):
    return dataclasses.replace(task.fed, num_clients=3, k_initial=2,
                               client_engine=engine,
                               memory_budget_mb=budget_mb, **over)


def run_pair(arch, engine, budget_mb=0.0):
    """The reference's run and the port's, from the reference's init."""
    jt = tiny(jtasks, arch)
    jsim = JSim(jt, fed_of(jt, engine, budget_mb), "asyncfeded", seed=0)
    init = jax.tree.map(np.asarray, jsim.server.params)
    jres = jsim.run(max_time=float("inf"), max_updates=UPDATES)
    tt = tiny(tasks, arch)
    tsim = FederatedSimulation(
        tt, fed_of(tt, engine, budget_mb), "asyncfeded", seed=0,
        device="cpu", init_params=params_from_numpy(init, device="cpu"))
    return jres, tsim.run(max_time=float("inf"), max_updates=UPDATES)


@pytest.fixture(scope="module")
def runs():
    """Every (arch, engine) pair of runs, and the 1 MiB budgeted pair."""
    out = {key: run_pair(*key) for key in RUNS}
    out["budget"] = run_pair("h2o-danube-1.8b", "cohort", budget_mb=1.0)
    return out


@pytest.mark.parametrize("key", RUNS, ids=lambda k: "-".join(k))
def test_engine_matches_reference_engine(runs, key):
    jres, tres = runs[key]
    assert tres.total_updates == jres.total_updates == UPDATES
    assert tres.total_drains == jres.total_drains
    assert trace(tres) == trace(jres)
    for field in ("gamma", "eta"):
        np.testing.assert_allclose([getattr(h, field) for h in tres.history],
                                   [getattr(h, field) for h in jres.history],
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose([p.loss for p in tres.points],
                               [p.loss for p in jres.points],
                               rtol=1e-4, atol=1e-5)
    assert [p.accuracy for p in tres.points] == pytest.approx(
        [p.accuracy for p in jres.points], abs=1e-6)
    assert tres.plan == jres.plan


def port_run(arch, engine):
    t = tiny(tasks, arch)
    return FederatedSimulation(t, fed_of(t, engine), "asyncfeded", seed=0,
                               device="cpu").run(max_time=float("inf"),
                                                 max_updates=UPDATES)


@pytest.mark.parametrize("arch", sorted(TINY))
def test_port_engines_agree(runs, arch):
    if arch == "h2o-danube-1.8b":
        loop, coh = (runs[(arch, e)][1] for e in ("loop", "cohort"))
    else:
        loop, coh = port_run(arch, "loop"), port_run(arch, "cohort")
    assert trace(loop) == trace(coh)
    assert coh.plan["engine"] == "cohort" and loop.plan is None
    for field in ("gamma", "eta"):
        np.testing.assert_allclose([getattr(h, field) for h in coh.history],
                                   [getattr(h, field) for h in loop.history],
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose([p.loss for p in coh.points],
                               [p.loss for p in loop.points],
                               rtol=1e-4, atol=1e-5)


def test_forced_low_budget_plan_equals_reference(runs):
    """1 MiB is far below the tiny arch's stacked footprint: the plan
    leaves the full-width cohort as the reference's does, and the run keeps
    the unconstrained trace."""
    jres, tres = runs["budget"]
    plan = tres.plan
    assert plan == jres.plan
    assert plan["engine"] == "loop" or plan["width"] < 4 \
        or plan["k_chunk"] < 2
    assert plan["budget_bytes"] == 2 ** 20
    assert plan["est_bytes"] <= plan["full_bytes"]
    assert tres.summary()["plan"] == plan
    _, unconstrained = runs[("h2o-danube-1.8b", "cohort")]
    assert trace(tres) == trace(unconstrained)
    np.testing.assert_allclose([h.gamma for h in tres.history],
                               [h.gamma for h in unconstrained.history],
                               rtol=1e-4, atol=1e-5)


def test_finalize_fires_on_arch_path():
    """A FedBuff run whose buffer cannot fill still flushes at the end."""
    t = tiny(tasks, "h2o-danube-1.8b")
    sim = FederatedSimulation(t, fed_of(t, "cohort", fedbuff_size=64),
                              "fedbuff", seed=0, device="cpu")
    res = sim.run(max_time=float("inf"), max_updates=UPDATES)
    assert sim.server.buffer == []
    assert len(res.history) == 1
    assert res.history[-1].client_id == -1


def test_run_arch_federated_keys(runs):
    """On the loop engine at the fixture's tiny task and K (the reference
    reuses the fixture's compiles)."""
    kw = dict(steps=2, num_clients=2, k_local=2, seed=0, d_model=64,
              seq_len=16, num_layers=1, global_batch=2,
              client_engine="loop")
    jout = jtrain.run_arch_federated("h2o-danube-1.8b", **kw)
    out = train.run_arch_federated("h2o-danube-1.8b", device="cpu", **kw)
    assert set(out) == set(jout)
    assert set(out["summary"]) == set(jout["summary"])
    assert out["summary"]["algorithm"] == "asyncfeded"
    assert out["updates"] >= 2
    assert all(h["k_next"] >= 1 for h in out["history"])
    assert [set(h) for h in out["history"]] == [set(h)
                                                for h in jout["history"]]


def test_run_paper_and_cli(tmp_path):
    """``run_paper`` returns the reference's keys; ``main`` runs the arch
    mode from the command line and writes its JSON."""
    out = train.run_paper("synthetic-1-1", "asyncfeded", max_time=1.0,
                          seed=0, suspension_prob=0.1, device="cpu")
    assert set(out) == {"task", "algorithm", "seed", "updates",
                        "final_accuracy", "max_accuracy", "curve"}
    assert out["updates"] > 0
    path = tmp_path / "arch.json"
    train.main(["--mode", "arch", "--arch", "h2o-danube-1.8b", "--steps",
                "2", "--clients", "2", "--k-local", "1", "--device", "cpu",
                "--out", str(path)])
    got = json.loads(path.read_text())
    assert got["updates"] >= 2 and got["arch"] == "h2o-danube-1.8b"


def test_cohort_sharded_names_a17():
    """The pod engine (A17, ported) trains the arch task: on one device its
    one pod gives the cohort engine's run, history for history."""
    kw = dict(steps=2, device="cpu", d_model=64, seq_len=16, num_layers=1)
    got = train.run_arch_federated("h2o-danube-1.8b",
                                   client_engine="cohort_sharded", **kw)
    want = train.run_arch_federated("h2o-danube-1.8b",
                                    client_engine="cohort", **kw)
    assert got["updates"] >= 2
    assert got["history"] == want["history"]
    assert got["losses"] == want["losses"]


@pytest.mark.parametrize("name", ["arch-danube-smoke", "arch-mamba2-smoke",
                                  "arch-danube-budgeted"])
def test_registered_scenarios_run(name):
    """As configured (cohort engine, auto window, the scenario's clients,
    size and budget), cut to eight updates; the budgeted scenario's plan
    is the reference's for the same fan-out."""
    scen = TC.SCENARIOS[name]
    task = tasks.as_task(name)
    assert isinstance(task, tasks.ArchTask) and task.fed is scen.fed
    sim = FederatedSimulation(name, scen.fed, "asyncfeded", seed=0,
                              device="cpu")
    res = sim.run(max_time=float("inf"), max_updates=8)
    assert res.total_updates >= 8
    assert all(math.isfinite(p.loss) for p in res.points)
    assert res.plan is not None
    kw = dict(clients=scen.fed.num_clients, k=scen.fed.k_initial,
              param_bytes=sim.model_bytes)
    want = jbudget.plan_cohort(jtasks.as_task(name), scen.fed, **kw)
    assert budget.plan_cohort(task, scen.fed, **kw).to_dict() == \
        want.to_dict()
    if name == "arch-danube-budgeted":
        assert want.constrained
