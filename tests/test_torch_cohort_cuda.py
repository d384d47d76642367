"""The cohort engine, the population engine and checkpoints on the card,
held against the same code on the CPU. Every test here needs a CUDA card
and skips without one; the file imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cohort_cuda.py

Tolerances: a CUDA delta against the CPU's, 1e-4 of the delta's scale plus
a few ulps of the params' largest entry (cuBLAS and the CPU sum the
products in other orders, and a delta is x_K - x_0); within one device the
memory plans change no arithmetic, so they are held to the reference's
cohort-vs-loop tolerance (rtol 2e-5, atol 1e-7).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import checkpoint
from repro_torch import configs as TC
from repro_torch.core import cohort
from repro_torch.core.budget import CohortPlan
from repro_torch.core.client import Client
from repro_torch.core.server import AsyncFedEDServer
from repro_torch.core.simulator import FederatedSimulation
from repro_torch.core.tasks import as_task
from repro_torch.data.pipeline import load_task_datasets
from repro_torch.utils import pytree as pt

requires_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                   reason="needs a CUDA card")


def clients(name, n, device, seed=0):
    task = TC.PAPER_TASKS[name]
    train, _ = load_task_datasets(task, seed=seed)
    return [Client(i, task, train[i], task.fed, seed=seed, device=device)
            for i in range(n)]


def params(name, device):
    return as_task(TC.PAPER_TASKS[name]).init(
        torch.Generator().manual_seed(0), torch.device(device))


def close_to_cpu(cuda_delta, cpu_delta, p):
    for a, b, q in zip(pt.tree_leaves(cuda_delta), pt.tree_leaves(cpu_delta),
                       pt.tree_leaves(p)):
        tol = (1e-4 * float(b.abs().max())
               + 2.0 ** -18 * float(q.abs().max()))
        assert float((a.cpu() - b).abs().max()) <= tol


@requires_cuda
@pytest.mark.parametrize("name,ks", [("synthetic-1-1", [3, 7, 5, 1, 4]),
                                     ("synthetic-1-1", [6, 6, 6]),
                                     ("shakespeare", [2, 1, 2])])
def test_cuda_cohort_equals_cpu_cohort(name, ks):
    """Two fan-outs (momentum carried) on the card and on the CPU; the
    momentum rows stay on the card between them."""
    n = len(ks)
    pc, pg = params(name, "cpu"), params(name, "cuda")
    cc, cg = clients(name, n, "cpu"), clients(name, n, "cuda")
    task = TC.PAPER_TASKS[name]
    for rnd in (1, 2):
        cpu = cohort.run_cohort(task, cc, pc, ks, [rnd] * n)
        gpu = cohort.run_cohort(task, cg, pg, ks, [rnd] * n)
        for (u1, l1), (u2, l2) in zip(gpu, cpu):
            assert all(t.is_cuda for t in pt.tree_leaves(u1.delta))
            close_to_cpu(u1.delta, u2.delta, pc)
            assert abs(l1 - l2) < 1e-4
    assert all(t.is_cuda for c in cg for t in pt.tree_leaves(c._mu))


@requires_cuda
@pytest.mark.parametrize("width,k_chunk", [(2, 16), (4, 2), (2, 1)])
def test_cuda_plans_equal_unconstrained(width, k_chunk):
    ks = [3, 7, 5, 1, 4]
    p = params("synthetic-1-1", "cuda")
    plan = CohortPlan("cohort", width, k_chunk, 0, 0, 1, "test")
    a, b = clients("synthetic-1-1", 5, "cuda"), clients("synthetic-1-1", 5,
                                                        "cuda")
    full = cohort.run_cohort(TC.SYNTHETIC_1_1, a, p, ks, [1] * 5)
    cut = cohort.run_cohort(TC.SYNTHETIC_1_1, b, p, ks, [1] * 5, plan=plan)
    for (u1, _), (u2, _) in zip(full, cut):
        for x, y in zip(pt.tree_leaves(u1.delta), pt.tree_leaves(u2.delta)):
            torch.testing.assert_close(x, y, rtol=2e-5, atol=1e-7)


@requires_cuda
def test_cuda_delta_rows_do_not_alias():
    p = params("synthetic-1-1", "cuda")
    out = cohort.run_cohort(TC.SYNTHETIC_1_1, clients("synthetic-1-1", 4,
                                                      "cuda"), p,
                            [2, 3, 2, 1], [1] * 4)
    before = [pt.tree_map(torch.clone, u.delta) for u, _ in out]
    for leaf in pt.tree_leaves(out[1][0].delta):
        leaf.mul_(-2.0)
    for i in (0, 2, 3):
        assert all(torch.equal(x, y) for x, y in zip(
            pt.tree_leaves(out[i][0].delta), pt.tree_leaves(before[i])))


@requires_cuda
@pytest.mark.parametrize("backend", ["pytree", "pallas"])
def test_cuda_population_table_equals_materialized(backend):
    base = TC.SYNTHETIC_1_1
    res = {}
    for mode in ("table", "materialized"):
        fed = dataclasses.replace(
            base.fed, num_clients=64, population=mode, arrival_rate=30.0,
            session_stay_prob=0.25, backend=backend, client_engine="cohort",
            client_behavior="diurnal", batch_window="auto")
        task = dataclasses.replace(base, num_clients=64,
                                   samples_per_client=32, fed=fed)
        res[mode] = FederatedSimulation(task, fed, "asyncfeded", seed=3,
                                        device="cuda").run(max_time=1.5,
                                                           eval_every=25)
    t, m = res["table"], res["materialized"]
    assert t.total_updates > 0
    assert ([dataclasses.astuple(r) for r in t.history]
            == [dataclasses.astuple(r) for r in m.history])
    assert t.population["sessions"] == m.population["sessions"]


@requires_cuda
def test_cuda_checkpoint_restores_on_either_device(tmp_path):
    fed = dataclasses.replace(TC.SYNTHETIC_1_1.fed, backend="pallas")
    gpu = AsyncFedEDServer(params("synthetic-1-1", "cuda"), fed,
                           backend="pallas")
    gpu._flat = gpu._flat.replace(gpu._flat.vec * 1.5)
    gpu.save_checkpoint(str(tmp_path))
    cpu = AsyncFedEDServer(pt.tree_map(torch.zeros_like,
                                       params("synthetic-1-1", "cpu")), fed,
                           backend="pallas")
    cpu.restore_checkpoint(str(tmp_path))
    assert torch.equal(cpu._flat.vec, gpu._flat.vec.cpu())
    fresh = AsyncFedEDServer(pt.tree_map(torch.zeros_like,
                                         params("synthetic-1-1", "cuda")),
                             fed, backend="pallas")
    fresh.restore_checkpoint(str(tmp_path))
    assert fresh._flat.vec.is_cuda and torch.equal(fresh._flat.vec,
                                                   gpu._flat.vec)
    spec = gpu._flat.spec
    vec, meta = checkpoint.restore_flat(str(tmp_path),
                                        n_padded=3 * spec.n_padded)
    assert np.array_equal(vec[:spec.n], gpu._flat.vec[:spec.n].cpu().numpy())
    assert not vec[spec.n:].any() and meta["n"] == spec.n
