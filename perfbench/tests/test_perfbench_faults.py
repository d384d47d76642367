"""``correct`` comes out true for the port and false for its control and
for each fault a cell can have, at a size the CPU runs in a second.

Each fault is planted underneath the harness, in the program the harness
drives: a step that leaves the state unchanged, half of each batch left
out (the mean taken over the rest), an answer altered where it is
produced. Two training faults switch on only after the seeding drains: a
client that drops its momentum between rounds, and a server whose Eq. 8
goes wrong once the window is open. The exchange between chips does not exist on the cells' one
chip. The controls: the reference in the program's place with its matrix
products in TF32 (training), the port's own bf16 wire form for the deltas
(the server).
"""
import time

import pytest
import torch

from perfbench import bench, control
from perfbench.runners import fedtrain, server_uploads
from perfbench.tests import tiny

SEED = 2 ** 31 + 99
SECONDS = 0.3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train(cfg, hook=None) -> bool:
    out = fedtrain.run(tiny.fedtrain_cell(cfg), SEED, SECONDS, False, "cpu",
                       time.time(), hook=hook)
    return bench.correct(out.checks)


def _serve(hook=None, wire="f32") -> bool:
    out = server_uploads.run(tiny.agg_cell(), SEED, SECONDS, False, "cpu",
                             time.time(), hook=hook, wire=wire)
    return bench.correct(out.checks)


# ------------------------------------------------------------ training ----

def _unchanged(sim):
    """Every local round returns the model it was given."""
    from repro_torch.utils import pytree as pt
    run = sim._run_locals

    def locals_(jobs):
        ups = run(jobs)
        for u in ups:
            u.delta = pt.tree_map(torch.zeros_like, u.delta)
        return ups
    sim._run_locals = locals_


def _half_rows(sim):
    """Each client trains on the first half of each batch's rows."""
    for c in sim.clients:
        draw = c.batcher.next_stacked

        def half(k, draw=draw):
            x, y = draw(k)
            r = y.shape[1] // 2
            return {"tokens": x["tokens"][:, :r]}, y[:, :r]
        c.batcher.next_stacked = half


def _altered_delta(sim):
    """The first client's delta has one leaf off by 1% where it is made."""
    run = sim._run_locals

    def locals_(jobs):
        ups = run(jobs)
        ups[0].delta["final_norm"]["scale"] = (
            ups[0].delta["final_norm"]["scale"] * 1.01)
        return ups
    sim._run_locals = locals_


def _momentum_dropped(sim):
    """From its second round on, each client starts with no momentum."""
    run = sim._run_locals
    seen = set()

    def locals_(jobs):
        for c, _ in jobs:
            if c.client_id in seen:
                c._mu = None
            seen.add(c.client_id)
        return run(jobs)
    sim._run_locals = locals_


def _k_rule_broken_late(sim):
    """Once every client's second round has been drained (the window), the
    server hands back and keeps a K one higher than Eq. 8 gives."""
    kctl = sim.server.kctl
    observe = kctl.observe
    drained = {}

    def broken(client_id, gamma):
        late = (len(drained) == len(sim.clients)
                and min(drained.values()) >= 2)
        drained[client_id] = drained.get(client_id, 0) + 1
        k = observe(client_id, gamma)
        if late:
            k += 1
            kctl._k[client_id] = k
        return k
    kctl.observe = broken


@pytest.mark.parametrize("cfg", tiny.CONFIGS, ids=lambda c: c["name"])
def test_training_port_is_correct(cfg):
    assert _train(cfg)


@pytest.mark.parametrize("fault", [_unchanged, _half_rows, _altered_delta,
                                   _momentum_dropped, _k_rule_broken_late],
                         ids=lambda f: f.__name__.strip("_"))
def test_training_fault_is_caught(fault):
    assert not _train(tiny.MAMBA2, fault)


def test_training_control_is_caught():
    cell = tiny.fedtrain_cell(tiny.MAMBA2)
    readings = dict(control.fedtrain_readings(cell, SEED, "cpu"))
    assert bench.correct(readings["program"])
    assert not bench.correct(readings["tf32"])
    assert not bench.correct(readings["half_rows"])


# -------------------------------------------------------------- server ----

def _server_unchanged(server):
    """A drain computes its scalars but leaves the model as it was."""
    for name in ("flat_aggregate", "flat_aggregate_batched"):
        agg = server._agg[name]

        def same(x_t, *a, agg=agg, **kw):
            return (x_t, *agg(x_t, *a, **kw)[1:])
        server._agg[name] = same


def _server_half(server):
    """A drain aggregates the first half of its uploads only."""
    drain = server.on_update_batch

    def half(upds):
        keep = drain(upds[:max(1, len(upds) // 2)])
        return keep + [keep[-1]] * (len(upds) - len(keep))
    server.on_update_batch = half


def _server_altered(server):
    """Each drain hands its first client a K one higher than it computed."""
    drain = server.on_update_batch

    def altered(upds):
        replies = drain(upds)
        replies[0].k_next += 1
        return replies
    server.on_update_batch = altered


def test_server_port_is_correct():
    assert _serve()


@pytest.mark.parametrize("fault", [_server_unchanged, _server_half,
                                   _server_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_server_fault_is_caught(fault):
    assert not _serve(fault)


def test_server_control_is_caught():
    assert not _serve(wire="bf16")
