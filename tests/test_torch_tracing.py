"""The port's recorder (``repro_torch.utils.tracing``) and the spans and
counters the program opens with it, on the CPU.

* The recorder: off, it records nothing, keeps nothing and calls no
  ``torch.cuda`` function; on, spans nest with their parents' ids,
  counters add up, and ``collect`` hands the recording back and turns it
  off.
* The program: a flat ring server's burst drain opens its phases in order
  inside ``server.drain``; ``server.copy_bytes`` is the bytes its
  staging copies read and write; ``server.stale_rows`` and
  ``server.stale_snapshots`` count the stale rows its norms read in place
  and the distinct snapshots among them; ``gmis.clamps`` counts the lookups
  a shallow ring clamps; both client engines count ``client.steps`` as the
  sum of the real rows' K; and a simulation's history, replies and
  evaluations are the same with the recorder on and off.
"""
import dataclasses
import sys

import pytest
import torch

from repro_torch import configs as TC
from repro_torch.configs.base import FedConfig
from repro_torch.core import cohort
from repro_torch.core.client import Client
from repro_torch.core.server import ClientUpdate, make_server
from repro_torch.core.simulator import FederatedSimulation
from repro_torch.data.pipeline import load_task_datasets
from repro_torch.kernels.fedagg import fedagg
from repro_torch.utils import pytree as pt
from repro_torch.utils import tracing


@pytest.fixture(autouse=True)
def _recorder_off():
    """Every test starts and ends with the recorder off."""
    tracing.collect()
    yield
    tracing.collect()


def _no_cuda(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("torch.cuda called while the recorder is off")
    for name in ("Event", "synchronize", "current_device", "Stream",
                 "current_stream"):
        monkeypatch.setattr(torch.cuda, name, boom)


# ------------------------------------------------------------ recorder ----

def test_off_records_nothing_and_calls_no_cuda(monkeypatch):
    _no_cuda(monkeypatch)
    for fn in ("tensor", "empty", "zeros"):
        monkeypatch.setattr(torch, fn, lambda *a, **kw: (_ for _ in ()).throw(
            AssertionError("a tensor made while the recorder is off")))
    assert not tracing.active()
    blocks = sys.getallocatedblocks()
    for i in range(20000):
        with tracing.span("server.drain", updates=i) as sp:
            assert sp is tracing._NOOP
        tracing.count("gmis.lookups")
        tracing.count("server.copy_bytes", 4 * i)
    # nothing the loop made outlives it (a few blocks of slack for the
    # interpreter's own caches)
    assert sys.getallocatedblocks() - blocks < 50
    assert tracing.span("x") is tracing.span("y") is tracing._NOOP
    assert tracing.collect() is None


def test_spans_nest_with_parent_ids_and_attributes():
    tracing.enable()
    with tracing.span("sim.drain", events=3):
        with tracing.span("server.drain", updates=3, path="batched"):
            with tracing.span("server.stack"):
                pass
        with tracing.span("sim.dispatch"):
            pass
    with tracing.span("sim.eval"):
        pass
    rec = tracing.collect()
    names = [s.name for s in rec.spans]
    assert names == ["sim.drain", "server.drain", "server.stack",
                     "sim.dispatch", "sim.eval"]
    assert [s.id for s in rec.spans] == [0, 1, 2, 3, 4]
    assert [s.parent for s in rec.spans] == [None, 0, 1, 0, None]
    assert rec.spans[1].attrs == {"updates": 3, "path": "batched"}
    for s in rec.spans:
        assert s.host_open <= s.host_close
        if s.parent is not None:
            p = rec.spans[s.parent]
            assert p.host_open <= s.host_open <= s.host_close <= p.host_close


def test_counters_add_up():
    tracing.enable()
    tracing.count("gmis.lookups")
    tracing.count("gmis.lookups", 4)
    tracing.count("server.copy_bytes", 1 << 40)
    tracing.count("server.copy_bytes", 1)
    assert tracing.collect().counters == {"gmis.lookups": 5,
                                          "server.copy_bytes": (1 << 40) + 1}


def test_collect_clears_and_turns_off(monkeypatch):
    _no_cuda(monkeypatch)              # on or off, the recorder is host-only
    tracing.enable()
    with tracing.span("a"):
        tracing.count("c", 2)
    with tracing.span("open"):
        rec = tracing.collect()        # a span still open is left out
    assert [s.name for s in rec.spans] == ["a"] and rec.counters == {"c": 2}
    assert not tracing.active() and tracing.collect() is None
    with tracing.span("b"):
        tracing.count("c")
    assert tracing.collect() is None
    tracing.enable()
    rec = tracing.collect()
    assert rec.spans == [] and rec.counters == {}


# ------------------------------------------------------------- server ----

def _params(seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(33, 7, generator=g),
            "b": [torch.randn(129, generator=g).to(dtype)]}


def _delta(seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(100 + seed)
    return {"a": 0.05 * torch.randn(33, 7, generator=g),
            "b": [(0.05 * torch.randn(129, generator=g)).to(dtype)]}


def _server(depth=8, dtype=torch.float32):
    fed = FedConfig(lam=1.0, eps=1.0, gmis_depth=depth)
    return make_server("asyncfeded", _params(dtype=dtype), fed,
                       backend="pallas")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_burst_drain_opens_its_phases_in_order(dtype):
    srv = _server(dtype=dtype)
    replies = [srv.on_connect(c) for c in range(3)]
    upds = [ClientUpdate(c, replies[c].iteration, 2, _delta(c, dtype))
            for c in range(3)]
    tracing.enable()
    srv.on_update_batch(upds)
    rec = tracing.collect()
    drain = rec.spans[0]
    assert drain.name == "server.drain"
    assert drain.attrs == {"updates": 3, "path": "batched"}
    kids = [s for s in rec.spans if s.parent == drain.id]
    assert [s.name for s in kids] == ["server.stack", "server.flatten",
                                      "server.norms", "server.schedule",
                                      "server.apply", "server.record"]
    assert all(a.host_close <= b.host_open for a, b in zip(kids, kids[1:]))
    n_pad = fedagg.BLOCK
    # per update: its delta's leaves read (129 of them bf16 in the bf16
    # tree) and written once, cast, into its row of the delta stack
    # (4 n_pad); the server hands its stale snapshot in place, and on the
    # CPU the plain norms copy it into their (B, n) stack (4 n_pad each
    # way), which the card's kernel does not
    leaves = 4 * 33 * 7 + 129 * (2 if dtype == torch.bfloat16 else 4)
    assert rec.counters["server.copy_bytes"] == 3 * (3 * 4 * n_pad
                                                     + leaves)
    # three rows, all on the one version the clients connected at
    assert rec.counters["server.stale_rows"] == 3
    assert rec.counters["server.stale_snapshots"] == 1
    assert rec.counters["gmis.lookups"] == 3
    assert "gmis.clamps" not in rec.counters


def test_single_drain_opens_server_update():
    srv = _server()
    r = srv.on_connect(0)
    tracing.enable()
    srv.on_update_batch([ClientUpdate(0, r.iteration, 2, _delta(0))])
    rec = tracing.collect()
    assert [(s.name, s.parent) for s in rec.spans] == [
        ("server.drain", None), ("server.update", 0)]
    assert rec.spans[0].attrs["path"] == "single"
    # the delta's leaves read and its padded vector written once
    assert rec.counters["server.copy_bytes"] == 4 * (33 * 7 + 129
                                                     + fedagg.BLOCK)


def test_clamps_count_the_lookups_a_shallow_ring_clamps():
    """A ring of 2: each drain appends one version, so an update whose
    snapshot is two or more drains old reads the oldest version kept."""
    srv = _server(depth=2)
    its = {c: srv.on_connect(c).iteration for c in range(5)}
    tracing.enable()
    planted = 0
    for drain in ([0], [1], [2, 3], [4], [0, 1]):
        kept = set(srv.gmis._store)
        planted += sum(its[c] not in kept for c in drain)
        replies = srv.on_update_batch(
            [ClientUpdate(c, its[c], 2, _delta(c)) for c in drain])
        its.update({c: r.iteration for c, r in zip(drain, replies)})
    rec = tracing.collect()
    assert planted == 5        # clients 2, 3 and 4 from x_1, then 0 and 1
    assert rec.counters["gmis.clamps"] == planted
    assert rec.counters["gmis.lookups"] == 7


# ------------------------------------------------------------ clients ----

def _clients(n):
    task = TC.PAPER_TASKS["synthetic-1-1"]
    train, _ = load_task_datasets(task, seed=0)
    clients = [Client(i, task, train[i], task.fed, seed=0, device="cpu")
               for i in range(n)]
    params = clients[0].task.init(torch.Generator().manual_seed(0), "cpu")
    return clients, params


def test_loop_engine_counts_steps():
    clients, params = _clients(2)
    tracing.enable()
    for c, k in zip(clients, (3, 5)):
        c.run_local(params, k, 1)
    rec = tracing.collect()
    assert rec.counters["client.steps"] == 8
    steps = [s for s in rec.spans if s.name == "client.step"]
    assert len(steps) == 8 and all(s.attrs == {"rows": 1} for s in steps)
    assert [s.name for s in rec.spans[:2]] == ["client.stage", "client.step"]
    assert rec.spans[-1].name == "client.collect"


def test_cohort_engine_counts_real_rows_and_steps():
    """Ragged K pads the steps to a bucket of 8 and three clients to four
    rows: eight batched steps run, fifteen client steps are real."""
    clients, params = _clients(3)
    ks = [3, 7, 5]
    tracing.enable()
    cohort.run_cohort(clients[0].task, clients, params, ks, [1, 1, 1])
    rec = tracing.collect()
    assert rec.counters["client.steps"] == sum(ks)
    steps = [s for s in rec.spans if s.name == "client.step"]
    assert len(steps) == 8 and all(s.attrs == {"rows": 4} for s in steps)
    names = {s.name for s in rec.spans}
    assert names == {"client.stage", "client.step", "client.collect"}


# --------------------------------------------------------- simulation ----

def _simulate(engine, on):
    task = TC.SYNTHETIC_1_1
    fed = dataclasses.replace(task.fed, backend="pallas",
                              client_engine=engine)
    sim = FederatedSimulation(task, fed, "asyncfeded", seed=3,
                              batch_window=0.05, device="cpu")
    replies, steps = [], []
    drain, train = sim.server.on_update_batch, sim._run_locals

    def on_batch(upds):
        out = drain(upds)
        replies.append([(r.iteration, r.k_next) for r in out])
        return out

    def run_locals(jobs):
        steps.append(sum(r.k_next for _, r in jobs))
        return train(jobs)
    sim.server.on_update_batch = on_batch
    sim._run_locals = run_locals
    if on:
        tracing.enable()
    res = sim.run(max_time=4.0, max_updates=40)
    rec = tracing.collect()
    return res, replies, sum(steps), sim.server.params, rec


@pytest.mark.parametrize("engine", ["loop", "cohort"])
def test_simulation_is_the_same_with_the_recorder_on(engine):
    off, r_off, _, x_off, _ = _simulate(engine, on=False)
    on, r_on, steps, x_on, rec = _simulate(engine, on=True)
    assert off.total_updates == on.total_updates >= 40
    assert off.history == on.history and r_off == r_on
    assert off.points == on.points
    for a, b in zip(pt.tree_leaves(x_off), pt.tree_leaves(x_on)):
        assert torch.equal(a, b)
    names = {s.name for s in rec.spans}
    assert {"sim.drain", "sim.dispatch", "sim.eval", "client.fanout",
            "client.stage", "client.step", "client.collect", "server.drain",
            "server.stack", "server.flatten", "server.norms",
            "server.schedule", "server.apply", "server.record"} <= names
    if engine == "cohort":
        assert "client.plan" in names
    assert rec.counters["client.steps"] == steps
    assert rec.counters["gmis.lookups"] == on.total_updates
