"""The plain reference against the port at a small size on the CPU, on the
same seeded inputs: the weights' layout, the two models' logits and loss
gradients, a client's local round, and the AsyncFedED rule through the
port's flat server. The port is imported here to be compared; the
reference never imports it (``test_perfbench_guard.py``)."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from perfbench import bench, feed, weights
from perfbench.reference import client, pooled, rule
from perfbench.reference import federation as fed_ref
from perfbench.reference.ops import Precision, cross_entropy, round_tf32
from perfbench.tests import tiny

CONFIGS = tiny.CONFIGS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(cfg):
    from perfbench.runners.fedtrain import port_config
    return port_config(cfg)


def _file(name):
    with open(bench.ROOT / "perfbench" / "configs" / f"{name}.json") as f:
        return json.load(f)


@pytest.mark.parametrize("cfg", CONFIGS + [_file("mamba2-1.3b"),
                                           _file("h2o-danube-1.8b")],
                         ids=lambda c: c["name"])
def test_layout_is_the_ports(cfg):
    from repro_torch.models import model as M
    from repro_torch.utils import pytree as pt
    defs = M.model_defs(_port_cfg(cfg))
    leaves, _ = pt.tree_flatten(defs)
    paths = sorted(s.path for s in weights.leaf_specs(cfg))
    assert [tuple(d.shape) for d in leaves] == [
        s.shape for s in sorted(weights.leaf_specs(cfg), key=lambda s: s.path)]
    assert len(paths) == len(leaves)


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["name"])
def test_buffer_is_the_ports_flat_vector(cfg):
    from repro_torch.utils import pytree as pt
    flat, tree = weights.draw(cfg, 3, "cpu")
    assert torch.equal(pt.tree_flatten_to_vector(tree), flat)
    again, _ = weights.draw(cfg, 3, "cpu")
    assert torch.equal(again, flat)


def _inputs(cfg, seed=7):
    tr = tiny.fedtrain_cell(cfg).traffic
    toks, labels = feed.client_stream(seed, 0, cfg, tr).next()
    return torch.as_tensor(toks["tokens"]), torch.as_tensor(labels)


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["name"])
def test_logits_and_gradients(cfg):
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    _, tree = weights.draw(cfg, 11, "cpu")
    tokens, labels = _inputs(cfg)
    fwd = fed_ref.model_forward(cfg, Precision("f32"))
    pc = _port_cfg(cfg)

    def port_loss(t):
        logits, _, _ = M.forward(t, tokens, pc, remat=False, q_chunk=8,
                                 kv_chunk=8)
        return logits, L.cross_entropy(logits, labels)

    leaves = {k: v.clone().requires_grad_(True)
              for k, v in weights.leaves(tree).items()}
    ref_logits = fwd(weights.tree_of(leaves), tokens)
    ref_grads = torch.autograd.grad(cross_entropy(ref_logits, labels),
                                    list(leaves.values()))
    pleaves = {k: v.clone().requires_grad_(True)
               for k, v in weights.leaves(tree).items()}
    port_logits, loss = port_loss(weights.tree_of(pleaves))
    port_grads = torch.autograd.grad(loss, list(pleaves.values()))
    gap = (port_logits - ref_logits).abs().max() / ref_logits.abs().max()
    assert float(gap.detach()) < 1e-5
    for k, g, h in zip(leaves, ref_grads, port_grads):
        assert float((g - h).abs().max()) <= 1e-4 * float(g.abs().max()) \
            + 1e-9, k


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["name"])
def test_local_round(cfg):
    from repro_torch.core.client import Client
    from perfbench.runners.fedtrain import port_task
    cell = tiny.fedtrain_cell(cfg)
    task, fed = port_task(cfg, cell.traffic)
    _, tree = weights.draw(cfg, 5, "cpu")
    c = Client(0, task, 0, fed, seed=5, device="cpu")
    c.batcher = feed.client_stream(5, 0, cfg, cell.traffic)
    upd, _ = c.run_local(tree, 2, 1)
    stream = feed.client_stream(5, 0, cfg, cell.traffic)
    batches = []
    for _ in range(2):
        t, lab = stream.next()
        batches.append((torch.as_tensor(t["tokens"]), torch.as_tensor(lab)))
    delta, mom = client.local_round(
        fed_ref.model_forward(cfg, Precision("f32")), weights.leaves(tree),
        None, batches, fed.local_lr, fed.local_momentum)
    pd, pm = weights.leaves(upd.delta), weights.leaves(c._mu)
    for k in delta:
        tol = 1e-4 * float(delta[k].abs().max()) + 1e-9
        assert float((pd[k] - delta[k]).abs().max()) <= tol, k
        tol = 1e-4 * float(mom[k].abs().max()) + 1e-9
        assert float((pm[k] - mom[k]).abs().max()) <= tol, k


def _drains(rng, clients, n):
    """Drain compositions with snapshots filled in by the replies."""
    out, left = [], list(range(clients))
    for _ in range(n):
        b = int(rng.integers(1, 5))
        rng.shuffle(left)
        out.append(sorted(left[:b]))
    return out


def test_rule_against_the_ports_flat_server():
    """Bursts and single arrivals through the port's flat server (its
    plain twins on the CPU) against the reference rule, with a ring so
    shallow that it clamps."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.server import ClientUpdate, make_server
    cfg = tiny.MAMBA2
    tr = tiny.agg_cell().traffic
    fd = dict(tr["fed"], gmis_depth=3, num_clients=6)
    flat, tree = weights.draw(cfg, 9, "cpu")
    server = make_server("asyncfeded", tree, FedConfig(**fd),
                         backend="pallas")
    gen = torch.Generator().manual_seed(1)
    deltas = [weights.carve(cfg, 1e-2 * torch.randn(flat.numel(),
                                                    generator=gen))
              for _ in range(5)]
    ref = rule.Server(weights.leaves(tree), rule.RuleParams.of(fd),
                      fed_ref.dist, fed_ref.norm, fed_ref.step)
    snap = {c: server.on_connect(c).iteration for c in range(6)}
    rng = np.random.default_rng(0)
    for i, drain in enumerate(_drains(rng, 6, 12)):
        ups = [ClientUpdate(c, snap[c], 2, deltas[(i + c) % 5])
               for c in drain]
        n0 = len(server.history)
        replies = server.on_update_batch(ups)
        recs = ref.drain([(c, snap[c], weights.leaves(deltas[(i + c) % 5]))
                          for c in drain])
        for h, r, rep in zip(server.history[n0:], recs, replies):
            assert (h.iteration, h.client_id, h.lag, h.k_next) == (
                r.iteration, r.client_id, r.lag, r.k_next)
            assert h.gamma == pytest.approx(r.gamma, rel=1e-5, abs=1e-9)
            assert h.eta == pytest.approx(r.eta, rel=1e-5)
            assert (rep.iteration, rep.k_next) == (ref.t, r.k_next)
        for c, rep in zip(drain, replies):
            snap[c] = rep.iteration
    assert ref.clamps > 0
    got = weights.leaves(server.params)
    for k, v in ref.x.items():
        assert torch.allclose(got[k], v, rtol=1e-5, atol=1e-6), k


def test_pooled_rule_equals_the_rule_on_vectors():
    """The rule followed in a pool's coefficients gives the rule on the
    vectors themselves."""
    fd = dict(tiny.agg_cell().traffic["fed"], gmis_depth=3)
    rp = rule.RuleParams.of(fd)
    gen = torch.Generator().manual_seed(2)
    x1 = torch.randn(4000, dtype=torch.float64, generator=gen)
    pool = 0.05 * torch.randn((4, 4000), dtype=torch.float64, generator=gen)
    vec = rule.Server(x1, rp, lambda a, b: float(torch.linalg.norm(a - b)),
                      lambda j: float(torch.linalg.norm(pool[j])),
                      lambda x, eta, j: x + eta * pool[j])
    coef = pooled.server(pooled.gram(pool), rp)
    snap = {c: 1 for c in range(5)}
    rng = np.random.default_rng(3)
    for drain in _drains(rng, 5, 15):
        ups = [(c, snap[c], (c * 7 + len(drain)) % 4) for c in drain]
        a, b = vec.drain(ups), coef.drain(ups)
        for r, s in zip(a, b):
            assert (r.iteration, r.lag, r.k_next) == (s.iteration, s.lag,
                                                      s.k_next)
            assert r.gamma == pytest.approx(s.gamma, rel=1e-9, abs=1e-12)
        for c in drain:
            snap[c] = vec.t
    assert torch.allclose(vec.x, x1 + torch.as_tensor(coef.x) @ pool)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -12, -3.0e-7],
                     dtype=torch.float32)
    r = round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1 + 2 ** -10 and r[2] == 1 + 2 ** -10
    bits = r.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    a = torch.randn(5, 7, dtype=torch.float32, requires_grad=True)
    b = torch.randn(7, 3, dtype=torch.float32, requires_grad=True)
    out = Precision("tf32").mm(a, b)
    assert torch.equal(out, round_tf32(a.detach()) @ round_tf32(b.detach()))
    g = torch.randn(5, 3)
    ga, gb = torch.autograd.grad(out, (a, b), g)
    assert torch.equal(ga, round_tf32(g) @ round_tf32(b.detach()).T)
    assert torch.equal(gb, round_tf32(a.detach()).T @ round_tf32(g))


def test_client_streams_differ_and_repeat():
    cfg = tiny.MAMBA2
    tr = tiny.fedtrain_cell(cfg).traffic
    a = feed.client_stream(2 ** 31 + 5, 0, cfg, tr).next_stacked(2)
    b = feed.client_stream(2 ** 31 + 5, 0, cfg, tr).next_stacked(2)
    c = feed.client_stream(2 ** 31 + 5, 1, cfg, tr).next_stacked(2)
    assert np.array_equal(a[0]["tokens"], b[0]["tokens"])
    assert not np.array_equal(a[0]["tokens"], c[0]["tokens"])
    assert a[0]["tokens"].shape == (2, tr["rows"], tr["seq_len"])
    rows = a[0]["tokens"].reshape(-1, tr["seq_len"])
    assert len({r.tobytes() for r in rows}) == len(rows)
    assert np.array_equal(a[1], np.roll(a[0]["tokens"], -1, axis=-1))
    assert dataclasses.is_dataclass(weights.leaf_specs(cfg)[0])
