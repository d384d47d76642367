"""The baseline servers (FedAsync with its three decays, FedBuff, synchronous
FedAvg/FedProx), the per-leaf AsyncFedED variant, the synchronous rounds
and ``run_comparison`` of the port against the reference.

Inputs are drawn with numpy from a seed and handed to both packages. A
scripted run drives each of the nine ``make_server`` names through the
same arrivals: one client whose snapshot ages out of a two-deep ring,
unequal ``num_samples``, a FedBuff buffer left partly filled for
``finalize``, and int8 and bf16 deltas. Records must agree exactly in
``iteration``, ``client_id``, ``lag``, ``k_next``, ``screen`` and the
positions of their NaNs; ``eta`` (FedAsync's alpha) and gamma to rtol 1e-6;
params to rtol 1e-6, atol 1e-7. Whole simulations from the reference's
initial params must give the reference's event trace, and eval accuracies
within 0.01 (three rows of the ~300-row eval set).
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as C
from repro.configs.base import FedConfig as JFedConfig
from repro.core import aggregation as jagg
from repro.core import compression as jc
from repro.core import tasks as jtasks
from repro.core.server import ClientUpdate as JUpdate
from repro.core.server import make_server as jmake
from repro.core.simulator import FederatedSimulation as JSim
from repro.core.simulator import run_comparison as jrun_comparison
from repro.utils import pytree as jpt
from repro_torch import configs as TC
from repro_torch.configs.base import FedConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import aggregation as agg
from repro_torch.core import compression as tc
from repro_torch.core.server import ClientUpdate, make_server
from repro_torch.core.simulator import FederatedSimulation, run_comparison
from repro_torch.utils import pytree as pt

ROOT = Path(__file__).resolve().parents[1]

NAMES = ("asyncfeded", "asyncfeded-perleaf", "asyncfeded-displacement",
         "fedasync+constant", "fedasync+poly", "fedasync+hinge", "fedbuff",
         "fedavg", "fedprox")
#: client -> num_samples, all different so the FedAvg weights are unequal
NUMS = {0: 3, 1: 5, 2: 7, 3: 11}
#: (client, delta seed); client 3 first arrives after five updates, when
#: its snapshot (iteration 1) has aged out of the two-deep ring
SCRIPT = [(0, 0), (1, 1), (2, 2), (0, 3), (1, 4), (3, 5), (2, 6)]


def np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (scale * rng.normal(size=s)).astype(np.float32)
    # insertion order differs from the sorted leaf order on purpose
    return {"w": f(33, 7), "b": [f(129), f(2, 3, 5)]}


def fed_kw(**kw):
    return {**dict(lam=1.0, eps=1.0, staleness_cap=4.0, gmis_depth=2,
                   fedbuff_size=3, fedasync_alpha=0.6, poly_a=0.5,
                   hinge_a=2.0, hinge_b=1.0), **kw}


def servers(name, **kw):
    ref = jmake(name, jax.tree.map(jnp.asarray, np_tree(0)),
                JFedConfig(**fed_kw(**kw)))
    port = make_server(name, params_from_numpy(np_tree(0), device="cpu"),
                       FedConfig(**fed_kw(**kw)))
    return ref, port


def wire(mode, d, ref):
    """The delta as each package sends it: a tree, or the wire form
    quantized by that package from the same padded flat vector."""
    if ref:
        if mode == "off":
            return jax.tree.map(jnp.asarray, d)
        spec = jpt.FlatSpec(np_tree(0), block=jc.BLOCK)
        return jc.quantize_vec(spec.flatten(d), mode, spec.n)
    t = params_from_numpy(d, device="cpu")
    if mode == "off":
        return t
    spec = pt.FlatSpec(t, block=tc.BLOCK)
    return tc.quantize_vec(spec.flatten(t), mode, spec.n)


def drive(srv, ref, mode="off"):
    """The scripted arrivals (asynchronous servers), then ``finalize``; a
    synchronous server takes the script as rounds of four."""
    Update = JUpdate if ref else ClientUpdate
    reply = {c: srv.on_connect(c) for c in NUMS}
    if not srv.is_async:
        for r in range(3):
            srv.round([Update(c, reply[c].iteration, 5,
                              wire(mode, np_tree(10 * r + c, 0.05), ref),
                              num_samples=NUMS[c]) for c in NUMS])
        return srv
    for cid, seed in SCRIPT:
        reply[cid] = srv.on_update(Update(
            cid, reply[cid].iteration, 5, wire(mode, np_tree(seed, 0.05), ref),
            num_samples=NUMS[cid]))
    srv.finalize(0.0)
    return srv


def assert_same_records(port, ref):
    key = lambda h: [(r.iteration, r.client_id, r.lag, r.k_used, r.k_next,
                      r.screen) for r in h]
    assert key(port.history) == key(ref.history)
    for field in ("gamma", "dist", "delta_norm"):
        a = np.array([getattr(r, field) for r in port.history])
        b = np.array([getattr(r, field) for r in ref.history])
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    for field in ("eta", "gamma"):
        np.testing.assert_allclose([getattr(r, field) for r in port.history],
                                   [getattr(r, field) for r in ref.history],
                                   rtol=1e-6, atol=0)
    assert port.t == ref.t


def assert_same_params(port, ref, atol=1e-7):
    for a, b in zip(jax.tree.leaves(ref.params), pt.tree_leaves(port.params)):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=atol)


class TestScriptedServers:
    @pytest.mark.parametrize("name", NAMES)
    def test_matches_reference(self, name):
        ref, port = servers(name)
        drive(ref, True)
        drive(port, False)
        assert_same_records(port, ref)
        assert_same_params(port, ref)
        assert len(port.history) == {"fedbuff": 3, "fedavg": 3,
                                     "fedprox": 3}.get(name, len(SCRIPT))

    @pytest.mark.parametrize("mode", ["int8", "bf16"])
    @pytest.mark.parametrize("name", ["fedasync+constant", "fedasync+hinge",
                                      "fedbuff", "asyncfeded-perleaf"])
    def test_wire_forms_match_reference(self, name, mode):
        ref, port = servers(name, delta_compression=mode)
        drive(ref, True, mode)
        drive(port, False, mode)
        assert_same_records(port, ref)
        assert_same_params(port, ref)

    def test_the_script_covers_its_cases(self):
        """The ring clamps client 3's snapshot, FedBuff's finalize flushes
        a partial buffer, FedAsync's decay is taken at the clamped lag."""
        ref, port = servers("fedasync+hinge")
        drive(port, False)
        rec = port.history[SCRIPT.index((3, 5))]
        # iteration 1 aged out; the oldest retained version is 5
        assert rec.client_id == 3 and rec.lag == 1
        fb = drive(servers("fedbuff")[1], False)
        assert [r.client_id for r in fb.history] == [2, 3, -1]
        assert fb.buffer == []
        poly = drive(servers("fedasync+poly")[1], False)
        assert poly.history[0].eta == pytest.approx(0.6)
        assert poly.history[1].eta == pytest.approx(0.6 * 2 ** -0.5)

    def test_sync_weights_are_sample_shares(self):
        """One FedAvg round of unit deltas moves every element by exactly
        the sum of the weights, 1, whatever the shares."""
        srv = make_server("fedavg", params_from_numpy(np_tree(0),
                                                      device="cpu"),
                          FedConfig(**fed_kw()))
        x0 = pt.tree_map(torch.clone, srv.params)
        ones = pt.tree_map(torch.ones_like, x0)
        srv.round([ClientUpdate(c, 1, 5, ones, num_samples=n)
                   for c, n in NUMS.items()])
        for a, b in zip(pt.tree_leaves(srv.params), pt.tree_leaves(x0)):
            torch.testing.assert_close(a - b, torch.ones_like(a), rtol=0,
                                       atol=1e-6)
        assert srv.screen is None and srv.screen_stats() is None

    def test_perleaf_needs_pytree_backend(self):
        p = params_from_numpy(np_tree(0), device="cpu")
        with pytest.raises(ValueError, match="pytree"):
            make_server("asyncfeded-perleaf", p, FedConfig(), backend="pallas")
        with pytest.raises(ValueError):
            make_server("fedasync+linear", p, FedConfig())
        assert make_server("asyncfeded-perleaf", p, FedConfig()).per_leaf

    @pytest.mark.parametrize("name", ["fedasync+constant", "fedbuff",
                                      "fedavg"])
    def test_stored_snapshots_never_change(self, name):
        """The ring of FedAsync holds the trees it mixed, and a reply's
        params are every client's start: an aggregation writes new
        tensors and never into those."""
        srv = make_server(name, params_from_numpy(np_tree(0), device="cpu"),
                          FedConfig(**fed_kw(gmis_depth=8)))
        rep = srv.on_connect(0)
        held = rep.params
        copy = pt.tree_map(torch.clone, held)
        stored = srv.gmis.get(1)[0] if name.startswith("fedasync") else None
        for step in range(4):
            d = params_from_numpy(np_tree(step, 0.05), device="cpu")
            if srv.is_async:
                srv.on_update(ClientUpdate(0, rep.iteration, 5, d))
            else:
                srv.round([ClientUpdate(0, 1, 5, d)])
        srv.finalize(0.0)
        assert srv.t > 1
        for a, b in zip(pt.tree_leaves(held), pt.tree_leaves(copy)):
            assert torch.equal(a, b)
        if stored is not None:
            assert srv.gmis.get(1)[0] is stored
        assert not torch.equal(pt.tree_leaves(srv.params)[0],
                               pt.tree_leaves(copy)[0])


class TestScreenedBaselines:
    """The reference's screened-reject contract
    (tests/test_adversary.py::TestScreenedServers): a 50x delta after
    warm-up is rejected, and the model and the counter do not move."""

    @pytest.mark.parametrize("name", ["fedasync+constant", "fedasync+poly",
                                      "fedbuff"])
    def test_reject_freezes_model_and_counter(self, name):
        kw = dict(screen="reject", screen_warmup=2, screen_k=3.0)
        ref, port = servers(name, **kw)
        for srv, is_ref in ((ref, True), (port, False)):
            Update = JUpdate if is_ref else ClientUpdate
            for cid in (0, 1):
                srv.on_connect(cid)
                srv.on_update(Update(cid, srv.t, 5,
                                     wire("off", np_tree(cid, 0.05), is_ref)))
            t0 = srv.t
            before = [np.array(x) for x in
                      (jax.tree.leaves(srv.params) if is_ref
                       else pt.tree_leaves(srv.params))]
            bad = wire("off", np_tree(7, 2.5), is_ref)
            reply = srv.on_update(Update(2, srv.t, 5, bad))
            rec = srv.history[-1]
            assert rec.screen == "reject" and rec.eta == 0.0
            assert srv.t == t0 and reply.iteration == t0
            after = (jax.tree.leaves(srv.params) if is_ref
                     else pt.tree_leaves(srv.params))
            for a, b in zip(before, after):
                np.testing.assert_array_equal(a, np.array(b))
            assert srv.screen_stats()["reject"] == 1
            assert rec.delta_norm == pytest.approx(
                float(np.sqrt(sum(np.sum(np.square(l)) for l in
                                  jax.tree.leaves(np_tree(7, 2.5))))),
                rel=1e-5)
        assert_same_records(port, ref)
        assert port.screen.counts == ref.screen.counts


class TestPerLeaf:
    def trees(self, seed, n):
        """x_t, x_stale, delta with entries in quarters: every sum of
        squares is exact in any order, so gamma is the same float in both
        packages and eta isolates Eq. 7's division."""
        rng = np.random.default_rng(seed)
        return [{"w": (rng.integers(-8, 9, size=n) / 4).astype(np.float32)}
                for _ in range(3)]

    def test_eq7_division_bitwise(self):
        """One leaf of 64: the parameter-weighted means are the leaf's own
        values, and gamma and eta equal the reference's bit for bit. A
        reciprocal times lambda would differ for some of these inputs."""
        differs = 0
        for seed in range(32):
            x, s, d = self.trees(seed, 64)
            j = jagg.asyncfeded_aggregate_per_leaf(
                *(jax.tree.map(jnp.asarray, v) for v in (x, s, d)),
                lam=0.7, eps=0.3)
            t = agg.asyncfeded_aggregate_per_leaf(
                *(pt.tree_map(torch.tensor, v) for v in (x, s, d)),
                lam=0.7, eps=0.3)
            assert np.float32(j.gamma).tobytes() == t.gamma.numpy().tobytes()
            assert np.float32(j.eta).tobytes() == t.eta.numpy().tobytes()
            recip = torch.reciprocal(t.gamma + 0.3) * 0.7
            differs += recip.numpy().tobytes() != t.eta.numpy().tobytes()
            # XLA's CPU code and PyTorch round x + eta * d differently,
            # up to an ulp of eta * d, large where x + eta * d ~ 0
            np.testing.assert_allclose(t.params["w"].numpy(),
                                       np.asarray(j.params["w"]), rtol=1e-6,
                                       atol=1e-6)
        assert differs > 0

    @pytest.mark.parametrize("cap", [0.0, 1.5])
    def test_weighted_means_match_reference(self, cap):
        """Several leaves of unequal sizes, one unmoved (gamma 0) and one
        zero delta (gamma capped or huge): the tree's new params, the
        weighted gamma and eta, dist and delta_norm."""
        x, s, d = (np_tree(i) for i in (1, 2, 3))
        s["b"][0] = x["b"][0].copy()
        d["b"][1] = np.zeros_like(d["b"][1])
        j = jagg.asyncfeded_aggregate_per_leaf(
            *(jax.tree.map(jnp.asarray, v) for v in (x, s, d)),
            lam=0.9, eps=0.5, cap=cap)
        t = agg.asyncfeded_aggregate_per_leaf(
            *(params_from_numpy(v, device="cpu") for v in (x, s, d)),
            lam=0.9, eps=0.5, cap=cap)
        for a, b in zip(jax.tree.leaves(j.params), pt.tree_leaves(t.params)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-6)
        for f in ("gamma", "eta", "dist", "delta_norm"):
            np.testing.assert_allclose(float(getattr(t, f)),
                                       float(getattr(j, f)), rtol=1e-6)


# ------------------------------------------------------- whole simulations --
def _key(history):
    return [(r.iteration, r.client_id, r.lag, r.k_used, r.k_next, r.screen)
            for r in history]


def ref_init(task, seed=0):
    return jax.tree.map(np.asarray,
                        jtasks.as_task(task).init(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("name", [n for n in NAMES if n != "asyncfeded"])
def test_simulation_matches_reference(name):
    """SYNTHETIC_1_1 (paper behavior, window 0) for 20 updates or rounds
    from the reference's init: the same event trace, update and drain
    counts and eval curve."""
    fed = C.SYNTHETIC_1_1.fed
    jsim = JSim(C.SYNTHETIC_1_1, fed, name, seed=0)
    init = jax.tree.map(np.asarray, jsim.server.params)
    jres = jsim.run(max_time=1e9, max_updates=20)
    tsim = FederatedSimulation(TC.SYNTHETIC_1_1, fed, name, seed=0,
                               device="cpu",
                               init_params=params_from_numpy(init,
                                                             device="cpu"))
    tres = tsim.run(max_time=1e9, max_updates=20)
    assert _key(tres.history) == _key(jres.history)
    assert (tres.total_updates, tres.total_drains) == (jres.total_updates,
                                                       jres.total_drains)
    assert tres.total_updates == 20
    assert ([(p.time, p.iteration) for p in tres.points]
            == [(p.time, p.iteration) for p in jres.points])
    np.testing.assert_allclose([p.accuracy for p in tres.points],
                               [p.accuracy for p in jres.points], atol=0.01)
    assert tsim.prox_mu == jsim.prox_mu
    assert tres.summary().keys() == jres.summary().keys()
    np.testing.assert_allclose(np.array(tres.to_json()["curve"]),
                               np.array(jres.to_json()["curve"]), atol=0.01)


def test_sync_rounds_with_dropout():
    """Synchronous rounds where clients drop out: the roster shrinks, the
    round time is the straggler's, and the trace and eval times equal the
    reference's."""
    fed = dataclasses.replace(C.SYNTHETIC_1_1.fed, dropout_prob=0.2)
    jsim = JSim(C.SYNTHETIC_1_1, fed, "fedavg", seed=3)
    init = jax.tree.map(np.asarray, jsim.server.params)
    jres = jsim.run(max_time=1e9, eval_every=4)
    tres = FederatedSimulation(
        TC.SYNTHETIC_1_1, fed, "fedavg", seed=3, device="cpu",
        init_params=params_from_numpy(init, device="cpu")).run(
            max_time=1e9, eval_every=4)
    assert tres.total_updates == jres.total_updates > 0
    assert [p.time for p in tres.points] == [p.time for p in jres.points]
    assert _key(tres.history) == _key(jres.history)


def test_run_comparison_matches_reference():
    """The quickstart's three algorithms through ``run_comparison`` for 3
    virtual seconds, from the reference's init: the same updates and
    drains per algorithm, max accuracy within 0.01."""
    algs = ["asyncfeded", "fedavg", "fedasync+constant"]
    jout = jrun_comparison(C.SYNTHETIC_1_1, algs, max_time=3.0,
                           eval_every=10)
    tout = run_comparison(TC.SYNTHETIC_1_1, algs, max_time=3.0,
                          eval_every=10, device="cpu",
                          init_params=params_from_numpy(
                              ref_init(C.SYNTHETIC_1_1), device="cpu"))
    assert list(tout) == algs
    for alg in algs:
        (j,), (t,) = jout[alg], tout[alg]
        assert (t.total_updates, t.total_drains) == (j.total_updates,
                                                     j.total_drains)
        assert _key(t.history) == _key(j.history)
        assert abs(t.max_accuracy() - j.max_accuracy()) <= 0.01


def test_quickstart_twin_runs_on_cpu():
    env = dict(os.environ, QUICKSTART_MAX_TIME="3",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "examples/quickstart_torch.py",
                          "--device", "cpu"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rows = re.findall(r"^(\S+) +updates= *(\d+) max_acc=([\d.]+) t90=",
                      out.stdout, re.M)
    assert [r[0] for r in rows] == ["asyncfeded", "fedavg",
                                    "fedasync+constant"]
    for _, updates, max_acc in rows:
        assert int(updates) > 0 and 0.0 < float(max_acc) <= 1.0
    assert "median gamma" in out.stdout
