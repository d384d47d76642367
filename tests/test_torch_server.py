"""The port's AsyncFedED server against the reference on the scripted run of
tests/test_flat_backend.py (three clients, six updates, staleness cap 4),
for both GMIS modes and both backends, plus the server's own contract, the
burst drain and compressed deltas.

The reference's flat backend runs its Pallas kernels in interpret mode. The
inputs are drawn once with jax.random and handed to both packages as numpy;
a compressed delta is quantized by each package from the same vector (the
two give the same bytes, tests/test_torch_compression.py). Tolerances are
the reference's own for its backend parity: params rtol 1e-5 (atol 1e-6),
gamma rtol 1e-4; k_next and the screen verdicts must be equal. A burst's
scalars come through the f64 schedule from sums the reference takes with
XLA's dot (tests/test_torch_fedagg_batched.py): they are held to the
reference's own tolerance for batch against sequential, rtol 1e-4 on
params with atol 1e-6.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as JFedConfig
from repro.core import compression as jc
from repro.core.server import ClientUpdate as JUpdate
from repro.core.server import make_server as jmake
from repro.utils import pytree as jpt
from repro_torch.configs.base import FedConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import compression as tc
from repro_torch.core.server import (AsyncFedEDServer, ClientUpdate,
                                     make_server)
from repro_torch.kernels.fedagg import fedagg, ops
from repro_torch.utils import pytree as pt
from torch_threads import one_torch_thread  # noqa: F401


def mk_params(seed=0):
    return {"a": jax.random.normal(jax.random.PRNGKey(seed), (33, 7)),
            "b": [jax.random.normal(jax.random.PRNGKey(seed + 1), (129,)),
                  jax.random.normal(jax.random.PRNGKey(seed + 2), (2, 3, 5))]}


def mk_delta(seed, scale=0.05):
    leaves = jax.tree.leaves(mk_params())
    ks = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    new = [scale * jax.random.normal(k, l.shape) for k, l in zip(ks, leaves)]
    return jax.tree.map(np.asarray, jax.tree.unflatten(
        jax.tree.structure(mk_params()), new))


def scripted(srv, to_delta):
    replies = [srv.on_connect(i) for i in range(3)]
    for step in range(6):
        cid = step % 3
        srv.on_update(to_delta(cid, replies[cid].iteration, mk_delta(step)))
        replies[cid] = srv.on_connect(cid)
    return srv


def run_ref(gmis_mode, backend):
    fed = JFedConfig(lam=1.0, eps=1.0, staleness_cap=4.0)
    srv = jmake("asyncfeded", mk_params(), fed, gmis_mode=gmis_mode,
                backend=backend)
    return scripted(srv, lambda c, it, d: JUpdate(c, it, 5, d))


def run_port(gmis_mode, backend):
    fed = FedConfig(lam=1.0, eps=1.0, staleness_cap=4.0)
    srv = make_server("asyncfeded",
                      params_from_numpy(jax.tree.map(np.asarray, mk_params()),
                                        device="cpu"),
                      fed, gmis_mode=gmis_mode, backend=backend)
    return scripted(srv, lambda c, it, d: ClientUpdate(
        c, it, 5, params_from_numpy(d, device="cpu")))


@pytest.mark.parametrize("ref_backend", ["pytree", "pallas"])
@pytest.mark.parametrize("backend", ["pytree", "pallas"])
@pytest.mark.parametrize("gmis_mode", ["ring", "displacement"])
def test_scripted_run_parity(gmis_mode, backend, ref_backend):
    ref = run_ref(gmis_mode, ref_backend)
    port = run_port(gmis_mode, backend)
    for a, b in zip(jax.tree.leaves(ref.params),
                    pt.tree_leaves(port.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose([r.gamma for r in port.history],
                               [r.gamma for r in ref.history], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose([r.eta for r in port.history],
                               [r.eta for r in ref.history], rtol=1e-4)
    key = lambda h: [(r.iteration, r.client_id, r.lag, r.k_used, r.k_next,
                      r.screen) for r in h]
    assert key(port.history) == key(ref.history)
    assert port.t == ref.t


class TestServerContract:
    def fed(self, **kw):
        return FedConfig(lam=1.0, eps=1.0, **kw)

    def params(self):
        return params_from_numpy(jax.tree.map(np.asarray, mk_params()), device="cpu")

    def test_reply_params_structure_preserved(self):
        srv = make_server("asyncfeded", self.params(), self.fed(),
                          backend="pallas")
        rep = srv.on_connect(0)
        assert pt.tree_structure(rep.params) == pt.tree_structure(
            self.params())
        rep2 = srv.on_update(ClientUpdate(0, rep.iteration, 5,
                                          params_from_numpy(mk_delta(0), device="cpu")))
        assert rep2.params["a"].shape == (33, 7)
        assert srv._flat.vec.shape == (fedagg.BLOCK,)

    def test_stored_snapshots_never_change(self):
        """The ring GMIS holds the flat vector of every version and the
        clients hold views of it: an aggregation, single or batched (whose
        norms read the snapshots in place), must never write into
        either."""
        srv = make_server("asyncfeded", self.params(), self.fed(),
                          backend="pallas")
        rep = srv.on_connect(0)
        other = srv.on_connect(1)
        first = srv.gmis.get(1)[0]
        first_copy = first.clone()
        view = rep.params["a"].clone()
        for step in range(3):
            rep = srv.on_update(ClientUpdate(0, rep.iteration, 5,
                                             params_from_numpy(mk_delta(step),
                                                               device="cpu")))
        assert not torch.equal(rep.params["a"], view)
        last = srv.gmis.get(rep.iteration)[0]
        kept = [last.clone(), rep.params["a"].clone()]
        srv.on_update_batch([ClientUpdate(c, it, 5, params_from_numpy(
            mk_delta(10 + c), device="cpu"))
            for c, it in ((0, rep.iteration), (1, other.iteration))])
        assert torch.equal(srv.gmis.get(1)[0], first_copy)
        assert srv.gmis.get(1)[0] is first
        assert srv.gmis.get(rep.iteration)[0] is last
        assert torch.equal(last, kept[0])
        assert torch.equal(rep.params["a"], kept[1])

    def test_backend_validation(self):
        with pytest.raises(ValueError):
            AsyncFedEDServer(self.params(), self.fed(), backend="tpu")
        with pytest.raises(ValueError):
            AsyncFedEDServer(self.params(), self.fed(), gmis_mode="nope")

    def test_batch_of_one_equals_on_update(self):
        s1 = make_server("asyncfeded", self.params(), self.fed(),
                         backend="pallas")
        s2 = make_server("asyncfeded", self.params(), self.fed(),
                         backend="pallas")
        for s in (s1, s2):
            s.on_connect(0)
        upd = ClientUpdate(0, 1, 5, params_from_numpy(mk_delta(31), device="cpu"))
        r1 = s1.on_update(upd)
        (r2,) = s2.on_update_batch([upd])
        assert (r1.iteration, r1.k_next) == (r2.iteration, r2.k_next)
        assert torch.equal(s1._flat.vec, s2._flat.vec)

    def test_flat_burst_drain_not_ported(self):
        """The flat burst drain takes every wire form: bursts of int8
        deltas on the flat server go through the int8 batched sweeps and
        match the reference server's drains (no screen)."""
        ref, port = both_servers(dict(lam=1.0, eps=1.0,
                                      delta_compression="int8"))
        drive(port, False, "int8")
        drive(ref, True, "int8")
        assert_same_run(port, ref, params_rtol=1e-4)
        assert max(len(d) for d in SCRIPT) > 1

    def test_pytree_burst_drains_sequentially(self):
        srv = make_server("asyncfeded", self.params(), self.fed())
        for i in range(3):
            srv.on_connect(i)
        ups = [ClientUpdate(i, 1, 5, params_from_numpy(mk_delta(40 + i), device="cpu"))
               for i in range(3)]
        replies = srv.on_update_batch(ups)
        assert srv.t == 4 and all(r.iteration == 4 for r in replies)

    @pytest.mark.parametrize("mode,knee", [("off", 15), ("bf16", 20),
                                           ("int8", 24)])
    def test_batch_limit_is_the_reference_knee(self, mode, knee):
        srv = make_server("asyncfeded", self.params(),
                          self.fed(delta_compression=mode), backend="pallas")
        ref = jmake("asyncfeded", mk_params(),
                    JFedConfig(delta_compression=mode), backend="pallas")
        assert srv.batch_limit() == ref.batch_limit() == knee
        assert make_server("asyncfeded", self.params(),
                           self.fed(delta_compression=mode)
                           ).batch_limit() is None

    def test_unknown_aggregator(self):
        with pytest.raises(ValueError):
            make_server("fedsgd", self.params(), self.fed())

    def test_compression_not_ported(self):
        """Compressed transport is ported whole: both backends take every
        mode, and an int8 burst screened inside the drain (norm clip) gives
        the reference server's records, verdicts and model."""
        for mode in tc.MODES:
            for backend in ("pytree", "pallas"):
                make_server("asyncfeded", self.params(),
                            self.fed(delta_compression=mode),
                            backend=backend)
        ref, port = both_servers(dict(lam=1.0, eps=1.0,
                                      delta_compression="int8",
                                      screen="clip", screen_warmup=2))
        drive(port, False, "int8")
        drive(ref, True, "int8")
        assert_same_run(port, ref, params_rtol=1e-4)
        assert port.screen.counts == ref.screen.counts
        assert any(r.screen == "clip" for r in port.history)

    @pytest.mark.parametrize("policy", ["clip", "reject"])
    def test_norm_screen_matches_reference(self, policy):
        """Screening reuses the copied screens: a 10x delta after warm-up is
        clipped or rejected exactly as in the reference."""
        kw = dict(lam=1.0, eps=1.0, screen=policy, screen_warmup=2)
        ref = jmake("asyncfeded", mk_params(), JFedConfig(**kw),
                    backend="pallas")
        port = make_server("asyncfeded", self.params(), FedConfig(**kw),
                           backend="pallas")
        for step, scale in enumerate((1.0, 1.0, 1.0, 10.0)):
            d = mk_delta(step, scale=0.05 * scale)
            ref.on_update(JUpdate(0, ref.t, 5, d))
            port.on_update(ClientUpdate(0, port.t, 5, params_from_numpy(d, device="cpu")))
        assert ([r.screen for r in port.history]
                == [r.screen for r in ref.history])
        assert port.history[-1].screen == policy
        np.testing.assert_allclose([r.eta for r in port.history],
                                   [r.eta for r in ref.history], rtol=1e-4)



# ------------------------------------------------- bursts and wire forms --
def port_params():
    return params_from_numpy(jax.tree.map(np.asarray, mk_params()),
                             device="cpu")


def both_servers(fed_kw, backend="pallas", gmis_mode="ring"):
    ref = jmake("asyncfeded", mk_params(), JFedConfig(**fed_kw),
                gmis_mode=gmis_mode, backend=backend)
    port = make_server("asyncfeded", port_params(), FedConfig(**fed_kw),
                       gmis_mode=gmis_mode, backend=backend)
    return ref, port


def wire(mode, d, ref):
    """The update's delta as each package sends it: a tree, or the wire
    form quantized from the padded flat vector."""
    if ref:
        if mode == "off":
            return d
        spec = jpt.FlatSpec(mk_params(), block=jc.BLOCK)
        return jc.quantize_vec(spec.flatten(d), mode, spec.n)
    t = params_from_numpy(d, device="cpu")
    if mode == "off":
        return t
    spec = pt.FlatSpec(t, block=tc.BLOCK)
    return tc.quantize_vec(spec.flatten(t), mode, spec.n)


#: four clients; each inner list is one drain of (client, delta seed,
#: delta scale). Client 3's second arrival is ten times the others.
SCRIPT = [[(0, 0, 1.0)], [(1, 1, 1.0)], [(2, 2, 1.0), (3, 3, 1.0),
                                         (0, 4, 1.0)],
          [(1, 5, 1.0)], [(3, 6, 10.0), (2, 7, 1.0), (1, 8, 1.0)],
          [(0, 9, 1.0), (2, 10, 1.0)]]


def drive(srv, ref, mode, script=SCRIPT, batched=True):
    Update = JUpdate if ref else ClientUpdate
    reply = {i: srv.on_connect(i) for i in range(4)}
    for drain in script:
        ups = [Update(c, reply[c].iteration, 5,
                      wire(mode, mk_delta(seed, 0.05 * scale), ref))
               for c, seed, scale in drain]
        if batched:
            out = srv.on_update_batch(ups)
        else:
            out = [srv.on_update(u) for u in ups]
        for (c, _, _), r in zip(drain, out):
            reply[c] = r if batched else srv.on_connect(c)
    return srv


def assert_same_run(port, ref, params_rtol=1e-5):
    key = lambda h: [(r.iteration, r.client_id, r.lag, r.k_used, r.k_next,
                      r.screen) for r in h]
    assert key(port.history) == key(ref.history)
    for field in ("gamma", "eta", "dist", "delta_norm"):
        np.testing.assert_allclose(
            [getattr(r, field) for r in port.history],
            [getattr(r, field) for r in ref.history], rtol=1e-4, atol=1e-7)
    for a, b in zip(jax.tree.leaves(ref.params),
                    pt.tree_leaves(port.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   rtol=params_rtol, atol=1e-6)
    assert port.t == ref.t


class TestBurstDrain:
    @pytest.mark.parametrize("screen", ["off", "clip", "reject"])
    @pytest.mark.parametrize("mode", ["off", "bf16"])
    def test_burst_matches_reference(self, mode, screen):
        """Bursts of three on the flat ring-GMIS server, against the
        reference's on_update_batch: every record (screen verdicts
        included) and the model agree, and the bursts went through one
        batched sweep pair each."""
        kw = dict(lam=1.0, eps=1.0, delta_compression=mode, screen=screen,
                  screen_warmup=2)
        ref, port = both_servers(kw)
        fedagg.reset_launches()
        drive(port, False, mode)
        drive(ref, True, mode)
        assert_same_run(port, ref, params_rtol=1e-4)
        assert all(k.launches == 0 for k in fedagg.KERNELS)   # CPU
        if screen != "off":
            assert port.history[6].screen == screen
            assert port.screen.counts == ref.screen.counts
            assert port.screen.threshold == pytest.approx(
                ref.screen.threshold, rel=1e-5)

    def test_batch_matches_sequential(self):
        """Twin of tests/test_flat_backend.py::TestBatchedUpdates::
        test_batch_matches_sequential: a burst of four equals four
        on_update calls."""
        fed = FedConfig(lam=1.0, eps=1.0)
        srvs = []
        for _ in range(2):
            srv = make_server("asyncfeded", params_from_numpy(
                jax.tree.map(np.asarray, mk_params()), device="cpu"), fed,
                backend="pallas")
            for i in range(4):
                srv.on_connect(i)
            srvs.append(srv)
        s_seq, s_bat = srvs
        ups = [ClientUpdate(i, 1, 5, params_from_numpy(mk_delta(20 + i),
                                                        device="cpu"))
               for i in range(4)]
        for u in ups:
            s_seq.on_update(u)
        replies = s_bat.on_update_batch(ups)
        assert len(replies) == 4
        for l1, l2 in zip(pt.tree_leaves(s_seq.params),
                          pt.tree_leaves(s_bat.params)):
            np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=1e-4,
                                       atol=1e-6)
        np.testing.assert_allclose([r.gamma for r in s_seq.history],
                                   [r.gamma for r in s_bat.history],
                                   rtol=1e-3, atol=1e-6)
        assert ([r.k_next for r in s_seq.history]
                == [r.k_next for r in s_bat.history])
        assert all(r.iteration == s_bat.t for r in replies)
        # only the final version entered the GMIS
        assert s_bat.gmis.num_stored == 2

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_drains_match_the_old_staging(self, dtype):
        """A batched drain of three, a single drain and another batched
        drain give, to the bit, the history and flat vectors of
        ``ops.flat_aggregate_batched`` / ``ops.flat_aggregate`` fed by
        stacks built as the server built them before it wrote each delta
        into its row (cat, pad, stack); a reply's params are unchanged by
        the drains after it, so the fresh stacks alias nothing handed
        out."""
        cast = lambda t: pt.tree_map(lambda l: l.to(dtype)
                                     if l.shape == (129,) else l, t)
        fed = FedConfig(lam=1.0, eps=1.0, staleness_cap=4.0)
        srv = make_server("asyncfeded", cast(params_from_numpy(
            jax.tree.map(np.asarray, mk_params()), device="cpu")), fed,
            backend="pallas")
        spec = srv._flat.spec
        old = lambda t: torch.nn.functional.pad(
            torch.cat([l.reshape(-1).float() for l in pt.tree_leaves(t)]),
            (0, spec.n_padded - spec.n))
        kw = dict(lam=fed.lam, eps=fed.eps, cap=fed.staleness_cap)
        its = {c: srv.on_connect(c).iteration for c in range(3)}
        x = srv._flat.vec.clone()
        versions, want, kept = {1: x}, [], []
        for seed, drain in enumerate(([0, 1, 2], [1], [2, 0, 1])):
            ups = [ClientUpdate(c, its[c], 5, cast(params_from_numpy(
                mk_delta(10 * seed + c), device="cpu"))) for c in drain]
            replies = srv.on_update_batch(ups)
            stales = [versions[u.snapshot_iter] for u in ups]
            if len(ups) > 1:
                x, etas, gammas, dists, dnorms, _ = (
                    ops.flat_aggregate_batched(
                        x, torch.stack(stales),
                        torch.stack([old(u.delta) for u in ups]), **kw))
                want += zip(gammas.tolist(), etas.tolist(), dists.tolist(),
                            dnorms.tolist())
            else:
                x, *scalars = ops.flat_aggregate(
                    x, stales[0], old(ups[0].delta), **kw)
                want.append(tuple(torch.stack(scalars).tolist()))
            versions[srv.t] = x
            assert torch.equal(srv._flat.vec.view(torch.int32),
                               x.view(torch.int32))
            assert [(r.gamma, r.eta, r.dist, r.delta_norm)
                    for r in srv.history] == want
            for tree, copies in kept:
                assert all(torch.equal(a, b) for a, b in zip(
                    pt.tree_leaves(tree), copies))
            leaves = pt.tree_leaves(replies[0].params)
            kept.append((replies[0].params, [l.clone() for l in leaves]))
            its.update({u.client_id: r.iteration
                        for u, r in zip(ups, replies)})
        assert srv.t == 8 and len(kept) == 3

    @pytest.mark.parametrize("mode", ["off", "bf16", "int8"])
    def test_norms_read_the_rings_own_snapshots(self, mode, monkeypatch):
        """A batched drain hands the norms the ring's own snapshot tensors
        (two arrivals on one version pass the same one), not a (B, n)
        stack of copies."""
        srv = make_server("asyncfeded", port_params(), FedConfig(
            lam=1.0, eps=1.0, delta_compression=mode), backend="pallas")
        its = {c: srv.on_connect(c).iteration for c in range(3)}
        srv.on_update(ClientUpdate(0, its[0], 5,
                                   wire(mode, mk_delta(1), False)))
        its[0] = srv.on_connect(0).iteration
        seen = []
        packed = fedagg.norms_batched_packed

        def record(x_t, x_stales, *a):
            seen.append(x_stales)
            return packed(x_t, x_stales, *a)
        monkeypatch.setattr(fedagg, "norms_batched_packed", record)
        ring = {t: srv.gmis.get(t)[0] for t in (1, 2)}
        upds = [ClientUpdate(c, its[c], 5,
                             wire(mode, mk_delta(2 + c), False))
                for c in (0, 1, 2)]
        srv.on_update_batch(upds)
        (stales,) = seen
        assert not isinstance(stales, torch.Tensor)
        assert [s is ring[u.snapshot_iter] for s, u in zip(stales, upds)] \
            == [True] * 3
        assert stales[1] is stales[2]

    @pytest.mark.parametrize("mode", ["off", "int8"])
    def test_drain_evicting_what_it_read(self, mode):
        """On a ring of depth 2 a drain reads a version that its own append
        evicts: its records and model are those of the same drains on a
        deep ring, to the bit."""
        runs = []
        for depth in (2, 16):
            srv = make_server("asyncfeded", port_params(), FedConfig(
                lam=1.0, eps=1.0, gmis_depth=depth, delta_compression=mode),
                backend="pallas")
            its = {c: srv.on_connect(c).iteration for c in range(3)}
            for seed, drain in enumerate(([0], [0, 1, 2], [2, 1])):
                oldest = next(iter(srv.gmis._store))
                replies = srv.on_update_batch(
                    [ClientUpdate(c, its[c], 5, wire(mode, mk_delta(
                        5 * seed + c), False)) for c in drain])
                its.update({c: r.iteration for c, r in zip(drain, replies)})
                if depth == 2 and seed == 1:
                    # the drain read version 1, which its append evicted
                    assert oldest == 1 and 1 not in srv.gmis._store
            runs.append(srv)
        shallow, deep = runs
        assert [dataclasses.astuple(r) for r in shallow.history] == \
            [dataclasses.astuple(r) for r in deep.history]
        assert torch.equal(shallow._flat.vec, deep._flat.vec)

    @pytest.mark.parametrize("case", ["displacement", "cosine", "mixed",
                                      "pytree"])
    def test_fallbacks_drain_sequentially(self, case):
        """Displacement GMIS, a direction screen, a burst mixing wire forms
        and the tree backend drain one at a time, as the reference does,
        and re-register every drained client at the final model."""
        kw = dict(lam=1.0, eps=1.0)
        backend, gmis_mode, mode = "pallas", "ring", "off"
        if case == "displacement":
            gmis_mode = "displacement"
        elif case == "cosine":
            kw.update(screen="cosine", screen_warmup=2)
        elif case == "mixed":
            kw.update(delta_compression="int8")
        else:
            backend = "pytree"
        ref, port = both_servers(kw, backend=backend, gmis_mode=gmis_mode)
        if case == "mixed":
            script = [[(0, 0, 1.0), (1, 1, 1.0)], [(2, 2, 1.0), (3, 3, 1.0)]]
            for srv, is_ref in ((port, False), (ref, True)):
                Update = JUpdate if is_ref else ClientUpdate
                for drain in script:
                    srv.on_update_batch([
                        Update(c, 1, 5, wire("int8" if c % 2 else "off",
                                             mk_delta(seed), is_ref))
                        for c, seed, _ in drain])
        else:
            fedagg.reset_launches()
            drive(port, False, mode)
            drive(ref, True, mode)
            assert fedagg.fedagg_norms_batched.launches == 0
        assert_same_run(port, ref)
        if case == "displacement":
            for i in (0, 2):
                assert float(port.gmis.distance_from(i, port.t, None)) == 0.0


class TestCompressedSequential:
    @pytest.mark.parametrize("gmis_mode", ["ring", "displacement"])
    @pytest.mark.parametrize("backend", ["pytree", "pallas"])
    @pytest.mark.parametrize("mode", ["int8", "bf16"])
    def test_matches_reference(self, mode, backend, gmis_mode):
        """The scripted run with compressed deltas, one arrival at a time:
        the int8 sweeps (or the f32 sweeps on a bf16 payload) on the flat
        backend, dequantize-then-tree on the tree backend."""
        kw = dict(lam=1.0, eps=1.0, staleness_cap=4.0, delta_compression=mode)
        ref, port = both_servers(kw, backend=backend, gmis_mode=gmis_mode)
        script = [[(c % 4, c, 1.0)] for c in range(8)]
        drive(port, False, mode, script, batched=False)
        drive(ref, True, mode, script, batched=False)
        assert_same_run(port, ref)

    @pytest.mark.parametrize("policy", ["clip", "reject"])
    def test_screen_on_int8(self, policy):
        kw = dict(lam=1.0, eps=1.0, delta_compression="int8", screen=policy,
                  screen_warmup=2)
        ref, port = both_servers(kw)
        script = [[(c % 4, c, 10.0 if c == 5 else 1.0)] for c in range(7)]
        drive(port, False, "int8", script, batched=False)
        drive(ref, True, "int8", script, batched=False)
        assert port.history[5].screen == policy
        assert_same_run(port, ref)
