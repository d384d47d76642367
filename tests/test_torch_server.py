"""The port's AsyncFedED server against the reference on the scripted run of
tests/test_flat_backend.py (three clients, six updates, staleness cap 4),
for both GMIS modes and both backends, plus the server's own contract.

The reference's flat backend runs its Pallas kernels in interpret mode. The
inputs are drawn once with jax.random and handed to both packages as numpy.
Tolerances are the reference's own for its backend parity: params rtol
1e-5 (atol 1e-6), gamma rtol 1e-4; k_next must be equal.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as JFedConfig
from repro.core.server import ClientUpdate as JUpdate
from repro.core.server import make_server as jmake
from repro_torch.configs.base import FedConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.server import (AsyncFedEDServer, ClientUpdate,
                                     make_server)
from repro_torch.kernels.fedagg import fedagg
from repro_torch.utils import pytree as pt


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
        clients hold views of it: an aggregation must never write into
        either."""
        srv = make_server("asyncfeded", self.params(), self.fed(),
                          backend="pallas")
        rep = srv.on_connect(0)
        first = srv.gmis.get(1)[0]
        first_copy = first.clone()
        view = rep.params["a"].clone()
        for step in range(3):
            rep = srv.on_update(ClientUpdate(0, rep.iteration, 5,
                                             params_from_numpy(mk_delta(step),
                                                               device="cpu")))
        assert torch.equal(srv.gmis.get(1)[0], first_copy)
        assert srv.gmis.get(1)[0] is first
        assert not torch.equal(rep.params["a"], view)

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
        srv = make_server("asyncfeded", self.params(), self.fed(),
                          backend="pallas")
        ups = [ClientUpdate(i, 1, 5, params_from_numpy(mk_delta(40 + i), device="cpu"))
               for i in range(2)]
        with pytest.raises(NotImplementedError, match="A11"):
            srv.on_update_batch(ups)

    def test_pytree_burst_drains_sequentially(self):
        srv = make_server("asyncfeded", self.params(), self.fed())
        for i in range(3):
            srv.on_connect(i)
        ups = [ClientUpdate(i, 1, 5, params_from_numpy(mk_delta(40 + i), device="cpu"))
               for i in range(3)]
        replies = srv.on_update_batch(ups)
        assert srv.t == 4 and all(r.iteration == 4 for r in replies)

    def test_batch_limit_is_the_reference_knee(self):
        srv = make_server("asyncfeded", self.params(), self.fed(),
                          backend="pallas")
        ref = jmake("asyncfeded", mk_params(), JFedConfig(),
                    backend="pallas")
        assert srv.batch_limit() == ref.batch_limit() == 15
        assert make_server("asyncfeded", self.params(),
                           self.fed()).batch_limit() is None

    @pytest.mark.parametrize("name", ["fedasync+constant", "fedbuff",
                                      "fedavg", "asyncfeded-perleaf"])
    def test_baselines_not_ported(self, name):
        with pytest.raises(NotImplementedError):
            make_server(name, self.params(), self.fed())

    def test_unknown_aggregator(self):
        with pytest.raises(ValueError):
            make_server("fedsgd", self.params(), self.fed())

    def test_compression_not_ported(self):
        with pytest.raises(NotImplementedError, match="A12"):
            make_server("asyncfeded", self.params(),
                        self.fed(delta_compression="int8"))

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

