"""The port's pod engine (``client_engine="cohort_sharded"``) against the
reference's: the contract of the reference's ``tests/test_cohort_sharded.py``
and of ``tests/test_flat_sharded.py::TestCompressedPodCollectives``.

The port runs its pods under the mesh's device hook
(``launch.mesh.repeat_devices(8)``): eight pods on the one CPU, one after
another, so every fan-out of two or more clients really splits. Each run
is held against the REFERENCE's ``cohort_sharded`` engine on its CPU
device(s) from the same inputs, not the loop engine against the sharded
one. The reference's own loop-against-sharded comparison fails for the
``scale`` and ``zero`` attacks (the loop corrupts a delta before it is
quantized, the pod engine after), and both engines of the same package
are what a user compares; so each attack here compares like with like.

* Engine level: uniform K, ragged K with client counts the pods do not
  divide, per-client params with FedProx, each delta to 1e-4 of its scale
  (the packages sum in other orders, ``test_torch_cohort.py``); the batcher
  streams end in the reference's state; an engine switch between rounds.
* Simulator: FedAvg rounds; async seeding and burst re-dispatch on both
  server backends; int8 and bf16 wire forms on both backends; the 2-D
  layout (pods and ``model_shards=2``); the four attacks on int8 wire
  forms. Each run's trace equals the reference's, accuracy to rtol 1e-3,
  and its gammas agree with the port's one-device run of the same config
  to rtol 2e-4 / atol 1e-5 (the reference's bound for its own sharded
  runs; on the CPU they are equal). Against the reference the gammas hold
  rtol 2e-4 where the packages' float noise allows: with bf16 wire forms
  a last-bit difference in a delta can round an element to the
  neighbouring bf16 value, and an attacked run amplifies such
  differences, so the loop engine of the port parts from the reference's
  loop engine as much as the pods do (bf16 up to 4.6e-4 relative, the
  ``scale`` attack 1.2e-3, measured). Those runs hold the port's
  cross-package bound of ``test_torch_simulator.py`` (rtol 1e-3) for
  bf16, and trace, attack statistics and accuracy for the attacks, as
  ``test_torch_adversary.py`` holds attacked runs.
* The committed error-feedback rows own their storage and lie on the
  client's device.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as C
from repro.core import cohort as jcohort
from repro.core.client import Client as JClient
from repro.core.simulator import FederatedSimulation as JSim
from repro.data.pipeline import load_task_datasets as jload
from repro.launch import mesh as jmesh
from repro.models import small as jsmall
from repro_torch import configs as TC
from repro_torch.configs.base import CLIENT_ENGINES
from repro_torch.convert import params_from_numpy
from repro_torch.core import cohort, compression
from repro_torch.core.client import Client
from repro_torch.core.simulator import FederatedSimulation
from repro_torch.data.pipeline import load_task_datasets
from repro_torch.launch import mesh
from repro_torch.utils import pytree as pt
from torch_threads import one_torch_thread  # noqa: F401

PODS = 8


def jparams(seed=0):
    return jsmall.init_task_model(jax.random.PRNGKey(seed), C.SYNTHETIC_1_1)


def tparams(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def clients(n, seed=0, package="torch"):
    if package == "torch":
        train, _ = load_task_datasets(TC.SYNTHETIC_1_1, seed=seed)
        return [Client(i, TC.SYNTHETIC_1_1, train[i], TC.SYNTHETIC_1_1.fed,
                       seed=seed, device="cpu") for i in range(n)]
    train, _ = jload(C.SYNTHETIC_1_1, seed=seed)
    return [JClient(i, C.SYNTHETIC_1_1, train[i], C.SYNTHETIC_1_1.fed,
                    seed=seed) for i in range(n)]


def assert_close_ref(t_delta, j_delta, params):
    """1e-4 of the delta's scale plus a few ulps of the params' largest
    entry (a delta is x_K - x_0)."""
    for t, j, q in zip(pt.tree_leaves(t_delta), jax.tree.leaves(j_delta),
                       jax.tree.leaves(params)):
        tol = (1e-4 * float(np.abs(np.asarray(j)).max())
               + 2.0 ** -18 * float(np.abs(np.asarray(q)).max()))
        assert float(np.abs(t.numpy() - np.asarray(j)).max()) <= tol


def sharded_pair(n, ks, params, seed=0, snapshot=1, prox_mu=0.0,
                 per_client=False, tc=None, jc=None):
    """One fan-out through the port's pod engine (``PODS`` pods) and the
    reference's, on clients made alike."""
    tc = clients(n, seed) if tc is None else tc
    jc = clients(n, seed, "jax") if jc is None else jc
    tp = [tparams(p) for p in params] if per_client else tparams(params)
    with mesh.repeat_devices(PODS):
        got = cohort.run_cohort(TC.SYNTHETIC_1_1, tc, tp, ks, [snapshot] * n,
                                prox_mu=prox_mu, per_client_params=per_client,
                                engine="cohort_sharded")
    want = jcohort.run_cohort(C.SYNTHETIC_1_1, jc, params, ks,
                              [snapshot] * n, prox_mu=prox_mu,
                              per_client_params=per_client,
                              engine="cohort_sharded")
    return got, want, tc, jc


def assert_pair(got, want, params):
    assert len(got) == len(want)
    for (u1, l1), (u2, l2) in zip(got, want):
        assert ((u1.client_id, u1.k_used, u1.snapshot_iter, u1.num_samples)
                == (u2.client_id, u2.k_used, u2.snapshot_iter,
                    u2.num_samples))
        assert_close_ref(u1.delta, u2.delta, params)
        assert abs(l1 - l2) <= 1e-4 * max(1.0, abs(l2))


class TestPodBucketing:
    def test_pod_count_is_pow2_and_clamped(self):
        assert mesh.pod_count(device="cpu") == 1
        for n in (1, 3, 8, 12):
            with mesh.repeat_devices(n):
                got = mesh.pod_count(device="cpu")
                assert got & (got - 1) == 0 and got <= n
                assert mesh.pod_count(max_pods=2, device="cpu") <= 2
                assert mesh.pod_count(max_pods=1, device="cpu") == 1
                for cap in (3, 5, 6, 7):
                    got = mesh.pod_count(max_pods=cap, device="cpu")
                    assert got <= cap and got & (got - 1) == 0
                for c_real in (1, 3, 5, 8, 9):
                    c_pad = cohort.bucket_size(c_real)
                    assert c_pad % mesh.pod_count(max_pods=c_pad,
                                                  device="cpu") == 0
        # the reference's rule on its own device count
        n = jax.device_count()
        assert jmesh.pod_count() == max(1, 1 << (n.bit_length() - 1))
        with mesh.repeat_devices(n):
            assert mesh.pod_count(device="cpu") == jmesh.pod_count()
            for cap in (1, 2, 3, 5, 8):
                assert (mesh.pod_count(max_pods=cap, device="cpu")
                        == jmesh.pod_count(max_pods=cap))

    def test_cohort_mesh_layout(self):
        with mesh.repeat_devices(4):
            m = mesh.make_cohort_mesh(4, device="cpu")
            f = mesh.make_fedagg_mesh(2, n_pods=2, device="cpu")
        assert m.shape == (4, 1) and len(m.pod_devices()) == 4
        assert f.shape == (2, 2) and len(f.model_devices(1)) == 2
        assert m.home == torch.device("cpu")
        with pytest.raises(ValueError, match="needs 4 devices, have 1"):
            mesh.make_cohort_mesh(4, device="cpu")

    def test_run_cohort_rejects_non_cohort_engines(self):
        cs = clients(1)
        p = tparams(jparams())
        for bad in ("loop", "turbo"):
            with pytest.raises(ValueError, match="engine"):
                cohort.run_cohort(TC.SYNTHETIC_1_1, cs, p, [1], [1],
                                  engine=bad)
        assert cohort.COHORT_ENGINES == jcohort.COHORT_ENGINES

    def test_fedconfig_rejects_unknown_engine(self):
        with pytest.raises(ValueError, match="client_engine"):
            dataclasses.replace(TC.SYNTHETIC_1_1.fed, client_engine="turbo")
        for eng in CLIENT_ENGINES:
            dataclasses.replace(TC.SYNTHETIC_1_1.fed, client_engine=eng)


class TestEngineEquivalence:
    def test_uniform_k_dense(self):
        params = jparams()
        got, want, _, _ = sharded_pair(3, [6] * 3, params, seed=7)
        assert_pair(got, want, params)

    def test_ragged_k_momentum_carry_nondividing_c(self):
        """C = 5 pads to 8 rows over 8 pods (3 discarded), C = 3 to 4 rows
        over 4 pods; the second round carries the momentum."""
        params = jparams()
        for n, ks in ((5, [3, 7, 5, 1, 4]), (3, [2, 4, 3])):
            tc, jc = clients(n, seed=n), clients(n, seed=n, package="jax")
            for rnd in (1, 2):
                got, want, _, _ = sharded_pair(n, ks, params, snapshot=rnd,
                                               tc=tc, jc=jc)
                assert_pair(got, want, params)
            assert all(c.round_idx == 2 for c in tc)

    def test_sharded_matches_unsharded_cohort(self):
        """The pods' rows equal the one-device cohort engine's rows."""
        params = jparams()
        tp = tparams(params)
        a, b = clients(4, seed=3), clients(4, seed=3)
        with mesh.repeat_devices(PODS):
            got = cohort.run_cohort(TC.SYNTHETIC_1_1, a, tp, [2, 4, 3, 2],
                                    [1] * 4, engine="cohort_sharded")
        want = cohort.run_cohort(TC.SYNTHETIC_1_1, b, tp, [2, 4, 3, 2],
                                 [1] * 4)
        for (u1, l1), (u2, l2) in zip(got, want):
            for x, y in zip(pt.tree_leaves(u1.delta),
                            pt.tree_leaves(u2.delta)):
                np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=2e-5,
                                           atol=1e-7)
            assert abs(l1 - l2) < 1e-5

    def test_per_client_params_and_fedprox(self):
        params = jparams()
        bumped = jax.tree.map(lambda p: p + 0.01, params)
        got, want, _, _ = sharded_pair(2, [3, 3], [params, bumped], seed=4,
                                       prox_mu=0.1, per_client=True)
        assert_pair(got, want, params)


class TestRngStream:
    def test_rng_state_identical_after_fanout(self):
        ks = [3, 7, 5, 1, 4]
        _, _, tc, jc = sharded_pair(5, ks, jparams())
        for a, b in zip(tc, jc):
            assert (a.batcher.rng.bit_generator.state
                    == b.batcher.rng.bit_generator.state)
            np.testing.assert_array_equal(a.batcher.next()[0],
                                          b.batcher.next()[0])

    def test_engine_switch_mid_run(self):
        """Round 1 on the pods, round 2 on the loop, in both packages."""
        params = jparams()
        ks = [2, 3, 2]
        _, _, tc, jc = sharded_pair(3, ks, params, seed=9)
        tp = tparams(params)
        got = [c.run_local(tp, k, 2, 0.0) for c, k in zip(tc, ks)]
        want = [c.run_local(params, k, 2, 0.0) for c, k in zip(jc, ks)]
        assert_pair(got, want, params)


# ------------------------------------------------------- simulations --
def trace(res):
    return [(h.iteration, h.client_id, h.lag, h.k_next, h.screen)
            for h in res.history]


def assert_same_run(r1, r2, *, rtol=2e-4, atol=1e-5, acc_rtol=1e-3):
    assert trace(r1) == trace(r2)
    np.testing.assert_allclose([h.gamma for h in r1.history],
                               [h.gamma for h in r2.history],
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose([p.accuracy for p in r1.points],
                               [p.accuracy for p in r2.points],
                               rtol=acc_rtol)


@functools.lru_cache(maxsize=None)
def reference_run(fed, algorithm, seed, window, max_updates):
    """The reference's run, shared by the tests that compare with it."""
    jsim = JSim(C.SYNTHETIC_1_1, fed, algorithm, seed=seed,
                batch_window=window)
    init = jax.tree.map(np.asarray, jsim.server.params)
    return jsim, jsim.run(max_time=1e9, max_updates=max_updates), init


@functools.lru_cache(maxsize=None)
def sim_pair(fed, *, algorithm="asyncfeded", seed=3, window=0.05,
             max_updates=30, shards=1):
    """The reference's ``cohort_sharded`` run, the port's under ``PODS``
    pods (and ``shards`` model shards), both from the reference's init;
    the port's run of the same config on one device (one pod, one shard)
    is held to it here at the sharding bound. Returns (reference sim,
    its result, the port's sharded sim, its result), shared by the tests
    that ask for the same runs."""
    jsim, jres, init = reference_run(fed, algorithm, seed, window,
                                     max_updates)

    def port(devices, shards):
        with mesh.repeat_devices(devices):
            sim = FederatedSimulation(
                TC.SYNTHETIC_1_1, dataclasses.replace(fed,
                                                      model_shards=shards),
                algorithm, seed=seed, batch_window=window, device="cpu",
                init_params=params_from_numpy(init, device="cpu"))
            fanouts = []
            run_locals = sim._run_locals
            sim._run_locals = lambda jobs: (fanouts.append(len(jobs))
                                            or run_locals(jobs))
            return sim, sim.run(max_time=1e9, max_updates=max_updates), \
                max(fanouts)

    tsim, tres, widest = port(PODS, shards)
    _, one, _ = port(1, 1)
    assert widest >= 2
    assert tres.total_updates == one.total_updates
    assert_same_run(tres, one)
    assert tres.attack == one.attack
    return jsim, jres, tsim, tres


def fed_of(**kw):
    return dataclasses.replace(C.SYNTHETIC_1_1.fed,
                               client_engine="cohort_sharded", **kw)


def test_fedavg_rounds():
    jsim = JSim(C.SYNTHETIC_1_1, fed_of(), "fedavg", seed=1)
    init = jax.tree.map(np.asarray, jsim.server.params)
    jres = jsim.run(max_time=1e9, max_updates=3)
    with mesh.repeat_devices(PODS):
        tres = FederatedSimulation(
            TC.SYNTHETIC_1_1, fed_of(), "fedavg", seed=1, device="cpu",
            init_params=params_from_numpy(init, device="cpu")).run(
            max_time=1e9, max_updates=3)
    assert tres.total_updates == jres.total_updates == 3
    np.testing.assert_allclose([p.accuracy for p in tres.points],
                               [p.accuracy for p in jres.points], rtol=1e-3)
    np.testing.assert_allclose([p.loss for p in tres.points],
                               [p.loss for p in jres.points], rtol=1e-4)


@pytest.mark.parametrize("backend", ["pytree", "pallas"])
def test_async_seeding_and_burst_redispatch(backend):
    """The window drives both fan-out sites: the seeding (uniform K) and
    the burst re-dispatch (ragged K once adaptive K has diverged)."""
    _, jres, _, tres = sim_pair(fed_of(backend=backend))
    assert tres.total_updates == jres.total_updates >= 30
    assert len({h.k_next for h in jres.history}) > 1
    assert_same_run(tres, jres)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("backend", ["pytree", "pallas"])
def test_wire_forms(mode, backend):
    """Each pod quantizes its own rows; the server receives the wire
    blocks the reference's pods emit (bf16: the cross-package bound, see
    the module's docstring)."""
    _, jres, tsim, tres = sim_pair(fed_of(backend=backend,
                                          delta_compression=mode))
    assert tres.total_updates == jres.total_updates >= 30
    assert_same_run(tres, jres, rtol=2e-4 if mode == "int8" else 1e-3)


def test_wire_with_model_shards():
    """The 2-D layout: pods emitting int8 wire blocks into a server with
    two model shards (single arrivals and bursts), against the reference's
    pod engine into its unsharded server (the shard boundary is
    invisible: its own ``test_wire_with_model_shards``)."""
    fed = fed_of(backend="pallas", delta_compression="int8")
    _, jres, tsim, tres = sim_pair(fed, shards=2)
    assert len(tsim.server._flat.vec) == 2
    assert_same_run(tres, jres)


def test_residual_rows_own_their_storage():
    """A committed error-feedback row is a tensor of its own on the
    client's device: not a view keeping the fan-out's stacked rows
    alive (the torch meaning of the reference's host-neutral rows)."""
    fed = fed_of(backend="pallas", delta_compression="int8")
    _, _, tsim, _ = sim_pair(fed)
    staged = [c for c in tsim.clients if c._residual is not None]
    assert len(staged) >= 2
    for c in staged:
        r = c._residual
        assert isinstance(r, torch.Tensor) and r.device == c.device
        assert r.dtype == torch.float32 and r.dim() == 1
        assert r.storage_offset() == 0
        assert r.untyped_storage().nbytes() == r.numel() * 4
    ptrs = {c._residual.untyped_storage().data_ptr() for c in staged}
    assert len(ptrs) == len(staged)


def test_engine_emits_wire_form():
    """With compression on, the pod engine's updates are CompressedDelta
    and ``compress_update`` passes them through."""
    tc = clients(3, seed=2)
    fed = dataclasses.replace(TC.SYNTHETIC_1_1.fed, delta_compression="int8")
    for c in tc:
        c.fed = fed
    with mesh.repeat_devices(PODS):
        out = cohort.run_cohort(TC.SYNTHETIC_1_1, tc, tparams(jparams()),
                                [2, 2, 2], [1] * 3, engine="cohort_sharded")
    for (u, _), c in zip(out, tc):
        assert compression.is_compressed(u.delta) and u.delta.mode == "int8"
        assert c.compress_update(u) is u


@pytest.mark.parametrize("attack", ["sign-flip", "gaussian-noise", "scale",
                                    "zero"])
def test_adversary_corrupts_wire_form(attack):
    """The attacks act on the CompressedDelta the pod engine emitted, in
    both packages, so the attacked runs match."""
    fed = fed_of(backend="pallas", delta_compression="int8", attack=attack,
                 attack_frac=0.3)
    jsim, jres, tsim, tres = sim_pair(fed, seed=5, max_updates=25)
    assert jsim.adversary.applied > 0 and tsim.adversary.applied > 0
    assert tres.attack == jres.attack
    assert trace(tres) == trace(jres)
    np.testing.assert_allclose([p.accuracy for p in tres.points],
                               [p.accuracy for p in jres.points],
                               rtol=1e-3)
    if attack == "sign-flip":
        assert_same_run(tres, jres)
