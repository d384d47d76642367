"""The model-sharded flat state (``FedConfig.model_shards``) of the port
against the JAX package: the contract of the reference's
``tests/test_kernels.py::TestFedAggSharded`` and
``tests/test_flat_sharded.py``.

The port is single-controller, as the reference is: a sharded vector is a
tuple of S contiguous shards on the devices of a mesh, and one process
drives them all. These tests run S > 1 on the one CPU through the mesh's
device hook (``launch.mesh.repeat_devices``, the counterpart of XLA's
forced host device count), with no extra process.

* Ops: the six sharded entry points at S in {1, 2, 4, 8}, on true sizes
  the shard count does not divide (BLOCK + 517, 3 BLOCK - 1) and on 6
  blocks over 2 shards, against the reference's replicated
  ``repro.kernels.fedagg.ops`` (rtol 1e-4, the reference's own bound) and
  its ``sharded`` twins at ``shards=1`` (one JAX device), against the
  port's unsharded ops to rtol 1e-5, and every new shard bitwise equal to
  the unsharded AXPY or apply at the same eta(s).
* Server: the paths of ``TestShardedServerEquivalence`` (sequential S = 2,
  8; burst S = 4; int8 burst S = 4; displacement S = 2; a reduced danube
  ``ArchTask`` S = 2) against the reference's UNSHARDED pallas runs from
  the reference's init: traces equal, gammas to rtol 2e-4 / atol 1e-5,
  accuracies to rtol 1e-3 (``assert_same_run``'s bounds).
* Per-shard bytes at S = 8, the mesh's error on too few devices, and a
  checkpoint saved at S = 4 restored at S = 1 by the port and by the
  reference's server.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as C
from repro.configs import shapes as jshapes
from repro.core import compression as jcompression
from repro.core import tasks as jtasks
from repro.core.simulator import FederatedSimulation as JSim
from repro.kernels.fedagg import ops as jops
from repro.kernels.fedagg import sharded as jsharded
from repro_torch import configs as TC
from repro_torch.configs import shapes
from repro_torch.convert import params_from_numpy
from repro_torch.core import compression, tasks
from repro_torch.core.simulator import FederatedSimulation
from repro_torch.kernels.fedagg import fedagg, ops, sharded
from repro_torch.launch import mesh
from repro_torch.sharding import specs
from repro_torch.utils import pytree as pt
from torch_threads import one_torch_thread  # noqa: F401

BLOCK = fedagg.BLOCK


# --------------------------------------------------------------- ops --
def padded(n_true, shards, seed):
    """(x_t, x_stale, delta) as numpy f32, padded to BLOCK * shards: the
    server's layout for a true size the shard count may not divide."""
    rng = np.random.default_rng(seed)
    block = BLOCK * shards
    n_pad = -(-n_true // block) * block
    xt = np.zeros(n_pad, np.float32)
    xt[:n_true] = rng.standard_normal(n_true, dtype=np.float32)
    xs, d = xt.copy(), np.zeros(n_pad, np.float32)
    xs[:n_true] += 0.03
    d[:n_true] = rng.standard_normal(n_true, dtype=np.float32) * 0.02
    return xt, xs, d


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def split(a, s, scales=False):
    m = mesh.make_fedagg_mesh(s, device="cpu")
    return (specs.split_scales if scales else specs.split_flat)(t(a), m)


def check_single(got, ref_j, port, axpy):
    """``got``: a sharded entry point's output; ``ref_j``: the reference's
    replicated op's; ``port``: the port's unsharded op's. ``axpy(eta)`` is
    the unsharded AXPY at a given eta."""
    new, *scalars = got
    full = specs.gather_flat(new).numpy()
    np.testing.assert_allclose(full, np.asarray(ref_j[0]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose([float(x) for x in scalars],
                               [float(x) for x in ref_j[1:]], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose([float(x) for x in scalars],
                               [float(x) for x in port[1:]], rtol=1e-5,
                               atol=1e-7)
    # elementwise, so bitwise the unsharded AXPY at the sharded eta
    assert np.array_equal(full, axpy(scalars[1]).numpy())


SINGLE = [(s, n) for s in (1, 2, 4, 8) for n in (BLOCK + 517, 3 * BLOCK - 1)]


@pytest.mark.parametrize("shards,n_true", SINGLE)
def test_flat_aggregate_nondividing(shards, n_true):
    """The padded tail is value-transparent on every shard, a shard that
    is nearly all padding included (BLOCK + 517 at S = 8)."""
    xt, xs, d = padded(n_true, shards, seed=shards)
    with mesh.repeat_devices(shards):
        got = sharded.flat_aggregate(split(xt, shards), split(xs, shards),
                                     split(d, shards), lam=2.0, eps=1.0)
    ref = jops.flat_aggregate(jnp.asarray(xt), jnp.asarray(xs),
                              jnp.asarray(d), lam=2.0, eps=1.0)
    port = ops.flat_aggregate(t(xt), t(xs), t(d), lam=2.0, eps=1.0)
    check_single(got, ref, port, lambda e: fedagg.axpy_plain(t(xt), t(d), e))
    assert len(got[0]) == shards
    assert all(s.shape == (xt.shape[0] // shards,) for s in got[0])


def test_shards1_equals_reference_sharded_twin():
    """S = 1 against the reference's own sharded twin on a one-device
    mesh, and against the port's unsharded op to the bit."""
    xt, xs, d = padded(BLOCK + 129, 1, seed=0)
    got = sharded.flat_aggregate((t(xt),), (t(xs),), (t(d),), lam=2.0,
                                 eps=1.0)
    ref = jsharded.flat_aggregate(jnp.asarray(xt), jnp.asarray(xs),
                                  jnp.asarray(d), lam=2.0, eps=1.0, shards=1)
    port = ops.flat_aggregate(t(xt), t(xs), t(d), lam=2.0, eps=1.0)
    check_single(got, ref, port, lambda e: fedagg.axpy_plain(t(xt), t(d), e))
    assert all(torch.equal(a, b) for a, b in zip(got[1:], port[1:]))


def test_nonpow2_blocks_per_shard():
    """6 kernel blocks over 2 shards: 3 blocks a shard."""
    xt, xs, d = padded(6 * BLOCK - 777, 2, seed=5)
    assert xt.shape[0] == 6 * BLOCK
    with mesh.repeat_devices(2):
        got = sharded.flat_aggregate(split(xt, 2), split(xs, 2),
                                     split(d, 2), lam=1.5, eps=0.5)
    ref = jops.flat_aggregate(jnp.asarray(xt), jnp.asarray(xs),
                              jnp.asarray(d), lam=1.5, eps=0.5)
    port = ops.flat_aggregate(t(xt), t(xs), t(d), lam=1.5, eps=0.5)
    check_single(got, ref, port, lambda e: fedagg.axpy_plain(t(xt), t(d), e))


@pytest.mark.parametrize("shards", [2, 4])
def test_displacement_nondividing(shards):
    xt, disp, d = padded(2 * BLOCK + 33, shards, seed=9)
    z = np.zeros_like(xt)
    with mesh.repeat_devices(shards):
        got = sharded.flat_aggregate_displacement(
            split(xt, shards), split(disp, shards), split(d, shards),
            split(z, shards), lam=2.0, eps=1.0)
    ref = jops.flat_aggregate_displacement(
        jnp.asarray(xt), jnp.asarray(disp), jnp.asarray(d), jnp.asarray(z),
        lam=2.0, eps=1.0)
    port = ops.flat_aggregate_displacement(t(xt), t(disp), t(d), t(z),
                                           lam=2.0, eps=1.0)
    check_single(got, ref, port, lambda e: fedagg.axpy_plain(t(xt), t(d), e))


def quantized(d):
    """The reference's int8 wire form of ``d`` and the port's, which are
    equal byte for byte (``test_torch_compression.py``)."""
    cd = jcompression.quantize_vec(jnp.asarray(d), "int8", int(d.shape[0]))
    q, s = np.asarray(cd.q), np.asarray(cd.scales)
    tq = compression.quantize_vec(t(d), "int8", int(d.shape[0]))
    assert np.array_equal(tq.q.numpy(), q) and np.array_equal(
        tq.scales.numpy(), s)
    return cd, q, s


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_q_int8_nondividing(shards):
    """int8 twins: each shard's scales stay beside its q blocks."""
    xt, xs, d = padded(2 * BLOCK * shards - 917, shards, seed=3)
    cd, q, s = quantized(d)
    with mesh.repeat_devices(shards):
        sq, ss = split(q, shards), split(s, shards, scales=True)
        assert all(a.shape[0] == b.shape[0] * fedagg.QBLOCK
                   for a, b in zip(sq, ss))
        got = sharded.flat_aggregate_q(split(xt, shards), split(xs, shards),
                                       sq, ss, lam=2.0, eps=1.0)
    ref = jops.flat_aggregate_q(jnp.asarray(xt), jnp.asarray(xs), cd.q,
                                cd.scales, lam=2.0, eps=1.0)
    port = ops.flat_aggregate_q(t(xt), t(xs), t(q), t(s), lam=2.0, eps=1.0)
    check_single(got, ref, port,
                 lambda e: fedagg.axpy_q_plain(t(xt), t(q), t(s), e))


def test_displacement_q_int8():
    xt, disp, d = padded(2 * BLOCK + 1001, 2, seed=13)
    z = np.zeros_like(xt)
    cd, q, s = quantized(d)
    with mesh.repeat_devices(2):
        got = sharded.flat_aggregate_displacement_q(
            split(xt, 2), split(disp, 2), split(q, 2),
            split(s, 2, scales=True), split(z, 2), lam=1.0, eps=1.0)
    ref = jops.flat_aggregate_displacement_q(
        jnp.asarray(xt), jnp.asarray(disp), cd.q, cd.scales, jnp.asarray(z),
        lam=1.0, eps=1.0)
    port = ops.flat_aggregate_displacement_q(t(xt), t(disp), t(q), t(s),
                                             t(z), lam=1.0, eps=1.0)
    check_single(got, ref, port,
                 lambda e: fedagg.axpy_q_plain(t(xt), t(q), t(s), e))


def burst(n_true, shards, b, seed):
    xt, _, _ = padded(n_true, shards, seed)
    rng = np.random.default_rng(seed + 1)
    n = xt.shape[0]
    xs = (xt[None] + 0.01 * rng.standard_normal((b, n), dtype=np.float32)
          ).astype(np.float32)
    d = (0.02 * rng.standard_normal((b, n), dtype=np.float32)
         ).astype(np.float32)
    return xt, xs, d


def check_batched(got, ref, port, apply):
    new, etas, gammas, dists, dnorms, _ = got
    full = specs.gather_flat(new).numpy()
    for a, r, p in zip((etas, gammas, dists, dnorms), ref[1:5], port[1:5]):
        np.testing.assert_allclose(a, np.asarray(r), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(a, p, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(full, np.asarray(ref[0]), rtol=1e-4,
                               atol=1e-5)
    assert np.array_equal(full, apply(torch.from_numpy(etas)).numpy())


@pytest.mark.parametrize("shards,b", [(2, 3), (4, 2), (8, 5)])
def test_batched_nondividing(shards, b):
    """The batched sweep: one fixed-order sum of the (B,)/(B, B)
    partials gives the replicated schedule."""
    xt, xs, d = burst(2 * BLOCK + 71, shards, b, seed=17)
    with mesh.repeat_devices(shards):
        got = sharded.flat_aggregate_batched(
            split(xt, shards), split(xs, shards), split(d, shards), lam=2.0,
            eps=1.0)
    ref = jops.flat_aggregate_batched(jnp.asarray(xt), jnp.asarray(xs),
                                      jnp.asarray(d), lam=2.0, eps=1.0)
    port = ops.flat_aggregate_batched(t(xt), t(xs), t(d), lam=2.0, eps=1.0)
    check_batched(got, ref, port,
                  lambda e: fedagg.apply_batched_plain(t(xt), t(d), e))


def test_batched_bf16_payload():
    """bf16 rows ride the f32 batched sweeps per shard."""
    xt, xs, d = burst(2 * BLOCK + 5, 2, 2, seed=23)
    d16 = t(d).to(torch.bfloat16)
    with mesh.repeat_devices(2):
        m = mesh.make_fedagg_mesh(2, device="cpu")
        got = sharded.flat_aggregate_batched(
            split(xt, 2), split(xs, 2), specs.split_flat(d16, m), lam=2.0,
            eps=1.0)
    ref = jops.flat_aggregate_batched(
        jnp.asarray(xt), jnp.asarray(xs),
        jnp.asarray(d16.float().numpy()).astype(jnp.bfloat16), lam=2.0,
        eps=1.0)
    port = ops.flat_aggregate_batched(t(xt), t(xs), d16, lam=2.0, eps=1.0)
    check_batched(got, ref, port,
                  lambda e: fedagg.apply_batched_plain(t(xt), d16, e))


@pytest.mark.parametrize("shards", [2, 4])
def test_batched_q_int8(shards):
    b = 3
    xt, xs, _ = burst(2 * BLOCK + 600, shards, b, seed=29)
    rng = np.random.default_rng(31)
    rows = [quantized((0.02 * rng.standard_normal(
        xt.shape[0], dtype=np.float32)).astype(np.float32))
        for _ in range(b)]
    q = np.stack([r[1] for r in rows])
    s = np.stack([r[2] for r in rows])
    with mesh.repeat_devices(shards):
        got = sharded.flat_aggregate_batched_q(
            split(xt, shards), split(xs, shards), split(q, shards),
            split(s, shards, scales=True), lam=2.0, eps=1.0)
    ref = jops.flat_aggregate_batched_q(
        jnp.asarray(xt), jnp.asarray(xs), jnp.asarray(q), jnp.asarray(s),
        lam=2.0, eps=1.0)
    port = ops.flat_aggregate_batched_q(t(xt), t(xs), t(q), t(s), lam=2.0,
                                        eps=1.0)
    check_batched(got, ref, port,
                  lambda e: fedagg.apply_batched_q_plain(t(xt), t(q), t(s),
                                                         e))


def test_screen_sees_summed_norms():
    """A burst's screen is called once, with the norms summed over every
    shard (the unsharded op's norms, to float tolerance)."""
    xt, xs, d = burst(3 * BLOCK, 2, 4, seed=41)
    seen = []

    def screen(dns):
        seen.append(np.asarray(dns))
        return np.ones_like(dns)

    with mesh.repeat_devices(2):
        sharded.flat_aggregate_batched(split(xt, 2), split(xs, 2),
                                       split(d, 2), lam=2.0, eps=1.0,
                                       screen=screen)
    want = np.sqrt((d.astype(np.float64) ** 2).sum(axis=1))
    assert len(seen) == 1
    np.testing.assert_allclose(seen[0], want, rtol=1e-5)


def test_split_shards_own_storage():
    """Each shard is its own allocation, not a view into one tensor."""
    xt, _, _ = padded(3 * BLOCK, 4, seed=1)
    vec = t(xt)
    with mesh.repeat_devices(4):
        shards = split(xt, 4)
    ptrs = {s.untyped_storage().data_ptr() for s in shards}
    assert len(ptrs) == 4
    assert vec.untyped_storage().data_ptr() not in ptrs
    assert all(s.untyped_storage().nbytes() == s.numel() * 4 for s in shards)
    assert torch.equal(specs.gather_flat(shards), vec)
    with pytest.raises(ValueError, match="whole"):
        specs.split_flat(t(np.zeros(3 * BLOCK, np.float32)),
                         mesh.Mesh((torch.device("cpu"),) * 2, (1, 2)))


# ------------------------------------------------------------- server --
def trace(res):
    return [(h.iteration, h.client_id, h.lag, h.k_next, h.screen)
            for h in res.history]


def assert_same_run(r1, r2, *, rtol=2e-4, atol=1e-5, acc_rtol=1e-3):
    """The reference's ``tests/test_flat_sharded.py`` bounds."""
    assert trace(r1) == trace(r2)
    np.testing.assert_allclose([h.gamma for h in r1.history],
                               [h.gamma for h in r2.history],
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose([p.accuracy for p in r1.points],
                               [p.accuracy for p in r2.points],
                               rtol=acc_rtol)


UPDATES = 30


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's unsharded pallas runs, one per (algorithm, window,
    compression), shared by the shard counts that compare with them."""
    cache = {}

    def get(algorithm="asyncfeded", window=0.0, compression="off"):
        key = (algorithm, window, compression)
        if key not in cache:
            fed = dataclasses.replace(C.SYNTHETIC_1_1.fed, backend="pallas",
                                      delta_compression=compression)
            jsim = JSim(C.SYNTHETIC_1_1, fed, algorithm, seed=3,
                        batch_window=window)
            init = jax.tree.map(np.asarray, jsim.server.params)
            res = jsim.run(max_time=1e9, max_updates=UPDATES)
            cache[key] = (init, res, fed)
        return cache[key]

    return get


def port_run(init, fed, shards, algorithm="asyncfeded", window=0.0,
             max_updates=UPDATES, task=TC.SYNTHETIC_1_1, seed=3):
    with mesh.repeat_devices(shards):
        sim = FederatedSimulation(
            task, dataclasses.replace(fed, model_shards=shards), algorithm,
            seed=seed, batch_window=window, device="cpu",
            init_params=params_from_numpy(init, device="cpu"))
        res = sim.run(max_time=1e9, max_updates=max_updates)
    return sim, res


@pytest.mark.parametrize("shards", [2, 8])
def test_sequential_paper_task(reference_runs, shards):
    init, jres, fed = reference_runs()
    sim, tres = port_run(init, fed, shards)
    assert tres.total_updates == jres.total_updates == UPDATES
    assert_same_run(tres, jres)
    assert len(sim.server._flat.vec) == shards
    assert len(sim.server.gmis.get(sim.server.t)[0]) == shards


def test_burst_batched_path(reference_runs):
    init, jres, fed = reference_runs(window=0.05)
    sim, tres = port_run(init, fed, 4, window=0.05)
    assert tres.total_drains == jres.total_drains < tres.total_updates
    assert_same_run(tres, jres)


def test_int8_burst(reference_runs):
    init, jres, fed = reference_runs(window=0.05, compression="int8")
    _, tres = port_run(init, fed, 4, window=0.05)
    assert tres.total_drains == jres.total_drains < tres.total_updates
    assert_same_run(tres, jres)


def test_displacement_gmis(reference_runs):
    init, jres, fed = reference_runs(algorithm="asyncfeded-displacement")
    sim, tres = port_run(init, fed, 2, algorithm="asyncfeded-displacement")
    assert_same_run(tres, jres)
    # the accumulators are shard tuples
    disps = list(sim.server.gmis._disp.values())
    assert disps and all(len(d) == 2 for d in disps)


def test_arch_task_sharded():
    """A reduced ArchTask's flat state splits as the paper MLP's does."""
    jt = jtasks.arch_task("h2o-danube-1.8b", seq_len=16, global_batch=2,
                          num_layers=1, d_model=64)
    fed = dataclasses.replace(jt.fed, num_clients=3, k_initial=2,
                              backend="pallas")
    jsim = JSim(jt, fed, "asyncfeded", seed=3)
    init = jax.tree.map(np.asarray, jsim.server.params)
    jres = jsim.run(max_time=float("inf"), max_updates=6)
    tt = tasks.arch_task("h2o-danube-1.8b", seq_len=16, global_batch=2,
                         num_layers=1, d_model=64)
    _, tres = port_run(init, fed, 2, max_updates=6, task=tt)
    assert tres.total_updates == jres.total_updates == 6
    assert_same_run(tres, jres)


def test_per_device_flat_bytes_shrink(reference_runs):
    """Each shard holds 1/S of the padded vector, as the footprint law
    says, in storage of its own."""
    init, _, fed = reference_runs()
    shards = 8
    sim, _ = port_run(init, fed, shards, max_updates=3)
    vec = sim.server._flat.vec
    total = sum(s.numel() * s.element_size() for s in vec)
    assert total == 4 * sim.server._flat.spec.n_padded
    assert total % (4 * BLOCK * shards) == 0
    assert len({s.untyped_storage().data_ptr() for s in vec}) == shards
    for s in vec:
        assert s.untyped_storage().nbytes() == total // shards
    assert (shapes.flat_state_bytes(total, 0, model_shards=shards)
            == jshapes.flat_state_bytes(total, 0, model_shards=shards)
            == 2 * (total // shards))
    for p, depth, s in ((1001, 0, 4), (64 << 20, 8, 8), (total, 4, 3)):
        assert (shapes.flat_state_bytes(p, depth, model_shards=s)
                == jshapes.flat_state_bytes(p, depth, model_shards=s))


def test_too_few_devices_raise():
    """The reference's error: the mesh needs S devices. One CPU is one
    device; under the hook, n."""
    fed = dataclasses.replace(TC.SYNTHETIC_1_1.fed, backend="pallas",
                              model_shards=2)
    with pytest.raises(ValueError, match=r"needs 2 devices, have 1"):
        FederatedSimulation(TC.SYNTHETIC_1_1, fed, device="cpu")
    with mesh.repeat_devices(4), pytest.raises(
            ValueError, match=r"needs 8 devices, have 4"):
        FederatedSimulation(TC.SYNTHETIC_1_1,
                            dataclasses.replace(fed, model_shards=8),
                            device="cpu")
    assert mesh.model_shard_count(device="cpu") == 1
    with mesh.repeat_devices(6):
        assert mesh.model_shard_count(device="cpu") == 4
        assert mesh.model_shard_count(2, device="cpu") == 2


def test_cross_layout_checkpoint(reference_runs, tmp_path):
    """Saved at S = 4, restored at S = 1 by the port and by the
    reference's flat server: the true elements equal bitwise."""
    init, _, fed = reference_runs()
    sim4, _ = port_run(init, fed, 4, max_updates=8)
    sim4.server.save_checkpoint(str(tmp_path), step=1)
    saved = specs.gather_flat(sim4.server._flat.vec).numpy()
    n = sim4.server._flat.spec.n
    sim1, _ = port_run(init, fed, 1, max_updates=2)
    sim1.server.restore_checkpoint(str(tmp_path), step=1)
    assert np.array_equal(sim1.server._flat.vec.numpy()[:n], saved[:n])
    jsim = JSim(C.SYNTHETIC_1_1, fed, "asyncfeded", seed=3)
    jsim.server.restore_checkpoint(str(tmp_path), step=1)
    assert np.array_equal(np.asarray(jsim.server._flat.vec)[:n], saved[:n])
    # and back into a sharded layout
    sim2, _ = port_run(init, fed, 2, max_updates=2)
    with mesh.repeat_devices(2):
        sim2.server.restore_checkpoint(str(tmp_path), step=1)
    assert np.array_equal(
        specs.gather_flat(sim2.server._flat.vec).numpy()[:n], saved[:n])
    assert sim2.server.params is not None
    assert all(torch.equal(a, b) for a, b in zip(
        pt.tree_leaves(sim2.server.params),
        pt.tree_leaves(sim1.server.params)))
