"""The model-sharded flat state and the pod engine on the card, held
against the same code unsharded on the card. Every test here needs a CUDA
card and skips without one; the file imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_sharded_cuda.py

S shards (and pods) run on the one card through the mesh's device hook
(``launch.mesh.repeat_devices``): S separate shard allocations and S kernel
launches per sweep. Tolerances: the sharded scalars against the unsharded
kernels' to rtol 1e-5 (per-shard sums reorder the reduction); every new
shard bitwise equal to the unsharded AXPY or apply at the same eta(s); a
sharded run against the unsharded run on the card with the reference's
``assert_same_run`` bounds (trace equal, gamma rtol 2e-4 / atol 1e-5,
accuracy rtol 1e-3).
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as TC
from repro_torch.core import compression
from repro_torch.core.simulator import FederatedSimulation
from repro_torch.kernels.fedagg import fedagg, ops, sharded
from repro_torch.launch import mesh
from repro_torch.sharding import specs

requires_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                   reason="needs a CUDA card")
BLOCK = fedagg.BLOCK


def inputs(n_true, shards, b=None, seed=0):
    """x_t, x_stale(s), delta(s) on the card, padded to BLOCK * shards."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = -(-n_true // (BLOCK * shards)) * BLOCK * shards
    rows = () if b is None else (b,)
    x = torch.zeros(n, device="cuda")
    x[:n_true] = torch.randn(n_true, device="cuda", generator=g)
    xs = torch.zeros(*rows, n, device="cuda")
    xs[..., :n_true] = x[:n_true] + 0.01 * torch.randn(
        *rows, n_true, device="cuda", generator=g)
    d = torch.zeros(*rows, n, device="cuda")
    d[..., :n_true] = 0.05 * torch.randn(*rows, n_true, device="cuda",
                                         generator=g)
    return x, xs, d


def launches():
    return {k.__name__: k.launches for k in fedagg.KERNELS if k.launches}


@requires_cuda
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("form", ["f32", "bf16", "int8", "disp",
                                  "disp_int8"])
def test_single_sweeps(shards, form):
    """Each single-arrival entry point (the displacement forms take the
    stale input as the displacement): S launches of each sweep."""
    x, xs, d = inputs(3 * BLOCK - 1, shards, seed=shards)
    z = torch.zeros_like(x)
    quant, disp = form.endswith("int8"), form.startswith("disp")
    name = ("flat_aggregate" + ("_displacement" if disp else "")
            + ("_q" if quant else ""))
    tail = (z,) if disp else ()
    with mesh.repeat_devices(shards):
        m = mesh.make_fedagg_mesh(shards)
        sp = lambda v: specs.split_flat(v, m)
        if quant:
            cd = compression.quantize_vec(d, "int8", d.shape[0])
            wire = (cd.q, cd.scales)
            swire = (sp(cd.q), specs.split_scales(cd.scales, m))
            again = lambda e: fedagg.fedagg_axpy_q(x, *wire, e)
        else:
            d = d.to(torch.bfloat16) if form == "bf16" else d
            wire, swire = (d,), (sp(d),)
            again = lambda e: fedagg.fedagg_axpy(x, d, e)
        stail = tuple(sp(t) for t in tail)
        fedagg.reset_launches()
        got = getattr(sharded, name)(sp(x), sp(xs), *swire, *stail, lam=2.0,
                                     eps=1.0)
        counts = launches()
    want = getattr(ops, name)(x, xs, *wire, *tail, lam=2.0, eps=1.0)
    norms = "fedagg_norms_q" if quant else "fedagg_norms"
    axpy = "fedagg_axpy_q" if quant else "fedagg_axpy"
    assert counts == {norms: shards, axpy: shards}
    new, *scalars = got
    assert len(new) == shards
    torch.testing.assert_close(torch.stack(scalars), torch.stack(want[1:]),
                               rtol=1e-5, atol=1e-7)
    assert torch.equal(specs.gather_flat(new), again(scalars[1]))


@requires_cuda
def test_single_arrival_waits_on_nothing():
    """The sharded single-arrival path queues its work without a host
    synchronisation (CUDA's sync debug mode raises on one)."""
    x, xs, d = inputs(3 * BLOCK, 4, seed=3)
    with mesh.repeat_devices(4):
        m = mesh.make_fedagg_mesh(4)
        a = [specs.split_flat(v, m) for v in (x, xs, d)]
        sharded.flat_aggregate(*a, lam=2.0, eps=1.0)      # the ticket
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = sharded.flat_aggregate(*a, lam=2.0, eps=1.0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(out[1])


@requires_cuda
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("b", [2, 23])
@pytest.mark.parametrize("form", ["f32", "bf16", "int8"])
def test_batched_sweeps(shards, b, form):
    x, xs, d = inputs(3 * BLOCK - 7, shards, b=b, seed=b)
    with mesh.repeat_devices(shards):
        m = mesh.make_fedagg_mesh(shards)
        sp = lambda v: specs.split_flat(v, m)
        fedagg.reset_launches()
        if form == "int8":
            rows = [compression.quantize_vec(r, "int8", r.shape[0])
                    for r in d]
            q = torch.stack([r.q for r in rows])
            s = torch.stack([r.scales for r in rows])
            got = sharded.flat_aggregate_batched_q(
                sp(x), sp(xs), sp(q), specs.split_scales(s, m), lam=2.0,
                eps=1.0)
            counts = launches()
            want = ops.flat_aggregate_batched_q(x, xs, q, s, lam=2.0,
                                                eps=1.0)
            again = lambda e: fedagg.fedagg_apply_batched_q(x, q, s, e)
            kinds = ("fedagg_norms_batched_q", "fedagg_apply_batched_q")
        else:
            d = d if form == "f32" else d.to(torch.bfloat16)
            got = sharded.flat_aggregate_batched(sp(x), sp(xs), sp(d),
                                                 lam=2.0, eps=1.0)
            counts = launches()
            want = ops.flat_aggregate_batched(x, xs, d, lam=2.0, eps=1.0)
            again = lambda e: fedagg.fedagg_apply_batched(x, d, e)
            kinds = ("fedagg_norms_batched", "fedagg_apply_batched")
    assert counts == {k: shards for k in kinds}
    new, *arrays = got[:5]
    for a, w in zip(arrays, want[1:5]):
        np.testing.assert_allclose(a, w, rtol=1e-5, atol=1e-7)
    etas = torch.from_numpy(arrays[0]).cuda()
    assert torch.equal(specs.gather_flat(new), again(etas))


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


def run(fed, algorithm="asyncfeded", window=0.0, devices=None, updates=30):
    """A run on the card; under the device hook when ``devices`` is
    given."""
    hook = (contextlib.nullcontext() if devices is None
            else mesh.repeat_devices(devices))
    with hook:
        sim = FederatedSimulation(TC.SYNTHETIC_1_1, fed, algorithm, seed=3,
                                  batch_window=window, device="cuda")
        return sim, sim.run(max_time=1e9, max_updates=updates)


@requires_cuda
@pytest.mark.parametrize("shards,window,compress,algorithm", [
    (2, 0.0, "off", "asyncfeded"), (8, 0.0, "off", "asyncfeded"),
    (4, 0.05, "off", "asyncfeded"), (4, 0.05, "int8", "asyncfeded"),
    (2, 0.0, "off", "asyncfeded-displacement")])
def test_sharded_server_equals_unsharded(shards, window, compress,
                                         algorithm):
    fed = dataclasses.replace(TC.SYNTHETIC_1_1.fed, backend="pallas",
                              delta_compression=compress)
    _, want = run(fed, algorithm, window)
    sim, got = run(dataclasses.replace(fed, model_shards=shards), algorithm,
                   window, devices=shards)
    assert got.total_drains == want.total_drains
    assert len(sim.server._flat.vec) == shards
    assert all(s.is_cuda for s in sim.server._flat.vec)
    assert_same_run(got, want)


@requires_cuda
def test_model_shards_need_devices():
    fed = dataclasses.replace(TC.SYNTHETIC_1_1.fed, backend="pallas",
                              model_shards=2 * torch.cuda.device_count())
    with pytest.raises(ValueError, match="devices, have"):
        FederatedSimulation(TC.SYNTHETIC_1_1, fed, device="cuda")


@requires_cuda
@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_pod_engine_equals_cohort(mode):
    fed = dataclasses.replace(TC.SYNTHETIC_1_1.fed, backend="pallas",
                              delta_compression=mode,
                              client_engine="cohort")
    _, want = run(fed, window=0.05)
    sharded_fed = dataclasses.replace(fed, client_engine="cohort_sharded")
    sim, got = run(sharded_fed, window=0.05, devices=4)
    assert_same_run(got, want)
    res = [c._residual for c in sim.clients if c._residual is not None]
    assert res and all(r.is_cuda and r.untyped_storage().nbytes()
                       == r.numel() * 4 for r in res)


@requires_cuda
def test_checkpoint_across_layouts(tmp_path):
    fed = dataclasses.replace(TC.SYNTHETIC_1_1.fed, backend="pallas")
    sim4, _ = run(dataclasses.replace(fed, model_shards=4), devices=4,
                  updates=8)
    sim4.server.save_checkpoint(str(tmp_path), step=1)
    sim1, _ = run(fed, updates=2)
    sim1.server.restore_checkpoint(str(tmp_path), step=1)
    n = sim1.server._flat.spec.n
    assert torch.equal(sim1.server._flat.vec[:n],
                       specs.gather_flat(sim4.server._flat.vec)[:n])


# ------------------------------------------------ several real cards --
requires_cards = pytest.mark.skipif(
    "torch.cuda.device_count() < 2",
    reason="needs two or more CUDA cards (shards on distinct devices)")


def cards():
    return mesh.model_shard_count()


@requires_cards
@pytest.mark.parametrize("form", ["f32", "int8"])
def test_real_cards_ops(form):
    """Shards on distinct cards: the kernels launch on each shard's card,
    the partials cross to the first; the same results as on one card."""
    s = cards()
    x, xs, d = inputs(5 * BLOCK + 3, s, b=3, seed=s)
    m = mesh.make_fedagg_mesh(s)
    assert len(set(m.devices)) == s
    sp = lambda v: specs.split_flat(v, m)
    if form == "int8":
        cd = compression.quantize_vec(d[0], "int8", d.shape[1])
        got = sharded.flat_aggregate_q(sp(x), sp(xs[0]), sp(cd.q),
                                       specs.split_scales(cd.scales, m),
                                       lam=2.0, eps=1.0)
        want = ops.flat_aggregate_q(x, xs[0], cd.q, cd.scales, lam=2.0,
                                    eps=1.0)
        axpy = lambda e: fedagg.fedagg_axpy_q(x, cd.q, cd.scales, e)
        rows = [compression.quantize_vec(r, "int8", r.shape[0]) for r in d]
        q = torch.stack([r.q for r in rows])
        sc = torch.stack([r.scales for r in rows])
        bgot = sharded.flat_aggregate_batched_q(
            sp(x), sp(xs), sp(q), specs.split_scales(sc, m), lam=2.0,
            eps=1.0)
        bwant = ops.flat_aggregate_batched_q(x, xs, q, sc, lam=2.0, eps=1.0)
        apply = lambda e: fedagg.fedagg_apply_batched_q(x, q, sc, e)
    else:
        got = sharded.flat_aggregate(sp(x), sp(xs[0]), sp(d[0]), lam=2.0,
                                     eps=1.0)
        want = ops.flat_aggregate(x, xs[0], d[0], lam=2.0, eps=1.0)
        axpy = lambda e: fedagg.fedagg_axpy(x, d[0], e)
        bgot = sharded.flat_aggregate_batched(sp(x), sp(xs), sp(d), lam=2.0,
                                              eps=1.0)
        bwant = ops.flat_aggregate_batched(x, xs, d, lam=2.0, eps=1.0)
        apply = lambda e: fedagg.fedagg_apply_batched(x, d, e)
    assert [t.device for t in got[0]] == list(m.devices)
    torch.testing.assert_close(torch.stack(got[1:]), torch.stack(want[1:]),
                               rtol=1e-5, atol=1e-7)
    assert torch.equal(specs.gather_flat(got[0]), axpy(got[2]))
    for a, w in zip(bgot[1:5], bwant[1:5]):
        np.testing.assert_allclose(a, w, rtol=1e-5, atol=1e-7)
    assert torch.equal(specs.gather_flat(bgot[0]),
                       apply(torch.from_numpy(bgot[1]).cuda()))


@requires_cards
@pytest.mark.parametrize("window,compress,algorithm", [
    (0.0, "off", "asyncfeded"), (0.05, "off", "asyncfeded"),
    (0.05, "int8", "asyncfeded"), (0.0, "off", "asyncfeded-displacement")])
def test_real_cards_server(window, compress, algorithm):
    fed = dataclasses.replace(TC.SYNTHETIC_1_1.fed, backend="pallas",
                              delta_compression=compress)
    _, want = run(fed, algorithm, window)
    sim, got = run(dataclasses.replace(fed, model_shards=cards()),
                   algorithm, window)
    assert len({t.device for t in sim.server._flat.vec}) == cards()
    assert got.total_drains == want.total_drains
    assert_same_run(got, want)


@requires_cards
def test_real_cards_pods():
    """One pod per card, int8 wire forms, into a server sharded over the
    same cards."""
    fed = dataclasses.replace(TC.SYNTHETIC_1_1.fed, backend="pallas",
                              delta_compression="int8",
                              client_engine="cohort")
    _, want = run(fed, window=0.05)
    _, got = run(dataclasses.replace(fed, client_engine="cohort_sharded",
                                     model_shards=cards()), window=0.05)
    assert_same_run(got, want)


@requires_cards
def test_real_cards_arch_pods():
    """A reduced mamba2 ArchTask on one pod per card: its SSD scans launch
    on each pod's card."""
    from repro_torch.core import tasks

    task = tasks.arch_task("mamba2-1.3b", seq_len=64, global_batch=2,
                           num_layers=1, d_model=64)
    base = dataclasses.replace(task.fed, num_clients=4, k_initial=2,
                               client_engine="cohort")
    runs = []
    for fed in (base, dataclasses.replace(base,
                                          client_engine="cohort_sharded")):
        sim = FederatedSimulation(task, fed, "asyncfeded", seed=0,
                                  device="cuda")
        runs.append(sim.run(max_time=float("inf"), max_updates=6))
    assert trace(runs[1]) == trace(runs[0])
    np.testing.assert_allclose([h.gamma for h in runs[1].history],
                               [h.gamma for h in runs[0].history],
                               rtol=2e-4, atol=1e-5)
