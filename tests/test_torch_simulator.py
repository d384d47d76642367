"""The slice as a whole: the port's FederatedSimulation against the
reference on the paper's main experiment — SYNTHETIC_1_1, asyncfeded, the
flat-state server (backend="pallas"), seed 0 — with the reference's initial
params injected, for 30 updates; then on the burst drain (SYNTHETIC_BURST,
auto window, loop engine, about 40 updates) and on int8 transport
(SYNTHETIC_1_1, 30 updates).

The event trace (iteration, client_id, lag, k_next) must be identical: it is
numpy on both sides, driven only by the adaptive K. gamma and eta agree to
rtol 1e-3 (the port trains and sums in another order, and those last bits
accumulate over the run); eval accuracies to atol 0.01, three rows of the
~300-row eval set.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as C
from repro.core.simulator import FederatedSimulation as JSim
from repro_torch import configs as TC
from repro_torch.convert import params_from_numpy
from repro_torch.core.simulator import FederatedSimulation
from repro_torch.utils import pytree as pt
from torch_threads import one_torch_thread  # noqa: F401

MAX_UPDATES = 30


@pytest.fixture(scope="module")
def runs():
    fed = dataclasses.replace(C.SYNTHETIC_1_1.fed, backend="pallas")
    jsim = JSim(C.SYNTHETIC_1_1, fed, "asyncfeded", seed=0)
    init = jax.tree.map(np.asarray, jsim.server.params)
    jres = jsim.run(max_time=1e9, max_updates=MAX_UPDATES)
    tsim = FederatedSimulation(TC.SYNTHETIC_1_1, fed, "asyncfeded", seed=0,
                               device="cpu",
                               init_params=params_from_numpy(init, device="cpu"))
    tres = tsim.run(max_time=1e9, max_updates=MAX_UPDATES)
    return jsim, jres, tsim, tres


def test_event_history_identical(runs):
    _, jres, _, tres = runs
    key = lambda h: [(r.iteration, r.client_id, r.lag, r.k_used, r.k_next)
                     for r in h]
    assert len(tres.history) == MAX_UPDATES
    assert key(tres.history) == key(jres.history)
    assert (tres.total_updates, tres.total_drains) == (jres.total_updates,
                                                       jres.total_drains)


def test_gamma_eta_agree(runs):
    _, jres, _, tres = runs
    for field in ("gamma", "eta", "dist", "delta_norm"):
        np.testing.assert_allclose([getattr(r, field) for r in tres.history],
                                   [getattr(r, field) for r in jres.history],
                                   rtol=1e-3, atol=1e-7)


def test_eval_curve_agrees(runs):
    _, jres, _, tres = runs
    assert ([(p.time, p.iteration) for p in tres.points]
            == [(p.time, p.iteration) for p in jres.points])
    np.testing.assert_allclose([p.accuracy for p in tres.points],
                               [p.accuracy for p in jres.points], atol=0.01)
    np.testing.assert_allclose([p.loss for p in tres.points],
                               [p.loss for p in jres.points], rtol=1e-3)
    assert abs(tres.max_accuracy() - jres.max_accuracy()) <= 0.01
    s, r = tres.summary(), jres.summary()
    assert (s["updates"], s["drains"]) == (r["updates"], r["drains"])
    np.testing.assert_allclose(s["mean_gamma"], r["mean_gamma"], rtol=1e-3)


def test_model_bytes_and_final_params(runs):
    jsim, _, tsim, _ = runs
    assert tsim.model_bytes == jsim.model_bytes
    for a, b in zip(jax.tree.leaves(jsim.server.params),
                    pt.tree_leaves(tsim.server.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-3,
                                   atol=1e-5)


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FederatedSimulation(TC.SYNTHETIC_1_1, TC.SYNTHETIC_1_1.fed)


@pytest.mark.parametrize("change", [dict(client_engine="cohort_sharded"),
                                    dict(model_shards=2, backend="pallas")])
def test_later_slices_raise(change):
    """The pod engine and the model-sharded flat state (A17) raised here
    before they were ported; they are held to the reference in
    ``test_torch_cohort_sharded.py`` and ``test_torch_sharded.py``. Now
    the pod engine runs on one device, and ``model_shards=2`` raises the
    mesh's error when the simulation is built on one device, as the
    reference does on one chip."""
    fed = dataclasses.replace(TC.SYNTHETIC_1_1.fed, **change)
    if fed.model_shards > 1:
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            FederatedSimulation(TC.SYNTHETIC_1_1, fed, device="cpu")
        return
    res = FederatedSimulation(TC.SYNTHETIC_1_1, fed, device="cpu").run(
        max_time=5.0, max_updates=10)
    assert res.total_updates == 10


def test_own_init_runs_and_learns():
    """Without injected params the port draws its own seeded init."""
    fed = dataclasses.replace(TC.SYNTHETIC_1_1.fed, backend="pallas")
    sim = FederatedSimulation(TC.SYNTHETIC_1_1, fed, seed=1, device="cpu")
    res = sim.run(max_time=4.0)
    assert res.total_updates == len(res.history) > 0
    assert res.max_accuracy() > 0.3
    assert all(np.isfinite(r.gamma) for r in res.history)


def _parity_runs(task, ttask, fed, max_updates):
    """The reference and the port from the reference's init, seed 0; the
    port's server records the size of every drain."""
    jsim = JSim(task, fed, "asyncfeded", seed=0)
    init = jax.tree.map(np.asarray, jsim.server.params)
    jres = jsim.run(max_time=1e9, max_updates=max_updates)
    tsim = FederatedSimulation(ttask, fed, "asyncfeded", seed=0,
                               device="cpu",
                               init_params=params_from_numpy(init,
                                                             device="cpu"))
    sizes = []
    drain = tsim.server.on_update_batch
    tsim.server.on_update_batch = lambda ups: sizes.append(len(ups)) or drain(
        ups)
    tres = tsim.run(max_time=1e9, max_updates=max_updates)
    return jres, tres, sizes


def _assert_same_trace(jres, tres):
    key = lambda h: [(r.iteration, r.client_id, r.lag, r.k_used, r.k_next)
                     for r in h]
    assert key(tres.history) == key(jres.history)
    assert (tres.total_updates, tres.total_drains) == (jres.total_updates,
                                                       jres.total_drains)
    np.testing.assert_allclose([r.gamma for r in tres.history],
                               [r.gamma for r in jres.history], rtol=1e-3,
                               atol=1e-7)
    np.testing.assert_allclose([p.accuracy for p in tres.points],
                               [p.accuracy for p in jres.points], atol=0.01)


def test_synthetic_burst_trace_identical():
    """SYNTHETIC_BURST at its published setting (32 clients, poisson-burst
    arrivals, auto window, flat server) with the loop engine: the port's
    trace and drain count equal the reference's, and at least one drain
    went through the batched sweeps."""
    fed = dataclasses.replace(C.SYNTHETIC_BURST.fed, client_engine="loop")
    jres, tres, sizes = _parity_runs(C.SYNTHETIC_BURST, TC.SYNTHETIC_BURST,
                                     fed, 40)
    _assert_same_trace(jres, tres)
    assert max(sizes) >= 2 and len(sizes) == tres.total_drains


def test_int8_transport_trace_identical():
    """SYNTHETIC_1_1 with int8 deltas and error feedback through the int8
    sweeps: the trace equals the reference's for 30 updates."""
    fed = dataclasses.replace(C.SYNTHETIC_1_1.fed, backend="pallas",
                              delta_compression="int8")
    jres, tres, sizes = _parity_runs(C.SYNTHETIC_1_1, TC.SYNTHETIC_1_1, fed,
                                     30)
    _assert_same_trace(jres, tres)
    assert set(sizes) == {1} and len(tres.history) == 30


def test_synthetic_burst_int8_trace_identical():
    """SYNTHETIC_BURST with int8 deltas (loop engine, flat server, auto
    window): through its first burst, 29 arrivals drained by the int8
    batched sweeps after 34 single ones, the trace equals the reference's."""
    fed = dataclasses.replace(C.SYNTHETIC_BURST.fed, client_engine="loop",
                              delta_compression="int8")
    jres, tres, sizes = _parity_runs(C.SYNTHETIC_BURST, TC.SYNTHETIC_BURST,
                                     fed, 63)
    _assert_same_trace(jres, tres)
    assert sizes == [1] * 34 + [29] and len(sizes) == tres.total_drains
