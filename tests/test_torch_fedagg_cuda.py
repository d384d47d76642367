"""The port's CUDA kernels on the card, held against their plain PyTorch
versions, and the flat-state server on CUDA against the same server on the
CPU. Every test here needs a CUDA card and skips without one; the file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_fedagg_cuda.py

Tolerances: the norms sum in another order than the plain version (rtol
1e-5) and are bitwise equal run to run; a cross or Gram term of the batched
norms is a dot product that may cancel to near zero, so its error is held
to 1e-5 of the product of its two vectors' norms (the Cauchy-Schwarz bound
of the term). The AXPYs, int8 and batched ones included, round every
multiply and add separately, as the plain versions do, so they are exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core import compression
from repro_torch.core.server import ClientUpdate, make_server
from repro_torch.kernels.fedagg import fedagg, ops
from repro_torch.utils import pytree as pt

BLOCK = fedagg.BLOCK
requires_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                   reason="needs a CUDA card")


def inputs(n, delta_dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, device="cuda", generator=g)
    xs = x + 0.01 * torch.randn(n, device="cuda", generator=g)
    d = (0.05 * torch.randn(n, device="cuda", generator=g)).to(delta_dtype)
    return x, xs, d


@requires_cuda
@pytest.mark.parametrize("n", [BLOCK, 2 * BLOCK, 4 * BLOCK, 64 * BLOCK])
@pytest.mark.parametrize("delta_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernels_match_plain_versions(n, delta_dtype):
    fedagg.reset_launches()
    x, xs, d = inputs(n, delta_dtype)
    eta = torch.tensor(0.37, device="cuda")
    out = fedagg.fedagg_norms(x, xs, d)
    torch.testing.assert_close(out, fedagg.norms_plain(x, xs, d), rtol=1e-5,
                               atol=0.0)
    assert torch.equal(out, fedagg.fedagg_norms(x, xs, d))
    new = fedagg.fedagg_axpy(x, d, eta)
    assert torch.equal(new, fedagg.axpy_plain(x, d, eta))
    assert new.data_ptr() != x.data_ptr()
    assert (fedagg.fedagg_norms.launches, fedagg.fedagg_axpy.launches) == (2,
                                                                           1)


@requires_cuda
def test_flat_aggregate_cuda_matches_cpu():
    x, xs, d = inputs(2 * BLOCK, torch.float32, seed=1)
    gpu = ops.flat_aggregate(x, xs, d, lam=5.0, eps=5.0, cap=4.0)
    cpu = ops.flat_aggregate(x.cpu(), xs.cpu(), d.cpu(), lam=5.0, eps=5.0,
                             cap=4.0)
    for a, b in zip(gpu[1:], cpu[1:]):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    torch.testing.assert_close(gpu[0].cpu(), cpu[0], rtol=1e-5, atol=1e-6)


@requires_cuda
def test_wrapper_rejects_mixed_devices():
    x, xs, d = inputs(BLOCK, torch.float32)
    with pytest.raises(ValueError):
        fedagg.fedagg_norms(x, xs.cpu(), d)
    with pytest.raises(TypeError):
        fedagg.fedagg_axpy(x, d, torch.tensor(0.5))      # eta on the CPU


@requires_cuda
@pytest.mark.parametrize("gmis_mode", ["ring", "displacement"])
def test_server_on_cuda_matches_cpu(gmis_mode):
    """A scripted run of the flat-state server on the card and on the CPU:
    every aggregation launches both kernels once, and the runs agree."""
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(33, 7)).astype(np.float32),
              "b": [rng.normal(size=(129,)).astype(np.float32)]}
    deltas = [{"a": (0.05 * rng.normal(size=(33, 7))).astype(np.float32),
               "b": [(0.05 * rng.normal(size=(129,))).astype(np.float32)]}
              for _ in range(6)]
    fed = FedConfig(lam=1.0, eps=1.0, staleness_cap=4.0)
    runs = {}
    for dev in ("cuda", "cpu"):
        to = lambda t: pt.tree_map(lambda a: torch.from_numpy(a).to(dev), t)
        srv = make_server("asyncfeded", to(params), fed, gmis_mode=gmis_mode,
                          backend="pallas")
        fedagg.reset_launches()
        replies = [srv.on_connect(i) for i in range(3)]
        for step, d in enumerate(deltas):
            cid = step % 3
            srv.on_update(ClientUpdate(cid, replies[cid].iteration, 5, to(d)))
            replies[cid] = srv.on_connect(cid)
        runs[dev] = (srv, fedagg.fedagg_norms.launches,
                     fedagg.fedagg_axpy.launches)
    (gpu, n_norms, n_axpy), (cpu, c_norms, c_axpy) = runs["cuda"], runs["cpu"]
    assert (n_norms, n_axpy) == (6, 6) and (c_norms, c_axpy) == (0, 0)
    assert ([(r.lag, r.k_next) for r in gpu.history]
            == [(r.lag, r.k_next) for r in cpu.history])
    np.testing.assert_allclose([r.gamma for r in gpu.history],
                               [r.gamma for r in cpu.history], rtol=1e-5)
    torch.testing.assert_close(gpu._flat.vec.cpu(), cpu._flat.vec,
                               rtol=1e-5, atol=1e-6)


def quantized(n, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    d = 0.05 * torch.randn(n, device="cuda", generator=g)
    d[:fedagg.QBLOCK] = 0.0                    # one all-zero scale block
    cd = compression.quantize_vec(d, "int8", n)
    return cd.q, cd.scales


@requires_cuda
@pytest.mark.parametrize("n", [BLOCK, 4 * BLOCK, 64 * BLOCK])
def test_int8_kernels_match_plain_versions(n):
    fedagg.reset_launches()
    x, xs, _ = inputs(n, torch.float32)
    q, s = quantized(n, seed=n)
    eta = torch.tensor(0.37, device="cuda")
    out = fedagg.fedagg_norms_q(x, xs, q, s)
    torch.testing.assert_close(out, fedagg.norms_q_plain(x, xs, q, s),
                               rtol=1e-5, atol=0.0)
    assert torch.equal(out, fedagg.fedagg_norms_q(x, xs, q, s))
    new = fedagg.fedagg_axpy_q(x, q, s, eta)
    assert torch.equal(new, fedagg.axpy_q_plain(x, q, s, eta))
    assert (fedagg.fedagg_norms_q.launches, fedagg.fedagg_axpy_q.launches) == (
        2, 1)


def batched_inputs(b, n, delta_dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, device="cuda", generator=g)
    xs = x + 0.01 * torch.randn(b, n, device="cuda", generator=g)
    d = (0.05 * torch.randn(b, n, device="cuda", generator=g)).to(delta_dtype)
    return x, xs, d


def assert_batched_norms_close(got, want):
    """dist0_sq and dn_sq within rtol 1e-5; cross and gram within 1e-5 of
    the product of the norms of their two vectors."""
    d0, dn, cross, gram = want
    torch.testing.assert_close(got[0], d0, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(got[1], dn, rtol=1e-5, atol=0.0)
    bound_c = 1e-5 * torch.sqrt(d0[:, None] * dn[None, :])
    bound_g = 1e-5 * torch.sqrt(dn[:, None] * dn[None, :])
    assert bool(((got[2] - cross).abs() <= bound_c).all())
    assert bool(((got[3] - gram).abs() <= bound_g).all())


@requires_cuda
@pytest.mark.parametrize("b,n", [(1, BLOCK), (2, BLOCK), (8, 4 * BLOCK),
                                 (15, BLOCK), (64, BLOCK), (128, BLOCK)])
@pytest.mark.parametrize("delta_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_batched_kernels_match_plain_versions(b, n, delta_dtype):
    fedagg.reset_launches()
    x, xs, d = batched_inputs(b, n, delta_dtype, seed=b)
    got = fedagg.fedagg_norms_batched(x, xs, d)
    assert_batched_norms_close(got, fedagg.norms_batched_plain(x, xs, d))
    again = fedagg.fedagg_norms_batched(x, xs, d)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert torch.equal(got[3], got[3].T)
    assert torch.equal(got[1], torch.diagonal(got[3]))
    etas = torch.linspace(0.1, 0.9, b, device="cuda")
    new = fedagg.fedagg_apply_batched(x, d, etas)
    assert torch.equal(new, fedagg.apply_batched_plain(x, d, etas))
    assert new.data_ptr() != x.data_ptr()
    assert (fedagg.fedagg_norms_batched.launches,
            fedagg.fedagg_apply_batched.launches) == (2, 1)


@requires_cuda
def test_batched_rejects_a_burst_past_the_limit():
    x, xs, d = batched_inputs(fedagg.MAX_BATCH + 1, BLOCK, torch.float32)
    with pytest.raises(ValueError, match="arrivals"):
        fedagg.fedagg_norms_batched(x, xs, d)
    with pytest.raises(ValueError, match="arrivals"):
        fedagg.fedagg_apply_batched(x, d, torch.ones(d.shape[0],
                                                     device="cuda"))


@requires_cuda
def test_quantizer_bytes_equal_on_cuda_and_cpu():
    g = torch.Generator().manual_seed(3)
    v = 0.02 * torch.randn(2 * BLOCK, generator=g)
    v[:fedagg.QBLOCK] = 0.0
    v[fedagg.QBLOCK:fedagg.QBLOCK + 8] = torch.tensor(
        [1.27, 0.005, -0.005, 0.015, 0.025, -0.035, 0.0, 0.6])
    cpu = compression.quantize_vec(v, "int8", v.numel())
    gpu = compression.quantize_vec(v.cuda(), "int8", v.numel())
    assert torch.equal(gpu.q.cpu(), cpu.q)
    assert gpu.scales.cpu().numpy().tobytes() == cpu.scales.numpy().tobytes()


def _burst_run(dev, mode):
    """Four clients; one single arrival, then a burst of three, on a flat
    ring-GMIS server on ``dev``."""
    rng = np.random.default_rng(7)
    params = {"a": rng.normal(size=(33, 7)).astype(np.float32),
              "b": [rng.normal(size=(129,)).astype(np.float32)]}
    deltas = [{"a": (0.05 * rng.normal(size=(33, 7))).astype(np.float32),
               "b": [(0.05 * rng.normal(size=(129,))).astype(np.float32)]}
              for _ in range(4)]
    to = lambda t: pt.tree_map(lambda a: torch.from_numpy(a).to(dev), t)
    fed = FedConfig(lam=1.0, eps=1.0, delta_compression=mode)
    srv = make_server("asyncfeded", to(params), fed, backend="pallas")
    spec = pt.FlatSpec(to(params), block=BLOCK)
    wire = lambda d: (to(d) if mode == "off" else compression.quantize_vec(
        spec.flatten(to(d)), mode, spec.n))
    fedagg.reset_launches()
    replies = [srv.on_connect(i) for i in range(4)]
    srv.on_update(ClientUpdate(0, replies[0].iteration, 5, wire(deltas[0])))
    ups = [ClientUpdate(i, replies[i].iteration, 5, wire(deltas[i]))
           for i in (1, 2, 3)]
    if mode == "int8":
        for u in ups:
            srv.on_update(u)
    else:
        srv.on_update_batch(ups)
    return srv, {k.__name__: k.launches for k in fedagg.KERNELS}


@requires_cuda
@pytest.mark.parametrize("mode", ["off", "bf16", "int8"])
def test_server_paths_on_cuda_match_cpu(mode):
    """One arrival and a burst of three (int8: four arrivals one at a time)
    on the card and on the CPU: the card launches the kernels of the path,
    and the runs agree."""
    gpu, n = _burst_run("cuda", mode)
    cpu, c = _burst_run("cpu", mode)
    assert not any(c.values())
    if mode == "int8":
        assert (n["fedagg_norms_q"], n["fedagg_axpy_q"]) == (4, 4)
    else:
        assert (n["fedagg_norms"], n["fedagg_axpy"]) == (1, 1)
        assert (n["fedagg_norms_batched"], n["fedagg_apply_batched"]) == (1,
                                                                          1)
    assert ([(r.lag, r.k_next) for r in gpu.history]
            == [(r.lag, r.k_next) for r in cpu.history])
    np.testing.assert_allclose([r.gamma for r in gpu.history],
                               [r.gamma for r in cpu.history], rtol=1e-5)
    torch.testing.assert_close(gpu._flat.vec.cpu(), cpu._flat.vec,
                               rtol=1e-5, atol=1e-6)
