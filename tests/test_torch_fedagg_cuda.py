"""The port's CUDA kernels on the card, held against their plain PyTorch
versions, and the flat-state server on CUDA against the same server on the
CPU. Every test here needs a CUDA card and skips without one; the file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_fedagg_cuda.py

Tolerances: the norms sum in another order than the plain version (rtol
1e-5) and are bitwise equal run to run; the AXPY rounds its multiply and add
separately, as the plain version does, so it is exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import FedConfig
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
