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
@pytest.mark.parametrize("n", [BLOCK, 4 * BLOCK, 64 * BLOCK])
@pytest.mark.parametrize("delta_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_equals_axpy_and_norms(n, delta_dtype):
    """fedagg_fused's output is fedagg_axpy's and its partials are
    fedagg_norms', to the bit, on the same inputs; it writes a new tensor
    and counts one launch."""
    fedagg.reset_launches()
    x, xs, d = inputs(n, delta_dtype, seed=2)
    eta = torch.tensor(0.37, device="cuda")
    out, part = fedagg.fedagg_fused(x, xs, d, eta)
    assert fedagg.fedagg_fused.launches == 1
    assert torch.equal(out, fedagg.fedagg_axpy(x, d, eta))
    assert torch.equal(part, fedagg.fedagg_norms(x, xs, d))
    assert out.data_ptr() != x.data_ptr()
    pout, ppart = fedagg.fused_plain(x, xs, d, eta)
    assert torch.equal(out, pout)
    torch.testing.assert_close(part, ppart, rtol=1e-5, atol=0.0)
    again = fedagg.fedagg_fused(x, xs, d, eta)
    assert torch.equal(out, again[0]) and torch.equal(part, again[1])


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


@requires_cuda
@pytest.mark.parametrize("n", [BLOCK, 16 * BLOCK, 13 * BLOCK],
                         ids=["65536", "2^20", "851968"])
def test_axpys_equal_plain(n):
    """fedagg_axpy (f32 and bf16 deltas) and fedagg_axpy_q equal their plain
    versions to the bit at 65,536, 2^20 and 851,968 elements (832 blocks of
    256 threads: not a multiple of 132 SMs)."""
    fedagg.reset_launches()
    x, _, d = inputs(n, torch.float32, seed=n)
    q, s = quantized(n, seed=n + 1)
    eta = torch.tensor(0.37, device="cuda")
    assert torch.equal(fedagg.fedagg_axpy(x, d, eta),
                       fedagg.axpy_plain(x, d, eta))
    db = d.bfloat16()
    assert torch.equal(fedagg.fedagg_axpy(x, db, eta),
                       fedagg.axpy_plain(x, db, eta))
    assert torch.equal(fedagg.fedagg_axpy_q(x, q, s, eta),
                       fedagg.axpy_q_plain(x, q, s, eta))
    assert (fedagg.fedagg_axpy.launches, fedagg.fedagg_axpy_q.launches) == (
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
@pytest.mark.parametrize("b,n", [(2, BLOCK), (15, BLOCK), (24, 4 * BLOCK),
                                 (128, BLOCK)])
def test_batched_q_kernels_match_plain_versions(b, n):
    """The int8 burst pair against its plain versions: norms to the batched
    tolerances and bitwise repeatable, the apply to the bit."""
    fedagg.reset_launches()
    x, xs, d = batched_inputs(b, n, torch.float32, seed=b)
    d[:, :fedagg.QBLOCK] = 0.0
    wires = [compression.quantize_vec(row, "int8", n) for row in d]
    qs = torch.stack([w.q for w in wires])
    sc = torch.stack([w.scales for w in wires])
    got = fedagg.fedagg_norms_batched_q(x, xs, qs, sc)
    assert_batched_norms_close(got,
                               fedagg.norms_batched_q_plain(x, xs, qs, sc))
    again = fedagg.fedagg_norms_batched_q(x, xs, qs, sc)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    etas = torch.linspace(0.1, 0.9, b, device="cuda")
    new = fedagg.fedagg_apply_batched_q(x, qs, sc, etas)
    assert torch.equal(new, fedagg.apply_batched_q_plain(x, qs, sc, etas))
    assert (fedagg.fedagg_norms_batched_q.launches,
            fedagg.fedagg_apply_batched_q.launches,
            fedagg.fedagg_norms_batched.launches) == (2, 1, 0)


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
    srv.on_update_batch(ups)
    return srv, {k.__name__: k.launches for k in fedagg.KERNELS}


@requires_cuda
@pytest.mark.parametrize("mode", ["off", "bf16", "int8"])
def test_server_paths_on_cuda_match_cpu(mode):
    """One arrival and a burst of three on the card and on the CPU: the
    card launches the kernels of the path, and the runs agree."""
    gpu, n = _burst_run("cuda", mode)
    cpu, c = _burst_run("cpu", mode)
    assert not any(c.values())
    q = "_q" if mode == "int8" else ""
    assert (n["fedagg_norms" + q], n["fedagg_axpy" + q]) == (1, 1)
    assert (n["fedagg_norms_batched" + q],
            n["fedagg_apply_batched" + q]) == (1, 1)
    assert sum(n.values()) == 4
    assert ([(r.lag, r.k_next) for r in gpu.history]
            == [(r.lag, r.k_next) for r in cpu.history])
    np.testing.assert_allclose([r.gamma for r in gpu.history],
                               [r.gamma for r in cpu.history], rtol=1e-5)
    torch.testing.assert_close(gpu._flat.vec.cpu(), cpu._flat.vec,
                               rtol=1e-5, atol=1e-6)


@requires_cuda
def test_burst_on_cuda_stages_no_stale_row():
    """With the recorder on, a burst of three on the card moves each
    delta's leaves into its row of the delta stack and nothing else: the
    norms read the stale snapshots in place, so ``server.copy_bytes`` holds
    no stale row (the CPU's plain norms copy them into a stack)."""
    from repro_torch.utils import tracing
    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(33, 7, generator=g).cuda(),
              "b": [torch.randn(129, generator=g).cuda()]}
    srv = make_server("asyncfeded", params, FedConfig(lam=1.0, eps=1.0),
                      backend="pallas")
    its = [srv.on_connect(c).iteration for c in range(3)]
    upds = [ClientUpdate(c, its[c], 2, pt.tree_map(
        lambda t: 0.05 * torch.randn_like(t), params)) for c in range(3)]
    tracing.enable()
    try:
        srv.on_update_batch(upds)
    finally:
        rec = tracing.collect()
    assert rec.counters["server.copy_bytes"] == 3 * 4 * (BLOCK + 33 * 7
                                                         + 129)
    assert (rec.counters["server.stale_rows"],
            rec.counters["server.stale_snapshots"]) == (3, 1)


def _batched_wire(b, n, delta, seed):
    """(x, xs, deltas, scales) for the batched norms at (B, n): f32 or bf16
    deltas with scales None, or int8 wire rows (one all-zero scale block
    each) with their scales."""
    x, xs, d = batched_inputs(b, n, torch.float32, seed=seed)
    if delta == "int8":
        d[:, :fedagg.QBLOCK] = 0.0
        wires = [compression.quantize_vec(row, "int8", n) for row in d]
        return (x, xs, torch.stack([w.q for w in wires]),
                torch.stack([w.scales for w in wires]))
    return x, xs, d.to(getattr(torch, delta)), None


@requires_cuda
@pytest.mark.parametrize("delta", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("n", [BLOCK, 16 * BLOCK], ids=["65536", "2^20"])
@pytest.mark.parametrize("b", [1, 2, 23, 24, 64, 128])
def test_batched_norms_split_k(b, n, delta):
    """The split-K batched norms (and their int8 twin) against their plain
    versions at one panel (B <= 32), at two row panels (B = 64) and at
    eight (B = 128), to the file's batched tolerances; bitwise repeatable;
    dn equal to gram's diagonal and gram symmetric, to the bit."""
    x, xs, d, sc = _batched_wire(b, n, delta, seed=b + n)
    if sc is None:
        got = fedagg.fedagg_norms_batched(x, xs, d)
        want = fedagg.norms_batched_plain(x, xs, d)
        again = fedagg.fedagg_norms_batched(x, xs, d)
    else:
        got = fedagg.fedagg_norms_batched_q(x, xs, d, sc)
        want = fedagg.norms_batched_q_plain(x, xs, d, sc)
        again = fedagg.fedagg_norms_batched_q(x, xs, d, sc)
    assert_batched_norms_close(got, want)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert torch.equal(got[3], got[3].T)
    assert torch.equal(got[1], torch.diagonal(got[3]))


def _norms_of(x, d, sc):
    """The batched norms (or their int8 twin) of the given stale rows."""
    if sc is None:
        return lambda rows: fedagg.fedagg_norms_batched(x, rows, d)
    return lambda rows: fedagg.fedagg_norms_batched_q(x, rows, d, sc)


@requires_cuda
@pytest.mark.parametrize("delta", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("n", [BLOCK, 16 * BLOCK], ids=["65536", "2^20"])
@pytest.mark.parametrize("b", [2, 15, 23])
def test_stale_rows_read_in_place(b, n, delta):
    """The kernel reads each stale row through its pointer: rows given as
    B tensors of their own, as the rows of a (B, n) stack, and as one
    tensor repeated on every row give the outputs of the same rows passed
    as a stack, to the bit; a call is one launch of the wrapper, two
    kernel nodes in a CUDA graph, whose replay gives the same bits."""
    x, xs, d, sc = _batched_wire(b, n, delta, seed=b + n)
    norms = _norms_of(x, d, sc)
    same = lambda got, want: all(torch.equal(g, w)
                                 for g, w in zip(got, want))
    fedagg.reset_launches()
    want = norms(xs)
    assert (fedagg.fedagg_norms_batched.launches
            + fedagg.fedagg_norms_batched_q.launches) == 1
    own = [row.clone() for row in xs]
    assert len({row.data_ptr() for row in own}) == b
    assert same(norms(own), want)
    assert same(norms(list(xs.unbind(0))), want)
    assert same(norms([xs[1]] * b), norms(xs[1].expand(b, -1).contiguous()))
    types, replayed = _captured_node_types(
        lambda: fedagg.norms_batched_packed(x, own, d, sc))
    assert types == [0, 0]
    assert same(fedagg.split_batched(replayed, b), want)


@requires_cuda
@pytest.mark.parametrize("case", ["misaligned", "host", "b_too_big"])
def test_batched_norms_refuse_a_stale_row(case):
    """A stale row that is not 16-byte aligned or not on the card, and a
    table of more rows than the kernels take, are refused before a launch."""
    b, n = 3, BLOCK
    x, xs, d = batched_inputs(b, n, torch.float32)
    rows = list(xs)
    if case == "misaligned":
        rows[1] = torch.zeros(n + 1, device="cuda")[1:]
        match = "aligned"
    elif case == "host":
        rows[1] = rows[1].cpu()
        match = "expected"
    else:
        b = fedagg.MAX_BATCH + 1
        rows, d, match = [rows[0]] * b, d[:1].expand(b, -1).contiguous(), \
            "arrivals"
    fedagg.reset_launches()
    with pytest.raises(ValueError, match=match):
        fedagg.fedagg_norms_batched(x, rows, d)
    assert fedagg.fedagg_norms_batched.launches == 0


@requires_cuda
@pytest.mark.parametrize("n", [BLOCK, 13 * BLOCK], ids=["65536", "851968"])
def test_single_norms_replay_in_a_graph(n):
    """fedagg_norms, fedagg_norms_q and fedagg_fused captured in one CUDA
    graph and replayed three times: every replay equals the eager calls to
    the bit, so the sweeps' shared ticket is back at 0 after each sweep; the
    fused sweep's norms equal fedagg_norms' to the bit; each call is one
    CUDA launch (torch.profiler's kernel events)."""
    from torch.profiler import ProfilerActivity, profile
    x, xs, d = inputs(n, torch.float32, seed=5)
    q, s = quantized(n, seed=6)
    eta = torch.tensor(0.37, device="cuda")
    calls = lambda: (fedagg.fedagg_norms(x, xs, d),
                     fedagg.fedagg_norms_q(x, xs, q, s),
                     *fedagg.fedagg_fused(x, xs, d, eta))
    eager = [t.clone() for t in calls()]
    assert torch.equal(eager[3], eager[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        calls()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 3 and all("norms_sweep" in k for k in kernels)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    fedagg.reset_launches()
    with torch.cuda.graph(graph):
        captured = calls()
    assert (fedagg.fedagg_norms.launches, fedagg.fedagg_norms_q.launches,
            fedagg.fedagg_fused.launches) == (1, 1, 1)
    for _ in range(3):
        for t in captured:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, e) for a, e in zip(captured, eager))
    assert all(torch.equal(a, e) for a, e in zip(calls(), eager))


def _apply_inputs(b, n, delta, seed):
    """(x, deltas, scales, etas) for the batched apply at (B, n): f32 or
    bf16 deltas with scales None, or int8 wire rows with an all-zero scale
    block each; etas from -0.5 to 0.9 with one set to zero."""
    x, _, d = batched_inputs(b, n, torch.float32, seed=seed)
    etas = torch.linspace(-0.5, 0.9, b, device="cuda")
    etas[b // 2] = 0.0
    if delta == "int8":
        d[:, :fedagg.QBLOCK] = 0.0
        wires = [compression.quantize_vec(row, "int8", n) for row in d]
        return (x, torch.stack([w.q for w in wires]),
                torch.stack([w.scales for w in wires]), etas)
    return x, d.to(getattr(torch, delta)), None, etas


def _apply(x, d, sc, etas):
    if sc is None:
        return fedagg.fedagg_apply_batched(x, d, etas)
    return fedagg.fedagg_apply_batched_q(x, d, sc, etas)


def _apply_plain(x, d, sc, etas):
    if sc is None:
        return fedagg.apply_batched_plain(x, d, etas)
    return fedagg.apply_batched_q_plain(x, d, sc, etas)


def _captured_node_types(fn):
    """``fn()`` captured in a CUDA graph: the type of each node of the graph
    as libcuda reports it (cuGraphGetNodes, cuGraphNodeGetType; 0 is a
    kernel), which counts launches without a profiler's trace, and the
    output after one replay."""
    import ctypes
    cuda = ctypes.CDLL("libcuda.so.1")
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = fn()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    assert cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                       ctypes.byref(kind)) == 0
        types.append(kind.value)
    graph.replay()
    torch.cuda.synchronize()
    return types, out


@requires_cuda
@pytest.mark.parametrize("delta", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("n", [BLOCK, 3 * BLOCK, 16 * BLOCK],
                         ids=["65536", "196608", "2^20"])
@pytest.mark.parametrize("b", [1, 2, 7, 8, 9, 16, 17, 23, 24, 128])
def test_apply_batched_equals_plain(b, n, delta):
    """The batched apply (and its int8 twin) equals its plain version to the
    bit: B across the register chunks' remainders, the int8 widths' switch
    (B 16 to 17) and the largest burst; n at the paper lengths and at 2^20,
    where a thread takes 16 bytes of every delta form; etas with a zero and
    negative entries, int8 rows with an all-zero block. A call is counted
    once, writes a new tensor and, captured in a CUDA graph, is one kernel
    node, whose replay gives the same bits."""
    x, d, sc, etas = _apply_inputs(b, n, delta, seed=b + n)
    fedagg.reset_launches()
    out = _apply(x, d, sc, etas)
    assert (fedagg.fedagg_apply_batched.launches
            + fedagg.fedagg_apply_batched_q.launches) == 1
    assert out.data_ptr() != x.data_ptr()
    assert torch.equal(out, _apply_plain(x, d, sc, etas))
    types, replayed = _captured_node_types(lambda: _apply(x, d, sc, etas))
    assert types == [0]
    assert torch.equal(replayed, out)


@requires_cuda
@pytest.mark.parametrize("n", [BLOCK, 16 * BLOCK], ids=["65536", "2^20"])
def test_apply_batched_replays_in_a_graph(n):
    """The f32, bf16 and int8 batched applies captured in one CUDA graph and
    replayed three times: every replay equals the eager calls to the bit;
    each call is one kernel event under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    inputs = [_apply_inputs(b, n, delta, seed=7)
              for b, delta in ((23, "float32"), (8, "bfloat16"),
                               (24, "int8"))]
    calls = lambda: [_apply(*args) for args in inputs]
    eager = calls()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        calls()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 3 and all("apply_batched" in k for k in kernels)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = calls()
    for _ in range(3):
        for t in captured:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, e) for a, e in zip(captured, eager))
    assert all(torch.equal(e, _apply_plain(*args))
               for e, args in zip(eager, inputs))
