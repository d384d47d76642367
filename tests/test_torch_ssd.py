"""The port's SSD chunked scan (kernels/ssd) against the reference: its plain
version, which the wrapper takes on the CPU, against the reference's Pallas
kernel ``ssd_scan`` in interpret mode and its oracle ``ssd_scan_ref`` at
tests/test_kernels.py's TestSSD shapes; the chunk split changes nothing; the
model-layout wrapper ``ops.ssd_chunked`` against ``ssd_chunked_pallas`` with
two groups, and with a starting state against the reference's model path
``models/ssm.py::ssd_chunked(initial_state=...)``, which the port keeps as
its oracle too; and the ``S % chunk`` raise. Inputs are drawn with numpy from
a seed and handed to both.

Tolerances: rtol/atol 1e-4, the reference's own for its kernel against its
oracle (tests/test_kernels.py::TestSSD): the port sums the per-chunk products
in torch's order, the reference in XLA's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ops import ssd_chunked_pallas
from repro.kernels.ssd.ref import ssd_scan_ref
from repro.kernels.ssd.ssd import ssd_scan as jkernel_scan
from repro.models import ssm as JS
from repro_torch.kernels.ssd import ops, ssd
from repro_torch.models import ssm as TS
from torch_threads import one_torch_thread  # noqa: F401

RTOL = ATOL = 1e-4
T = torch.from_numpy


@pytest.fixture(autouse=True)
def no_launches():
    ssd.ssd_scan.launches = 0
    yield
    assert ssd.ssd_scan.launches == 0              # the CPU takes no kernel


def softplus(v):
    return np.log1p(np.exp(v))


def row_inputs(bh, s, p, n, seed=0):
    """x, dt, a, b, c in the (BH, S, P) row layout, as TestSSD draws them
    (dt softplus'ed, a = -exp(0.3 z), b and c scaled by 0.3)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(bh, s, p)).astype(np.float32),
            softplus(rng.normal(size=(bh, s))).astype(np.float32),
            (-np.exp(0.3 * rng.normal(size=(bh,)))).astype(np.float32),
            (0.3 * rng.normal(size=(bh, s, n))).astype(np.float32),
            (0.3 * rng.normal(size=(bh, s, n))).astype(np.float32))


def model_inputs(bs, s, h, p, g, n, seed=0):
    """The same draws in the model's layout, b and c grouped."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(bs, s, h, p)).astype(np.float32),
            softplus(rng.normal(size=(bs, s, h))).astype(np.float32),
            (-np.exp(0.3 * rng.normal(size=(h,)))).astype(np.float32),
            (0.3 * rng.normal(size=(bs, s, g, n))).astype(np.float32),
            (0.3 * rng.normal(size=(bs, s, g, n))).astype(np.float32))


def close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 128, 8, 16, 64),
                                   (1, 256, 16, 32, 128),
                                   (3, 64, 4, 8, 32),
                                   (2, 40, 8, 16, 64)])
def test_plain_matches_pallas_and_oracle(shape):
    """(BH, S, P, N, chunk): TestSSD's shapes, and a chunk cut to S = 40."""
    bh, s, p, n, chunk = shape
    arrs = row_inputs(bh, s, p, n, seed=s + p)
    y, st = ssd.ssd_scan(*map(T, arrs), chunk=chunk)
    assert y.shape == (bh, s, p) and st.shape == (bh, p, n)
    assert y.dtype == st.dtype == torch.float32
    py, pst = ssd.ssd_scan_plain(*map(T, arrs), chunk=chunk)
    assert torch.equal(y, py) and torch.equal(st, pst)
    j = tuple(map(jnp.asarray, arrs))
    for jy, jst in (jkernel_scan(*j, chunk=chunk),
                    ssd_scan_ref(*j, chunk=min(chunk, s))):
        close(y, jy)
        close(st, jst)


def test_chunk_invariance():
    """TestSSD::test_chunk_invariance: the chunk is a tiling only."""
    arrs = tuple(map(T, row_inputs(2, 128, 8, 16, seed=1)))
    y32, s32 = ssd.ssd_scan(*arrs, chunk=32)
    y128, s128 = ssd.ssd_scan(*arrs, chunk=128)
    np.testing.assert_allclose(y32.numpy(), y128.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(s32.numpy(), s128.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("groups", [1, 2])
def test_model_wrapper_matches_pallas_wrapper(groups):
    """TestSSD::test_model_wrapper's shape: ops.ssd_chunked repeats each
    group to its heads as ssd_chunked_pallas does."""
    arrs = model_inputs(2, 64, 4, 8, groups, 16, seed=2)
    y, st = ops.ssd_chunked(*map(T, arrs), 32)
    jy, jst = ssd_chunked_pallas(*map(jnp.asarray, arrs), chunk=32)
    assert y.shape == (2, 64, 4, 8) and st.shape == (2, 4, 8, 16)
    close(y, jy)
    close(st, jst)


@pytest.mark.parametrize("chunk", [16, 64])
def test_initial_state_matches_model_path(chunk):
    """A starting state through ops.ssd_chunked, through the port's model
    twin and through the reference's ``ssd_chunked(initial_state=...)``
    (the TPU kernel has none)."""
    arrs = model_inputs(2, 64, 4, 8, 2, 16, seed=3)
    h0 = np.random.default_rng(4).normal(size=(2, 4, 8, 16)).astype(
        np.float32)
    jy, jst = JS.ssd_chunked(*map(jnp.asarray, arrs), chunk,
                             initial_state=jnp.asarray(h0))
    for fn in (ops.ssd_chunked, TS.ssd_chunked):
        y, st = fn(*map(T, arrs), chunk, initial_state=T(h0))
        close(y, jy)
        close(st, jst)


def test_model_twin_matches_reference_without_state():
    arrs = model_inputs(1, 96, 6, 4, 3, 8, seed=5)
    y, st = TS.ssd_chunked(*map(T, arrs), 32)
    jy, jst = JS.ssd_chunked(*map(jnp.asarray, arrs), 32)
    close(y, jy)
    close(st, jst)


def test_large_decay_stays_finite():
    """dt * a of -40 per step: exp(cum[l] - cum[s]) above the diagonal
    overflows, and is masked, never multiplied by zero."""
    x, dt, a, b, c = row_inputs(2, 64, 4, 8, seed=6)
    dt = np.full_like(dt, 40.0)
    a = np.full_like(a, -1.0)
    y, st = ssd.ssd_scan(*map(T, (x, dt, a, b, c)), chunk=32)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    jy, jst = jkernel_scan(*map(jnp.asarray, (x, dt, a, b, c)), chunk=32)
    close(y, jy)


def test_sequence_not_a_multiple_of_the_chunk_raises():
    arrs = tuple(map(T, row_inputs(1, 96, 4, 8)))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd.ssd_scan(*arrs, chunk=64)
    marrs = tuple(map(T, model_inputs(1, 96, 2, 4, 1, 8)))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_chunked(*marrs, 64)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TS.ssd_chunked(*marrs, 64)


@pytest.mark.parametrize("case", ["x_f64", "dt_shape", "h0_shape",
                                  "two_dim"])
def test_wrapper_rejects(case):
    x, dt, a, b, c = map(T, row_inputs(2, 32, 4, 8))
    h0 = None
    if case == "x_f64":
        x = x.double()
    elif case == "dt_shape":
        dt = dt[:, :16]
    elif case == "h0_shape":
        h0 = torch.zeros(2, 8, 4)
    else:
        x = x[0]
    with pytest.raises((TypeError, ValueError)):
        ssd.ssd_scan(x, dt, a, b, c, chunk=16, h0=h0)


def test_launch_needs_cuda_tensors():
    marrs = tuple(map(T, model_inputs(1, 32, 2, 4, 1, 8)))
    a_rows = marrs[2].repeat(1)
    with pytest.raises(ValueError, match="CUDA"):
        ssd.launch(marrs[0], marrs[1], a_rows, marrs[3], marrs[4], chunk=32)


def test_ssd_work_at_the_serve_shape():
    """mamba2-1.3b's prefill of 2048 (B 4, H 64, P 64, G 1, N 128, L 256):
    26.07 GFLOP with C B^T once per group, 0.389 ms at 67 TFLOP/s of f32,
    above the 0.09 ms that its bytes take at 3.35 TB/s. Counted per head,
    as the first kernel's note did, it was 43.05 GFLOP and 0.643 ms."""
    nbytes, flops = ssd.ssd_work(4, 2048, 64, 64, 1, 128, 256, False)
    assert round(flops / 1e9, 2) == 26.07
    assert round(flops / 67e12 * 1e3, 3) == 0.389
    assert nbytes / 3.35e12 < flops / 67e12
    per_head = 4 * 64 * 8 * (4 * 256 * 64 * 128 + 256 * 257 * (128 + 64))
    assert round(per_head / 1e9, 2) == 43.05


@pytest.mark.parametrize("shape", [(2, 96, 4, 8, 1, 16, 32),
                                   (2, 96, 6, 8, 3, 16, 32),
                                   (1, 40, 4, 4, 2, 8, 256),
                                   (3, 64, 2, 8, 1, 4, 64)],
                         ids=["g1", "g3", "ragged", "one_chunk"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_ssd_work_counts_causal_pairs(shape, with_h0):
    """ssd_work against a count by enumeration: each causal pair (s <= l)
    of each chunk costs 2N flops once per (batch, chunk, group) and 2P per
    head, each (row, chunk) 2 L P N for its state and 2 L P N for the
    state's term; every input element is read once and every output
    element written once, 4 bytes each."""
    bs, s, h, p, g, n, chunk = shape
    L = min(chunk, s)
    pairs = sum(1 for l in range(L) for t in range(L) if t <= l)
    flops = 0
    for _ in range(bs * (s // L)):
        flops += g * pairs * 2 * n
        flops += h * (pairs * 2 * p + 2 * (2 * L * p * n))
    elems = {"x": bs * s * h * p, "dt": bs * s * h, "a": h,
             "b": bs * s * g * n, "c": bs * s * g * n, "y": bs * s * h * p,
             "state": bs * h * p * n, "h0": bs * h * p * n if with_h0 else 0}
    assert ssd.ssd_work(bs, s, h, p, g, n, chunk, with_h0) == (
        4 * sum(elems.values()), flops)
