"""The fedagg sweeps of the port (repro_torch.kernels.fedagg) against the
reference's Pallas kernels, run in interpret mode on the CPU as the
reference's own tests run them.

On the CPU the wrappers take their plain PyTorch versions; the CUDA kernels
are held against those plain versions on the card by
tests/test_torch_fedagg_cuda.py.

Tolerances: the squared norms sum 65536-262144 f32 terms in another order
than the Pallas grid does, so rtol 1e-5; the AXPY is one multiply and one
add per element in both, so it must agree to 1e-6 relative (XLA may fuse
the two into one rounding). A whole step's output also carries eta's last
bits, which come from those sums: atol 1e-6 on values of order 1.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.kernels.fedagg import fedagg as jfed
from repro.kernels.fedagg import ops as jops
from repro_torch.kernels.fedagg import fedagg, ops
from torch_threads import one_torch_thread  # noqa: F401

BLOCK = 65536
LAM, EPS = 2.0, 0.5


def inputs(n, delta_dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    xs = (x + 0.01 * rng.normal(size=n)).astype(np.float32)
    d = (0.05 * rng.normal(size=n)).astype(np.float32)
    jd = jnp.asarray(d).astype(delta_dtype)
    td = torch.from_numpy(np.asarray(jd.astype(jnp.float32))).to(
        {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[
            delta_dtype])
    return ((jnp.asarray(x), jnp.asarray(xs), jd),
            (torch.from_numpy(x), torch.from_numpy(xs), td))


SIZES = [BLOCK, 2 * BLOCK, 4 * BLOCK]
DTYPES = [jnp.float32, jnp.bfloat16]


@pytest.fixture(autouse=True)
def zero_counts():
    fedagg.reset_launches()
    yield


@pytest.mark.parametrize("delta_dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("n", SIZES)
class TestAgainstPallas:
    def test_norms(self, n, delta_dtype):
        (jx, jxs, jd), (tx, txs, td) = inputs(n, delta_dtype)
        ref = np.asarray(jfed.fedagg_norms(jx, jxs, jd, interpret=True))
        np.testing.assert_allclose(fedagg.norms_plain(tx, txs, td).numpy(),
                                   ref, rtol=1e-5)
        np.testing.assert_allclose(fedagg.fedagg_norms(tx, txs, td).numpy(),
                                   ref, rtol=1e-5)

    def test_axpy(self, n, delta_dtype):
        (jx, _, jd), (tx, _, td) = inputs(n, delta_dtype)
        ref = np.asarray(jfed.fedagg_axpy(jx, jd, jnp.float32(0.37),
                                          interpret=True))
        out = fedagg.fedagg_axpy(tx, td, torch.tensor(0.37))
        assert out.dtype == torch.float32 and out.shape == (n,)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-7)

    def test_fused(self, n, delta_dtype):
        """fedagg_fused: the reference's one-pass (AXPY, norms) pair, held
        as tests/test_kernels.py holds it (rtol 1e-5); the plain version is
        the AXPY's and the norms' plain versions, to the bit."""
        (jx, jxs, jd), (tx, txs, td) = inputs(n, delta_dtype)
        eta = torch.tensor(0.37)
        jout, jpart = jfed.fedagg_fused(jx, jxs, jd, jnp.float32(0.37),
                                        interpret=True)
        out, part = fedagg.fedagg_fused(tx, txs, td, eta)
        assert out.dtype == torch.float32 and out.shape == (n,)
        assert part.dtype == torch.float32 and part.shape == (2,)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(part.numpy(), np.asarray(jpart),
                                   rtol=1e-5)
        assert torch.equal(out, fedagg.axpy_plain(tx, td, eta))
        assert torch.equal(part, fedagg.norms_plain(tx, txs, td))

    def test_flat_aggregate(self, n, delta_dtype):
        (jx, jxs, jd), (tx, txs, td) = inputs(n, delta_dtype)
        jr = jops.flat_aggregate(jx, jxs, jd, lam=LAM, eps=EPS, cap=3.0)
        tr = ops.flat_aggregate(tx, txs, td, lam=LAM, eps=EPS, cap=3.0)
        np.testing.assert_allclose(tr[0].numpy(), np.asarray(jr[0]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose([float(v) for v in tr[1:]],
                                   [float(v) for v in jr[1:]], rtol=1e-5)

    def test_flat_aggregate_displacement(self, n, delta_dtype):
        (jx, jxs, jd), (tx, txs, td) = inputs(n, delta_dtype)
        jdisp, tdisp = jx - jxs, tx - txs
        jr = jops.flat_aggregate_displacement(
            jx, jdisp, jd, jnp.zeros_like(jx), lam=LAM, eps=EPS)
        tr = ops.flat_aggregate_displacement(
            tx, tdisp, td, torch.zeros_like(tx), lam=LAM, eps=EPS)
        np.testing.assert_allclose(tr[0].numpy(), np.asarray(jr[0]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose([float(v) for v in tr[1:]],
                                   [float(v) for v in jr[1:]], rtol=1e-5)


class TestEdgeCases:
    """Eq.(6/7) boundary rules through the port's flat path, against the
    reference's tree and flat paths."""

    def _all(self, x_t, x_s, d, cap=0.0):
        j = {k: jnp.asarray(v) for k, v in (("x", x_t), ("s", x_s),
                                             ("d", d))}
        t = {k: torch.from_numpy(np.asarray(v, np.float32))
             for k, v in (("x", x_t), ("s", x_s), ("d", d))}
        rt = jagg.asyncfeded_aggregate({"w": j["x"]}, {"w": j["s"]},
                                       {"w": j["d"]}, lam=LAM, eps=EPS,
                                       cap=cap)
        rf = jops.asyncfeded_aggregate_pallas(
            {"w": j["x"]}, {"w": j["s"]}, {"w": j["d"]}, lam=LAM, eps=EPS,
            cap=cap)
        rp = ops.asyncfeded_aggregate_pallas(
            {"w": t["x"]}, {"w": t["s"]}, {"w": t["d"]}, lam=LAM, eps=EPS,
            cap=cap)
        for r in (rt, rf):
            np.testing.assert_allclose(float(rp.gamma), float(r.gamma),
                                       rtol=1e-5, atol=1e-8)
            np.testing.assert_allclose(float(rp.eta), float(r.eta),
                                       rtol=1e-5)
            np.testing.assert_allclose(rp.params["w"].numpy(),
                                       np.asarray(r.params["w"]), rtol=1e-5,
                                       atol=1e-7)
        return rp

    def test_zero_delta_is_discarded(self):
        r = self._all(np.full(67, 2.0, np.float32), np.zeros(67, np.float32),
                      np.zeros(67, np.float32))
        assert float(r.gamma) > 1e10 and float(r.eta) < 1e-9
        np.testing.assert_allclose(r.params["w"].numpy(), 2.0)

    @pytest.mark.parametrize("dval", [0.25, 0.0])
    def test_zero_drift_is_fresh(self, dval):
        x = np.ones(33, np.float32)
        r = self._all(x, x, np.full(33, dval, np.float32))
        assert float(r.gamma) == 0.0
        assert np.isclose(float(r.eta), LAM / EPS)

    def test_cap_clamps_gamma(self):
        r = self._all(np.full(17, 100.0, np.float32),
                      np.zeros(17, np.float32), np.full(17, 0.01, np.float32),
                      cap=5.0)
        assert np.isclose(float(r.gamma), 5.0)
        assert np.isclose(float(r.eta), LAM / (5.0 + EPS))


class TestWrapper:
    def test_cpu_calls_leave_launch_counts_at_zero(self):
        _, (tx, txs, td) = inputs(BLOCK, jnp.float32)
        ops.flat_aggregate(tx, txs, td, lam=1.0, eps=1.0)
        fedagg.fedagg_axpy(tx, td, torch.tensor(0.5))
        fedagg.fedagg_fused(tx, txs, td, torch.tensor(0.5))
        assert fedagg.fedagg_norms.launches == 0
        assert fedagg.fedagg_axpy.launches == 0
        assert fedagg.fedagg_fused.launches == 0

    def test_axpy_writes_a_new_tensor(self):
        _, (tx, _, td) = inputs(BLOCK, jnp.float32)
        before = tx.clone()
        out = fedagg.fedagg_axpy(tx, td, torch.tensor(0.5))
        assert out.data_ptr() != tx.data_ptr()
        assert torch.equal(tx, before)

    @pytest.mark.parametrize("case", ["x_f64", "delta_f16", "delta_int",
                                      "short", "not_block", "two_dim",
                                      "strided", "mixed_device"])
    def test_norms_rejects(self, case):
        n = BLOCK
        x = torch.zeros(n)
        xs = torch.zeros(n)
        d = torch.zeros(n)
        if case == "x_f64":
            x = x.double()
        elif case == "delta_f16":
            d = d.half()
        elif case == "delta_int":
            d = d.int()
        elif case == "short":
            d = d[:n // 2]
        elif case == "not_block":
            x, xs, d = (torch.zeros(n + 4) for _ in range(3))
        elif case == "two_dim":
            x = x.reshape(2, -1)
        elif case == "strided":
            d = torch.zeros(2 * n)[::2]
        elif case == "mixed_device":
            d = torch.zeros(n, device="meta")
        with pytest.raises((TypeError, ValueError)):
            fedagg.fedagg_norms(x, xs, d)

    @pytest.mark.parametrize("case", ["eta_f64", "eta_vector", "eta_float",
                                      "strided"])
    def test_axpy_rejects(self, case):
        x, d, eta = torch.zeros(BLOCK), torch.zeros(BLOCK), torch.tensor(1.0)
        if case == "eta_f64":
            eta = eta.double()
        elif case == "eta_vector":
            eta = torch.ones(2)
        elif case == "eta_float":
            eta = 1.0
        elif case == "strided":
            x = torch.zeros(2 * BLOCK)[::2]
        with pytest.raises((TypeError, ValueError)):
            fedagg.fedagg_axpy(x, d, eta)

    @pytest.mark.parametrize("case", ["stale_short", "delta_int",
                                      "eta_float"])
    def test_fused_rejects(self, case):
        x, xs, d = (torch.zeros(BLOCK) for _ in range(3))
        eta = torch.tensor(1.0)
        if case == "stale_short":
            xs = xs[:BLOCK // 2]
        elif case == "delta_int":
            d = d.int()
        else:
            eta = 1.0
        with pytest.raises((TypeError, ValueError)):
            fedagg.fedagg_fused(x, xs, d, eta)

    def test_layout_constants_and_batch_knee(self):
        assert fedagg.BLOCK == jfed.BLOCK_ROWS * jfed.LANES
        assert fedagg.QBLOCK == jfed.QBLOCK
        for b in (4, 2, 1):
            assert fedagg.batched_b_max(b) == jfed.batched_b_max(b)

    def test_pad_flat_vector(self):
        v = torch.arange(5, dtype=torch.float32)
        p = ops.pad_flat_vector(v)
        assert p.shape == (BLOCK,) and torch.equal(p[:5], v)
        assert not p[5:].any()
        assert ops.pad_flat_vector(torch.zeros(BLOCK)).shape == (BLOCK,)


class TestBuild:
    def test_target_keyed_by_source_bytes(self, tmp_path):
        from repro_torch.kernels import build
        src = tmp_path / "k.cu"
        src.write_text("// one\n")
        first = build.target(src)
        assert first.parent == build.BUILD_DIR and first.suffix == ".so"
        assert build.target(src) == first
        src.write_text("// two\n")
        assert build.target(src) != first
        assert build.target(fedagg.SOURCE).name.startswith("fedagg-")
        assert build.build_log(src) == ""

    def test_missing_nvcc_raises(self, tmp_path, monkeypatch):
        from repro_torch.kernels import build
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.delenv("CUDA_HOME", raising=False)
        if Path("/usr/local/cuda/bin/nvcc").exists():
            pytest.skip("a CUDA toolkit is installed")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.nvcc()


class TestNormsWork:
    """fedagg.norms_work, which chip_smoke.py's bound of the single norms
    sweeps reads, against counts by hand."""

    @pytest.mark.parametrize("n", [BLOCK, 4 * BLOCK, 1 << 28])
    def test_f32_is_12_bytes_and_5_flops_per_element(self, n):
        # x_t, x_stale and delta read once, 4 bytes each; x_t - x_stale,
        # its square and the running sum, the delta's square and its sum
        assert fedagg.norms_work(n) == (12 * n, 5 * n)

    def test_bf16_and_int8_deltas(self):
        n = 2 * BLOCK
        assert fedagg.norms_work(n, 2) == (10 * n, 5 * n)
        # one byte of q, an f32 scale per 1024 elements, the dequantizing
        # multiply
        assert fedagg.norms_work(n, 1) == (9 * n + 4 * (n // 1024), 6 * n)

    def test_rejects_other_delta_widths(self):
        with pytest.raises(ValueError, match="bytes"):
            fedagg.norms_work(BLOCK, 8)
