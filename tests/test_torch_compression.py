"""Compressed delta transport in the port (repro_torch.core.compression, the
client's error feedback, the int8 sweeps and their flat ops) against the
reference, on the same inputs made with numpy.

The quantizer must give the reference's int8 bytes and f32 scale bits
exactly, on random data, all-zero blocks and exact .5 ties; so must a chain
of error-feedback emissions. The int8 sweeps run their plain versions here
and are held against the reference's Pallas kernels in interpret mode:
norms rtol 1e-5 (another summation order), the AXPY rtol 1e-6 with atol 1e-7
(one multiply chain per element; XLA may fuse two roundings into one), a
whole step rtol 1e-5 with atol 1e-6 (eta carries the norms' last bits).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as JFedConfig
from repro.core import compression as jc
from repro.core.client import Client as JClient
from repro.core.server import ClientUpdate as JUpdate
from repro.kernels.fedagg import fedagg as jfed
from repro.kernels.fedagg import ops as jops
from repro_torch.configs.base import FedConfig
from repro_torch.core import compression as tc
from repro_torch.core.client import Client
from repro_torch.core.server import ClientUpdate
from repro_torch.kernels.fedagg import fedagg, ops
from torch_threads import one_torch_thread  # noqa: F401

BLOCK = fedagg.BLOCK
QBLOCK = fedagg.QBLOCK


def vec(n, seed=0, scale=0.05):
    return (scale * np.random.default_rng(seed).normal(size=n)).astype(
        np.float32)


def both(v):
    return jnp.asarray(v), torch.from_numpy(np.array(v))


def ties(n=BLOCK):
    """Blocks whose values sit exactly on .5 steps of their scale: the first
    element of each block sets absmax = 127 * s for a power-of-two s, and
    the rest are odd multiples of s / 2."""
    rng = np.random.default_rng(1)
    v = np.zeros(n, np.float32)
    for blk, s in enumerate((1.0, 0.25, 2.0 ** -7, 8.0)):
        lo = blk * QBLOCK
        v[lo] = 127 * s
        half = (2 * rng.integers(-127, 127, QBLOCK - 1) + 1) * (s / 2)
        v[lo + 1:lo + QBLOCK] = np.clip(half, -127 * s, 127 * s)
    return v


class TestQuantizer:
    @pytest.mark.parametrize("case", ["random", "tiny", "large", "zeros",
                                      "ties"])
    def test_int8_bits_equal_reference(self, case):
        n = 2 * BLOCK
        if case == "ties":
            v = ties(n)
        elif case == "zeros":
            v = vec(n)
            v[3 * QBLOCK:7 * QBLOCK] = 0.0       # four all-zero blocks
        else:
            v = vec(n, seed=5, scale={"random": 0.05, "tiny": 1e-6,
                                      "large": 300.0}[case])
        jv, tv = both(v)
        jq, js = jc._quantize_int8(jv)
        tq, ts = tc._quantize_int8(tv)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
        assert ts.numpy().tobytes() == np.asarray(js).tobytes()
        if case == "zeros":
            assert not ts[3:7].any() and not tq[3 * QBLOCK:7 * QBLOCK].any()

    def test_ties_round_half_to_even(self):
        v = np.zeros(BLOCK, np.float32)
        v[0] = 127.0
        v[1:6] = [0.5, 1.5, 2.5, -0.5, -2.5]
        tq, _ = tc._quantize_int8(torch.from_numpy(v))
        assert tq[:6].tolist() == [127, 0, 2, 2, 0, -2]

    @pytest.mark.parametrize("mode", ["int8", "bf16"])
    def test_quantize_and_dequantize_equal_reference(self, mode):
        n = BLOCK
        jv, tv = both(vec(n, seed=2))
        jcd = jc.quantize_vec(jv, mode, n - 7)
        tcd = tc.quantize_vec(tv, mode, n - 7)
        assert (tcd.mode, tcd.n) == (jcd.mode, jcd.n)
        assert tcd.wire_bytes() == jcd.wire_bytes()
        assert (tcd.q.float().numpy().tobytes()
                == np.asarray(jcd.q.astype(jnp.float32)).tobytes())
        assert (tc.dequantize(tcd).numpy().tobytes()
                == np.asarray(jc.dequantize(jcd)).tobytes())

    @pytest.mark.parametrize("mode", ["int8", "bf16"])
    def test_scale_delta_equals_reference(self, mode):
        n = BLOCK
        jv, tv = both(vec(n, seed=3))
        js = jc.scale_delta(jc.quantize_vec(jv, mode, n), 0.37)
        ts = tc.scale_delta(tc.quantize_vec(tv, mode, n), 0.37)
        assert (tc.dequantize(ts).numpy().tobytes()
                == np.asarray(jc.dequantize(js)).tobytes())
        if mode == "int8":
            # exact on the scales: the payload is not re-quantized
            assert torch.equal(ts.q, tc.quantize_vec(tv, mode, n).q)

    def test_scale_delta_of_a_tree(self):
        d = {"w": torch.ones(5)}
        assert torch.equal(tc.scale_delta(d, 0.5)["w"], torch.full((5,), 0.5))

    @pytest.mark.parametrize("mode", ["int8", "bf16"])
    def test_delta_norm_equals_reference(self, mode):
        jv, tv = both(vec(BLOCK, seed=4))
        assert tc.delta_norm(tc.quantize_vec(tv, mode, BLOCK)) == (
            pytest.approx(jc.delta_norm(jc.quantize_vec(jv, mode, BLOCK)),
                          rel=1e-6))
        tree = {"a": torch.from_numpy(vec(40, seed=5))}
        assert tc.delta_norm(tree) == pytest.approx(
            jc.delta_norm({"a": jnp.asarray(vec(40, seed=5))}), rel=1e-6)

    def test_constants_equal_reference(self):
        assert tc.MODES == jc.MODES
        assert tc.BLOCK == jc.BLOCK and tc.QBLOCK == jfed.QBLOCK
        for mode in jc.MODES:
            assert tc.wire_bytes_per_param(mode) == jc.wire_bytes_per_param(
                mode)
        assert tc.is_compressed(tc.quantize_vec(torch.zeros(BLOCK), "int8",
                                                1))
        assert not tc.is_compressed({"w": torch.zeros(1)})
        with pytest.raises(ValueError):
            tc.quantize_vec(torch.zeros(BLOCK), "fp8", 1)


# --------------------------------------------------------- error feedback --
def bare_client(cls, mode):
    """A client without its dataset plumbing, as the reference's tests make
    one."""
    c = cls.__new__(cls)
    c.client_id = 0
    c.fed = (JFedConfig if cls is JClient else FedConfig)(
        delta_compression=mode, num_clients=2)
    c._residual = None
    c._flatspec = None
    return c


class TestErrorFeedback:
    def test_residual_cancels_bias(self):
        """Emitting the same delta T times: with error feedback the sum of
        the dequantized emissions tracks T * delta to one quantization
        step."""
        c = bare_client(Client, "int8")
        delta = {"w": torch.from_numpy(vec(300, seed=0, scale=0.01))}
        T, acc = 8, None
        for _ in range(T):
            d = tc.dequantize(c.compress_update(
                ClientUpdate(0, 1, 1, delta)).delta)
            acc = d if acc is None else acc + d
        padded = torch.nn.functional.pad(delta["w"], (0, BLOCK - 300))
        step = tc.quantize_vec(padded, "int8", 300).scales.repeat_interleave(
            QBLOCK)
        assert bool(((acc - T * padded).abs() <= step + 1e-9).all())

    def test_chain_of_emissions_equals_reference(self):
        """Four emissions with the residual carried between them: the wire
        bytes equal the reference client's at every step."""
        jcl, tcl = bare_client(JClient, "int8"), bare_client(Client, "int8")
        for step in range(4):
            v = {"a": vec((33, 7), seed=10 + step),
                 "b": vec(129, seed=20 + step)}
            ju = jcl.compress_update(JUpdate(0, 1, 1, {
                k: jnp.asarray(a) for k, a in v.items()}))
            tu = tcl.compress_update(ClientUpdate(0, 1, 1, {
                k: torch.from_numpy(a) for k, a in v.items()}))
            assert tu.delta.q.numpy().tobytes() == np.asarray(
                ju.delta.q).tobytes()
            assert tu.delta.scales.numpy().tobytes() == np.asarray(
                ju.delta.scales).tobytes()
            assert tu.delta.n == ju.delta.n == 33 * 7 + 129
        assert tcl._residual.numpy().tobytes() == np.asarray(
            jcl._residual).tobytes()

    def test_release_residual(self):
        c = bare_client(Client, "int8")
        c.compress_update(ClientUpdate(0, 1, 1, {"w": torch.full((300,),
                                                                 0.003)}))
        assert c._residual is not None
        c.release_residual()
        assert c._residual is None

    def test_off_mode_is_noop(self):
        c = bare_client(Client, "off")
        upd = ClientUpdate(0, 1, 1, {"w": torch.ones(8)})
        assert c.compress_update(upd) is upd

    def test_no_double_compression(self):
        c = bare_client(Client, "int8")
        upd = c.compress_update(ClientUpdate(0, 1, 1,
                                             {"w": torch.full((300,), 0.003)}))
        assert tc.is_compressed(upd.delta)
        assert c.compress_update(upd) is upd


# ------------------------------------------------------------ int8 sweeps --
def q_inputs(nblocks, seed=0):
    n = BLOCK * nblocks
    x, xs = vec(n, seed, 1.0), vec(n, seed + 1, 1.0)
    d = vec(n, seed + 2)
    d[:QBLOCK] = 0.0
    jq, js = jc._quantize_int8(jnp.asarray(d))
    return ((jnp.asarray(x), jnp.asarray(xs), jq, js),
            (torch.from_numpy(x), torch.from_numpy(xs),
             torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(js))))


@pytest.fixture()
def no_launches():
    fedagg.reset_launches()
    yield
    assert not any(k.launches for k in fedagg.KERNELS)


@pytest.mark.usefixtures("no_launches")
@pytest.mark.parametrize("nblocks", [1, 2, 5])
class TestInt8Sweeps:
    def test_norms_q(self, nblocks):
        (jx, jxs, jq, js), (tx, txs, tq, ts) = q_inputs(nblocks)
        want = np.asarray(jfed.fedagg_norms_q(jx, jxs, jq, js,
                                              interpret=True))
        np.testing.assert_allclose(fedagg.norms_q_plain(tx, txs, tq,
                                                        ts).numpy(),
                                   want, rtol=1e-5)
        np.testing.assert_allclose(fedagg.fedagg_norms_q(tx, txs, tq,
                                                         ts).numpy(),
                                   want, rtol=1e-5)

    def test_axpy_q(self, nblocks):
        (jx, _, jq, js), (tx, _, tq, ts) = q_inputs(nblocks)
        want = np.asarray(jfed.fedagg_axpy_q(jx, jq, js, jnp.float32(0.37),
                                             interpret=True))
        got = fedagg.fedagg_axpy_q(tx, tq, ts, torch.tensor(0.37))
        assert got.dtype == torch.float32 and got.data_ptr() != tx.data_ptr()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
        # the plain version is the f32 AXPY of the dequantized delta
        assert torch.equal(got, fedagg.axpy_plain(
            tx, fedagg.dequantize_plain(tq, ts), torch.tensor(0.37)))

    def test_flat_aggregate_q(self, nblocks):
        (jx, jxs, jq, js), (tx, txs, tq, ts) = q_inputs(nblocks, seed=3)
        jr = jops.flat_aggregate_q(jx, jxs, jq, js, lam=2.0, eps=0.5,
                                   cap=3.0)
        tr = ops.flat_aggregate_q(tx, txs, tq, ts, lam=2.0, eps=0.5, cap=3.0)
        np.testing.assert_allclose(tr[0].numpy(), np.asarray(jr[0]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose([float(v) for v in tr[1:]],
                                   [float(v) for v in jr[1:]], rtol=1e-5)

    def test_flat_aggregate_displacement_q(self, nblocks):
        (jx, jxs, jq, js), (tx, txs, tq, ts) = q_inputs(nblocks, seed=4)
        jr = jops.flat_aggregate_displacement_q(
            jx, jx - jxs, jq, js, jnp.zeros_like(jx), lam=2.0, eps=0.5)
        tr = ops.flat_aggregate_displacement_q(
            tx, tx - txs, tq, ts, torch.zeros_like(tx), lam=2.0, eps=0.5)
        np.testing.assert_allclose(tr[0].numpy(), np.asarray(jr[0]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose([float(v) for v in tr[1:]],
                                   [float(v) for v in jr[1:]], rtol=1e-5)


@pytest.mark.parametrize("case", ["q_int32", "q_short", "scales_short",
                                  "scales_f64"])
def test_int8_wrappers_reject(case):
    x = torch.zeros(BLOCK)
    q = torch.zeros(BLOCK, dtype=torch.int8)
    s = torch.zeros(BLOCK // QBLOCK)
    if case == "q_int32":
        q = q.int()
    elif case == "q_short":
        q = q[:BLOCK // 2]
    elif case == "scales_short":
        s = s[:-1]
    elif case == "scales_f64":
        s = s.double()
    with pytest.raises((TypeError, ValueError)):
        fedagg.fedagg_norms_q(x, x, q, s)
    with pytest.raises((TypeError, ValueError)):
        fedagg.fedagg_axpy_q(x, q, s, torch.tensor(1.0))
