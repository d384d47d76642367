"""The burst drain's sweeps in the port (fedagg_norms_batched,
fedagg_apply_batched, ops.flat_aggregate_batched, and their int8 twins)
against the reference's Pallas kernels, run in interpret mode on the CPU as
the reference's own tests run them, and against its ref.py oracles.

On the CPU the wrappers take their plain PyTorch versions; the CUDA kernels
are held against those plain versions on the card by
tests/test_torch_fedagg_cuda.py.

Tolerances. The batched norms are held against the same sums taken in f64
(``exact``): dist0_sq and dn_sq to rtol 1e-5, and a cross or Gram term, a dot
product that can cancel to near zero, to 1e-5 of the product of its two
vectors' norms (the Cauchy-Schwarz bound of the term). The port meets that;
the reference's cross and Gram terms come from XLA's CPU dot, which sums
131072 f32 products with up to 3e-5 relative error, so the reference is held
to 1e-4 of the same truth (ROADMAP.md C). The apply sums B products in
another order than the reference's jnp.dot: rtol 1e-6 with atol 1e-6. A
whole drain carries the reference's dot error into its etas: its scalars
and model are held to the reference's own tolerance for its batched path,
rtol 1e-4 and atol 1e-5 (tests/test_kernels.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as JFedConfig
from repro.core import screening as jscreening
from repro.kernels.fedagg import fedagg as jfed
from repro.kernels.fedagg import ops as jops
from repro.kernels.fedagg import ref as jref
from repro_torch.configs.base import FedConfig
from repro_torch.core import screening
from repro_torch.kernels.fedagg import fedagg, ops

BLOCK = 65536
LAM, EPS = 2.0, 0.5
_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def inputs(b, n, delta_dtype=jnp.float32, seed=0, delta_scale=0.05):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    xs = (x + 0.01 * rng.normal(size=(b, n))).astype(np.float32)
    d = (delta_scale * rng.normal(size=(b, n))).astype(np.float32)
    jd = jnp.asarray(d).astype(delta_dtype)
    td = torch.from_numpy(np.asarray(jd.astype(jnp.float32))).to(
        _TORCH[delta_dtype])
    return ((jnp.asarray(x), jnp.asarray(xs), jd),
            (torch.from_numpy(x), torch.from_numpy(xs), td))


def exact(x, xs, d):
    """The four batched outputs, summed in f64 from the same f32 inputs."""
    s = np.asarray(x, np.float64)[None] - np.asarray(xs, np.float64)
    d = np.asarray(jnp.asarray(d).astype(jnp.float32), np.float64)
    return (s * s).sum(1), (d * d).sum(1), s @ d.T, d @ d.T


def assert_norms_close(got, want, rtol):
    d0, dn, cross, gram = (np.asarray(w, np.float64) for w in want)
    np.testing.assert_allclose(np.asarray(got[0]), d0, rtol=rtol)
    np.testing.assert_allclose(np.asarray(got[1]), dn, rtol=rtol)
    np.testing.assert_array_less(np.abs(np.asarray(got[2]) - cross),
                                 rtol * np.sqrt(np.outer(d0, dn)) + 1e-30)
    np.testing.assert_array_less(np.abs(np.asarray(got[3]) - gram),
                                 rtol * np.sqrt(np.outer(dn, dn)) + 1e-30)


@pytest.fixture(autouse=True)
def zero_counts():
    fedagg.reset_launches()
    yield
    assert not any(k.launches for k in fedagg.KERNELS)


@pytest.mark.parametrize("delta_dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [BLOCK, 2 * BLOCK])
@pytest.mark.parametrize("b", [1, 2, 5, 15, 24])
class TestAgainstPallas:
    def test_norms_batched(self, b, n, delta_dtype):
        (jx, jxs, jd), (tx, txs, td) = inputs(b, n, delta_dtype, seed=b)
        got = [t.numpy() for t in fedagg.fedagg_norms_batched(tx, txs, td)]
        assert [g.shape for g in got] == [(b,), (b,), (b, b), (b, b)]
        truth = exact(jx, jxs, jd)
        assert_norms_close(got, truth, 1e-5)
        for ref in (jfed.fedagg_norms_batched(jx, jxs, jd, interpret=True),
                    jref.norms_batched_ref(jx, jxs, jd)):
            assert_norms_close(ref, truth, 1e-4)

    def test_apply_batched(self, b, n, delta_dtype):
        (jx, _, jd), (tx, _, td) = inputs(b, n, delta_dtype, seed=b)
        etas = np.linspace(0.1, 1.3, b).astype(np.float32)
        got = fedagg.fedagg_apply_batched(tx, td, torch.from_numpy(etas))
        assert got.dtype == torch.float32 and got.shape == (n,)
        for want in (jfed.fedagg_apply_batched(jx, jd, jnp.asarray(etas),
                                               interpret=True),
                     jref.apply_batched_ref(jx, jd, jnp.asarray(etas))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)


def test_apply_batched_sums_in_the_kernels_order():
    """The plain version is the CUDA kernel's loop: acc = eta_0 d_0, then
    acc + eta_b d_b, then x + acc, each step rounded to f32 on its own."""
    _, (tx, _, td) = inputs(7, BLOCK, seed=3)
    etas = np.linspace(0.2, 0.8, 7).astype(np.float32)
    x, d = tx.numpy(), td.numpy()
    acc = etas[0] * d[0]
    for b in range(1, 7):
        acc = (acc + (etas[b] * d[b]).astype(np.float32)).astype(np.float32)
    want = (x + acc).astype(np.float32)
    got = fedagg.apply_batched_plain(tx, td, torch.from_numpy(etas))
    assert got.numpy().tobytes() == want.tobytes()
    # a burst of one is the single AXPY, to the bit
    assert torch.equal(fedagg.apply_batched_plain(tx, td[:1],
                                                  torch.from_numpy(etas[:1])),
                       fedagg.axpy_plain(tx, td[0],
                                         torch.tensor(etas[0])))


def test_packed_output_is_the_four_parts():
    _, (tx, txs, td) = inputs(3, BLOCK, seed=4)
    packed = fedagg.norms_batched_packed(tx, txs, td)
    assert packed.shape == (2 * 3 + 2 * 9,)
    for a, b in zip(fedagg.split_batched(packed, 3),
                    fedagg.norms_batched_plain(tx, txs, td)):
        assert torch.equal(a, b)


class TestFlatAggregateBatched:
    def _both(self, b, n, cap=0.0, seed=7, **kw):
        (jx, jxs, jd), (tx, txs, td) = inputs(b, n, seed=seed, **kw)
        jr = jops.flat_aggregate_batched(jx, jxs, jd, lam=LAM, eps=EPS,
                                         cap=cap)
        tr = ops.flat_aggregate_batched(tx, txs, td, lam=LAM, eps=EPS,
                                        cap=cap)
        return (jx, jxs, jd), jr, tr

    @pytest.mark.parametrize("b,cap", [(2, 0.0), (5, 0.0), (15, 3.0)])
    def test_matches_reference(self, b, cap):
        _, jr, tr = self._both(b, 2 * BLOCK, cap=cap)
        np.testing.assert_allclose(tr[0].numpy(), np.asarray(jr[0]),
                                   rtol=1e-4, atol=1e-5)
        for t, j in zip(tr[1:5], jr[1:5]):
            assert t.dtype == np.float32
            np.testing.assert_allclose(t, j, rtol=1e-4)
        assert tr[5] is None and jr[5] is None

    @pytest.mark.parametrize("b", [2, 5])
    def test_sequential_equivalence(self, b):
        (jx, jxs, jd), _, tr = self._both(b, 2 * BLOCK)
        rnew, retas, rgammas, rdists = jref.aggregate_batched_seq_ref(
            jx, jxs, jd, LAM, EPS)
        np.testing.assert_allclose(tr[1], retas, rtol=1e-4)
        np.testing.assert_allclose(tr[2], rgammas, rtol=1e-4)
        np.testing.assert_allclose(tr[3], rdists, rtol=1e-4)
        np.testing.assert_allclose(tr[0].numpy(), np.asarray(rnew),
                                   rtol=1e-4, atol=1e-5)

    @pytest.mark.parametrize("policy", ["clip", "reject"])
    def test_screen_inside_the_burst(self, policy):
        """One client's five arrivals in a burst, the last ten times the
        others: the screens of both packages see the kernel-emitted norms
        and flag it alike; the schedules and models agree."""
        b = 5
        (jx, jxs, jd), (tx, txs, td) = inputs(b, BLOCK, seed=9)
        jd = jd.at[4].multiply(10.0)
        td = td.clone()
        td[4] *= 10.0
        kw = dict(screen=policy, screen_warmup=2)
        jscr = jscreening.make_screen(JFedConfig(**kw))
        tscr = screening.make_screen(FedConfig(**kw))
        ids = [0] * b
        jr = jops.flat_aggregate_batched(
            jx, jxs, jd, lam=LAM, eps=EPS,
            screen=lambda dns: jscr.decide_batch(dns, ids))
        tr = ops.flat_aggregate_batched(
            tx, txs, td, lam=LAM, eps=EPS,
            screen=lambda dns: tscr.decide_batch(dns, ids))
        np.testing.assert_allclose(tr[5], jr[5], rtol=1e-5)
        assert tr[5][4] < 1.0 and (tr[5][4] == 0.0) == (policy == "reject")
        assert tscr.counts == jscr.counts
        np.testing.assert_allclose(tr[1], jr[1], rtol=1e-4)
        np.testing.assert_allclose(tr[0].numpy(), np.asarray(jr[0]),
                                   rtol=1e-4, atol=1e-5)

    def test_tree_entry_point(self):
        rng = np.random.default_rng(5)
        mk = lambda s=1.0: {"a": (s * rng.normal(size=(41, 13))).astype(
            np.float32), "b": (s * rng.normal(size=(257,))).astype(np.float32)}
        x, stales, deltas = mk(), [mk() for _ in range(3)], [
            mk(0.05) for _ in range(3)]
        jt = lambda t: {k: jnp.asarray(v) for k, v in t.items()}
        tt = lambda t: {k: torch.from_numpy(v) for k, v in t.items()}
        jr = jops.asyncfeded_aggregate_batched_pallas(
            jt(x), [jt(s) for s in stales], [jt(d) for d in deltas],
            lam=LAM, eps=EPS)
        tr = ops.asyncfeded_aggregate_batched_pallas(
            tt(x), [tt(s) for s in stales], [tt(d) for d in deltas],
            lam=LAM, eps=EPS)
        for k in ("a", "b"):
            assert tr[0][k].shape == x[k].shape
            np.testing.assert_allclose(tr[0][k].numpy(),
                                       np.asarray(jr[0][k]), rtol=1e-4,
                                       atol=1e-5)
        for t, j in zip(tr[1:], jr[1:]):
            np.testing.assert_allclose(t, j, rtol=1e-4)


class TestWrapperChecks:
    @pytest.mark.parametrize("case", ["b_zero", "b_too_big", "stale_rows",
                                      "delta_f16", "stale_bf16", "etas_len",
                                      "etas_f64"])
    def test_rejects(self, case):
        b, n = 3, BLOCK
        x, xs, d = torch.zeros(n), torch.zeros(b, n), torch.zeros(b, n)
        etas = torch.ones(b)
        if case == "b_zero":
            xs, d, etas = xs[:0], d[:0], etas[:0]
        elif case == "b_too_big":
            b = fedagg.MAX_BATCH + 1
            xs, d, etas = (torch.zeros(b, n), torch.zeros(b, n),
                           torch.ones(b))
        elif case == "stale_rows":
            xs = xs[:2]
        elif case == "delta_f16":
            d = d.half()
        elif case == "stale_bf16":
            xs = xs.bfloat16()
        elif case == "etas_len":
            etas = etas[:2]
        elif case == "etas_f64":
            etas = etas.double()
        with pytest.raises((TypeError, ValueError)):
            fedagg.fedagg_norms_batched(x, xs, d)
            fedagg.fedagg_apply_batched(x, d, etas)

    def test_int8_burst_raises_naming_b7(self):
        """The int8 burst drain (ROADMAP.md B7) runs: at B = 2, 15 and 24
        (the int8 knee) ops.flat_aggregate_batched_q gives the reference's
        drain (interpret mode) and its sequential oracle on the dequantized
        deltas, and a bad int8 input is refused."""
        for b in (2, 15, 24):
            (jx, jxs, jq, js), (tx, txs, tq, ts) = q_inputs(b, 2 * BLOCK,
                                                            seed=20 + b)
            jr = jops.flat_aggregate_batched_q(jx, jxs, jq, js, lam=LAM,
                                               eps=EPS)
            tr = ops.flat_aggregate_batched_q(tx, txs, tq, ts, lam=LAM,
                                              eps=EPS)
            np.testing.assert_allclose(tr[0].numpy(), np.asarray(jr[0]),
                                       rtol=1e-4, atol=1e-5)
            for t, j in zip(tr[1:5], jr[1:5]):
                assert t.dtype == np.float32
                np.testing.assert_allclose(t, j, rtol=1e-4)
            assert tr[5] is None and jr[5] is None
            jd = np.asarray(dequant(jq, js))
            rnew, retas, rgammas, rdists = jref.aggregate_batched_seq_ref(
                jx, jxs, jnp.asarray(jd), LAM, EPS)
            np.testing.assert_allclose(tr[1], retas, rtol=1e-4)
            np.testing.assert_allclose(tr[2], rgammas, rtol=1e-4)
            np.testing.assert_allclose(tr[3], rdists, rtol=1e-4)
            np.testing.assert_allclose(tr[0].numpy(), np.asarray(rnew),
                                       rtol=1e-4, atol=1e-5)
        with pytest.raises((TypeError, ValueError)):
            ops.flat_aggregate_batched_q(tx, txs, tq.float(), ts, lam=1.0,
                                         eps=1.0)
        with pytest.raises((TypeError, ValueError)):
            fedagg.fedagg_apply_batched_q(tx, tq, ts[:, :-1],
                                          torch.ones(24))


def q_inputs(b, n, seed=0):
    """x_t, B stales, and B int8 deltas with their per-1024 scales (one
    all-zero block), the same numbers for both packages."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    xs = (x + 0.01 * rng.normal(size=(b, n))).astype(np.float32)
    q = rng.integers(-127, 128, size=(b, n)).astype(np.int8)
    q[:, :fedagg.QBLOCK] = 0
    sc = (0.05 / 127 * rng.uniform(0.5, 2.0, size=(b, n // fedagg.QBLOCK))
          ).astype(np.float32)
    return ((jnp.asarray(x), jnp.asarray(xs), jnp.asarray(q),
             jnp.asarray(sc)),
            (torch.from_numpy(x), torch.from_numpy(xs), torch.from_numpy(q),
             torch.from_numpy(sc)))


def dequant(q, sc):
    """The (B, n) f32 deltas the int8 wire form stands for."""
    q = np.asarray(q).astype(np.float32)
    return (q.reshape(q.shape[0], -1, fedagg.QBLOCK)
            * np.asarray(sc)[..., None]).reshape(q.shape)


@pytest.mark.parametrize("n", [BLOCK, 2 * BLOCK])
@pytest.mark.parametrize("b", [2, 15, 24])
class TestInt8AgainstPallas:
    def test_norms_batched_q(self, b, n):
        (jx, jxs, jq, js), (tx, txs, tq, ts) = q_inputs(b, n, seed=b)
        got = [t.numpy() for t in fedagg.fedagg_norms_batched_q(tx, txs, tq,
                                                                ts)]
        assert [g.shape for g in got] == [(b,), (b,), (b, b), (b, b)]
        truth = exact(jx, jxs, dequant(jq, js))
        assert_norms_close(got, truth, 1e-5)
        assert_norms_close(jfed.fedagg_norms_batched_q(jx, jxs, jq, js,
                                                       interpret=True),
                           truth, 1e-4)
        # the plain version is the f32 one on the dequantized deltas
        for a, w in zip(fedagg.fedagg_norms_batched_q(tx, txs, tq, ts),
                        fedagg.norms_batched_plain(
                            tx, txs, torch.from_numpy(dequant(jq, js)))):
            assert torch.equal(a, w)

    def test_apply_batched_q(self, b, n):
        (jx, _, jq, js), (tx, _, tq, ts) = q_inputs(b, n, seed=b)
        etas = np.linspace(0.1, 1.3, b).astype(np.float32)
        got = fedagg.fedagg_apply_batched_q(tx, tq, ts, torch.from_numpy(etas))
        assert got.dtype == torch.float32 and got.shape == (n,)
        want = jfed.fedagg_apply_batched_q(jx, jq, js, jnp.asarray(etas),
                                           interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        # the kernel's order of roundings: the f32 plain apply on the
        # dequantized deltas, to the bit
        assert torch.equal(got, fedagg.apply_batched_plain(
            tx, torch.from_numpy(dequant(jq, js)), torch.from_numpy(etas)))


@pytest.mark.parametrize("b", [1, 2, 8, 23, 24, 128])
@pytest.mark.parametrize("delta_bytes", [4, 2, 1], ids=["f32", "bf16",
                                                        "int8"])
def test_norms_batched_work_counts_the_outputs(b, delta_bytes):
    """fedagg.norms_batched_work, which chip_smoke.py's bound of the batched
    norms reads, against a count of its outputs: per element the B drifts
    (a subtraction each), the B squared drifts and B x B cross terms (a
    multiply and an add each), the Gram terms k <= l (the same), and with
    int8 deltas one dequantizing multiply per delta; x_t and the B stales
    read in f32, the deltas in their wire form (int8: an f32 scale per
    1024 elements). 4(B+1) + 4B bytes and 3B^2 + 4B flops per f32
    element."""
    n = 2 * BLOCK
    gram = sum(1 for k in range(b) for l in range(b) if k <= l)
    flops = b + 2 * b + 2 * b * b + 2 * gram + (b if delta_bytes == 1 else 0)
    scales = 4 * b * (n // 1024) if delta_bytes == 1 else 0
    assert fedagg.norms_batched_work(b, n, delta_bytes) == (
        4 * (b + 1) * n + delta_bytes * b * n + scales, flops * n)
    if delta_bytes == 4:
        assert flops == 3 * b * b + 4 * b


@pytest.mark.parametrize("b", [1, 2, 8, 23, 24, 128])
@pytest.mark.parametrize("delta_bytes", [4, 2, 1], ids=["f32", "bf16",
                                                        "int8"])
def test_apply_batched_work_counts_the_chain(b, delta_bytes):
    """fedagg.apply_batched_work, which chip_smoke.py's bound of the batched
    applies reads, against a count of the sum the plain version takes: per
    element B multiplies by an eta, B - 1 adds into the sum and one onto
    x_t, and with int8 deltas one dequantizing multiply per delta; x_t read
    and the new vector written in f32, the deltas read in their wire form
    (int8: an f32 scale per 1024 elements). 4(B + 2) bytes and 2B flops per
    f32 element."""
    n = 2 * BLOCK
    flops = b + (b - 1) + 1 + (b if delta_bytes == 1 else 0)
    scales = 4 * b * (n // 1024) if delta_bytes == 1 else 0
    assert fedagg.apply_batched_work(b, n, delta_bytes) == (
        4 * n + delta_bytes * b * n + scales + 4 * n, flops * n)
    if delta_bytes == 4:
        assert fedagg.apply_batched_work(b, n) == (4 * (b + 2) * n,
                                                   2 * b * n)


def test_apply_batched_work_rejects_other_widths():
    with pytest.raises(ValueError, match="4, 2 or 1 bytes"):
        fedagg.apply_batched_work(2, BLOCK, 8)
