"""The port's RG-LRU scan (kernels/rglru) against the reference: its plain
version, which the wrapper takes on the CPU, against the reference's oracle
``rglru_scan_ref`` and its Pallas kernel in interpret mode at several chunk
and tile splits, the gate wrapper against ``rglru_pallas``, and the model's
``rglru_scan`` and Griffin block against the JAX model's, with and without a
starting state. Inputs are drawn with numpy from a seed and handed to both.

Tolerances: rtol 1e-4, atol 1e-5, the reference's own for its kernel
against its oracle (tests/test_kernels.py): the plain version steps through
the sequence in order, the oracle combines in an associative tree.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as C
from repro.kernels.rglru.ops import rglru_pallas
from repro.kernels.rglru.ref import rglru_scan_ref
from repro.kernels.rglru.rglru import rglru_scan as jkernel_scan
from repro.models import rglru as JRG
from repro.models.params import init_params as jinit_params
from repro_torch import configs as TC
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.rglru import ops, rglru
from repro_torch.models import rglru as TRG

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def no_launches():
    rglru.rglru_scan.launches = 0
    yield
    assert rglru.rglru_scan.launches == 0          # the CPU takes no kernel


def scan_inputs(b, s, w, seed=0):
    rng = np.random.default_rng(seed)
    log_at = (-np.abs(rng.normal(size=(b, s, w))) * 0.1).astype(np.float32)
    xi = rng.normal(size=(b, s, w)).astype(np.float32)
    return log_at, xi


def gate_inputs(b, s, w, seed=0):
    rng = np.random.default_rng(seed)
    sig = lambda a: 1.0 / (1.0 + np.exp(-a))
    x = rng.normal(size=(b, s, w)).astype(np.float32)
    r = sig(rng.normal(size=(b, s, w))).astype(np.float32)
    i = sig(rng.normal(size=(b, s, w))).astype(np.float32)
    lam = (rng.normal(size=(w,)) * 0.5 + 2.0).astype(np.float32)
    h0 = rng.normal(size=(b, w)).astype(np.float32)
    return x, r, i, lam, h0


T = torch.from_numpy


@pytest.mark.parametrize("shape", [(2, 256, 128, 128, 64),
                                   (1, 64, 512, 32, 512),
                                   (3, 128, 96, 64, 32),
                                   (2, 100, 96, 100, 96)])
def test_plain_matches_oracle_and_pallas(shape):
    """(B, S, W, chunk, tile_w): the reference kernel's chunk and channel
    tiles change nothing in the port, whose plain version is one loop."""
    b, s, w, chunk, tile_w = shape
    log_at, xi = scan_inputs(b, s, w, seed=s + w)
    got, last = rglru.rglru_scan(T(log_at), T(xi))
    assert got.shape == (b, s, w) and got.dtype == torch.float32
    assert torch.equal(last, got[:, -1])
    for want in (rglru_scan_ref(jnp.asarray(log_at), jnp.asarray(xi)),
                 jkernel_scan(jnp.asarray(log_at), jnp.asarray(xi),
                              chunk=chunk, tile_w=tile_w)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_plain_carries_its_state():
    """The plain version steps through the sequence in order, so a scan of
    the second half from the first half's last state is the whole scan's
    second half, to the bit: the carry the kernel's chunks rely on."""
    log_at, xi = (T(a) for a in scan_inputs(2, 40, 16, seed=3))
    whole, last = rglru.rglru_scan_plain(log_at, xi)
    first, mid = rglru.rglru_scan_plain(log_at[:, :17], xi[:, :17])
    second, end = rglru.rglru_scan_plain(log_at[:, 17:], xi[:, 17:], mid)
    assert torch.equal(torch.cat([first, second], 1), whole)
    assert torch.equal(end, last)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_model_scan_matches_reference(with_h0):
    x, r, i, lam, h0 = gate_inputs(2, 128, 64, seed=7)
    jh0 = jnp.asarray(h0) if with_h0 else None
    th0 = T(h0) if with_h0 else None
    jh, jlast = JRG.rglru_scan(jnp.asarray(x), jnp.asarray(r),
                               jnp.asarray(i), jnp.asarray(lam), h0=jh0)
    th, tlast = TRG.rglru_scan(T(x), T(r), T(i), T(lam), h0=th0)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=RTOL,
                               atol=ATOL)
    assert tlast.dtype == torch.float32


def test_gate_wrapper_matches_rglru_pallas():
    x, r, i, lam, _ = gate_inputs(2, 128, 64)
    jh, jlast = rglru_pallas(jnp.asarray(x), jnp.asarray(r), jnp.asarray(i),
                             jnp.asarray(lam), chunk=64, tile_w=32)
    th, tlast = ops.rglru(T(x), T(r), T(i), T(lam))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=RTOL,
                               atol=ATOL)


def test_decode_step_matches_reference():
    x, r, i, lam, h0 = gate_inputs(3, 1, 32, seed=11)
    jy, jh = JRG.rglru_decode_step(jnp.asarray(h0), jnp.asarray(x[:, 0]),
                                   jnp.asarray(r[:, 0]), jnp.asarray(i[:, 0]),
                                   jnp.asarray(lam))
    ty, th = TRG.rglru_decode_step(T(h0), T(x[:, 0]), T(r[:, 0]),
                                   T(i[:, 0]), T(lam))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("mode", ["prefill", "continue", "decode"])
def test_block_matches_reference(mode):
    """The Griffin block at the reduced recurrentgemma-2b width, on the
    reference's weights: a prefill from zero state, a prefill continuing
    from a state (the scan's h0), and one decode step."""
    jcfg = dataclasses.replace(C.reduced(C.get_arch("recurrentgemma-2b")),
                               dtype="float32")
    tcfg = dataclasses.replace(TC.reduced(TC.get_arch("recurrentgemma-2b")),
                               dtype="float32")
    jp = jinit_params(jax.random.PRNGKey(4), JRG.rglru_defs(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(5)
    s = 1 if mode == "decode" else 24
    x = rng.normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    w = jcfg.rglru_width
    state = (None, None) if mode == "prefill" else (
        rng.normal(size=(2, w)).astype(np.float32),
        rng.normal(size=(2, jcfg.conv1d_width - 1, w)).astype(np.float32))
    jst = [None if a is None else jnp.asarray(a) for a in state]
    tst = [None if a is None else T(a) for a in state]
    jy, (jrec, jconv) = JRG.rglru_block_fwd(jp, jnp.asarray(x), jcfg,
                                            rec_state=jst[0],
                                            conv_state=jst[1])
    ty, (trec, tconv) = TRG.rglru_block_fwd(tp, T(x), tcfg, rec_state=tst[0],
                                            conv_state=tst[1])
    for t, j in ((ty, jy), (trec, jrec), (tconv, jconv)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("case", ["log_at_bf16", "xi_f16", "shape", "h0",
                                  "h0_dtype"])
def test_wrapper_rejects(case):
    log_at, xi = (T(a) for a in scan_inputs(2, 8, 4))
    h0 = None
    if case == "log_at_bf16":
        log_at = log_at.bfloat16()
    elif case == "xi_f16":
        xi = xi.half()
    elif case == "shape":
        xi = xi[:, :7]
    elif case == "h0":
        h0 = torch.zeros(2, 5)
    else:
        h0 = torch.zeros(2, 4, dtype=torch.float64)
    with pytest.raises((TypeError, ValueError)):
        rglru.rglru_scan(log_at, xi, h0)


def test_bf16_input_keeps_its_dtype():
    log_at, xi = scan_inputs(1, 16, 8, seed=2)
    xb = T(xi).bfloat16()
    got, last = rglru.rglru_scan(T(log_at), xb)
    assert got.dtype == torch.bfloat16 and last.dtype == torch.float32
    want, _ = rglru.rglru_scan(T(log_at), xb.float())
    torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)
