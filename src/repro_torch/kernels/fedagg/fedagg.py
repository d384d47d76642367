"""The AsyncFedED server's sweeps over the padded flat model.

  one arrival   fedagg_norms : one pass over (x_t, x_stale, delta) emitting
                [||x_t - x_stale||^2, ||delta||^2] -> gamma, eta (Eq. 6/7);
                fedagg_axpy  : one pass computing x_t + eta * delta (Eq. 5).
  eta known     fedagg_fused : both in one pass, for an eta fixed before the
                sweep; no server path of either package calls it.
  int8 wire     fedagg_norms_q / fedagg_axpy_q : the same two sweeps with the
                delta as int8 ``q`` and one f32 scale per ``QBLOCK`` elements,
                dequantized in registers.
  a burst of B  fedagg_norms_batched : one pass over x_t, B stale rows read
                where they lie and B stacked deltas, emitting every norm,
                cross term and Gram entry the sequential-equivalence
                schedule needs;
                fedagg_apply_batched : one pass computing
                x_t + sum_b eta_b * delta_b.
  int8 burst    fedagg_norms_batched_q / fedagg_apply_batched_q : the burst
                pair with the B deltas in int8 wire form, (B, n) int8 and
                (B, n // QBLOCK) f32 scales, dequantized in registers.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/fedagg.cu`` and ``csrc/fedagg_batched.cu``, built by ``nvcc`` for
``sm_90a`` at first use, both at once) or raises; on a CPU tensor it runs its
plain PyTorch version beside it (``*_plain``). Nothing falls back from one to
the other. Each wrapper adds one to ``<wrapper>.launches`` per call that
launches its kernel. The single norms sweeps (``fedagg_norms``,
``fedagg_norms_q``, ``fedagg_fused``) are one CUDA launch each: the block that
draws the last ticket of a per-device integer counter folds the per-block
partials in a fixed order. The batched norms are a split-K product in one
launch and a fixed-order fold of its partials in a second, programmatic-
dependent one, counted once per call.

The batched pair takes f32 and bf16 deltas; its int8 twins are the same
kernel templates with the int8 loader.

``BLOCK = BLOCK_ROWS * LANES = 65536`` and ``QBLOCK = 1024`` are layout
constants of the flat state, not tile sizes of these kernels: the padded
length, checkpoints and wire shapes are defined by them in both packages.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.utils import tracing

LANES = 128
BLOCK_ROWS = 512
BLOCK = BLOCK_ROWS * LANES             # flat vectors pad to a multiple of this
QBLOCK_ROWS = 8
QBLOCK = QBLOCK_ROWS * LANES           # elements per int8 scale on the wire

SOURCE = Path(__file__).with_name("csrc") / "fedagg.cu"
BATCHED_SOURCE = SOURCE.with_name("fedagg_batched.cu")
SOURCES = (SOURCE, BATCHED_SOURCE)

#: the largest burst the batched kernels take (``kMaxB`` in the source)
MAX_BATCH = 128

# operand budget per grid step of the reference's multi-delta kernels
_VMEM_BUDGET_BYTES = 8 * 1024 * 1024


def batched_b_max(delta_bytes: int = 4) -> int:
    """The reference's free-batch knee for its multi-delta kernels: 15 (f32),
    20 (bf16), 24 (int8) arrivals. It is TPU memory arithmetic, kept as it is
    because ``AsyncFedEDServer.batch_limit()`` reports it and the auto-window
    controller clamps to it, so ``"auto"`` window traces depend on it."""
    per_elem = _VMEM_BUDGET_BYTES // (BLOCK_ROWS * LANES)
    return int((per_elem - 4) // (4 + delta_bytes))


def _delta_work(n: int, delta_bytes: int) -> Tuple[int, int]:
    """(bytes, flops) of one delta of n elements with ``delta_bytes`` per
    element: its wire bytes, and for the int8 form (1 byte) an f32 scale
    per ``QBLOCK`` elements and one dequantizing multiply per element."""
    if delta_bytes not in (4, 2, 1):
        raise ValueError(f"a delta element takes 4, 2 or 1 bytes, not "
                         f"{delta_bytes}")
    if delta_bytes == 1:
        return n + 4 * (n // QBLOCK), n
    return delta_bytes * n, 0


def norms_work(n: int, delta_bytes: int = 4) -> Tuple[int, int]:
    """(bytes, flops) the norms sweep must move and do over n elements with
    a delta of ``delta_bytes`` per element (4 f32, 2 bf16, 1 int8 wire
    form): x_t, x_stale and the delta read once; per element a subtraction
    and two multiply-adds, for ||x_t - x_stale||^2 and ||delta||^2. 12 bytes
    and 5 flops per f32 element."""
    dbytes, dflops = _delta_work(n, delta_bytes)
    return 8 * n + dbytes, 5 * n + dflops


def norms_batched_work(b: int, n: int,
                       delta_bytes: int = 4) -> Tuple[int, int]:
    """(bytes, flops) the batched norms must move and do for a burst of B
    over n elements: x_t, the B stales and the B deltas read once; per
    element B drifts (one flop each), B squared drifts, B^2 cross terms and
    the B(B+1)/2 Gram terms of one triangle (two flops each): 4(B+1) + 4B
    bytes and 3B^2 + 4B flops per f32 element."""
    dbytes, dflops = _delta_work(n, delta_bytes)
    return 4 * (b + 1) * n + b * dbytes, (3 * b * b + 4 * b) * n + b * dflops


def apply_batched_work(b: int, n: int,
                       delta_bytes: int = 4) -> Tuple[int, int]:
    """(bytes, flops) the batched apply must move and do for a burst of B
    over n elements: x_t and the B deltas read once, the new vector written;
    per element B multiplies by an eta and B adds (B - 1 into the sum, one
    onto x_t), and with int8 deltas one dequantizing multiply per delta:
    4(B + 2) bytes and 2B flops per f32 element."""
    dbytes, dflops = _delta_work(n, delta_bytes)
    return 8 * n + b * dbytes, 2 * b * n + b * dflops


# ------------------------------------------------------------ plain versions --

def norms_plain(x_t: torch.Tensor, x_stale: torch.Tensor,
                delta: torch.Tensor) -> torch.Tensor:
    """(2,) f32: [||x_t - x_stale||^2, ||delta||^2]."""
    diff = x_t.float() - x_stale.float()
    d = delta.float()
    return torch.stack([torch.sum(diff * diff), torch.sum(d * d)])


def axpy_plain(x_t: torch.Tensor, delta: torch.Tensor,
               eta: torch.Tensor) -> torch.Tensor:
    """x_t + eta * delta in f32, cast to the dtype of x_t."""
    return (x_t.float() + eta.reshape(()).float() * delta.float()
            ).to(x_t.dtype)


def fused_plain(x_t: torch.Tensor, x_stale: torch.Tensor,
                delta: torch.Tensor, eta: torch.Tensor):
    """(:func:`axpy_plain`, :func:`norms_plain`) of the same inputs."""
    return axpy_plain(x_t, delta, eta), norms_plain(x_t, x_stale, delta)


def dequantize_plain(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 ``q`` (n,) times its block's f32 scale: the f32 delta (n,)."""
    return (q.float().reshape(-1, QBLOCK) * scales.reshape(-1, 1)).reshape(-1)


def norms_q_plain(x_t: torch.Tensor, x_stale: torch.Tensor, q: torch.Tensor,
                  scales: torch.Tensor) -> torch.Tensor:
    """:func:`norms_plain` of the dequantized delta."""
    return norms_plain(x_t, x_stale, dequantize_plain(q, scales))


def axpy_q_plain(x_t: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                 eta: torch.Tensor) -> torch.Tensor:
    """:func:`axpy_plain` of the dequantized delta."""
    return axpy_plain(x_t, dequantize_plain(q, scales), eta)


def norms_batched_plain(x_t: torch.Tensor, x_stales: torch.Tensor,
                        deltas: torch.Tensor):
    """(dist0_sq (B,), dn_sq (B,), cross (B, B), gram (B, B)) in f32, with
    cross[b, k] = <x_t - x_stales[b], deltas[k]> and
    gram[k, l] = <deltas[k], deltas[l]>."""
    s = x_t.float()[None] - x_stales.float()
    d = deltas.float()
    return (torch.sum(s * s, dim=1), torch.sum(d * d, dim=1), s @ d.T,
            d @ d.T)


def apply_batched_plain(x_t: torch.Tensor, deltas: torch.Tensor,
                        etas: torch.Tensor) -> torch.Tensor:
    """x_t + sum_b etas[b] * deltas[b], summed in the kernel's order:
    acc = etas[0] d_0, then acc + etas[b] d_b for b = 1..B-1, then x_t + acc,
    every multiply and add rounded on its own."""
    etas = etas.float()
    acc = etas[0] * deltas[0].float()
    for b in range(1, deltas.shape[0]):
        acc = acc + etas[b] * deltas[b].float()
    return (x_t.float() + acc).to(x_t.dtype)


def dequantize_rows_plain(qs: torch.Tensor,
                          scales: torch.Tensor) -> torch.Tensor:
    """(B, n) int8 ``qs`` with (B, n // QBLOCK) ``scales``: the (B, n) f32
    deltas, each row as :func:`dequantize_plain` makes it."""
    b = qs.shape[0]
    return (qs.float().reshape(b, -1, QBLOCK)
            * scales.reshape(b, -1, 1)).reshape(b, -1)


def norms_batched_q_plain(x_t: torch.Tensor, x_stales: torch.Tensor,
                          qs: torch.Tensor, scales: torch.Tensor):
    """:func:`norms_batched_plain` of the dequantized deltas."""
    return norms_batched_plain(x_t, x_stales,
                               dequantize_rows_plain(qs, scales))


def apply_batched_q_plain(x_t: torch.Tensor, qs: torch.Tensor,
                          scales: torch.Tensor,
                          etas: torch.Tensor) -> torch.Tensor:
    """:func:`apply_batched_plain` of the dequantized deltas: the same
    roundings as the kernel, so the two agree to the bit."""
    return apply_batched_plain(x_t, dequantize_rows_plain(qs, scales), etas)


def split_batched(packed, b: int):
    """The batched norms' packed (2B + 2B^2,) output, as the four outputs
    (dist0_sq, dn_sq, cross, gram) of :func:`norms_batched_plain`. Works on a
    tensor or a numpy array; the parts are views."""
    return (packed[:b], packed[b:2 * b],
            packed[2 * b:2 * b + b * b].reshape(b, b),
            packed[2 * b + b * b:].reshape(b, b))


# ------------------------------------------------------------------ checks --

def _check_inputs(x_t: torch.Tensor, pairs) -> None:
    """x_t is a flat f32 (n,) with n a multiple of ``BLOCK``; each
    ``(name, tensor, dtypes[, shape])`` lies beside it, shape (n,) unless
    given."""
    if not isinstance(x_t, torch.Tensor) or x_t.dim() != 1:
        raise ValueError("x_t must be a flat (n,) tensor")
    n = x_t.shape[0]
    if n % BLOCK:
        raise ValueError(f"flat length {n} is not a multiple of {BLOCK}")
    build.check_tensor("x_t", x_t, (torch.float32,), (n,), x_t.device)
    for name, t, dtypes, *shape in pairs:
        build.check_tensor(name, t, dtypes, shape[0] if shape else (n,),
                      x_t.device)


def _check_batch(b: int) -> None:
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f"a burst of {b} arrivals: the batched kernels take "
                         f"1 to {MAX_BATCH}")


def _stale_rows(x_t: torch.Tensor, x_stales, b: int):
    """The B stale snapshots of a burst as a list of (n,) f32 tensors beside
    x_t: the given sequence of B rows, or the rows of a (B, n) tensor. Each
    row is checked as a kernel input (contiguous, 16-byte aligned on CUDA);
    rows may repeat."""
    rows = list(x_stales)
    if len(rows) != b:
        raise ValueError(f"{len(rows)} stale rows for a burst of {b} "
                         "arrivals")
    for i, row in enumerate(rows):
        build.check_tensor(f"x_stales[{i}]", row, _F32, x_t.shape,
                           x_t.device)
    return rows


def _check_eta(eta: torch.Tensor, shape, x_t: torch.Tensor) -> None:
    if (not isinstance(eta, torch.Tensor)
            or (tuple(eta.shape) != shape
                and not (shape == () and eta.numel() == 1))
            or eta.dtype != torch.float32 or eta.device != x_t.device):
        raise TypeError(f"eta must be an f32 tensor of shape {shape} on the "
                        "device of x_t")


_F32 = (torch.float32,)
_DELTA_DTYPES = (torch.float32, torch.bfloat16)
_VP, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _bind(lib: ctypes.CDLL, names, argtypes, restype=ctypes.c_int) -> None:
    for name in names:
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = restype


@functools.lru_cache(maxsize=None)
def load_libraries() -> Tuple[ctypes.CDLL, ctypes.CDLL]:
    """Build (at first use, both sources at once) and bind ``csrc/fedagg.cu``
    and ``csrc/fedagg_batched.cu``."""
    build.build_all(SOURCES)
    lib, blib = build.load(SOURCE), build.load(BATCHED_SOURCE)
    _bind(lib, ("fedagg_norms_f32", "fedagg_norms_bf16"),
          [_VP, _VP, _VP, _VP, _VP, _VP, _I64, _VP])
    _bind(lib, ("fedagg_norms_int8",), [_VP, _VP, _VP, _VP, _VP, _VP, _VP,
                                        _I64, _VP])
    _bind(lib, ("fedagg_axpy_f32", "fedagg_axpy_bf16"),
          [_VP, _VP, _VP, _VP, _I64, _VP])
    _bind(lib, ("fedagg_axpy_int8",), [_VP, _VP, _VP, _VP, _VP, _I64, _VP])
    _bind(lib, ("fedagg_fused_f32", "fedagg_fused_bf16"),
          [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I64, _VP])
    _bind(lib, ("fedagg_norms_blocks",), [_I64])
    _bind(lib, ("fedagg_error_string",), [_INT], ctypes.c_char_p)
    _bind(blib, ("fedagg_norms_batched_f32", "fedagg_norms_batched_bf16"),
          [_VP, _VP, _VP, _INT, _I64, _VP, _VP, _VP])
    _bind(blib, ("fedagg_apply_batched_f32", "fedagg_apply_batched_bf16"),
          [_VP, _VP, _VP, _INT, _I64, _VP, _VP])
    _bind(blib, ("fedagg_norms_batched_int8",),
          [_VP, _VP, _VP, _VP, _INT, _I64, _VP, _VP, _VP])
    _bind(blib, ("fedagg_apply_batched_int8",),
          [_VP, _VP, _VP, _VP, _INT, _I64, _VP, _VP])
    _bind(blib, ("fedagg_norms_batched_scratch",), [_I64, _INT], _I64)
    _bind(blib, ("fedagg_batched_max_b", "fedagg_batched_init"), [])
    if blib.fedagg_batched_max_b() != MAX_BATCH:
        raise RuntimeError("fedagg_batched.cu and MAX_BATCH disagree")
    _batched_ready(torch.device("cuda", torch.cuda.current_device()),
                   (lib, blib))
    return lib, blib


@functools.lru_cache(maxsize=None)
def _batched_ready(device: torch.device, libs) -> None:
    """Let the batched norms kernel use its shared memory on ``device``:
    the attribute is set per device, on the current one when the libraries
    load and on any other at its first burst (an eager call, as the
    ticket's first is, so that no captured launch makes it)."""
    lib, blib = libs
    with torch.cuda.device(device):
        err = blib.fedagg_batched_init()
    if err:
        raise RuntimeError(f"fedagg_batched_init failed on {device}: "
                           f"{lib.fedagg_error_string(err).decode()}")


def _raise_on(err: int, what: str) -> None:
    if err:
        lib = load_libraries()[0]
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.fedagg_error_string(err).decode()}")


def _norms_buffer(lib: ctypes.CDLL, x_t: torch.Tensor):
    """(out (2,) followed by the per-block partials, in one allocation;
    the device's ticket) for a single norms sweep over x_t."""
    buf = torch.empty(2 + 2 * lib.fedagg_norms_blocks(x_t.shape[0]),
                      dtype=torch.float32, device=x_t.device)
    return buf, _ticket(x_t.device)


@functools.lru_cache(maxsize=None)
def _ticket(device: torch.device) -> torch.Tensor:
    """The single norms sweeps' ticket on ``device``: one int32, zeroed here
    once and left at 0 by every sweep (the block that draws the last ticket
    folds the partials and resets it), so that a CUDA graph may replay a
    sweep. The sweeps of a device share it, so they must run one after
    another: the server issues every sweep on ``build.stream(device)``, one
    stream. Made outside graph capture, by an eager first call."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the norms sweeps' ticket is made by a first "
                           "call outside CUDA graph capture")
    ticket = torch.zeros(1, dtype=torch.int32, device=device)
    torch.cuda.current_stream(device).synchronize()
    return ticket


# ---------------------------------------------------------------- wrappers --

def fedagg_norms(x_t: torch.Tensor, x_stale: torch.Tensor,
                 delta: torch.Tensor) -> torch.Tensor:
    """[||x_t - x_stale||^2, ||delta||^2] as a (2,) f32 tensor on the
    inputs' device. x_t, x_stale f32, delta f32 or bf16 (upcast on load),
    all flat (n,) with n a multiple of ``BLOCK``.

    Replaces the JAX package's ``kernels/fedagg/fedagg.py::fedagg_norms``
    (``_norms_kernel``). Bound by device memory: it reads 12 bytes per
    element (8 + 2 for a bf16 delta) and does 5 flops on them
    (:func:`norms_work`). The kernel streams 16-byte loads in a grid-stride
    loop, sums in registers, reduces each block with warp shuffles and
    writes one partial per block; in the same launch the block that draws
    the last ticket of the device's integer counter (:func:`_ticket`)
    folds the partials in a fixed order and resets the ticket. A call is
    one launch, and the result is the same to the bit on every run (no
    float atomics).
    """
    _check_inputs(x_t, [("x_stale", x_stale, _F32),
                        ("delta", delta, _DELTA_DTYPES)])
    if x_t.device.type == "cpu":
        return norms_plain(x_t, x_stale, delta)
    lib = load_libraries()[0]
    buf, ticket = _norms_buffer(lib, x_t)
    fn = (lib.fedagg_norms_f32 if delta.dtype == torch.float32
          else lib.fedagg_norms_bf16)
    err = fn(x_t.data_ptr(), x_stale.data_ptr(), delta.data_ptr(),
             buf.data_ptr() + 8, ticket.data_ptr(), buf.data_ptr(),
             x_t.shape[0], build.stream(x_t.device))
    _raise_on(err, "fedagg_norms")
    fedagg_norms.launches += 1
    return buf[:2]


def fedagg_axpy(x_t: torch.Tensor, delta: torch.Tensor,
                eta: torch.Tensor) -> torch.Tensor:
    """x_t + eta * delta into a NEW f32 tensor. ``eta`` is a one-element
    f32 tensor on the same device, read by the kernel, so nothing waits on
    the host between the norms sweep and this one.

    Replaces the JAX package's ``kernels/fedagg/fedagg.py::fedagg_axpy``
    (``_axpy_kernel``). Bound by device memory: it reads x_t and delta and
    writes the result, 12 bytes per element, for 2 flops (0.96 ms at 2^28
    and 3.35 TB/s). Each kernel thread reads one float4 of x_t and of
    delta and writes one, in a single pass with no loop, over as many
    blocks of 256 threads as the input needs, so the block scheduler spreads
    them over the SMs. The multiply and the add round separately, as
    the plain version does. It never works in place: the ring GMIS keeps
    every past flat vector and the clients hold views of the current one.
    """
    _check_inputs(x_t, [("delta", delta, _DELTA_DTYPES)])
    _check_eta(eta, (), x_t)
    if x_t.device.type == "cpu":
        return axpy_plain(x_t, delta, eta)
    lib = load_libraries()[0]
    eta = eta.reshape(1).contiguous()
    out = torch.empty_like(x_t)
    fn = (lib.fedagg_axpy_f32 if delta.dtype == torch.float32
          else lib.fedagg_axpy_bf16)
    err = fn(x_t.data_ptr(), delta.data_ptr(), eta.data_ptr(), out.data_ptr(),
             x_t.shape[0], build.stream(x_t.device))
    _raise_on(err, "fedagg_axpy")
    fedagg_axpy.launches += 1
    return out


def fedagg_fused(x_t: torch.Tensor, x_stale: torch.Tensor,
                 delta: torch.Tensor, eta: torch.Tensor):
    """(x_t + eta * delta into a NEW f32 tensor, [||x_t - x_stale||^2,
    ||delta||^2] as a (2,) f32 tensor) in one sweep; inputs as for
    :func:`fedagg_norms` and ``eta`` as for :func:`fedagg_axpy`.

    Replaces the JAX package's ``kernels/fedagg/fedagg.py::fedagg_fused``
    (``_fused_kernel``), the single-pass variant for an eta known before
    the sweep. Bound by device memory: it reads x_t, x_stale and delta and
    writes the result, 16 bytes per element, for 7 flops. It is the
    :func:`fedagg_norms` kernel that also writes the AXPY: the sums are the
    same code in the same order and the output rounds as
    :func:`fedagg_axpy`'s, so both outputs equal those two wrappers' to the
    bit. One call is one CUDA launch: the sweep and, in its last block, the
    fixed-order fold.
    """
    _check_inputs(x_t, [("x_stale", x_stale, _F32),
                        ("delta", delta, _DELTA_DTYPES)])
    _check_eta(eta, (), x_t)
    if x_t.device.type == "cpu":
        return fused_plain(x_t, x_stale, delta, eta)
    lib = load_libraries()[0]
    eta = eta.reshape(1).contiguous()
    buf, ticket = _norms_buffer(lib, x_t)
    out = torch.empty_like(x_t)
    fn = (lib.fedagg_fused_f32 if delta.dtype == torch.float32
          else lib.fedagg_fused_bf16)
    err = fn(x_t.data_ptr(), x_stale.data_ptr(), delta.data_ptr(),
             eta.data_ptr(), out.data_ptr(), buf.data_ptr() + 8,
             ticket.data_ptr(), buf.data_ptr(), x_t.shape[0],
             build.stream(x_t.device))
    _raise_on(err, "fedagg_fused")
    fedagg_fused.launches += 1
    return out, buf[:2]


def fedagg_norms_q(x_t: torch.Tensor, x_stale: torch.Tensor, q: torch.Tensor,
                   scales: torch.Tensor) -> torch.Tensor:
    """:func:`fedagg_norms` with the delta in int8 wire form: ``q`` (n,)
    int8 and ``scales`` (n // QBLOCK,) f32. The emitted ||delta||^2 is the
    norm of the DEQUANTIZED delta, exactly what :func:`fedagg_axpy_q`
    applies.

    Replaces the JAX package's ``kernels/fedagg/fedagg.py::fedagg_norms_q``
    (``_norms_q_kernel``). Bound by device memory: about 9 bytes per element
    (x_t, x_stale, one byte of q, a scale per 1024 elements). It is the
    :func:`fedagg_norms` kernel with the int8 loader: four q values in one
    4-byte load, each times its block's scale in registers, so the f32
    delta never exists in device memory; one launch, as
    :func:`fedagg_norms`.
    """
    n = x_t.shape[0] if isinstance(x_t, torch.Tensor) and x_t.dim() else 0
    _check_inputs(x_t, [("x_stale", x_stale, _F32),
                        ("q", q, (torch.int8,)),
                        ("scales", scales, _F32, (n // QBLOCK,))])
    if x_t.device.type == "cpu":
        return norms_q_plain(x_t, x_stale, q, scales)
    lib = load_libraries()[0]
    buf, ticket = _norms_buffer(lib, x_t)
    err = lib.fedagg_norms_int8(x_t.data_ptr(), x_stale.data_ptr(),
                                q.data_ptr(), scales.data_ptr(),
                                buf.data_ptr() + 8, ticket.data_ptr(),
                                buf.data_ptr(), n, build.stream(x_t.device))
    _raise_on(err, "fedagg_norms_q")
    fedagg_norms_q.launches += 1
    return buf[:2]


def fedagg_axpy_q(x_t: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                  eta: torch.Tensor) -> torch.Tensor:
    """x_t + eta * dequant(q, scales) into a NEW f32 tensor; ``eta`` as for
    :func:`fedagg_axpy`.

    Replaces the JAX package's ``kernels/fedagg/fedagg.py::fedagg_axpy_q``
    (``_axpy_q_kernel``). Bound by device memory: about 9 bytes per element.
    It is the :func:`fedagg_axpy` kernel, launch shape included, with the
    int8 loader; the dequantizing multiply, the multiply by eta and the add
    each round on their own, as the plain version does, so the two agree to
    the bit.
    """
    n = x_t.shape[0] if isinstance(x_t, torch.Tensor) and x_t.dim() else 0
    _check_inputs(x_t, [("q", q, (torch.int8,)),
                        ("scales", scales, _F32, (n // QBLOCK,))])
    _check_eta(eta, (), x_t)
    if x_t.device.type == "cpu":
        return axpy_q_plain(x_t, q, scales, eta)
    lib = load_libraries()[0]
    eta = eta.reshape(1).contiguous()
    out = torch.empty_like(x_t)
    err = lib.fedagg_axpy_int8(x_t.data_ptr(), q.data_ptr(),
                               scales.data_ptr(), eta.data_ptr(),
                               out.data_ptr(), n, build.stream(x_t.device))
    _raise_on(err, "fedagg_axpy_q")
    fedagg_axpy_q.launches += 1
    return out


def norms_batched_packed(x_t: torch.Tensor, x_stales: Sequence[torch.Tensor],
                         deltas: torch.Tensor,
                         scales: torch.Tensor = None) -> torch.Tensor:
    """The launch behind :func:`fedagg_norms_batched` and, for int8
    ``deltas`` with their (B, n // QBLOCK) ``scales``,
    :func:`fedagg_norms_batched_q`: the four outputs packed in one
    (2B + 2B^2,) f32 tensor, [dist0_sq, dn_sq, cross, gram]
    (:func:`split_batched` unpacks it), so a caller copies them to the host
    in one transfer. ``x_stales`` is B (n,) f32 tensors, or a (B, n) tensor
    as its rows: the kernel reads each where it lies, through a table of
    row pointers, and a row may repeat. Counts as a launch of the wrapper
    of its delta form."""
    b = deltas.shape[0] if isinstance(deltas, torch.Tensor) else 0
    _check_batch(b)
    n = x_t.shape[0] if isinstance(x_t, torch.Tensor) and x_t.dim() else 0
    quant = scales is not None
    _check_inputs(x_t, [("deltas", deltas, (torch.int8,), (b, n)),
                        ("scales", scales, _F32, (b, n // QBLOCK))] if quant
                  else [("deltas", deltas, _DELTA_DTYPES, (b, n))])
    rows = _stale_rows(x_t, x_stales, b)
    if x_t.device.type == "cpu":
        # the plain versions take a (B, n) stack: on the CPU the rows are
        # copied into one, counted as the server's staging copies are (each
        # byte read once and written once); the kernel reads them in place
        xs = torch.stack(rows)
        tracing.count("server.copy_bytes", 8 * xs.numel())
        dist, dn, cross, gram = (
            norms_batched_q_plain(x_t, xs, deltas, scales) if quant
            else norms_batched_plain(x_t, xs, deltas))
        return torch.cat([dist, dn, cross.reshape(-1), gram.reshape(-1)])
    libs = load_libraries()
    blib = libs[1]
    _batched_ready(x_t.device, libs)
    out_len = 2 * b + 2 * b * b
    buf = torch.empty(out_len + blib.fedagg_norms_batched_scratch(n, b),
                      dtype=torch.float32, device=x_t.device)
    # the launcher copies this host table into the kernel's parameters
    table = (ctypes.c_void_p * b)(*(row.data_ptr() for row in rows))
    tail = (b, n, buf.data_ptr() + 4 * out_len, buf.data_ptr(),
            build.stream(x_t.device))
    if quant:
        err = blib.fedagg_norms_batched_int8(
            x_t.data_ptr(), table, deltas.data_ptr(), scales.data_ptr(),
            *tail)
        _raise_on(err, "fedagg_norms_batched_q")
        fedagg_norms_batched_q.launches += 1
    else:
        fn = (blib.fedagg_norms_batched_f32 if deltas.dtype == torch.float32
              else blib.fedagg_norms_batched_bf16)
        err = fn(x_t.data_ptr(), table, deltas.data_ptr(), *tail)
        _raise_on(err, "fedagg_norms_batched")
        fedagg_norms_batched.launches += 1
    return buf[:out_len]


def fedagg_norms_batched(x_t: torch.Tensor, x_stales: Sequence[torch.Tensor],
                         deltas: torch.Tensor):
    """One sweep over B arrivals: (dist0_sq (B,), dn_sq (B,), cross (B, B),
    gram (B, B)) f32, with cross[b, k] = <x_t - x_stales[b], deltas[k]> and
    gram[k, l] = <deltas[k], deltas[l]>. x_t (n,) f32, x_stales B (n,) f32
    tensors or a (B, n) one (as its rows; a row may repeat), deltas (B, n)
    f32 or bf16, n a multiple of ``BLOCK``, 1 <= B <= ``MAX_BATCH``.

    Replaces the JAX package's
    ``kernels/fedagg/fedagg.py::fedagg_norms_batched``
    (``_norms_batched_kernel``). Bound by device memory: 4(2B+1) bytes per
    element against 3B^2 + 4B flops (:func:`norms_batched_work`), 8.9
    flop/byte at B = 23, under the f32 ridge. The kernel is a split-K
    product [S; D] D^T (S the B drifts): each block takes a contiguous
    range of the n elements and a panel of at most 64 x 64 outputs,
    stages its rows (each stale row through its pointer in a table passed
    among the launch's parameters, so no stack of the stales is copied) in
    double-buffered shared memory with the next stage's loads in flight,
    and each thread accumulates a 4 x 4 register tile over its range with
    no per-stage reduction; dist is summed by the threads that stage the
    drifts. A second, programmatic-dependent launch
    folds the blocks' partials, a warp per output in a fixed order.
    Bitwise repeatable, no float atomics, no TF32.
    """
    return split_batched(norms_batched_packed(x_t, x_stales, deltas),
                         deltas.shape[0])


def fedagg_apply_batched(x_t: torch.Tensor, deltas: torch.Tensor,
                         etas: torch.Tensor) -> torch.Tensor:
    """x_t + sum_b etas[b] * deltas[b] into a NEW f32 tensor. ``etas`` is a
    (B,) f32 tensor on the device of x_t.

    Replaces the JAX package's
    ``kernels/fedagg/fedagg.py::fedagg_apply_batched``
    (``_apply_batched_kernel``). Bound by device memory at model lengths: it
    reads 4(B+1) bytes per f32 element (2B + 4 with bf16 deltas) and writes
    4, for 2B flops (:func:`apply_batched_work`); at the paper's lengths,
    from L2, by the launch and the loads' latency. A kernel thread owns one
    slice of every delta row, 16 bytes at model lengths and one float4
    group at the paper's, and puts a register chunk's row loads (8 rows of
    f32, 16 of bf16) in flight, x_t's first, before it sums them, the next
    chunk's loads during the sum. It sums in the plain version's order,
    each multiply and add rounded on its own, so the two agree to the bit.
    One launch per call.
    """
    b = deltas.shape[0] if isinstance(deltas, torch.Tensor) else 0
    _check_batch(b)
    n = x_t.shape[0] if isinstance(x_t, torch.Tensor) and x_t.dim() else 0
    _check_inputs(x_t, [("deltas", deltas, _DELTA_DTYPES, (b, n))])
    _check_eta(etas, (b,), x_t)
    if x_t.device.type == "cpu":
        return apply_batched_plain(x_t, deltas, etas)
    blib = load_libraries()[1]
    etas = etas.contiguous()
    out = torch.empty_like(x_t)
    fn = (blib.fedagg_apply_batched_f32 if deltas.dtype == torch.float32
          else blib.fedagg_apply_batched_bf16)
    err = fn(x_t.data_ptr(), deltas.data_ptr(), etas.data_ptr(), b, n,
             out.data_ptr(), build.stream(x_t.device))
    _raise_on(err, "fedagg_apply_batched")
    fedagg_apply_batched.launches += 1
    return out


def fedagg_norms_batched_q(x_t: torch.Tensor,
                           x_stales: Sequence[torch.Tensor], qs: torch.Tensor,
                           scales: torch.Tensor):
    """:func:`fedagg_norms_batched` with the B deltas in int8 wire form:
    ``qs`` (B, n) int8 and ``scales`` (B, n // QBLOCK) f32. Every output is
    of the DEQUANTIZED deltas, exactly what :func:`fedagg_apply_batched_q`
    applies.

    Replaces the JAX package's
    ``kernels/fedagg/fedagg.py::fedagg_norms_batched_q``
    (``_norms_batched_q_kernel``). Bound by device memory: 4(B+1) + B bytes
    per element (x_t, the B stales, one byte of each q) against 3B^2 + 5B
    flops (:func:`norms_batched_work`). It is the
    :func:`fedagg_norms_batched` kernel with the int8 loader: each stage's
    int8 bytes and scales are copied into shared memory and dequantized
    there, so the f32 deltas never exist in device memory, and the fold is
    the same fixed-order one (bitwise repeatable).
    """
    return split_batched(norms_batched_packed(x_t, x_stales, qs, scales),
                         qs.shape[0])


def fedagg_apply_batched_q(x_t: torch.Tensor, qs: torch.Tensor,
                           scales: torch.Tensor,
                           etas: torch.Tensor) -> torch.Tensor:
    """x_t + sum_b etas[b] * dequant(qs[b], scales[b]) into a NEW f32
    tensor; ``qs`` (B, n) int8, ``scales`` (B, n // QBLOCK) f32, ``etas``
    (B,) f32 on the device of x_t.

    Replaces the JAX package's
    ``kernels/fedagg/fedagg.py::fedagg_apply_batched_q``
    (``_apply_batched_q_kernel``). Bound by device memory at model lengths:
    B + 4 bytes per element read (and a scale per ``QBLOCK``) and 4
    written, for 3B flops (:func:`apply_batched_work`). It is the
    :func:`fedagg_apply_batched` kernel with the int8 loader: a thread owns
    16 bytes of each row at model lengths and, at the paper's, 8 (4 for
    bursts past 16, so that more threads share the dequantizing); a block
    reads its B scales once into shared memory, and a byte becomes its
    float by a byte permute and an exact subtract. The dequantizing
    multiply and every multiply and add of the fixed-order sum round on
    their own, so it equals its plain version to the bit.
    """
    b = qs.shape[0] if isinstance(qs, torch.Tensor) else 0
    _check_batch(b)
    n = x_t.shape[0] if isinstance(x_t, torch.Tensor) and x_t.dim() else 0
    _check_inputs(x_t, [("qs", qs, (torch.int8,), (b, n)),
                        ("scales", scales, _F32, (b, n // QBLOCK))])
    _check_eta(etas, (b,), x_t)
    if x_t.device.type == "cpu":
        return apply_batched_q_plain(x_t, qs, scales, etas)
    blib = load_libraries()[1]
    etas = etas.contiguous()
    out = torch.empty_like(x_t)
    err = blib.fedagg_apply_batched_int8(
        x_t.data_ptr(), qs.data_ptr(), scales.data_ptr(), etas.data_ptr(), b,
        n, out.data_ptr(), build.stream(x_t.device))
    _raise_on(err, "fedagg_apply_batched_q")
    fedagg_apply_batched_q.launches += 1
    return out


KERNELS = (fedagg_norms, fedagg_axpy, fedagg_norms_batched,
           fedagg_apply_batched, fedagg_fused, fedagg_norms_q, fedagg_axpy_q,
           fedagg_norms_batched_q, fedagg_apply_batched_q)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


reset_launches()
