"""The AsyncFedED server's sweeps over the padded flat model.

  one arrival   fedagg_norms : one pass over (x_t, x_stale, delta) emitting
                [||x_t - x_stale||^2, ||delta||^2] -> gamma, eta (Eq. 6/7);
                fedagg_axpy  : one pass computing x_t + eta * delta (Eq. 5).
  int8 wire     fedagg_norms_q / fedagg_axpy_q : the same two sweeps with the
                delta as int8 ``q`` and one f32 scale per ``QBLOCK`` elements,
                dequantized in registers.
  a burst of B  fedagg_norms_batched : one pass over x_t and B stacked
                (stale, delta) pairs emitting every norm, cross term and
                Gram entry the sequential-equivalence schedule needs;
                fedagg_apply_batched : one pass computing
                x_t + sum_b eta_b * delta_b.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/fedagg.cu`` and ``csrc/fedagg_batched.cu``, built by ``nvcc`` for
``sm_90a`` at first use, both at once) or raises; on a CPU tensor it runs its
plain PyTorch version beside it (``*_plain``). Nothing falls back from one to
the other. Each wrapper adds one to ``<wrapper>.launches`` per call that
launches its kernel. The norms wrappers are one kernel in two CUDA launches
(per-block partials, then the fixed-order fold), counted once per call.

The batched pair takes f32 and bf16 deltas. Their int8 twins
(``fedagg_norms_batched_q`` / ``fedagg_apply_batched_q``) are not ported: an
int8 burst raises in ``ops.flat_aggregate_batched_q``.

``BLOCK = BLOCK_ROWS * LANES = 65536`` and ``QBLOCK = 1024`` are layout
constants of the flat state, not tile sizes of these kernels: the padded
length, checkpoints and wire shapes are defined by them in both packages.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import build

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


def split_batched(packed, b: int):
    """The batched norms' packed (2B + 2B^2,) output, as the four outputs
    (dist0_sq, dn_sq, cross, gram) of :func:`norms_batched_plain`. Works on a
    tensor or a numpy array; the parts are views."""
    return (packed[:b], packed[b:2 * b],
            packed[2 * b:2 * b + b * b].reshape(b, b),
            packed[2 * b + b * b:].reshape(b, b))


# ------------------------------------------------------------------ checks --

def _check_tensor(name: str, t: torch.Tensor, dtypes, shape,
                  device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_inputs(x_t: torch.Tensor, pairs) -> None:
    """x_t is a flat f32 (n,) with n a multiple of ``BLOCK``; each
    ``(name, tensor, dtypes[, shape])`` lies beside it, shape (n,) unless
    given."""
    if not isinstance(x_t, torch.Tensor) or x_t.dim() != 1:
        raise ValueError("x_t must be a flat (n,) tensor")
    n = x_t.shape[0]
    if n % BLOCK:
        raise ValueError(f"flat length {n} is not a multiple of {BLOCK}")
    _check_tensor("x_t", x_t, (torch.float32,), (n,), x_t.device)
    for name, t, dtypes, *shape in pairs:
        _check_tensor(name, t, dtypes, shape[0] if shape else (n,),
                      x_t.device)


def _check_batch(b: int) -> None:
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f"a burst of {b} arrivals: the batched kernels take "
                         f"1 to {MAX_BATCH}")


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
          [_VP, _VP, _VP, _VP, _VP, _I64, _VP])
    _bind(lib, ("fedagg_norms_int8",), [_VP, _VP, _VP, _VP, _VP, _VP, _I64,
                                        _VP])
    _bind(lib, ("fedagg_axpy_f32", "fedagg_axpy_bf16"),
          [_VP, _VP, _VP, _VP, _I64, _VP])
    _bind(lib, ("fedagg_axpy_int8",), [_VP, _VP, _VP, _VP, _VP, _I64, _VP])
    _bind(lib, ("fedagg_norms_blocks",), [_I64])
    _bind(lib, ("fedagg_error_string",), [_INT], ctypes.c_char_p)
    _bind(blib, ("fedagg_norms_batched_f32", "fedagg_norms_batched_bf16"),
          [_VP, _VP, _VP, _INT, _I64, _VP, _VP, _VP])
    _bind(blib, ("fedagg_apply_batched_f32", "fedagg_apply_batched_bf16"),
          [_VP, _VP, _VP, _INT, _I64, _VP, _VP])
    _bind(blib, ("fedagg_norms_batched_scratch",), [_I64, _INT], _I64)
    _bind(blib, ("fedagg_batched_max_b", "fedagg_batched_init"), [])
    if blib.fedagg_batched_max_b() != MAX_BATCH:
        raise RuntimeError("fedagg_batched.cu and MAX_BATCH disagree")
    err = blib.fedagg_batched_init()
    if err:
        raise RuntimeError("fedagg_batched_init failed: "
                           f"{lib.fedagg_error_string(err).decode()}")
    return lib, blib


def _stream(device: torch.device) -> int:
    """The current stream of ``device``, which must be the current device:
    a kernel launches on the device current to the calling thread."""
    if device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {device} but the current CUDA device "
                         f"is {torch.cuda.current_device()}: call under "
                         f"torch.cuda.device({device})")
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err:
        lib = load_libraries()[0]
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.fedagg_error_string(err).decode()}")


def _norms_buffer(lib: ctypes.CDLL, x_t: torch.Tensor) -> torch.Tensor:
    """out (2,) followed by the per-block partials, one allocation."""
    return torch.empty(2 + 2 * lib.fedagg_norms_blocks(x_t.shape[0]),
                       dtype=torch.float32, device=x_t.device)


# ---------------------------------------------------------------- wrappers --

def fedagg_norms(x_t: torch.Tensor, x_stale: torch.Tensor,
                 delta: torch.Tensor) -> torch.Tensor:
    """[||x_t - x_stale||^2, ||delta||^2] as a (2,) f32 tensor on the
    inputs' device. x_t, x_stale f32, delta f32 or bf16 (upcast on load),
    all flat (n,) with n a multiple of ``BLOCK``.

    Replaces the JAX package's ``kernels/fedagg/fedagg.py::fedagg_norms``
    (``_norms_kernel``). Bound by device memory: it reads 12 bytes per
    element (8 + 2 for a bf16 delta) and does 5 flops on them. The kernel
    streams 16-byte loads in a grid-stride loop, sums in registers, reduces
    each block with warp shuffles and writes one partial per block; a
    second one-block launch folds the partials in a fixed order, so the
    result is the same to the bit on every run (no float atomics). Its
    launch count goes up by one per call, for both launches.
    """
    _check_inputs(x_t, [("x_stale", x_stale, _F32),
                        ("delta", delta, _DELTA_DTYPES)])
    if x_t.device.type == "cpu":
        return norms_plain(x_t, x_stale, delta)
    lib = load_libraries()[0]
    buf = _norms_buffer(lib, x_t)
    fn = (lib.fedagg_norms_f32 if delta.dtype == torch.float32
          else lib.fedagg_norms_bf16)
    err = fn(x_t.data_ptr(), x_stale.data_ptr(), delta.data_ptr(),
             buf.data_ptr() + 8, buf.data_ptr(), x_t.shape[0],
             _stream(x_t.device))
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
    writes the result, 12 bytes per element, for 2 flops. The kernel
    streams 16-byte loads and stores in a grid-stride loop; the multiply
    and the add round separately, as the plain version does. It never
    works in place: the ring GMIS keeps every past flat vector and the
    clients hold views of the current one.
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
             x_t.shape[0], _stream(x_t.device))
    _raise_on(err, "fedagg_axpy")
    fedagg_axpy.launches += 1
    return out


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
    delta never exists in device memory.
    """
    n = x_t.shape[0] if isinstance(x_t, torch.Tensor) and x_t.dim() else 0
    _check_inputs(x_t, [("x_stale", x_stale, _F32),
                        ("q", q, (torch.int8,)),
                        ("scales", scales, _F32, (n // QBLOCK,))])
    if x_t.device.type == "cpu":
        return norms_q_plain(x_t, x_stale, q, scales)
    lib = load_libraries()[0]
    buf = _norms_buffer(lib, x_t)
    err = lib.fedagg_norms_int8(x_t.data_ptr(), x_stale.data_ptr(),
                                q.data_ptr(), scales.data_ptr(),
                                buf.data_ptr() + 8, buf.data_ptr(), n,
                                _stream(x_t.device))
    _raise_on(err, "fedagg_norms_q")
    fedagg_norms_q.launches += 1
    return buf[:2]


def fedagg_axpy_q(x_t: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                  eta: torch.Tensor) -> torch.Tensor:
    """x_t + eta * dequant(q, scales) into a NEW f32 tensor; ``eta`` as for
    :func:`fedagg_axpy`.

    Replaces the JAX package's ``kernels/fedagg/fedagg.py::fedagg_axpy_q``
    (``_axpy_q_kernel``). Bound by device memory: about 9 bytes per element.
    It is the :func:`fedagg_axpy` kernel with the int8 loader; the
    dequantizing multiply, the multiply by eta and the add each round on
    their own, as the plain version does, so the two agree to the bit.
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
                               out.data_ptr(), n, _stream(x_t.device))
    _raise_on(err, "fedagg_axpy_q")
    fedagg_axpy_q.launches += 1
    return out


def norms_batched_packed(x_t: torch.Tensor, x_stales: torch.Tensor,
                         deltas: torch.Tensor) -> torch.Tensor:
    """The launch behind :func:`fedagg_norms_batched`: its four outputs
    packed in one (2B + 2B^2,) f32 tensor, [dist0_sq, dn_sq, cross, gram]
    (:func:`split_batched` unpacks it), so a caller copies them to the host
    in one transfer. Counts as a launch of ``fedagg_norms_batched``."""
    b = deltas.shape[0] if isinstance(deltas, torch.Tensor) else 0
    _check_batch(b)
    n = x_t.shape[0] if isinstance(x_t, torch.Tensor) and x_t.dim() else 0
    _check_inputs(x_t, [("x_stales", x_stales, _F32, (b, n)),
                        ("deltas", deltas, _DELTA_DTYPES, (b, n))])
    if x_t.device.type == "cpu":
        dist, dn, cross, gram = norms_batched_plain(x_t, x_stales, deltas)
        return torch.cat([dist, dn, cross.reshape(-1), gram.reshape(-1)])
    blib = load_libraries()[1]
    out_len = 2 * b + 2 * b * b
    buf = torch.empty(out_len + blib.fedagg_norms_batched_scratch(n, b),
                      dtype=torch.float32, device=x_t.device)
    fn = (blib.fedagg_norms_batched_f32 if deltas.dtype == torch.float32
          else blib.fedagg_norms_batched_bf16)
    err = fn(x_t.data_ptr(), x_stales.data_ptr(), deltas.data_ptr(), b, n,
             buf.data_ptr() + 4 * out_len, buf.data_ptr(),
             _stream(x_t.device))
    _raise_on(err, "fedagg_norms_batched")
    fedagg_norms_batched.launches += 1
    return buf[:out_len]


def fedagg_norms_batched(x_t: torch.Tensor, x_stales: torch.Tensor,
                         deltas: torch.Tensor):
    """One sweep over B arrivals: (dist0_sq (B,), dn_sq (B,), cross (B, B),
    gram (B, B)) f32, with cross[b, k] = <x_t - x_stales[b], deltas[k]> and
    gram[k, l] = <deltas[k], deltas[l]>. x_t (n,) f32, x_stales (B, n) f32,
    deltas (B, n) f32 or bf16, n a multiple of ``BLOCK``, 1 <= B <=
    ``MAX_BATCH``.

    Replaces the JAX package's
    ``kernels/fedagg/fedagg.py::fedagg_norms_batched``
    (``_norms_batched_kernel``). Bound by device memory: 4(2B+1) bytes per
    element against about 4B^2 flops, 7.9 flop/byte at B = 15, under the
    f32 ridge. Too many sums for one thread's registers, so each block
    stages a chunk of the drifts and deltas in shared memory, its warps
    each own a fixed set of the dot products (gram's k <= l half only) and
    add each chunk's sum to an accumulator in shared memory; a second
    launch folds the blocks' partials in a fixed order. Bitwise repeatable,
    no float atomics, no TF32.
    """
    return split_batched(norms_batched_packed(x_t, x_stales, deltas),
                         deltas.shape[0])


def fedagg_apply_batched(x_t: torch.Tensor, deltas: torch.Tensor,
                         etas: torch.Tensor) -> torch.Tensor:
    """x_t + sum_b etas[b] * deltas[b] into a NEW f32 tensor. ``etas`` is a
    (B,) f32 tensor on the device of x_t.

    Replaces the JAX package's
    ``kernels/fedagg/fedagg.py::fedagg_apply_batched``
    (``_apply_batched_kernel``). Bound by device memory: it reads 4(B+1)
    bytes per element and writes 4, for 2B+1 flops. The kernel streams the
    B delta rows in a grid-stride loop and sums in the plain version's
    order, each multiply and add rounded on its own, so the two agree to
    the bit.
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
             out.data_ptr(), _stream(x_t.device))
    _raise_on(err, "fedagg_apply_batched")
    fedagg_apply_batched.launches += 1
    return out


KERNELS = (fedagg_norms, fedagg_axpy, fedagg_norms_batched,
           fedagg_apply_batched, fedagg_norms_q, fedagg_axpy_q)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


reset_launches()
