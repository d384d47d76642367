"""The AsyncFedED server's two sweeps over the padded flat model.

  phase 1  fedagg_norms : one pass over (x_t, x_stale, delta) emitting
           [||x_t - x_stale||^2, ||delta||^2] -> gamma, eta (Eq. 6/7).
  phase 2  fedagg_axpy  : one pass computing x_t + eta * delta (Eq. 5).

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/fedagg.cu``, built by ``nvcc`` for ``sm_90a`` at first use) or
raises; on a CPU tensor it runs its plain PyTorch version beside it
(``norms_plain``, ``axpy_plain``). Nothing falls back from one to the other.
Each wrapper adds one to ``<wrapper>.launches`` per call that launches its
kernel. ``fedagg_norms`` is one kernel in two CUDA launches (per-block
partials, then the fixed-order fold), counted once per call.

``BLOCK = BLOCK_ROWS * LANES = 65536`` and ``QBLOCK = 1024`` are layout
constants of the flat state, not tile sizes of these kernels: the padded
length, checkpoints and wire shapes are defined by them in both packages.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build

LANES = 128
BLOCK_ROWS = 512
BLOCK = BLOCK_ROWS * LANES             # flat vectors pad to a multiple of this
QBLOCK_ROWS = 8
QBLOCK = QBLOCK_ROWS * LANES           # elements per int8 scale on the wire

SOURCE = Path(__file__).with_name("csrc") / "fedagg.cu"

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


# ------------------------------------------------------------------ checks --

def _check_flat(name: str, t: torch.Tensor, dtypes, n: int,
                device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"{name} must have shape ({n},), got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_inputs(x_t: torch.Tensor, pairs) -> None:
    if not isinstance(x_t, torch.Tensor) or x_t.dim() != 1:
        raise ValueError("x_t must be a flat (n,) tensor")
    n = x_t.shape[0]
    if n % BLOCK:
        raise ValueError(f"flat length {n} is not a multiple of {BLOCK}")
    _check_flat("x_t", x_t, (torch.float32,), n, x_t.device)
    for name, t, dtypes in pairs:
        _check_flat(name, t, dtypes, n, x_t.device)


_DELTA_DTYPES = (torch.float32, torch.bfloat16)
_VP, _I64 = ctypes.c_void_p, ctypes.c_int64


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/fedagg.cu``."""
    lib = build.load(SOURCE)
    for fn in ("fedagg_norms_f32", "fedagg_norms_bf16"):
        getattr(lib, fn).argtypes = [_VP, _VP, _VP, _VP, _VP, _I64, _VP]
        getattr(lib, fn).restype = ctypes.c_int
    for fn in ("fedagg_axpy_f32", "fedagg_axpy_bf16"):
        getattr(lib, fn).argtypes = [_VP, _VP, _VP, _VP, _I64, _VP]
        getattr(lib, fn).restype = ctypes.c_int
    lib.fedagg_norms_blocks.argtypes = [_I64]
    lib.fedagg_norms_blocks.restype = ctypes.c_int
    lib.fedagg_error_string.argtypes = [ctypes.c_int]
    lib.fedagg_error_string.restype = ctypes.c_char_p
    return lib


def _stream(device: torch.device) -> int:
    """The current stream of ``device``, which must be the current device:
    a kernel launches on the device current to the calling thread."""
    if device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {device} but the current CUDA device "
                         f"is {torch.cuda.current_device()}: call under "
                         f"torch.cuda.device({device})")
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.fedagg_error_string(err).decode()}")


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
    _check_inputs(x_t, [("x_stale", x_stale, (torch.float32,)),
                        ("delta", delta, _DELTA_DTYPES)])
    if x_t.device.type == "cpu":
        return norms_plain(x_t, x_stale, delta)
    lib = load_library()
    n = x_t.shape[0]
    # out (2,) followed by the per-block partials, one allocation
    buf = torch.empty(2 + 2 * lib.fedagg_norms_blocks(n), dtype=torch.float32,
                      device=x_t.device)
    fn = (lib.fedagg_norms_f32 if delta.dtype == torch.float32
          else lib.fedagg_norms_bf16)
    err = fn(x_t.data_ptr(), x_stale.data_ptr(), delta.data_ptr(),
             buf.data_ptr() + 8, buf.data_ptr(), n, _stream(x_t.device))
    _raise_on(lib, err, "fedagg_norms")
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
    if (not isinstance(eta, torch.Tensor) or eta.numel() != 1
            or eta.dtype != torch.float32 or eta.device != x_t.device):
        raise TypeError("eta must be a one-element f32 tensor on the device "
                        "of x_t")
    if x_t.device.type == "cpu":
        return axpy_plain(x_t, delta, eta)
    lib = load_library()
    eta = eta.reshape(1).contiguous()
    out = torch.empty_like(x_t)
    fn = (lib.fedagg_axpy_f32 if delta.dtype == torch.float32
          else lib.fedagg_axpy_bf16)
    err = fn(x_t.data_ptr(), delta.data_ptr(), eta.data_ptr(), out.data_ptr(),
             x_t.shape[0], _stream(x_t.device))
    _raise_on(lib, err, "fedagg_axpy")
    fedagg_axpy.launches += 1
    return out


fedagg_norms.launches = 0
fedagg_axpy.launches = 0
KERNELS = (fedagg_norms, fedagg_axpy)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
