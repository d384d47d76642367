"""The RG-LRU linear recurrence (Griffin / RecurrentGemma):

    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) xi_t,   a_t = exp(log_at),

per channel over the sequence axis of (B, S, W) inputs, from ``h0`` (zero
when none is given).

On a CUDA tensor :func:`rglru_scan` launches its hand-written kernel
(``csrc/rglru.cu``, built by ``nvcc`` for ``sm_90a`` at first use) or
raises; on a CPU tensor it runs :func:`rglru_scan_plain`, and on a meta
tensor (the dry run's trace) the same plain version computes shapes only.
Nothing falls back from one to the other. ``rglru_scan.launches`` goes up
by one per call that launches the kernel (one CUDA launch).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

SOURCE = Path(__file__).with_name("csrc") / "rglru.cu"
_DTYPES = (torch.float32, torch.bfloat16)
_VP, _INT = ctypes.c_void_p, ctypes.c_int


def rglru_scan_plain(log_at: torch.Tensor, xi: torch.Tensor,
                     h0: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h (B, S, W) in xi's dtype, last step (B, W) f32): the recurrence in
    f32, one step after another, as the JAX package's ``_rglru_kernel``
    runs it inside a chunk."""
    la = log_at.float()
    a = torch.exp(la)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * la), min=1e-12))
    bt = beta * xi.float()
    h = (torch.zeros_like(bt[:, 0]) if h0 is None else h0.float())
    hs = []
    for t in range(bt.shape[1]):
        h = a[:, t] * h + bt[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(xi.dtype), h


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/rglru.cu``."""
    lib = build.load(SOURCE)
    for name in ("rglru_scan_f32", "rglru_scan_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [_VP, _VP, _VP, _INT, _INT, _INT, _VP, _VP, _VP]
        fn.restype = _INT
    lib.rglru_error_string.argtypes = [_INT]
    lib.rglru_error_string.restype = ctypes.c_char_p
    return lib


def rglru_scan(log_at: torch.Tensor, xi: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """log_at (B, S, W) f32, xi (B, S, W) f32 or bf16, h0 (B, W) f32 or
    None. Returns (h (B, S, W) in xi's dtype, the last step (B, W) f32).

    Replaces the JAX package's ``kernels/rglru/rglru.py::rglru_scan``
    (``_rglru_kernel``), which starts from zero; ``h0`` is the model's
    starting state (``models/rglru.py`` folds it into the first step, the
    same function). Bound by device memory: 12 bytes per f32 element read
    and written for about 10 flops. The kernel reads each input once: a
    block streams S in order for 32 channels through a ring of ``cp.async``
    stages in shared memory, the whole block computes each stage's gates,
    and one thread per channel steps the recurrence in the plain version's
    order (no scratch, no atomics, the same bits every run).
    """
    if not isinstance(xi, torch.Tensor) or xi.dim() != 3:
        raise ValueError("xi must be a (B, S, W) tensor")
    b, s, w = xi.shape
    dev = xi.device
    build.check_tensor("log_at", log_at, (torch.float32,), (b, s, w), dev)
    build.check_tensor("xi", xi, _DTYPES, (b, s, w), dev)
    if h0 is not None:
        build.check_tensor("h0", h0, (torch.float32,), (b, w), dev)
    if dev.type in ("cpu", "meta"):
        return rglru_scan_plain(log_at, xi, h0)
    lib = load_library()
    out = torch.empty_like(xi)
    last = torch.empty((b, w), dtype=torch.float32, device=dev)
    fn = (lib.rglru_scan_f32 if xi.dtype == torch.float32
          else lib.rglru_scan_bf16)
    err = fn(log_at.data_ptr(), xi.data_ptr(),
             None if h0 is None else h0.data_ptr(), b, s, w, out.data_ptr(),
             last.data_ptr(), build.stream(dev))
    if err:
        raise RuntimeError("rglru_scan launch failed: "
                           f"{lib.rglru_error_string(err).decode()}")
    rglru_scan.launches += 1
    return out, last


rglru_scan.launches = 0
KERNELS = (rglru_scan,)
