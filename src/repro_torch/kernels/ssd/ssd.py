"""The Mamba-2 SSD chunked scan (state-space duality, arXiv:2405.21060).

For each row (a batch and head) and each chunk of L steps, with ``cum`` the
within-chunk cumsum of ``dt * a`` and ``state`` the (P, N) state carried
from the chunks before (``h0``, zero when none is given):

    y[l]   = sum_{s <= l} (c_l . b_s) exp(cum[l] - cum[s]) dt_s x_s
             + exp(cum[l]) c_l state^T
    state' = exp(cum[L-1]) state + sum_s exp(cum[L-1] - cum[s]) dt_s x_s b_s^T

On a CUDA tensor :func:`ssd_scan` launches its hand-written kernel
(``csrc/ssd.cu``, built by ``nvcc`` for ``sm_90a`` at first use) or raises; on
a CPU tensor it runs :func:`ssd_scan_plain`. Nothing falls back from one to
the other. :func:`launch` is the same kernel on the model's layout, where the
heads of a group share its B and C in place (``kernels/ssd/ops.py``).
``ssd_scan.launches`` goes up by one per call that launches the kernel (four
CUDA launches: the score tiles, the chunk pass, the fold, the output pass),
through either entry. :func:`ssd_work` counts the bytes and operations the
function needs, for the kernel's bound.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

SOURCE = Path(__file__).with_name("csrc") / "ssd.cu"
#: the reference's default chunk (``kernels/ssd/ssd.py::DEFAULT_CHUNK``)
DEFAULT_CHUNK = 128
_F32 = (torch.float32,)
_VP, _INT = ctypes.c_void_p, ctypes.c_int


def chunk_of(chunk: int, s: int) -> int:
    """The chunk length the scan runs with: ``min(chunk, s)``, which must
    divide ``s`` (the reference asserts it; the port raises)."""
    chunk = min(chunk, s)
    if chunk < 1 or s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {chunk}")
    return chunk


def ssd_work(bs: int, s: int, h: int, p: int, g: int, n: int, chunk: int,
             with_h0: bool) -> Tuple[int, int]:
    """(bytes, flops) the scan must move and do on the model's layout at
    (B, S, H, P, G, N) with chunk ``min(chunk, S)``: x, dt, b, c, a (and
    h0) read once, y and the final state written; C B^T over the
    L (L + 1) / 2 causal pairs of each chunk once per group (2N flops each),
    the weighted W X over them per head (2P flops each), and the chunk's
    state and the state's term per head (2 L P N each)."""
    L = min(chunk, s)
    nc = s // L
    nbytes = 4 * (2 * bs * s * h * p + bs * s * h + 2 * bs * s * g * n + h
                  + bs * h * p * n * (2 if with_h0 else 1))
    flops = (bs * nc * g * L * (L + 1) * n
             + bs * h * nc * (4 * L * p * n + L * (L + 1) * p))
    return nbytes, flops


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, *,
                   chunk: int = DEFAULT_CHUNK,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (BH, S, P) in x's dtype, final state (BH, P, N) f32): the JAX
    package's ``_ssd_kernel`` in f32, one chunk after another, on the
    (BH, S, P) row layout."""
    bh, s, p = x.shape
    n = b.shape[-1]
    chunk = chunk_of(chunk, s)
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    af = a.float()
    state = (torch.zeros((bh, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    ys = []
    for k in range(s // chunk):
        sl = slice(k * chunk, (k + 1) * chunk)
        xk, dtk, bk, ck = xf[:, sl], dtf[:, sl], bf[:, sl], cf[:, sl]
        da_cum = torch.cumsum(dtk * af[:, None], dim=1)              # (BH, L)
        seg = da_cum[:, :, None] - da_cum[:, None, :]                # (BH, L, L)
        # masked before the exp: above the diagonal seg is positive and
        # exp(seg) can overflow, and 0 * inf would poison the VJP
        lmat = torch.exp(torch.where(causal, seg, float("-inf")))
        scores = ck @ bk.transpose(1, 2)                             # (BH, L, L)
        xdt = xk * dtk[..., None]                                    # (BH, L, P)
        y_diag = (scores * lmat) @ xdt
        y_off = torch.exp(da_cum)[..., None] * (ck @ state.transpose(1, 2))
        ys.append(y_diag + y_off)
        decay_states = torch.exp(da_cum[:, -1:] - da_cum)            # (BH, L)
        chunk_state = (xdt * decay_states[..., None]).transpose(1, 2) @ bk
        state = torch.exp(da_cum[:, -1])[:, None, None] * state + chunk_state
    return torch.cat(ys, dim=1).to(x.dtype), state


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/ssd.cu``."""
    lib = build.load(SOURCE)
    lib.ssd_scan_f32.argtypes = [_VP] * 6 + [_INT] * 7 + [_VP] * 4
    lib.ssd_scan_f32.restype = _INT
    lib.ssd_scratch_floats.argtypes = [_INT] * 7
    lib.ssd_scratch_floats.restype = ctypes.c_int64
    for name in ("ssd_max_p", "ssd_max_n", "ssd_max_chunk", "ssd_init"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = _INT
    lib.ssd_error_string.argtypes = [_INT]
    lib.ssd_error_string.restype = ctypes.c_char_p
    _ready(torch.device("cuda", torch.cuda.current_device()), lib)
    return lib


@functools.lru_cache(maxsize=None)
def _ready(device: torch.device, lib: ctypes.CDLL) -> None:
    """Let the chunk and output passes take their shared memory on
    ``device``: the attribute is set per device, on the current one when
    the library loads and on any other at its first scan (the pod engine
    trains on several cards)."""
    with torch.cuda.device(device):
        err = lib.ssd_init()
    if err:
        raise RuntimeError(f"ssd_init failed on {device}: "
                           f"{lib.ssd_error_string(err).decode()}")


def launch(x: torch.Tensor, dt: torch.Tensor, a_rows: torch.Tensor,
           b: torch.Tensor, c: torch.Tensor, *, chunk: int,
           h0: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on the model's layout, CUDA tensors only: x (B, S, H, P),
    dt (B, S, H), a_rows (B * H,) (head h of batch i at i * H + h), b and c
    (B, S, G, N), h0 (B, H, P, N) or None, all f32 and contiguous. Returns
    (y (B, S, H, P), final state (B, H, P, N)), both f32. Head h reads
    group h // (H // G) in place.

    Bound by operations (f32 outside the tensor cores): at the mamba2-1.3b
    serve shape 26.07 GFLOP of causal work, C B^T counted once per group
    (:func:`ssd_work`), against 0.29 GB that the function must move. A
    first pass writes the causal 64 x 64 tiles of C B^T once per (batch,
    chunk, group); a chunk pass writes each chunk's cumsum and state
    contribution; a fold runs the chunks in order from ``h0``; and an
    output pass forms each 64-row query tile from the C tile against the
    chunk's starting state, then from the group's score tiles on or below
    the diagonal turned into the head's weights against x
    (``csrc/ssd.cu``). No atomics: the same bits on every run.
    """
    if not isinstance(x, torch.Tensor) or x.dim() != 4:
        raise ValueError("x must be a (B, S, H, P) tensor")
    bs, s, h, p = x.shape
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"launch takes CUDA tensors, got {dev}")
    if not isinstance(b, torch.Tensor) or b.dim() != 4:
        raise ValueError("b must be a (B, S, G, N) tensor")
    g, n = b.shape[2], b.shape[3]
    if h % g:
        raise ValueError(f"{h} heads do not split into {g} groups")
    chunk = chunk_of(chunk, s)
    lib = load_library()
    _ready(dev, lib)
    if (p > lib.ssd_max_p() or n > lib.ssd_max_n()
            or chunk > lib.ssd_max_chunk()):
        raise ValueError(f"the kernel takes P <= {lib.ssd_max_p()}, N <= "
                         f"{lib.ssd_max_n()} and a chunk <= "
                         f"{lib.ssd_max_chunk()}; got P {p}, N {n}, chunk "
                         f"{chunk}")
    build.check_tensor("x", x, _F32, (bs, s, h, p), dev)
    build.check_tensor("dt", dt, _F32, (bs, s, h), dev)
    build.check_tensor("a", a_rows, _F32, (bs * h,), dev)
    build.check_tensor("b", b, _F32, (bs, s, g, n), dev)
    build.check_tensor("c", c, _F32, (bs, s, g, n), dev)
    if h0 is not None:
        build.check_tensor("h0", h0, _F32, (bs, h, p, n), dev)
    scratch = torch.empty(
        lib.ssd_scratch_floats(bs, s, h, g, p, n, chunk),
        dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    final = torch.empty((bs, h, p, n), dtype=torch.float32, device=dev)
    err = lib.ssd_scan_f32(x.data_ptr(), dt.data_ptr(), a_rows.data_ptr(),
                           b.data_ptr(), c.data_ptr(),
                           None if h0 is None else h0.data_ptr(),
                           bs, s, h, g, p, n, chunk, scratch.data_ptr(),
                           y.data_ptr(), final.data_ptr(), build.stream(dev))
    if err:
        raise RuntimeError("ssd_scan launch failed: "
                           f"{lib.ssd_error_string(err).decode()}")
    ssd_scan.launches += 1
    return y, final


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = DEFAULT_CHUNK,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (BH, S, P), dt (BH, S), a (BH,), b and c (BH, S, N), h0 (BH, P, N)
    or None, all f32. Returns (y (BH, S, P), final state (BH, P, N) f32).

    Replaces the JAX package's ``kernels/ssd/ssd.py::ssd_scan``
    (``_ssd_kernel``), which starts from a zero state; ``h0`` is the
    model's starting state (``models/ssm.py::ssd_chunked``'s
    ``initial_state``), and ``h0=None`` is the TPU kernel's function. The
    kernel is :func:`launch` with one head per row.
    """
    if not isinstance(x, torch.Tensor) or x.dim() != 3:
        raise ValueError("x must be a (BH, S, P) tensor")
    bh, s, p = x.shape
    n = b.shape[-1] if isinstance(b, torch.Tensor) and b.dim() == 3 else -1
    dev = x.device
    build.check_tensor("x", x, _F32, (bh, s, p), dev)
    build.check_tensor("dt", dt, _F32, (bh, s), dev)
    build.check_tensor("a", a, _F32, (bh,), dev)
    build.check_tensor("b", b, _F32, (bh, s, n), dev)
    build.check_tensor("c", c, _F32, (bh, s, n), dev)
    if h0 is not None:
        build.check_tensor("h0", h0, _F32, (bh, p, n), dev)
    if dev.type == "cpu":
        return ssd_scan_plain(x, dt, a, b, c, chunk=chunk, h0=h0)
    y, final = launch(x[:, :, None], dt[:, :, None], a, b[:, :, None],
                      c[:, :, None], chunk=chunk,
                      h0=None if h0 is None else h0[:, None])
    return y[:, :, 0], final[:, 0]


ssd_scan.launches = 0
KERNELS = (ssd_scan,)
