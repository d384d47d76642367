"""Mamba-2 SSD on the model's layout, over the hand-written kernel.

The counterpart of the JAX package's ``kernels/ssd/ops.py::
ssd_chunked_pallas``, with the model's starting state: x (B, S, H, P),
dt (B, S, H), a (H,), grouped b and c (B, S, G, N), and an optional
``initial_state`` (B, H, P, N). On CUDA the kernel reads these layouts in
place, each head its group's B and C (``ssd.launch``); on the CPU
:func:`ssd_chunked_plain` repeats the groups to heads and flattens the rows,
as the reference's wrapper does, for the kernel's plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssd import ssd


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous()


def ssd_chunked_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, c: torch.Tensor, chunk: int,
                      initial_state: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssd_chunked` through ``ssd.ssd_scan_plain`` on any device:
    the reference wrapper's layout changes around the kernel's plain
    version."""
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rows = bs * h
    to_rows = lambda t: _f32(torch.repeat_interleave(t, h // g, dim=2)
                             .transpose(1, 2).reshape(rows, s, n))
    y, st = ssd.ssd_scan_plain(
        _f32(x.transpose(1, 2).reshape(rows, s, p)),
        _f32(dt.transpose(1, 2).reshape(rows, s)), _f32(a).repeat(bs),
        to_rows(b), to_rows(c), chunk=chunk,
        h0=(None if initial_state is None
            else _f32(initial_state).reshape(rows, p, n)))
    return (y.reshape(bs, h, s, p).transpose(1, 2).to(x.dtype),
            st.reshape(bs, h, p, n))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N) f32).
    The scan runs in f32 whatever x's dtype; ``chunk`` is cut to S, and S
    must be a multiple of it. On CUDA through the kernel, on the CPU through
    its plain version."""
    if x.device.type == "cpu":
        return ssd_chunked_plain(x, dt, a, b, c, chunk, initial_state)
    a_rows = _f32(a).repeat(x.shape[0])             # row i * H + h: a[h]
    y, st = ssd.launch(_f32(x), _f32(dt), a_rows, _f32(b), _f32(c),
                       chunk=chunk,
                       h0=(None if initial_state is None
                           else _f32(initial_state)))
    return y.to(x.dtype), st
