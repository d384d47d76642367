"""Mamba-2 SSD on the model's layout, over the hand-written kernel.

The counterpart of the JAX package's ``kernels/ssd/ops.py::
ssd_chunked_pallas``, with the model's starting state: x (B, S, H, P),
dt (B, S, H), a (H,), grouped b and c (B, S, G, N), and an optional
``initial_state`` (B, H, P, N). On CUDA the kernel reads these layouts in
place, each head its group's B and C (``ssd.launch``); on the CPU
:func:`ssd_rows_plain` repeats the groups to heads and flattens the rows,
as the reference's wrapper does, for the kernel's plain version.

:class:`SSDScan` makes the scan a differentiable function that
``torch.func`` can transform: its forward is the kernel on CUDA (the plain
version on the CPU), its backward the VJP of the plain version recomputed
from the saved inputs (the JAX package differentiates its plain scan; it
has no backward kernel), and its vmap rule folds a vmapped client axis into
the kernel's batch axis, so one launch scans a whole cohort.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd import ssd


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous()


def ssd_rows_plain(x: torch.Tensor, dt: torch.Tensor, a_rows: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, chunk: int,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function on the model's layout through
    ``ssd.ssd_scan_plain``, on any device: ``a_rows`` (B * H,) holds head h
    of batch i at i * H + h, as ``ssd.launch`` takes it. Returns (y (B, S,
    H, P) in x's dtype, final state (B, H, P, N) f32)."""
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rows = bs * h
    to_rows = lambda t: _f32(torch.repeat_interleave(t, h // g, dim=2)
                             .transpose(1, 2).reshape(rows, s, n))
    y, st = ssd.ssd_scan_plain(
        _f32(x.transpose(1, 2).reshape(rows, s, p)),
        _f32(dt.transpose(1, 2).reshape(rows, s)), _f32(a_rows),
        to_rows(b), to_rows(c), chunk=chunk,
        h0=None if h0 is None else _f32(h0).reshape(rows, p, n))
    return (y.reshape(bs, h, s, p).transpose(1, 2).to(x.dtype),
            st.reshape(bs, h, p, n))


def ssd_chunked_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, c: torch.Tensor, chunk: int,
                      initial_state: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssd_chunked` through ``ssd.ssd_scan_plain`` on any device:
    the reference wrapper's layout changes around the kernel's plain
    version."""
    return ssd_rows_plain(x, dt, _f32(a).repeat(x.shape[0]), b, c, chunk,
                          initial_state)


class SSDScan(torch.autograd.Function):
    """``(y, final_state) = SSDScan.apply(x, dt, a_rows, b, c, h0, chunk)``
    on the layouts of ``ssd.launch``: x (B, S, H, P), dt (B, S, H), a_rows
    (B * H,), b and c (B, S, G, N), h0 (B, H, P, N) or None, all f32 and
    contiguous; ``chunk`` cut to S already.

    * forward: on CUDA the kernel, always (a build or launch failure
      raises); on the CPU :func:`ssd_rows_plain`;
    * backward: the VJP of :func:`ssd_rows_plain` at the saved inputs,
      through ``torch.func.vjp``, so that it runs under
      ``vmap(grad_and_value(...))`` too; gradients reach x, dt, a_rows, b,
      c and h0;
    * vmap: the client axis folds into the batch axis, (C, B, ...) ->
      (C * B, ...) and a_rows (C, B * H) -> (C * B * H,), whose rows then
      keep their per-client ``a``; one call (one launch on CUDA) scans every
      client.
    """

    @staticmethod
    def forward(x, dt, a_rows, b, c, h0, chunk):
        if x.device.type == "cuda":
            return ssd.launch(x, dt, a_rows, b, c, chunk=chunk, h0=h0)
        return ssd_rows_plain(x, dt, a_rows, b, c, chunk, h0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dt, a_rows, b, c, h0, chunk = inputs
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, a_rows, b, c, h0)

    @staticmethod
    def backward(ctx, gy, gstate):
        x, dt, a_rows, b, c, h0 = ctx.saved_tensors
        chunk = ctx.chunk
        if h0 is None:
            _, vjp = torch.func.vjp(
                lambda *t: ssd_rows_plain(*t, chunk), x, dt, a_rows, b, c)
            return (*vjp((gy, gstate)), None, None)
        _, vjp = torch.func.vjp(
            lambda x, dt, a, b, c, h0: ssd_rows_plain(x, dt, a, b, c, chunk,
                                                      h0),
            x, dt, a_rows, b, c, h0)
        return (*vjp((gy, gstate)), None)

    @staticmethod
    def vmap(info, in_dims, x, dt, a_rows, b, c, h0, chunk):
        n = info.batch_size
        args = [build.fold_vmapped(t, d, n)
                for t, d in zip((x, dt, a_rows, b, c, h0), in_dims)]
        y, st = SSDScan.apply(*args, chunk)
        return ((y.reshape(n, -1, *y.shape[1:]),
                 st.reshape(n, -1, *st.shape[1:])), (0, 0))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N) f32).
    The scan runs in f32 whatever x's dtype; ``chunk`` is cut to S, and S
    must be a multiple of it. Through :class:`SSDScan`: the kernel on CUDA,
    its plain version on the CPU, differentiable and vmappable on both."""
    chunk = ssd.chunk_of(chunk, x.shape[1])
    a_rows = _f32(a).repeat(x.shape[0])             # row i * H + h: a[h]
    y, st = SSDScan.apply(_f32(x), _f32(dt), a_rows, _f32(b), _f32(c),
                          None if initial_state is None
                          else _f32(initial_state), chunk)
    return y.to(x.dtype), st
