"""The RG-LRU recurrence from the model's gates, over the hand-written
kernel.

The counterpart of the JAX package's ``kernels/rglru/ops.py::rglru_pallas``:
the gate prologue ``log a_t = c * r_t * log sigmoid(Lambda)`` and the gated
input ``xi = i_t * x_t`` in PyTorch, then the recurrence through
:class:`RGLRUScan`: the kernel of
:func:`repro_torch.kernels.rglru.rglru.rglru_scan` forward, the VJP of its
plain version backward (the JAX package differentiates its plain scan; it
has no backward kernel), and a vmap rule that folds a vmapped client axis
into the kernel's batch axis.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.rglru.rglru import rglru_scan, rglru_scan_plain

#: the exponent's scale c in a_t = a^(c r_t) (Griffin)
RGLRU_C = 8.0


class RGLRUScan(torch.autograd.Function):
    """``(h, last) = RGLRUScan.apply(log_at, xi, h0)``: log_at (B, S, W)
    f32, xi (B, S, W) f32 or bf16, h0 (B, W) f32 or None, all contiguous.

    * forward: ``rglru_scan``, which launches the kernel on CUDA (a build
      or launch failure raises) and runs the plain version on the CPU;
    * backward: the VJP of ``rglru_scan_plain`` at the saved inputs through
      ``torch.func.vjp``, so that it runs under ``vmap(grad_and_value(...))``
      too;
    * vmap: (C, B, S, W) -> (C * B, S, W) and h0 (C, B, W) -> (C * B, W),
      one call (one launch on CUDA) for every client.
    """

    @staticmethod
    def forward(log_at, xi, h0):
        return rglru_scan(log_at, xi, h0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, gh, glast):
        log_at, xi, h0 = ctx.saved_tensors
        if h0 is None:
            _, vjp = torch.func.vjp(rglru_scan_plain, log_at, xi)
            return (*vjp((gh, glast)), None)
        _, vjp = torch.func.vjp(rglru_scan_plain, log_at, xi, h0)
        return vjp((gh, glast))

    @staticmethod
    def vmap(info, in_dims, log_at, xi, h0):
        n = info.batch_size
        args = [build.fold_vmapped(t, d, n)
                for t, d in zip((log_at, xi, h0), in_dims)]
        h, last = RGLRUScan.apply(*args)
        return ((h.reshape(n, -1, *h.shape[1:]),
                 last.reshape(n, -1, *last.shape[1:])), (0, 0))


def rglru(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
          lam: torch.Tensor, h0: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, r, i (B, S, W); lam (W,); h0 (B, W) or None. Returns (h (B, S, W)
    in x's dtype, the last step (B, W) f32). On CUDA through the kernel, on
    the CPU through its plain version; differentiable and vmappable on
    both."""
    log_at = RGLRU_C * r.float() * F.logsigmoid(lam.float())
    xi = (i.float() * x.float()).to(x.dtype)
    return RGLRUScan.apply(log_at.contiguous(), xi.contiguous(),
                           None if h0 is None else h0.float().contiguous())
