"""The RG-LRU recurrence from the model's gates, over the hand-written
kernel.

The counterpart of the JAX package's ``kernels/rglru/ops.py::rglru_pallas``:
the gate prologue ``log a_t = c * r_t * log sigmoid(Lambda)`` and the gated
input ``xi = i_t * x_t`` in PyTorch, then the recurrence through
:func:`repro_torch.kernels.rglru.rglru.rglru_scan`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru.rglru import rglru_scan

#: the exponent's scale c in a_t = a^(c r_t) (Griffin)
RGLRU_C = 8.0


def rglru(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
          lam: torch.Tensor, h0: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, r, i (B, S, W); lam (W,); h0 (B, W) or None. Returns (h (B, S, W)
    in x's dtype, the last step (B, W) f32). On CUDA through the kernel, on
    the CPU through its plain version."""
    log_at = RGLRU_C * r.float() * F.logsigmoid(lam.float())
    xi = (i.float() * x.float()).to(x.dtype)
    return rglru_scan(log_at.contiguous(), xi.contiguous(),
                      None if h0 is None else h0.float().contiguous())
