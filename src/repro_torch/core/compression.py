"""Compressed delta transport: the wire form of a client delta.

A delta travels as per-block-scaled int8 (one f32 scale per :data:`QBLOCK`
elements) or as a bf16 recast, carried in a :class:`CompressedDelta` beside
the true (unpadded) element count. Quantization error is absorbed by the
client's error-feedback residual (``Client._residual``): what the server
never received is folded into the client's next delta.

``CompressedDelta`` is not a tree: ``pt.tree_*`` helpers treat it as one
leaf and fail on it rather than walk into the payload. Servers decompress
explicitly (the tree backend) or hand ``q``/``scales`` straight to the
int8 kernels (``fedagg_norms_q``, ``fedagg_axpy_q``), which dequantize in
registers. Everything here is plain torch on the tensors' own device; the
int8 bytes and scales equal the JAX package's ``_quantize_int8`` bit for
bit (``tests/test_torch_compression.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.fedagg.fedagg import BLOCK, QBLOCK
from repro_torch.utils import pytree as pt

MODES = ("off", "int8", "bf16")

#: 1/127 rounded to f32 (exact as a Python float, so full_like keeps it)
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


@dataclass
class CompressedDelta:
    """A client delta in transport form.

    ``mode``   "int8" or "bf16".
    ``q``      the payload: int8 (n_padded,) for int8, bf16 (n_padded,) for
               bf16, always padded to a multiple of :data:`BLOCK`.
    ``scales`` f32 (n_padded // QBLOCK,) per-block scales for int8; None for
               bf16.
    ``n``      true element count before padding (``FlatSpec.n``).
    """

    mode: str
    q: torch.Tensor
    scales: Optional[torch.Tensor]
    n: int

    def wire_bytes(self) -> int:
        """Bytes this delta occupies in transport form."""
        total = self.q.numel() * self.q.element_size()
        if self.scales is not None:
            total += self.scales.numel() * self.scales.element_size()
        return int(total)


def _quantize_int8(vec: torch.Tensor):
    """f32 (n,) -> (int8 (n,), f32 (n // QBLOCK,)) per-block absmax scales.

    scale = absmax / 127 per QBLOCK elements; an all-zero block gets scale 0
    and quantizes to zeros. The reference's jitted ``absmax / 127.0`` is
    compiled by XLA into a multiply by the f32 reciprocal of 127, so that
    multiply is written out here, on a tensor, and gives the same bits on
    the CPU and on CUDA. The inverse scale is a true division of two
    tensors, as in the reference (PyTorch computes ``number / tensor`` as a
    reciprocal times the number). ``torch.round`` rounds half to even, as
    ``jnp.round`` does.
    """
    blocks = vec.reshape(-1, QBLOCK)
    absmax = torch.amax(torch.abs(blocks), dim=1)
    scales = absmax * torch.full_like(absmax, _INV_127)
    pos = scales > 0
    ones = torch.ones_like(scales)
    inv = torch.where(pos, ones / torch.where(pos, scales, ones),
                      torch.zeros_like(scales))
    q = torch.clamp(torch.round(blocks * inv[:, None]), -127, 127)
    return q.to(torch.int8).reshape(-1), scales


def _dequantize_int8(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return (q.float().reshape(-1, QBLOCK) * scales[:, None]).reshape(-1)


def quantize_vec(vec: torch.Tensor, mode: str, n: int) -> CompressedDelta:
    """Compress a padded flat f32 vector into transport form. ``vec`` is
    padded to a multiple of :data:`BLOCK` (the ``FlatSpec`` layout); ``n``
    is the true element count."""
    assert vec.shape[0] % BLOCK == 0, (vec.shape, BLOCK)
    if mode == "int8":
        q, scales = _quantize_int8(vec)
        return CompressedDelta("int8", q, scales, n)
    if mode == "bf16":
        return CompressedDelta("bf16", vec.to(torch.bfloat16), None, n)
    raise ValueError(f"unknown compression mode {mode!r}")


def dequantize(cd: CompressedDelta) -> torch.Tensor:
    """Transport form -> padded flat f32 vector."""
    if cd.mode == "int8":
        return _dequantize_int8(cd.q, cd.scales)
    if cd.mode == "bf16":
        return cd.q.float()
    raise ValueError(f"unknown compression mode {cd.mode!r}")


def is_compressed(delta) -> bool:
    return isinstance(delta, CompressedDelta)


def delta_norm(delta) -> float:
    """l2 norm of a delta in either form (what screening measures). For a
    compressed delta it is the norm of the DEQUANTIZED values, the values
    aggregation applies."""
    if is_compressed(delta):
        v = dequantize(delta)
        return float(torch.sqrt(torch.sum(v * v)))
    return float(pt.tree_norm(delta))


def scale_delta(delta, s: float):
    """Scale a delta by ``s`` in its own form (norm-clip verdicts). int8
    scaling is exact on the scales: dequant(q, s * scales) ==
    s * dequant(q, scales), so clipping never re-quantizes."""
    if is_compressed(delta):
        s32 = torch.tensor(s, dtype=torch.float32, device=delta.q.device)
        if delta.mode == "int8":
            return CompressedDelta("int8", delta.q, delta.scales * s32,
                                   delta.n)
        return CompressedDelta("bf16",
                               (delta.q.float() * s32).to(torch.bfloat16),
                               None, delta.n)
    return pt.tree_scale(delta, s)


def wire_bytes_per_param(mode: str) -> float:
    """Average transport bytes per parameter element for ``mode``: int8 is
    1 payload byte plus one f32 scale amortized over QBLOCK elements."""
    if mode == "int8":
        return 1.0 + 4.0 / QBLOCK
    if mode == "bf16":
        return 2.0
    return 4.0
