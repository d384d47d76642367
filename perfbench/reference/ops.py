"""Operations the reference models share.

Every matrix product goes through :func:`mm`. By default it is an exact
float32 product (TF32 stays off). The control of the training cells asks
for TF32 instead: each operand, in the forward and in the backward, is
rounded to TF32's 10-bit mantissa before a float32 product, as tensor
cores take their inputs; that rounding is written out here, so the control
reads the same on any device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value (ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(round_tf32(a), round_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        ga = torch.matmul(g, round_tf32(b).transpose(-1, -2))
        gb = torch.matmul(round_tf32(a).transpose(-1, -2), g)
        # undo broadcasting over leading dimensions
        while ga.dim() > a.dim():
            ga = ga.sum(0)
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        for i, n in enumerate(a.shape):
            if n == 1 and ga.shape[i] != 1:
                ga = ga.sum(i, keepdim=True)
        for i, n in enumerate(b.shape):
            if n == 1 and gb.shape[i] != 1:
                gb = gb.sum(i, keepdim=True)
        return ga, gb


class Precision:
    """How the reference multiplies: ``"f32"`` or ``"tf32"``."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "tf32"):
            raise ValueError(kind)
        self.kind = kind

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.kind == "tf32":
            return _TF32MatMul.apply(a, b)
        return torch.matmul(a, b)


def exact_matmul():
    """TF32 off for matrix products and cuDNN, as the configuration states."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy over every position."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)
