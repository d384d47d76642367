"""Learning-rate schedules: callables step -> f32 0-d tensor on the step's
device.

The JAX package's ``optim/schedule.py`` in PyTorch. Every division is a
true division of two tensors on the step's device: PyTorch divides a CUDA
tensor by a Python number as a multiply by its reciprocal, and ``float /
tensor`` is a reciprocal times the float, where the reference divides.
``decay ** step`` and ``cos`` are PyTorch's pow and cos, the reference's
XLA's: the last bit may differ (the tests state the tolerance).
"""
from __future__ import annotations

import math

import torch


def _f32(step: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(step).float()


def _div(num: torch.Tensor, den: float) -> torch.Tensor:
    """``num / den`` as a true division on ``num``'s device."""
    return torch.div(num, torch.tensor(den, dtype=num.dtype,
                                       device=num.device))


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=torch.as_tensor(step).device)


def exponential_decay(lr: float, decay: float):
    """Paper B.4: local lr decays by 0.995 per round."""
    def fn(step):
        s = _f32(step)
        return torch.tensor(lr, dtype=torch.float32,
                            device=s.device) * decay ** s
    return fn


def _cosine_part(t: torch.Tensor, final_frac: float) -> torch.Tensor:
    c = 0.5 * (1 + torch.cos(math.pi * t))
    return final_frac + (1 - final_frac) * c


def cosine(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(_div(_f32(step), total_steps), 0.0, 1.0)
        return lr * _cosine_part(t, final_frac)
    return fn


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        s = _f32(step)
        wu = torch.clamp(_div(s, max(warmup, 1)), 0.0, 1.0)
        t = torch.clamp(_div(s - warmup, max(total_steps - warmup, 1)),
                        0.0, 1.0)
        return lr * wu * _cosine_part(t, final_frac)
    return fn
