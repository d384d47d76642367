"""Optimizers as plain functions on the port's pytrees: SGD, momentum,
Adam, AdamW.

The JAX package's ``optim/optimizers.py`` in PyTorch. An
:class:`Optimizer` is ``(init, update)`` with ``update(grads, state, params)
-> (updates, new_state)``, and the updates are *added* to the params
(:func:`apply_updates`). Nothing is written in place: every call returns new
tensors, as the reference's functions return new arrays. The step counter
is an int32 0-d tensor on the params' device; Adam increments it before its
bias correction. The arithmetic runs in f32 and each update is cast back to
its gradient's dtype. A learning rate is a float or a schedule, a callable
step -> f32 0-d tensor (``optim.schedule``).

Bits: ``b1 ** step`` is ``torch.pow`` of a float and an f32 tensor, where
the reference has XLA's pow, and the global norm's per-leaf sums reduce in
PyTorch's order; both may differ from the reference in the last bits (the
tests state the tolerance). Every other operation is the reference's, in its
order.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch.utils import pytree as pt

PyTree = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]
ScalarOrSchedule = Union[float, Schedule]


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, Optional[PyTree]], tuple]


def _device(tree: PyTree) -> torch.device:
    leaves = pt.tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def _step0(params: PyTree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device(params))


def _lr(lr: ScalarOrSchedule, step: torch.Tensor) -> torch.Tensor:
    return (lr(step) if callable(lr)
            else torch.tensor(lr, dtype=torch.float32, device=step.device))


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32)


def sgd(lr: ScalarOrSchedule) -> Optimizer:
    def init(params):
        return {"step": _step0(params)}

    def update(grads, state, params=None):
        step = state["step"]
        rate = _lr(lr, step)
        ups = pt.tree_map(lambda g: (-rate * g.float()).to(g.dtype), grads)
        return ups, {"step": step + 1}

    return Optimizer(init, update)


def momentum(lr: ScalarOrSchedule, beta: float = 0.9,
             nesterov: bool = False) -> Optimizer:
    """Heavy-ball momentum: the paper's local optimizer (B.4: beta=0.5)."""

    def init(params):
        return {"step": _step0(params), "mu": pt.tree_map(_zeros_f32, params)}

    def update(grads, state, params=None):
        step = state["step"]
        rate = _lr(lr, step)
        mu = pt.tree_map(lambda m, g: beta * m + g.float(), state["mu"],
                         grads)
        if nesterov:
            ups = pt.tree_map(
                lambda m, g: (-rate * (beta * m + g.float())).to(g.dtype),
                mu, grads)
        else:
            ups = pt.tree_map(lambda m, g: (-rate * m).to(g.dtype), mu, grads)
        return ups, {"step": step + 1, "mu": mu}

    return Optimizer(init, update)


def adam(lr: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"step": _step0(params),
                "m": pt.tree_map(_zeros_f32, params),
                "v": pt.tree_map(_zeros_f32, params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        rate = _lr(lr, step)
        m = pt.tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                        state["m"], grads)
        v = pt.tree_map(
            lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()),
            state["v"], grads)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()

        def upd(m_, v_, p, g):
            u = -rate * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay and p is not None:
                u = u - rate * weight_decay * p.float()
            return u.to(g.dtype)

        if params is None:
            ups = pt.tree_map(lambda m_, v_, g: upd(m_, v_, None, g), m, v,
                              grads)
        else:
            ups = pt.tree_map(upd, m, v, params, grads)
        return ups, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def adamw(lr: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    return adam(lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)


def clip_by_global_norm(grads: PyTree, max_norm: float) -> PyTree:
    """Every leaf scaled by ``min(1, max_norm / max(|grads|, 1e-12))``, the
    norm summed over the leaves in the reference's leaf order. The division
    is a true one (``float / tensor`` in PyTorch is a reciprocal times the
    float)."""
    leaves = pt.tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    num = torch.full_like(gn, max_norm)
    scale = torch.clamp(torch.div(num, torch.clamp(gn, min=1e-12)), max=1.0)
    return pt.tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return pt.tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype),
                       params, updates)
