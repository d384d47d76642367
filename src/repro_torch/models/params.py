"""Parameter definition trees.

Each model block declares its parameters as a dict of :class:`ParamDef`
(shape, logical axes, initializer) beside its forward, as the JAX package
does. From one def-tree come the materialized tensors (:func:`init_params`)
and the parameter count (:func:`count_params`). The logical axes are kept
for the model-sharding slice; nothing here reads them yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.utils import pytree as pt

PyTree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The tensor dtype of a config's dtype name."""
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]    # logical axis name per dim (None = replicated)
    init: str = "normal"               # normal | zeros | ones | lru_lambda
    scale: float = 0.02
    dtype: Optional[str] = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             "in rank")


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def stack_defs(defs: PyTree, n: int) -> PyTree:
    """Add a leading group dimension of size n to every ParamDef."""
    return pt.tree_map(
        lambda d: dataclasses.replace(d, shape=(n,) + d.shape,
                                      axes=(None,) + d.axes), defs)


def _init_leaf(gen: torch.Generator, d: ParamDef,
               default_dtype: str) -> torch.Tensor:
    dtype = torch_dtype(d.dtype or default_dtype)
    dev = gen.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=dev)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=dev)
    if d.init == "lru_lambda":
        # RG-LRU Lambda parameterization: a = sigmoid(Lambda) uniformly in
        # [0.9, 0.999] following Griffin appendix.
        u = torch.empty(d.shape, dtype=torch.float32, device=dev).uniform_(
            0.9, 0.999, generator=gen)
        return torch.log(u / (1.0 - u)).to(dtype)
    if d.init == "normal":
        # scaled in place: no second temporary of the leaf's size (the
        # stacked expert weights of qwen2-moe-a2.7b are 16.6 GB each)
        return torch.randn(d.shape, generator=gen, dtype=torch.float32,
                           device=dev).mul_(d.scale).to(dtype)
    raise ValueError(d.init)


def init_params(gen: torch.Generator, defs: PyTree,
                param_dtype: str = "float32") -> PyTree:
    """The def-tree's tensors, drawn in leaf order from ``gen`` on the
    generator's device. The distributions are the JAX package's; the bits
    are not (``jax.random`` is another generator), so a parity test carries
    the reference's weights across (``repro_torch.convert``)."""
    return pt.tree_map(lambda d: _init_leaf(gen, d, param_dtype), defs)


def count_params(defs: PyTree) -> int:
    return int(sum(math.prod(d.shape) for d in pt.tree_leaves(defs)))
