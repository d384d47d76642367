"""Parameter definition trees.

Each model block declares its parameters as a dict of :class:`ParamDef`
(shape, logical axes, initializer) beside its forward, as the JAX package
does. From one def-tree come

* :func:`init_params`: the materialized tensors;
* :func:`abstract_params`: meta tensors, shapes and dtypes with no storage
  (the reference's ``ShapeDtypeStruct`` s; the dry run traces on them);
* :func:`partition_spec_tree`: the layout of each leaf over a logical mesh,
  from the logical axes and a rule table (``sharding/specs.py``);
* :func:`count_params`: the parameter count.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.utils import pytree as pt

PyTree = Any
#: one entry of a layout per dim: replicated (None), one mesh axis, or
#: several mesh axes in order
AxisSpec = Union[None, str, Tuple[str, ...]]
#: a leaf's layout: one entry per dim, ``tuple(PartitionSpec)`` of the
#: reference
Spec = Tuple[AxisSpec, ...]


def spec_entry(axes) -> AxisSpec:
    """One dim's entry as ``PartitionSpec`` normalizes it: a tuple of one
    axis is that axis's name."""
    if isinstance(axes, (tuple, list)):
        return axes[0] if len(axes) == 1 else tuple(axes)
    return axes

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


def abstract_params(defs: PyTree, param_dtype: str = "float32") -> PyTree:
    """The def-tree as meta tensors of its shapes and dtypes: no storage on
    any device, and no value to read."""
    return pt.tree_map(
        lambda d: torch.empty(d.shape, dtype=torch_dtype(d.dtype
                                                         or param_dtype),
                              device="meta"), defs)


def partition_spec_tree(defs: PyTree, rules: Dict[str, AxisSpec],
                        mesh_axis_sizes: Dict[str, int]) -> PyTree:
    """Logical axes -> a :data:`Spec` per leaf, skipping placements that do
    not divide.

    A logical axis maps to its mesh axis (or axes) only if the dim's size is
    a multiple of the mesh axes' product and no earlier dim of the leaf took
    one of those axes: the reference's ``partition_spec_tree``, whose
    ``PartitionSpec`` s these tuples equal entry for entry.
    """

    def spec(d: ParamDef) -> Spec:
        used = set()
        out = []
        for dim, ax in zip(d.shape, d.axes):
            mesh_ax = rules.get(ax) if ax else None
            if mesh_ax is None:
                out.append(None)
                continue
            axes = mesh_ax if isinstance(mesh_ax, tuple) else (mesh_ax,)
            size = 1
            for a in axes:
                size *= mesh_axis_sizes.get(a, 1)
            if any(a in used for a in axes) or dim % size != 0:
                out.append(None)
            else:
                out.append(spec_entry(mesh_ax))
                used.update(axes)
        return tuple(out)

    return pt.tree_map(spec, defs)


def count_params(defs: PyTree) -> int:
    return int(sum(math.prod(d.shape) for d in pt.tree_leaves(defs)))
