"""Tree utilities on nested dicts, lists and tuples of tensors.

The AsyncFedED protocol operates on whole parameter trees: pseudo-gradients,
Euclidean distances between model versions, and scaled AXPY updates. These
helpers are the plain-torch layer; the flat-state kernels live in
``repro_torch.kernels.fedagg``.

Leaf order is the JAX package's (``jax.tree.flatten``): dict keys sorted at
every level, lists and tuples in order. A flat vector built here is therefore
the reference's vector element for element, which is what lets one config,
one checkpoint layout and one test input drive both packages.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

PyTree = Any
#: structure of a tree: None for a leaf, else (kind, keys, children)
TreeDef = Any


# The walkers are module-level functions that take their accumulator as an
# argument: a nested function that calls itself holds its own closure cell,
# a reference cycle, and every leaf it collected (a decode cache, a model's
# params) would then stay alive until the cyclic garbage collector runs.


def _flatten(node, leaves: List[Any]) -> TreeDef:
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", tuple(keys),
                tuple(_flatten(node[k], leaves) for k in keys))
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, len(node),
                tuple(_flatten(c, leaves) for c in node))
    leaves.append(node)
    return None


def tree_flatten(tree: PyTree) -> Tuple[List[Any], TreeDef]:
    """Leaves in ``jax.tree.flatten`` order, and the structure to rebuild."""
    leaves: List[Any] = []
    treedef = _flatten(tree, leaves)
    return leaves, treedef


def _build(d: TreeDef, it) -> PyTree:
    if d is None:
        return next(it)
    kind, keys, children = d
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(keys, children)}
    out = [_build(c, it) for c in children]
    return tuple(out) if kind == "tuple" else out


def tree_unflatten(treedef: TreeDef, leaves) -> PyTree:
    return _build(treedef, iter(leaves))


def _up_to(d: TreeDef, node, out: List[Any]) -> None:
    if d is None:
        out.append(node)
        return
    kind, keys, children = d
    if kind == "dict":
        for k, c in zip(keys, children):
            _up_to(c, node[k], out)
    else:
        for i, c in enumerate(children):
            _up_to(c, node[i], out)


def leaves_up_to(treedef: TreeDef, tree: PyTree) -> List[Any]:
    """The nodes of ``tree`` at the leaf positions of ``treedef`` (from
    :func:`tree_flatten` of another tree), in the same order: the leaves of
    a tree whose own leaves may be tuples, such as a tree of layout specs
    beside the tensors they lay out."""
    out: List[Any] = []
    _up_to(treedef, tree, out)
    return out


def tree_leaves(tree: PyTree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_structure(tree: PyTree) -> TreeDef:
    return tree_flatten(tree)[1]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(treedef, [fn(*ls) for ls in zip(leaves, *others)])


def tree_sub(a: PyTree, b: PyTree) -> PyTree:
    """a - b, leafwise."""
    return tree_map(lambda x, y: x - y, a, b)


def tree_add(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(lambda x, y: x + y, a, b)


def tree_scale(a: PyTree, s) -> PyTree:
    return tree_map(lambda x: x * s, a)


def tree_axpy(alpha, x: PyTree, y: PyTree) -> PyTree:
    """alpha * x + y, leafwise (the Eq.(5) server update). A tensor
    ``alpha`` is read on each leaf's device (the leaves of a model-sharded
    vector may lie on several)."""
    return tree_map(lambda xi, yi: _scalar_at(alpha, xi) * xi + yi, x, y)


def _scalar_at(alpha, leaf: torch.Tensor):
    """``alpha`` where ``leaf`` can use it: a tensor on another CUDA device
    is copied to the leaf's; numbers and CPU scalars pass as they are."""
    if (isinstance(alpha, torch.Tensor) and alpha.device.type != "cpu"
            and alpha.device != leaf.device):
        return alpha.to(leaf.device)
    return alpha


def _sum_f32(parts: List[torch.Tensor]) -> torch.Tensor:
    """Left fold of per-leaf f32 sums from 0, as the reference reduces."""
    acc = torch.zeros((), dtype=torch.float32, device=parts[0].device)
    for p in parts:
        acc = acc + p
    return acc


def tree_dot(a: PyTree, b: PyTree) -> torch.Tensor:
    """Sum of elementwise products over all leaves, accumulated in f32."""
    return _sum_f32([torch.sum(x.float() * y.float())
                     for x, y in zip(tree_leaves(a), tree_leaves(b))])


def tree_sq_norm(a: PyTree) -> torch.Tensor:
    """Squared l2 norm over every leaf, accumulated in f32."""
    return _sum_f32([torch.sum(torch.square(x.float()))
                     for x in tree_leaves(a)])


def tree_norm(a: PyTree) -> torch.Tensor:
    return torch.sqrt(tree_sq_norm(a))


def tree_sq_dist(a: PyTree, b: PyTree) -> torch.Tensor:
    return _sum_f32([torch.sum(torch.square(x.float() - y.float()))
                     for x, y in zip(tree_leaves(a), tree_leaves(b))])


def tree_dist(a: PyTree, b: PyTree) -> torch.Tensor:
    return torch.sqrt(tree_sq_dist(a, b))


def tree_zeros_like(a: PyTree) -> PyTree:
    return tree_map(torch.zeros_like, a)


def tree_size(a: PyTree) -> int:
    return int(sum(l.numel() for l in tree_leaves(a)))


def tree_bytes(a: PyTree) -> int:
    return int(sum(l.numel() * l.element_size() for l in tree_leaves(a)))


def tree_cast(a: PyTree, dtype) -> PyTree:
    return tree_map(lambda x: x.to(dtype), a)


def tree_flatten_to_vector(a: PyTree) -> torch.Tensor:
    """Concatenate all leaves into one flat f32 vector (kernel layout)."""
    return torch.cat([l.reshape(-1).float() for l in tree_leaves(a)])


def tree_unflatten_from_vector(vec: torch.Tensor, like: PyTree) -> PyTree:
    """Inverse of :func:`tree_flatten_to_vector` against a template tree."""
    leaves, treedef = tree_flatten(like)
    out, off = [], 0
    for l in leaves:
        n = l.numel()
        out.append(vec[off:off + n].reshape(l.shape).to(l.dtype))
        off += n
    return tree_unflatten(treedef, out)


class FlatSpec:
    """Cached flatten/unflatten spec for a fixed tree structure.

    Flattening a tree for the fedagg kernels means: ravel every leaf to
    f32, concatenate, and zero-pad to a multiple of ``block`` (a layout
    constant of the flat state, 65536 for the server). ``FlatSpec``
    captures the structure, leaf shapes/dtypes, the padded length and the
    device once, so both directions are a single concat/split.
    """

    __slots__ = ("treedef", "shapes", "dtypes", "sizes", "n", "n_padded",
                 "block", "device")

    def __init__(self, tree: PyTree, block: int = 1):
        leaves, self.treedef = tree_flatten(tree)
        self.shapes = tuple(tuple(l.shape) for l in leaves)
        self.dtypes = tuple(l.dtype for l in leaves)
        self.sizes = tuple(l.numel() for l in leaves)
        self.n = int(sum(self.sizes))
        self.block = int(block)
        self.n_padded = self.n + (-self.n) % max(self.block, 1)
        self.device = leaves[0].device

    def flatten(self, tree: PyTree) -> torch.Tensor:
        """Tree (matching this spec) -> padded flat f32 vector."""
        vec = tree_flatten_to_vector(tree)
        if self.n_padded != self.n:
            vec = torch.nn.functional.pad(vec, (0, self.n_padded - self.n))
        return vec

    def unflatten(self, vec: torch.Tensor) -> PyTree:
        """Padded flat vector -> tree with the original shapes/dtypes.
        f32 leaves are views of ``vec``: callers must not write into
        ``vec`` in place while the tree is in use."""
        out, off = [], 0
        for shape, dtype, size in zip(self.shapes, self.dtypes, self.sizes):
            out.append(vec[off:off + size].reshape(shape).to(dtype))
            off += size
        return tree_unflatten(self.treedef, out)

    def zeros(self) -> torch.Tensor:
        return torch.zeros((self.n_padded,), dtype=torch.float32,
                           device=self.device)


class FlatParams:
    """A parameter tree held as one padded flat f32 vector.

    The flat-state server (``AsyncFedEDServer(backend="pallas")``) keeps
    the global model in this form so every Eq.(5-7) step is a kernel sweep
    over one contiguous vector instead of a walk over the tree. ``tree``
    materializes the tree view lazily and caches it; the cache is dropped
    whenever the vector is replaced. ``vec`` may also be a model-sharded
    vector, the tuple of its contiguous shards (``sharding/specs.py``);
    its owner then builds the tree view from a gathered copy.
    """

    __slots__ = ("vec", "spec", "_tree_cache")

    def __init__(self, vec: torch.Tensor, spec: FlatSpec,
                 tree_cache: Optional[PyTree] = None):
        parts = vec if isinstance(vec, tuple) else (vec,)
        assert all(p.dim() == 1 for p in parts), [p.shape for p in parts]
        n = sum(p.shape[0] for p in parts)
        assert n == spec.n_padded, (n, spec.n_padded)
        self.vec = vec
        self.spec = spec
        self._tree_cache = tree_cache

    @classmethod
    def from_tree(cls, tree: PyTree, block: int = 1) -> "FlatParams":
        spec = FlatSpec(tree, block=block)
        return cls(spec.flatten(tree), spec, tree_cache=tree)

    @property
    def tree(self) -> PyTree:
        if self._tree_cache is None:
            self._tree_cache = self.spec.unflatten(self.vec)
        return self._tree_cache

    def replace(self, vec: torch.Tensor) -> "FlatParams":
        """New FlatParams sharing the spec; invalidates the tree cache."""
        return FlatParams(vec, self.spec)
