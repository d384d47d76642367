"""Layouts of the model-sharded flat state and the pod-split cohort, and the
model layout rules of the dry run.

A model-sharded flat vector is a **tuple of S contiguous shard tensors**,
shard ``s`` on the mesh's ``s``-th model device, each with its own storage
(never a view into one long tensor). The server pads its flat vector to a
multiple of ``BLOCK * S``, so every shard is a whole number of kernel
blocks and the unsharded sweeps run on it unchanged. A tuple is a tree
(``utils.pytree``), so the GMIS stores and updates sharded snapshots as it
does flat vectors.

* ``(n,)`` vectors and ``(B, n)`` stacks split along their last axis: every
  row of a stack keeps all B entries of its own shard, so the batched
  sweep's ``(B,)`` and ``(B, B)`` outputs are per-shard partials summed
  once.
* int8 scale vectors ``(n // QBLOCK,)`` (and ``(B, n // QBLOCK)``) split
  the same way: QBLOCK (1024) divides BLOCK (65,536), which divides the
  shard length, so a contiguous split keeps every scale on the shard of
  the q block it dequantizes (:func:`split_scales`).
* A cohort's stacked client state splits along its leading client axis
  into equal pod blocks (:func:`split_cohort`).

The model layout rules (:data:`DEFAULT_RULES` to :func:`cache_spec_tree`)
are the reference's logical-axis -> mesh-axis rules, MaxText-style 2-D
sharding with a federated ``pod`` axis, on a ``launch.mesh.LogicalMesh``:

* ``model``: tensor parallelism over heads, mlp, experts, vocab;
* ``data``: batch parallelism for activations, and FSDP-style weight
  sharding along the ``embed`` logical axis;
* ``pod`` (multi-pod mesh only): the federated client axis, which extends
  the batch.

A spec is a tuple with one entry per dim: None (replicated), a mesh axis
name, or a tuple of them; it equals ``tuple(PartitionSpec)`` of the
reference's. The dry run reads them to size each leaf per device; the
single-controller port places nothing by them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.fedagg.fedagg import BLOCK, QBLOCK
from repro_torch.launch.mesh import LogicalMesh, Mesh
from repro_torch.models.model import cache_specs, model_defs
from repro_torch.models.params import (AxisSpec, Spec, partition_spec_tree,
                                       spec_entry)
from repro_torch.utils import pytree as pt

PyTree = Any


def _owned(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` copied into fresh contiguous storage on ``device``."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t)
    return out


def _split_last(t: torch.Tensor, mesh: Mesh, unit: int
                ) -> Tuple[torch.Tensor, ...]:
    devs = mesh.model_devices()
    n = t.shape[-1]
    if n % (unit * len(devs)):
        raise ValueError(f"length {n} does not split into {len(devs)} "
                         f"shards of whole {unit}-element blocks")
    w = n // len(devs)
    return tuple(_owned(t[..., s * w:(s + 1) * w], dev)
                 for s, dev in enumerate(devs))


def split_flat(vec: torch.Tensor, mesh: Mesh) -> Tuple[torch.Tensor, ...]:
    """A padded flat ``(n,)`` vector or ``(B, n)`` stack as its model
    shards: S contiguous slices of the last axis, each copied into its own
    storage on its model device. ``n`` must be a multiple of ``BLOCK *
    S``."""
    return _split_last(vec, mesh, BLOCK)


def split_scales(scales: torch.Tensor, mesh: Mesh
                 ) -> Tuple[torch.Tensor, ...]:
    """int8 scales ``(n // QBLOCK,)`` or ``(B, n // QBLOCK)`` split beside
    their q blocks: shard ``s`` gets the scales of shard ``s`` of
    :func:`split_flat`'s q."""
    return _split_last(scales, mesh, BLOCK // QBLOCK)


def gather_flat(shards: Sequence[torch.Tensor],
                device: torch.device = None) -> torch.Tensor:
    """The shards of :func:`split_flat` joined along the last axis on
    ``device`` (default: shard 0's, the mesh's home)."""
    device = shards[0].device if device is None else device
    return torch.cat([s.to(device) for s in shards], dim=-1)


def split_cohort(stacked: PyTree, n_pods: int) -> Tuple[PyTree, ...]:
    """A stacked cohort tree (every leaf ``(C, ...)``) as ``n_pods`` trees
    of ``C / n_pods`` consecutive client rows (views; the engine moves
    them to their pods' devices)."""
    c = pt.tree_leaves(stacked)[0].shape[0]
    if c % n_pods:
        raise ValueError(f"{c} client rows do not split over {n_pods} pods")
    r = c // n_pods
    return tuple(pt.tree_map(lambda t: t[p * r:(p + 1) * r], stacked)
                 for p in range(n_pods))


# ---------------------------------------------------------------------------
# Model layout rules (the dry run's)
# ---------------------------------------------------------------------------

DEFAULT_RULES: Dict[str, AxisSpec] = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "expert": "model",
    "embed": "data",      # FSDP: weights sharded over the data axis
}


def preset_rules(preset: str, mesh: LogicalMesh) -> Dict[str, AxisSpec]:
    """The named strategies of the reference:

    * ``tp``: :data:`DEFAULT_RULES`, tensor parallel on ``model`` and ZeRO
      on ``data``;
    * ``dp``: ZeRO-3 data parallelism: weights shard their output-feature
      dims (vocab, heads, mlp, experts) over ``data``, never d_model, and
      the batch spreads over every axis (``batch_spec(include_model=True)``);
    * ``ep``: expert-parallel serving: experts over ``model``, the expert
      ffn width over ``data``, attention split along the head dim, no
      d_model sharding.
    """
    if preset == "tp":
        return dict(DEFAULT_RULES)
    if preset == "dp":
        return {"vocab": "data", "heads": "data", "kv_heads": "data",
                "mlp": "data", "expert": "data", "embed": None}
    if preset == "ep":
        return {"vocab": "model", "heads": None, "kv_heads": None,
                "head_dim": "model", "mlp": "data", "expert": "model",
                "embed": None}
    raise ValueError(preset)


def param_spec_tree(cfg: ModelConfig, mesh: LogicalMesh,
                    rules: Optional[Dict[str, AxisSpec]] = None) -> PyTree:
    """A spec per leaf of ``model_defs(cfg)``. Rules naming an axis the
    mesh lacks drop it (a tuple rule keeps its present axes)."""
    rules = dict(rules or DEFAULT_RULES)

    def clean(v):
        if isinstance(v, tuple):
            kept = tuple(a for a in v if a in mesh.axis_names)
            return kept if kept else None
        return v if v in mesh.axis_names else None

    rules = {k: clean(v) for k, v in rules.items()}
    return partition_spec_tree(model_defs(cfg), rules, mesh.axis_sizes)


def batch_spec(mesh: LogicalMesh, batch_size: int,
               include_model: bool = False) -> Spec:
    """The batch dim over every data-like axis present (pod first) whose
    running product divides the batch; ``include_model``: the pure-DP
    preset also spreads it over ``model``. A one-entry spec."""
    names = ("pod", "data", "model") if include_model else ("pod", "data")
    sizes = mesh.axis_sizes
    total = 1
    used = []
    for a in (a for a in names if a in mesh.axis_names):
        if batch_size % (total * sizes[a]) == 0:
            used.append(a)
            total *= sizes[a]
    return (spec_entry(used) if used else None,)


def activation_spec(mesh: LogicalMesh, batch_size: int) -> Spec:
    """(batch, seq, embed) activations: batch over the data axes."""
    return (batch_spec(mesh, batch_size)[0], None, None)


def cache_layout(tree: PyTree, mesh: LogicalMesh, batch: int,
                 prefer: str = "largest") -> PyTree:
    """Specs of a cache tree whose leaves have shapes (the decode cache of
    ``cache_specs``, or the caches a prefill collects): batch over the data
    axes, plus one channel dim over ``model``: with ``prefer="largest"``
    the largest trailing dim that ``model`` divides (the sequence of a KV
    cache), with ``prefer="last"`` the last dim first (head dim, state N,
    width). The stacked groups' (``"layers"``) leading group dim is
    replicated and the rule applies to the dims after it."""
    sizes = mesh.axis_sizes
    b_axes = batch_spec(mesh, batch)[0]
    model_ax = "model" if "model" in mesh.axis_names else None

    def spec(shape: Tuple[int, ...]) -> Spec:
        dims = [None] * len(shape)
        dims[0] = b_axes
        if model_ax is not None and len(shape) >= 2:
            if prefer == "last":
                cands = [len(shape) - 1] + list(range(1, len(shape) - 1))
            else:
                cands = sorted(range(1, len(shape)), key=lambda i: -shape[i])
            for cand in cands:
                if shape[cand] % sizes[model_ax] == 0:
                    dims[cand] = model_ax
                    break
        return tuple(dims)

    out = {k: pt.tree_map(lambda s: spec(tuple(s.shape)), v)
           for k, v in tree.items() if k != "layers"}
    if "layers" in tree:
        out["layers"] = pt.tree_map(
            lambda s: (None, *spec(tuple(s.shape[1:]))), tree["layers"])
    return out


def cache_spec_tree(cfg: ModelConfig, mesh: LogicalMesh, batch: int,
                    cache_len: int, window: int,
                    prefer: str = "largest") -> PyTree:
    """Specs of the decode cache ``cache_specs(cfg, batch, cache_len,
    window)`` by :func:`cache_layout`."""
    return cache_layout(cache_specs(cfg, batch, cache_len, window), mesh,
                        batch, prefer)


def leaf_bytes(t, spec: Spec, mesh: LogicalMesh) -> int:
    """Bytes of one device's block of a tensor or ``TensorSpec`` ``t`` laid
    out by ``spec`` on ``mesh``: each dim over the product of its axes'
    sizes, rounded up."""
    sizes = mesh.axis_sizes
    n = 1
    for i, dim in enumerate(t.shape):
        ax = spec[i] if i < len(spec) else None
        split = 1
        for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
            split *= sizes[a]
        n *= -(-int(dim) // split)
    return n * t.dtype.itemsize
