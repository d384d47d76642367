"""Layouts of the model-sharded flat state and the pod-split cohort.

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
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch

from repro_torch.kernels.fedagg.fedagg import BLOCK, QBLOCK
from repro_torch.launch.mesh import Mesh
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
