"""Carrying parameters across from the JAX package.

The JAX package's params, given as nested dicts of numpy arrays (for
example ``jax.tree.map(np.asarray, params)``), become the port's dict of
tensors here. The port keeps the reference's names, shapes and layouts
(HWIO convolutions, ``(in, out)`` dense weights, one LSTM bias), so the
conversion is a copy; a layout that ever differs is changed here and
nowhere else.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils import pytree as pt
from repro_torch.utils.device import Device, resolve_device


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes: exact through f32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree, device: Device = None):
    """Nested dicts/lists of numpy arrays -> the same tree of tensors on
    ``device``, dtypes kept. ``None`` means CUDA, and raises without it;
    pass ``device="cpu"`` to stay on the CPU."""
    device = resolve_device(device)
    return pt.tree_map(lambda a: _leaf(a, device), tree)
