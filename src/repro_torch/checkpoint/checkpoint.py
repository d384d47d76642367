"""Parameter-tree and flat-state checkpoints: npz + json, no pickle.

The format is the JAX package's (``repro/checkpoint/checkpoint.py``), so a
file written by either package restores in the other:

* a tree checkpoint ``step_<n>.npz`` holds one array per leaf, named by its
  path — dict keys and list indices joined by ``/``, in the order
  ``jax.tree_util.tree_flatten_with_path`` gives them (dict keys sorted) —
  with ``step_<n>.npz.json`` recording each leaf's shape and dtype. Restore
  checks every leaf against a template tree, so silent drift is impossible.
* a flat checkpoint ``flat_<n>.npz`` holds the flat server's PADDED global
  vector under ``flat_vec``, with the layout ``(n, block, n_padded,
  model_shards)`` in its json. Restore keeps the ``n`` true elements and
  re-pads to the restoring layout (padding is zeros by construction).

Tensors reach the host with ``.cpu().numpy()``; restored tree leaves take
the template's device and dtype.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils import pytree as pt

PyTree = Any
_STEP_RE = re.compile(r"step_(\d+)\.npz$")
_FLAT_RE = re.compile(r"flat_(\d+)\.npz$")
_FLAT_KEY = "flat_vec"


def _walk_named(node, path: Tuple[str, ...],
                out: List[Tuple[str, Any]]) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            _walk_named(node[k], path + (str(k),), out)
    elif isinstance(node, (list, tuple)):
        for i, c in enumerate(node):
            _walk_named(c, path + (str(i),), out)
    else:
        out.append(("/".join(path), node))


def _named_leaves(tree: PyTree) -> List[Tuple[str, Any]]:
    """``(path name, leaf)`` in ``pt.tree_flatten`` order (the JAX
    package's): sorted dict keys, then list and tuple indices. A
    module-level walker: a nested one calling itself is a reference cycle
    that keeps the leaves alive until the cyclic collector runs."""
    out: List[Tuple[str, Any]] = []
    _walk_named(tree, (), out)
    return out


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def save_pytree(tree: PyTree, directory: str, step: int) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step}.npz")
    named = [(n, _host(a)) for n, a in _named_leaves(tree)]
    np.savez(path, **dict(named))
    meta = {n: {"shape": list(a.shape), "dtype": str(a.dtype)}
            for n, a in named}
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    return path


def restore_pytree(template: PyTree, directory: str,
                   step: Optional[int] = None) -> PyTree:
    """The tree saved at ``step`` (default: the latest), each leaf checked
    against ``template``'s shape and placed on its device, in its dtype."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step}.npz")
    leaves = []
    with np.load(path) as data:
        for name, tmpl in _named_leaves(template):
            arr = data[name]
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(
                    f"checkpoint leaf {name}: shape {arr.shape} != template "
                    f"{tuple(tmpl.shape)}")
            leaves.append(torch.from_numpy(arr).to(device=tmpl.device,
                                                   dtype=tmpl.dtype))
    return pt.tree_unflatten(pt.tree_structure(template), leaves)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := _STEP_RE.search(f))]
    return max(steps) if steps else None


def save_flat(vec, n: int, directory: str, step: int, *,
              block: int = 1, model_shards: int = 1) -> str:
    """Save the padded flat global vector with its layout.

    ``vec`` is the server's padded flat state (a tensor on any device, or
    an array), ``n`` the count of TRUE elements: everything past ``n`` is
    layout padding and must be zero. ``block`` and ``model_shards`` record
    the layout the vector was padded for."""
    vec = _host(vec)
    n = int(n)
    if vec.ndim != 1 or not (0 < n <= vec.shape[0]):
        raise ValueError(f"flat vec must be 1-D with 0 < n <= len: "
                         f"shape {vec.shape}, n={n}")
    if vec[n:].any():
        raise ValueError("flat checkpoint padding past n is non-zero — "
                         "vec is not a padded flat state")
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"flat_{step}.npz")
    np.savez(path, **{_FLAT_KEY: vec})
    meta = {"n": n, "block": int(block), "n_padded": int(vec.shape[0]),
            "model_shards": int(model_shards), "dtype": str(vec.dtype)}
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    return path


def restore_flat(directory: str, step: Optional[int] = None, *,
                 n: Optional[int] = None,
                 n_padded: Optional[int] = None) -> Tuple[np.ndarray, dict]:
    """``(vec, meta)`` of a flat checkpoint, ``vec`` on the host.

    ``n`` (when given) must equal the saved true-element count: another
    count means another model, and restore refuses. ``n_padded`` re-pads
    the true elements to the restoring layout's length; by default the
    saved padding stays."""
    if step is None:
        step = latest_flat_step(directory)
        if step is None:
            raise FileNotFoundError(f"no flat checkpoints in {directory}")
    path = os.path.join(directory, f"flat_{step}.npz")
    with open(path + ".json") as f:
        meta = json.load(f)
    with np.load(path) as data:
        vec = data[_FLAT_KEY]
    if n is not None and int(n) != int(meta["n"]):
        raise ValueError(f"flat checkpoint holds n={meta['n']} true "
                         f"elements, restoring model expects n={n}")
    true = vec[:int(meta["n"])]
    if n_padded is not None:
        n_padded = int(n_padded)
        if n_padded < true.shape[0]:
            raise ValueError(f"n_padded={n_padded} < n={true.shape[0]}")
        vec = np.zeros(n_padded, dtype=vec.dtype)
        vec[:true.shape[0]] = true
    return vec, meta


def latest_flat_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := _FLAT_RE.search(f))]
    return max(steps) if steps else None
