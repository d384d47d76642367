"""Seeded weights of a configuration, made by the benchmark and handed to
both the port and the plain reference.

The tree is laid out as the port's models take it (``embed``, ``layers``
with the layers stacked along a leading dimension, ``final_norm``,
``head``), every leaf in float32. :func:`draw` makes the whole model in a
few large calls on the device: one buffer, one normal draw over it from a
``torch.Generator`` seeded with the run's seed, then fills and scales by
leaf. The leaves are views of that buffer, in the order of sorted keys, so
the buffer is the model's flat vector as the port flattens it.

Initial values: normal with standard deviation 0.02 for the dense weights
and 1.0 for the token embedding, ones for norm scales, ``a_log`` and
``d_skip``, zeros for biases.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    init: str = "normal"        # normal | ones | zeros
    scale: float = 0.02


def _mamba2_block(cfg: dict) -> Dict[str, LeafSpec]:
    s, d = cfg["ssm"], cfg["d_model"]
    dinner = s["expand"] * d
    heads = dinner // s["head_dim"]
    gn = s["ngroups"] * s["state_dim"]
    conv_dim = dinner + 2 * gn
    return {
        ("norm1", "scale"): ((d,), "ones"),
        ("ssd", "in_proj"): ((d, 2 * dinner + 2 * gn + heads), "normal"),
        ("ssd", "conv_w"): ((s["conv_width"], conv_dim), "normal"),
        ("ssd", "conv_b"): ((conv_dim,), "zeros"),
        ("ssd", "a_log"): ((heads,), "ones"),
        ("ssd", "d_skip"): ((heads,), "ones"),
        ("ssd", "dt_bias"): ((heads,), "zeros"),
        ("ssd", "norm_scale"): ((dinner,), "ones"),
        ("ssd", "out_proj"): ((dinner, d), "normal"),
    }


def _attn_block(cfg: dict) -> Dict[str, LeafSpec]:
    d, h, kv, hd, f = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
                       cfg["head_dim"], cfg["d_ff"])
    return {
        ("norm1", "scale"): ((d,), "ones"),
        ("attn", "wq"): ((d, h, hd), "normal"),
        ("attn", "wk"): ((d, kv, hd), "normal"),
        ("attn", "wv"): ((d, kv, hd), "normal"),
        ("attn", "wo"): ((h, hd, d), "normal"),
        ("norm2", "scale"): ((d,), "ones"),
        ("ffn", "wi_gate"): ((d, f), "normal"),
        ("ffn", "wi_up"): ((d, f), "normal"),
        ("ffn", "wo"): ((f, d), "normal"),
    }


_BLOCKS = {"ssm": ("b0_ssd", _mamba2_block), "dense": ("b0_attn", _attn_block)}


def leaf_specs(cfg: dict) -> List[LeafSpec]:
    """Every leaf of the model, in sorted-key order."""
    d, v, layers = cfg["d_model"], cfg["vocab_size"], cfg["num_layers"]
    name, block = _BLOCKS[cfg["family"]]
    specs = [LeafSpec(("embed", "tok"), (v, d), "normal", 1.0),
             LeafSpec(("final_norm", "scale"), (d,), "ones")]
    if not cfg["tie_embeddings"]:
        specs.append(LeafSpec(("head", "out"), (d, v)))
    for sub, (shape, init) in block(cfg).items():
        specs.append(LeafSpec(("layers", name) + sub, (layers,) + shape,
                              init))
    return sorted(specs, key=lambda s: s.path)


def tree_of(leaves: Dict[Tuple[str, ...], torch.Tensor]) -> dict:
    """The model's tree from its leaves by path (a tied model's ``head`` is
    an empty dict, as the port's forward reads it)."""
    tree: dict = {"embed": {}, "final_norm": {}, "head": {}, "layers": {}}
    for path, t in leaves.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return tree


def carve(cfg: dict, flat: torch.Tensor) -> dict:
    """The tree whose leaves are views of ``flat`` (sorted-key order)."""
    leaves, off = {}, 0
    for s in leaf_specs(cfg):
        size = math.prod(s.shape)
        leaves[s.path] = flat[off:off + size].view(s.shape)
        off += size
    return tree_of(leaves)


def num_elements(cfg: dict) -> int:
    return sum(math.prod(s.shape) for s in leaf_specs(cfg))


def draw(cfg: dict, seed: int, device) -> Tuple[torch.Tensor, dict]:
    """(flat buffer, tree of views) of the model drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(num_elements(cfg), generator=gen, dtype=torch.float32,
                       device=device)
    off = 0
    for s in leaf_specs(cfg):
        size = math.prod(s.shape)
        part = flat[off:off + size]
        if s.init == "ones":
            part.fill_(1.0)
        elif s.init == "zeros":
            part.zero_()
        elif s.scale != 1.0:
            part.mul_(s.scale)
        off += size
    return flat, carve(cfg, flat)


def leaves(tree: dict) -> Dict[Tuple[str, ...], torch.Tensor]:
    """The tree's leaves by path, in sorted-key order."""
    out: Dict[Tuple[str, ...], torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            out[path] = node
    walk(tree, ())
    return out


def draw_pool(seed: int, size: int, n: int, norm: float,
              device) -> torch.Tensor:
    """``size`` delta vectors of n elements, each of norm ``norm``: normal
    draws from a generator of its own, seeded from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 0x9E3779B1 + 0x7F4A7C15) % (1 << 63))
    pool = torch.randn((size, n), generator=gen, dtype=torch.float32,
                       device=device)
    for row in pool:
        row.mul_(norm / float(torch.linalg.vector_norm(row,
                                                       dtype=torch.float64)))
    return pool
