"""Seeded weights of a configuration, made by the benchmark and handed to
both the port and the plain reference.

The tree is laid out as the port's models take it (``embed``, ``layers``
with the layers of each position of the block pattern stacked along a
leading dimension, ``tail{j}_{kind}`` for the layers after the last whole
repetition, ``final_norm``, ``head``), every leaf in float32. The layout
is the configuration's reference module's (its ``leaf_specs``), built
from the parts here: the blocks of the port's kinds (:func:`ssd_specs`,
:func:`attn_specs`), :func:`outer_specs`, :func:`stacked` and
:func:`tail`.

:func:`draw` makes the whole model in a few large calls on the device: one
buffer, one normal draw over it from a ``torch.Generator`` seeded with the
run's seed, then fills and scales by leaf. The leaves are views of that
buffer, in the order of sorted keys, so the buffer is the model's flat
vector as the port flattens it.

Initial values: normal with standard deviation 0.02 for the dense weights
and 1.0 for the token embedding, ones for norm scales, ``a_log`` and
``d_skip``, zeros for biases.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Dict, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    init: str = "normal"        # normal | ones | zeros
    scale: float = 0.02


#: one block's leaves: the path inside the block -> (shape, init)
Block = Dict[Tuple[str, ...], Tuple[Tuple[int, ...], str]]


def ssd_specs(cfg: dict) -> Block:
    """A Mamba-2 block (the port's ``ssd`` kind): a norm and the SSD
    mixer."""
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


def attn_specs(cfg: dict) -> Block:
    """An attention block with a SwiGLU MLP (the port's ``attn`` kind with
    no experts)."""
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


def outer_specs(cfg: dict) -> List[LeafSpec]:
    """The leaves around the layers: the token embedding, the final norm
    and, untied, the head."""
    d, v = cfg["d_model"], cfg["vocab_size"]
    specs = [LeafSpec(("embed", "tok"), (v, d), "normal", 1.0),
             LeafSpec(("final_norm", "scale"), (d,), "ones")]
    if not cfg["tie_embeddings"]:
        specs.append(LeafSpec(("head", "out"), (d, v)))
    return specs


def stacked(i: int, kind: str, block: Block, groups: int) -> List[LeafSpec]:
    """Position ``i`` of the block pattern, a block of ``kind``, stacked
    over the pattern's ``groups`` repetitions under ``layers/b{i}_{kind}``."""
    return [LeafSpec(("layers", f"b{i}_{kind}") + sub, (groups,) + shape,
                     init) for sub, (shape, init) in block.items()]


def tail(j: int, kind: str, block: Block) -> List[LeafSpec]:
    """The ``j``-th layer after the pattern's last whole repetition, a block
    of ``kind``, under ``tail{j}_{kind}``."""
    return [LeafSpec((f"tail{j}_{kind}",) + sub, shape, init)
            for sub, (shape, init) in block.items()]


def leaf_specs(cfg: dict) -> List[LeafSpec]:
    """Every leaf of the model, in sorted-key order: the layout that
    ``leaf_specs`` of the configuration's reference module
    (``perfbench/reference/<reference>.py``) gives."""
    mod = importlib.import_module(f"perfbench.reference.{cfg['reference']}")
    return sorted(mod.leaf_specs(cfg), key=lambda s: s.path)


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
