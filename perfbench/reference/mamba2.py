"""Mamba-2 (arXiv:2405.21060) in plain float32: the SSD layer in its
quadratic ("attention") form, with no chunking and no scan.

A block: RMSNorm, the input projection into (z, x, B, C, dt), a depthwise
causal convolution over (x, B, C) and SiLU, the SSD mixer

    y_t = sum_{s <= t} (C_t . B_s) exp(sum_{s < r <= t} dt_r A) dt_s x_s
          + D x_t,

the gate y * SiLU(z) under an RMSNorm, the output projection, and the
residual. The decay sums are taken in float64 from one cumulative sum (a
float32 difference of two long cumulative sums would lose digits). The
head is tied to the token embedding. Parameters are the tree of
:mod:`perfbench.weights`, laid out by :func:`leaf_specs`: the blocks
stacked under ``layers/b0_ssd``.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from perfbench import weights
from perfbench.reference.ops import Precision, rmsnorm, silu

#: the model cut to a size the CPU runs in a second (the benchmark's tests)
TINY = {"name": "tiny-mamba2", "port_arch": "mamba2-1.3b",
        "reference": "mamba2", "family": "ssm", "num_layers": 2,
        "d_model": 32, "vocab_size": 96, "tie_embeddings": True,
        "norm": "rmsnorm",
        "ssm": {"state_dim": 8, "head_dim": 8, "expand": 2, "conv_width": 4,
                "chunk_size": 8, "ngroups": 1},
        "dtype": "float32"}


def leaf_specs(cfg: dict) -> List[weights.LeafSpec]:
    return weights.outer_specs(cfg) + weights.stacked(
        0, "ssd", weights.ssd_specs(cfg), cfg["num_layers"])


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution: y_t = b + sum_i w_i x_{t - W + 1 + i}."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    s = x.shape[1]
    return b + sum(xp[:, i:i + s] * w[i] for i in range(width))


def ssd(x, dt, a, b, c, prec: Precision) -> torch.Tensor:
    """x (B, S, H, P), dt (B, S, H), a (H,), b and c (B, S, G, N)."""
    bs, s, h, p = x.shape
    g = b.shape[2]
    cum = torch.cumsum((dt * a).double(), dim=1)                 # (B, S, H)
    seg = (cum[:, :, None, :] - cum[:, None, :, :]).float()      # (B, t, s, H)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(causal[None, :, :, None], seg,
                                  torch.full_like(seg, float("-inf"))))
    cb = prec.mm(c.permute(0, 2, 1, 3), b.permute(0, 2, 3, 1))  # (B, G, t, s)
    cb = cb.repeat_interleave(h // g, dim=1)                     # (B, H, t, s)
    w = cb * decay.permute(0, 3, 1, 2)
    xdt = (x * dt[..., None]).permute(0, 2, 1, 3)                # (B, H, s, P)
    return prec.mm(w, xdt).permute(0, 2, 1, 3)                   # (B, t, H, P)


def block(p: dict, x: torch.Tensor, cfg: dict, prec: Precision):
    sc = cfg["ssm"]
    d = cfg["d_model"]
    dinner = sc["expand"] * d
    heads = dinner // sc["head_dim"]
    gn = sc["ngroups"] * sc["state_dim"]
    bs, s = x.shape[0], x.shape[1]
    h = rmsnorm(x, p["norm1"]["scale"])
    q = p["ssd"]
    z, xin, bc, dt = torch.split(prec.mm(h, q["in_proj"]),
                                 [dinner, dinner, 2 * gn, heads], dim=-1)
    conv = silu(_causal_conv(torch.cat([xin, bc], dim=-1), q["conv_w"],
                             q["conv_b"]))
    xin, b, c = torch.split(conv, [dinner, gn, gn], dim=-1)
    xh = xin.reshape(bs, s, heads, sc["head_dim"])
    a = -torch.exp(q["a_log"])
    dt = F.softplus(dt + q["dt_bias"])
    y = ssd(xh, dt, a, b.reshape(bs, s, sc["ngroups"], sc["state_dim"]),
            c.reshape(bs, s, sc["ngroups"], sc["state_dim"]), prec)
    y = (y + xh * q["d_skip"][:, None]).reshape(bs, s, dinner)
    y = rmsnorm(y * silu(z), q["norm_scale"])
    return x + prec.mm(y, q["out_proj"])


def forward(params: dict, tokens: torch.Tensor, cfg: dict,
            prec: Precision) -> torch.Tensor:
    """Logits (B, S, V) of token ids (B, S)."""
    x = params["embed"]["tok"][tokens.long()]
    blocks = params["layers"]["b0_ssd"]
    for i in range(cfg["num_layers"]):
        x = block(_layer(blocks, i), x, cfg, prec)
    x = rmsnorm(x, params["final_norm"]["scale"])
    return prec.mm(x, params["embed"]["tok"].t())


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]
