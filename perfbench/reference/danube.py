"""H2O-Danube (arXiv:2401.16818) in plain float32: a Llama-style decoder
with grouped-query attention inside a sliding window.

A block: RMSNorm, the q, k and v projections, rotary embeddings (each
head's two halves as the rotated pair, theta from the configuration), the
key and value heads repeated to the query heads, softmax attention over the
full score matrix with the causal and window mask, the output projection
and the residual; then RMSNorm, the SwiGLU MLP and the residual. The head
is untied. Parameters are the tree of :mod:`perfbench.weights`, laid out
by :func:`leaf_specs`: the blocks stacked under ``layers/b0_attn``.
"""
from __future__ import annotations

from typing import List

import torch

from perfbench import weights
from perfbench.reference.ops import Precision, rmsnorm, silu

#: the model cut to a size the CPU runs in a second (the benchmark's tests)
TINY = {"name": "tiny-danube", "port_arch": "h2o-danube-1.8b",
        "reference": "danube", "family": "dense", "num_layers": 2,
        "d_model": 32, "num_heads": 4, "num_kv_heads": 2, "head_dim": 8,
        "d_ff": 48, "vocab_size": 96, "sliding_window": 12,
        "rope_theta": 10000.0, "tie_embeddings": False, "norm": "rmsnorm",
        "dtype": "float32"}


def leaf_specs(cfg: dict) -> List[weights.LeafSpec]:
    return weights.outer_specs(cfg) + weights.stacked(
        0, "attn", weights.attn_specs(cfg), cfg["num_layers"])


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D) rotated at positions 0 .. S - 1."""
    s, dim = x.shape[1], x.shape[-1]
    half = dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(p: dict, x: torch.Tensor, cfg: dict, prec: Precision):
    bs, s, d = x.shape
    h, kv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    q = prec.mm(x, p["wq"].reshape(d, h * hd)).view(bs, s, h, hd)
    k = prec.mm(x, p["wk"].reshape(d, kv * hd)).view(bs, s, kv, hd)
    v = prec.mm(x, p["wv"].reshape(d, kv * hd)).view(bs, s, kv, hd)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    scores = prec.mm(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1)) * hd ** -0.5
    t = torch.arange(s, device=x.device)
    visible = t[None, :] <= t[:, None]
    if cfg["sliding_window"]:
        visible &= t[None, :] > t[:, None] - cfg["sliding_window"]
    scores = scores.masked_fill(~visible, float("-inf"))
    o = prec.mm(torch.softmax(scores, dim=-1), v.permute(0, 2, 1, 3))
    o = o.permute(0, 2, 1, 3).reshape(bs, s, h * hd)
    return prec.mm(o, p["wo"].reshape(h * hd, d))


def block(p: dict, x: torch.Tensor, cfg: dict, prec: Precision):
    x = x + attention(p["attn"], rmsnorm(x, p["norm1"]["scale"]), cfg, prec)
    h = rmsnorm(x, p["norm2"]["scale"])
    f = p["ffn"]
    act = silu(prec.mm(h, f["wi_gate"])) * prec.mm(h, f["wi_up"])
    return x + prec.mm(act, f["wo"])


def forward(params: dict, tokens: torch.Tensor, cfg: dict,
            prec: Precision) -> torch.Tensor:
    """Logits (B, S, V) of token ids (B, S)."""
    x = params["embed"]["tok"][tokens.long()]
    blocks = params["layers"]["b0_attn"]
    for i in range(cfg["num_layers"]):
        x = block({k: {n: t[i] for n, t in v.items()}
                   for k, v in blocks.items()}, x, cfg, prec)
    x = rmsnorm(x, params["final_norm"]["scale"])
    return prec.mm(x, params["head"]["out"])
