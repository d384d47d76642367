"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)          recurrence gate
    i_t = sigmoid(W_x x_t + b_x)          input gate
    a_t = a ** (c * r_t),  a = sigmoid(Lambda),  c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Training and prefill go through ``repro_torch.kernels.rglru.ops.RGLRUScan``:
the hand-written scan kernel on CUDA (its plain version, a step-by-step
loop, on the CPU), the plain version's VJP as the backward; decode is the
O(1) step in plain torch, as the JAX package has no kernel for it. The
block wraps the recurrence Griffin-style: two branches (conv1d->RG-LRU and
GeLU), multiplied, then an output projection.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.kernels.rglru.ops import RGLRU_C
from repro_torch.models.layers import gelu
from repro_torch.models.params import ParamDef
from repro_torch.models.ssm import _causal_conv

__all__ = ["RGLRU_C", "rglru_defs", "rglru_scan", "rglru_decode_step",
           "rglru_block_fwd"]


def rglru_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    w = cfg.rglru_width or d
    return {
        "in_x": ParamDef((d, w), ("embed", "mlp")),        # recurrent branch
        "in_gate": ParamDef((d, w), ("embed", "mlp")),     # gelu branch
        "conv_w": ParamDef((cfg.conv1d_width, w), (None, "mlp")),
        "conv_b": ParamDef((w,), ("mlp",), init="zeros"),
        "w_a": ParamDef((w, w), ("mlp", None)),
        "b_a": ParamDef((w,), ("mlp",), init="zeros"),
        "w_i": ParamDef((w, w), ("mlp", None)),
        "b_i": ParamDef((w,), ("mlp",), init="zeros"),
        "lam": ParamDef((w,), ("mlp",), init="lru_lambda"),
        "out": ParamDef((w, d), ("mlp", "embed")),
    }


def rglru_scan(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
               lam: torch.Tensor, h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, r, i: (B, S, W); lam: (W,). Returns (h (B,S,W), final_state (B,W)).
    The reference folds ``h0`` into the first step; the kernel starts from
    it, the same function."""
    return rglru_ops.rglru(x, r, i, lam, h0)


def rglru_decode_step(state: torch.Tensor, x: torch.Tensor, r: torch.Tensor,
                      i: torch.Tensor, lam: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step. state, x, r, i: (B, W)."""
    log_a_base = F.logsigmoid(lam.float())
    log_at = RGLRU_C * r.float() * log_a_base
    at = torch.exp(log_at)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_at), min=1e-12))
    h = at * state.float() + beta * (i.float() * x.float())
    return h.to(x.dtype), h


def rglru_block_fwd(p, x: torch.Tensor, cfg: ModelConfig, *,
                    rec_state=None, conv_state=None):
    """Griffin recurrent block. Returns (y, (rec_state, conv_state))."""
    dt = x.dtype
    xr = torch.einsum("bsd,dw->bsw", x, p["in_x"].to(dt))
    xg = torch.einsum("bsd,dw->bsw", x, p["in_gate"].to(dt))
    xr, new_conv = _causal_conv(xr, p["conv_w"], p["conv_b"], conv_state)
    r = torch.sigmoid(torch.einsum("bsw,wv->bsv", xr, p["w_a"].to(dt))
                      + p["b_a"].to(dt))
    i = torch.sigmoid(torch.einsum("bsw,wv->bsv", xr, p["w_i"].to(dt))
                      + p["b_i"].to(dt))
    if x.shape[1] == 1 and rec_state is not None:
        h, new_state = rglru_decode_step(rec_state, xr[:, 0], r[:, 0],
                                         i[:, 0], p["lam"])
        h = h[:, None]
    else:
        h, new_state = rglru_scan(xr, r, i, p["lam"], h0=rec_state)
    y = h * gelu(xg)
    out = torch.einsum("bsw,wd->bsd", y, p["out"].to(dt))
    return out, (new_state, new_conv)
