"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060).

Training and prefill use the chunked block decomposition: intra-chunk
attention-like dense products plus the inter-chunk state recurrence. It goes
through ``repro_torch.kernels.ssd.ops.SSDScan``: the hand-written
``ssd_scan`` kernel on CUDA, whether or not a starting state is given, and
the kernel's plain version on the CPU, with the plain version's VJP as the
backward and one launch for a vmapped cohort. Decode is the O(1) recurrent update in plain torch, as the
JAX package has no kernel for it. :func:`ssd_chunked` is the JAX package's
model-path scan, kept as the reference writes it; here it is the kernel's
oracle. The depthwise causal conv1d is shared with the RG-LRU block.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models.params import ParamDef


def ssd_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    s = cfg.ssm
    dinner = s.expand * cfg.d_model
    nheads = s.num_heads or dinner // s.head_dim
    return dinner, nheads, s.head_dim, s.state_dim


def ssd_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    s = cfg.ssm
    d = cfg.d_model
    dinner, nheads, _, n = ssd_dims(cfg)
    conv_dim = dinner + 2 * s.ngroups * n
    return {
        "in_proj": ParamDef(
            (d, 2 * dinner + 2 * s.ngroups * n + nheads), ("embed", "mlp")),
        "conv_w": ParamDef((s.conv_width, conv_dim), (None, "mlp")),
        "conv_b": ParamDef((conv_dim,), ("mlp",), init="zeros"),
        "a_log": ParamDef((nheads,), ("heads",), init="ones"),
        "d_skip": ParamDef((nheads,), ("heads",), init="ones"),
        "dt_bias": ParamDef((nheads,), ("heads",), init="zeros"),
        "norm_scale": ParamDef((dinner,), ("mlp",), init="ones"),
        "out_proj": ParamDef((dinner, d), ("mlp", "embed")),
    }


def segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{j < k <= i} x[..., k].
    Lower-triangular; -inf above the diagonal."""
    l = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x: (B, S, H, P)   dt: (B, S, H) (already softplus'ed, >0)
    a: (H,) (negative) b, c: (B, S, G, N)
    Returns (y (B,S,H,P), final_state (B,H,P,N)).
    """
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = s // chunk
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {chunk}")
    rep = h // g

    xc = x.reshape(bs, nc, chunk, h, p)
    dtc = dt.reshape(bs, nc, chunk, h)
    bc = b.reshape(bs, nc, chunk, g, n)
    cc = c.reshape(bs, nc, chunk, g, n)
    bh = torch.repeat_interleave(bc, rep, dim=3)           # (B,C,L,H,N)
    ch = torch.repeat_interleave(cc, rep, dim=3)

    da = dtc * a[None, None, None, :]                      # (B,C,L,H) negative
    da_cum = torch.cumsum(da, dim=2)                       # within-chunk

    # 1. intra-chunk (diagonal blocks): attention-like dense products
    lmat = torch.exp(segsum(da.permute(0, 1, 3, 2)))       # (B,C,H,L,L)
    scores = torch.einsum("bclhn,bcshn->bchls", ch.float(), bh.float())
    y_diag = torch.einsum("bchls,bcshn->bclhn", scores * lmat,
                          (xc * dtc[..., None]).float())
    y_diag = y_diag.to(x.dtype)

    # 2. chunk states: what each chunk contributes to the carried state
    decay_states = torch.exp(da_cum[:, :, -1:, :] - da_cum)  # (B,C,L,H)
    states = torch.einsum("bclhn,bclh,bclhp->bchpn", bh.float(),
                          decay_states.float(),
                          (xc * dtc[..., None]).float())    # (B,C,H,P,N)

    # 3. inter-chunk recurrence, chunk after chunk
    chunk_decay = torch.exp(da_cum[:, :, -1, :])           # (B,C,H)
    if initial_state is None:
        carry = torch.zeros((bs, h, p, n), dtype=torch.float32,
                            device=x.device)
    else:
        carry = initial_state.float()
    prev = []
    for k in range(nc):
        prev.append(carry)                                  # state *before* chunk
        carry = carry * chunk_decay[:, k, :, None, None] + states[:, k]
    prev_states = torch.stack(prev, dim=1)                  # (B,C,H,P,N)

    # 4. state -> output within each chunk
    state_decay = torch.exp(da_cum)                         # (B,C,L,H)
    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp", ch.float(), prev_states,
                         state_decay.float())
    y = (y_diag.float() + y_off).reshape(bs, s, h, p)
    return y.to(x.dtype), carry


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence. state: (B,H,P,N); x: (B,H,P); dt: (B,H);
    b,c: (B,G,N). Returns (y (B,H,P), new_state)."""
    h = x.shape[1]
    g = b.shape[1]
    bh = torch.repeat_interleave(b, h // g, dim=1)          # (B,H,N)
    ch = torch.repeat_interleave(c, h // g, dim=1)
    da = torch.exp(dt * a[None, :])                         # (B,H)
    new = (state * da[..., None, None]
           + torch.einsum("bhp,bhn->bhpn", (x * dt[..., None]).float(),
                          bh.float()))
    y = torch.einsum("bhpn,bhn->bhp", new, ch.float())
    return y.to(x.dtype), new


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d. x: (B,S,C); w: (W,C). Returns (y, new_state)
    where state is the last (W-1) inputs (for decode), a copy: a view would
    keep the whole padded input alive in the decode cache."""
    width = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                        # (B, S+W-1, C)
    y = xp[:, 0:x.shape[1], :] * w[0][None, None, :].to(x.dtype)
    for i in range(1, width):
        y = y + xp[:, i:i + x.shape[1], :] * w[i][None, None, :].to(x.dtype)
    y = y + b[None, None, :].to(x.dtype)
    new_state = xp[:, -(width - 1):, :].clone()
    return y, new_state


def ssd_block_fwd(p, x: torch.Tensor, cfg: ModelConfig, *,
                  ssm_state=None, conv_state=None):
    """Full Mamba-2 block: in_proj -> conv -> SSD -> gated norm -> out_proj.

    Prefill: the chunked scan from ``ssm_state`` (zero when None), returns
    (y, (ssm, conv) states). Decode: pass both states (x has S=1).
    """
    s = cfg.ssm
    dinner, nheads, hd, n = ssd_dims(cfg)
    gn = s.ngroups * n
    dt_f = x.dtype
    zxbcdt = torch.einsum("bsd,de->bse", x, p["in_proj"].to(dt_f))
    z, xin, bc, dt = torch.split(
        zxbcdt, [dinner, dinner, 2 * gn, nheads], dim=-1)
    conv_in = torch.cat([xin, bc], dim=-1)
    conv_out, new_conv = _causal_conv(conv_in, p["conv_w"], p["conv_b"],
                                      conv_state)
    conv_out = F.silu(conv_out)
    xin, b, c = torch.split(conv_out, [dinner, gn, gn], dim=-1)
    bsz, sl = x.shape[0], x.shape[1]
    xh = xin.reshape(bsz, sl, nheads, hd)
    bg = b.reshape(bsz, sl, s.ngroups, n)
    cg = c.reshape(bsz, sl, s.ngroups, n)
    a = -torch.exp(p["a_log"].float())
    dt = F.softplus(dt.float() + p["dt_bias"].float())

    if sl == 1 and ssm_state is not None:
        y, new_state = ssd_decode_step(
            ssm_state, xh[:, 0], dt[:, 0], a, bg[:, 0], cg[:, 0])
        y = y[:, None]
    else:
        chunk = min(s.chunk_size, sl)
        y, new_state = ssd_ops.ssd_chunked(xh, dt, a, bg, cg, chunk,
                                           initial_state=ssm_state)
    y = y + xh * p["d_skip"].to(dt_f)[None, None, :, None]
    y = y.reshape(bsz, sl, dinner)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = y * F.silu(z)
    yf = y.float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    y = (yf * torch.rsqrt(var + 1e-6) * p["norm_scale"].float()).to(dt_f)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(dt_f))
    return out, (new_state, new_conv)
