"""Analytic FLOPs / HBM-bytes model for the roofline.

Napkin-math totals from the model config, the arithmetic a performance
engineer does by hand: a copy of the JAX package's ``launch/analytic.py``,
pinned equal to it over every (arch x shape x attention mode). The dry run
(``launch/dryrun.py``) records these beside the flops its meta trace counts
(which see every layer and every op the step runs).

Conventions:
* matmul flops = 2*M*N*K
* train multiplier: fwd(1) + bwd(2) + full-remat recompute(1) = 4x fwd
* attention pairwise context per token:
    - scan mode computes every (q, kv) block -> C = S
    - unrolled+skip computes only visible blocks -> C ~= S/2 (causal),
      or ~= min(window + chunk, S/2) with a sliding window
* MoE (gshard): compute rides capacity slots = top_k * capacity_factor
  tokens per token, plus shared experts and the router.
"""
from __future__ import annotations

import math
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.ssm import ssd_dims


def _attn_context(cfg: ModelConfig, s: int, attn_mode: str, window: int,
                  q_chunk: int = 1024, kv_chunk: int = 1024) -> float:
    """Average computed context length per query token."""
    if attn_mode == "scan" or (attn_mode == "auto" and
                               (s // min(q_chunk, s)) *
                               (s // min(kv_chunk, s)) > 64):
        return float(s)                       # masked blocks still computed
    causal_avg = (s + 1) / 2
    if window:
        return float(min(window + kv_chunk, causal_avg))
    return float(min(causal_avg + kv_chunk / 2, s))


def _block_flops_per_token(cfg: ModelConfig, kind: str, ctx: float) -> float:
    d, hd = cfg.d_model, cfg.head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    if kind == "attn":
        f = 2 * d * h * hd + 2 * 2 * d * kv * hd + 2 * h * hd * d   # qkv + o
        f += 4 * h * ctx * hd                                       # scores+av
        if cfg.moe is not None:
            m = cfg.moe
            f += 2 * d * m.num_experts                              # router
            f += 6 * d * m.expert_d_ff * m.num_experts_per_tok * m.capacity_factor
            if m.num_shared_experts:
                sf = m.shared_d_ff or m.expert_d_ff * m.num_shared_experts
                f += 6 * d * sf + 2 * d
        else:
            mult = 6 if cfg.activation in ("swiglu", "geglu") else 4
            f += mult * d * cfg.d_ff
        return f
    if kind == "rglru":
        w = cfg.rglru_width or d
        f = 2 * d * w * 2 + 2 * w * w * 2 + 2 * w * d
        f += 2 * cfg.conv1d_width * w + 12 * w          # conv + gates/scan
        mult = 6 if cfg.activation in ("swiglu", "geglu") else 4
        f += mult * d * cfg.d_ff
        return f
    if kind == "ssd":
        s_ = cfg.ssm
        dinner, nheads, p, n = ssd_dims(cfg)
        gn = s_.ngroups * n
        f = 2 * d * (2 * dinner + 2 * gn + nheads) + 2 * dinner * d
        f += 2 * s_.conv_width * (dinner + 2 * gn)
        l = s_.chunk_size
        # intra-chunk scores (L*N) + y_diag (L*P) + state in/out (4*N*P)
        f += nheads * (2 * l * n + 2 * l * p + 4 * n * p)
        return f
    raise ValueError(kind)


def analytic_cost(cfg: ModelConfig, shape: ShapeConfig, chips: int,
                  attn_mode: str = "auto") -> Dict[str, float]:
    gb, s = shape.global_batch, shape.seq_len
    window = cfg.sliding_window
    if shape.name == "long_500k" and not window:
        window = cfg.long_context_window

    if shape.kind == "decode":
        tokens = float(gb)
        ctx = float(min(window, s) if window else s)
    else:
        tokens = float(gb * s)
        ctx = _attn_context(cfg, s, attn_mode, window)

    flops = 0.0
    for kind in cfg.layer_kinds:
        flops += _block_flops_per_token(cfg, kind, ctx) * tokens
    # head (+ per-codebook heads)
    head_tokens = tokens if shape.kind == "train" else float(gb)
    flops += 2 * cfg.d_model * cfg.vocab_size * cfg.num_codebooks * head_tokens
    if shape.kind == "train":
        flops *= 4.0                       # bwd 2x + remat recompute 1x

    # ---- HBM bytes (per device) ----
    p_dev = cfg.param_count() / chips
    act_dtype = 2                          # bf16
    pb = 4 if cfg.param_dtype == "float32" else 2    # param storage bytes
    if shape.kind == "train":
        # param read fwd + remat + bwd-weights + grad write
        w_bytes = p_dev * (pb * 3 + 4)
        # optimizer: read m,v (8) write p,m,v (8 + pb)
        w_bytes += p_dev * (16 + pb)
        # saved activations: one (B,S,d) per layer group, write + read
        n_layers = cfg.num_layers
        act = tokens / chips * cfg.d_model * act_dtype * 2 * n_layers
        # logits: write fwd + read bwd (bf16) + grad write
        logits = tokens / chips * cfg.vocab_size * cfg.num_codebooks * act_dtype * 3
        total_bytes = w_bytes + act + logits
    elif shape.kind == "prefill":
        w_bytes = p_dev * pb               # one read
        act = tokens / chips * cfg.d_model * act_dtype * 2 * cfg.num_layers
        kv_write = (tokens / chips * cfg.num_kv_heads * cfg.head_dim * 2
                    * act_dtype * sum(1 for k in cfg.layer_kinds if k == "attn"))
        total_bytes = w_bytes + act + kv_write
    else:  # decode
        w_bytes = p_dev * pb
        n_attn = sum(1 for k in cfg.layer_kinds if k == "attn")
        cache_len = min(window, s) if window else s
        kv_read = (gb / chips * cache_len * cfg.num_kv_heads * cfg.head_dim
                   * 2 * act_dtype * n_attn)
        state = 0.0
        for kind in cfg.layer_kinds:
            if kind == "ssd":
                dinner, nheads, p, n = ssd_dims(cfg)
                state += gb / chips * nheads * p * n * 4 * 2
            elif kind == "rglru":
                state += gb / chips * (cfg.rglru_width or cfg.d_model) * 4 * 2
        total_bytes = w_bytes + kv_read + state

    return {
        "flops_global": flops,
        "flops_per_device": flops / chips,
        "bytes_per_device": total_bytes,
        "attn_context_tokens": ctx,
    }
