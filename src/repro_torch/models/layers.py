"""Core neural-net primitives: norms, RoPE/M-RoPE, attention, MLPs, the
embedding and the head.

The JAX package's ``models/layers.py`` in PyTorch: pure functions
``fwd(params, x, ...) -> y`` over dicts of tensors, with each parameter tree
declared beside its forward by ``*_defs``, in the reference's layouts
(``(in, out)`` dense weights, ``(d, heads, head_dim)`` projections), so that
its weights carry across as they are. Decode attention goes through the
hand-written kernel of ``repro_torch.kernels.swa_attn`` on CUDA; the dense
products stay plain ``torch`` ops, as the JAX package leaves them to XLA.

The audio (multi-codebook) and vision front ends are not ported: they raise
``NotImplementedError`` naming ROADMAP.md A18b.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.swa_attn import ops as swa_ops
from repro_torch.kernels.swa_attn.swa_attn import swa_decode_plain
from repro_torch.models.params import ParamDef, torch_dtype

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_defs(cfg: ModelConfig, width: Optional[int] = None) -> Dict[str, ParamDef]:
    w = width or cfg.d_model
    d = {"scale": ParamDef((w,), ("embed",), init="ones")}
    if cfg.norm == "layernorm":
        d["bias"] = ParamDef((w,), ("embed",), init="zeros")
    return d


def norm_fwd(p, x: torch.Tensor, kind: str) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * p["scale"].float()
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = ((xf - mu) * torch.rsqrt(var + 1e-5) * p["scale"].float()
             + p["bias"].float())
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (RoPE and Qwen2-VL M-RoPE)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def mrope_sections(head_dim: int) -> Tuple[int, int, int]:
    """(temporal, height, width) frequency sections; Qwen2-VL uses 16/24/24
    of the 64 half-dims at head_dim=128 — we keep those proportions."""
    half = head_dim // 2
    t = max(1, round(half * 0.25))
    h = max(1, round(half * 0.375))
    return (t, h, half - t - h)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope: bool = False) -> torch.Tensor:
    """x: (B, S, H, D). positions: (B, S) or (3, B, S) for M-RoPE. The
    split-half rotation: the first and second halves of D are the pair."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)        # (half,)
    if mrope:
        if positions.dim() == 2:                         # text-only: t=h=w=pos
            positions = positions[None].expand((3,) + tuple(positions.shape))
        t, h, w = mrope_sections(head_dim)
        sec = torch.tensor([0] * t + [1] * h + [2] * w, device=x.device)
        # angle[b, s, k] = positions[sec[k], b, s] * freqs[k]
        pos_sel = positions.permute(1, 2, 0)[..., sec]  # (B, S, half)
        angles = pos_sel.float() * freqs
    else:
        angles = positions[..., None].float() * freqs   # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]               # (B, S, 1, half)
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attention_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, hd = cfg.d_model, cfg.head_dim
    defs = {
        "wq": ParamDef((d, cfg.num_heads, hd), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, cfg.num_kv_heads, hd),
                       ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, cfg.num_kv_heads, hd),
                       ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((cfg.num_heads, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((cfg.num_heads, hd), ("heads", None), init="zeros")
        defs["bk"] = ParamDef((cfg.num_kv_heads, hd), ("kv_heads", None), init="zeros")
        defs["bv"] = ParamDef((cfg.num_kv_heads, hd), ("kv_heads", None), init="zeros")
    return defs


def _repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, H, D) by repeating each kv head."""
    rep = num_heads // k.shape[2]
    return k if rep == 1 else k.repeat_interleave(rep, dim=2)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool, window: int = 0, q_offset: int = 0,
                      q_chunk: int = 1024, kv_chunk: int = 1024,
                      skip_masked_blocks: bool = True, softcap: float = 0.0,
                      mode: str = "auto") -> torch.Tensor:
    """Flash-style streaming-softmax attention in plain torch.

    q: (B, Sq, H, D); k/v: (B, Skv, H, D) (kv heads already repeated). The
    S x S score matrix is never formed: query chunks stream over key
    chunks with a running max and sum. The JAX package's two lowerings are
    one loop here: ``unrolled`` skips the (query, key) chunk pairs that
    causality and the window mask entirely (``skip_masked_blocks``),
    ``scan`` computes every pair, as its ``lax.scan`` does; ``auto`` picks
    as the reference does. Masked scores are -1e30 and the final division
    is by max(l, 1e-30), as in the reference.
    """
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if mode == "auto":
        nq_ = max(1, sq // min(q_chunk, sq))
        nkv_ = max(1, skv // min(kv_chunk, skv))
        mode = "unrolled" if nq_ * nkv_ <= 64 else "scan"
    if mode not in ("unrolled", "scan"):
        raise ValueError(f"unknown attention mode {mode!r}")
    skip = skip_masked_blocks and mode == "unrolled"
    scale = d ** -0.5
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    nq, nkv = sq // q_chunk, skv // kv_chunk
    if sq % q_chunk or skv % kv_chunk:
        raise ValueError(f"chunks ({q_chunk}, {kv_chunk}) do not divide "
                         f"({sq}, {skv})")
    dev = q.device

    def block_visible(qi: int, ki: int) -> bool:
        """Can any (query, key) pair in this block attend?"""
        q_lo = q_offset + qi * q_chunk
        q_hi = q_lo + q_chunk - 1
        k_lo, k_hi = ki * kv_chunk, ki * kv_chunk + kv_chunk - 1
        if causal and k_lo > q_hi:
            return False                                    # all in the future
        if window and k_hi < (q_lo - window + 1):
            return False                                    # all out of window
        return True

    outs = []
    for qi in range(nq):
        qblk = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        qpos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((b, h, q_chunk), -1e30, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, q_chunk, d), dtype=torch.float32, device=dev)
        for ki in range(nkv):
            if skip and not block_visible(qi, ki):
                continue
            kb = k[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            vb = v[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            s = torch.einsum("bqhd,bkhd->bhqk", qblk.float(),
                             kb.float()) * scale
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            kpos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window:
                mask &= kpos[None, :] > (qpos[:, None] - window)
            s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, vb.float())
            m = m_new
        blk = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(blk.permute(0, 2, 1, 3))                 # (B,Cq,H,D)
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_len, *,
                     softcap: float = 0.0) -> torch.Tensor:
    """One-token decode. q: (B, 1, H, D); caches: (B, S, H, D) (kv repeated).

    ``valid_len`` may be an int or (B,) lengths; positions >= valid_len are
    masked (for ring-buffer windows the whole buffer is valid and valid_len
    equals the buffer size). This is the plain version of the decode
    kernel: :func:`repro_torch.kernels.swa_attn.swa_attn.swa_decode_plain`.
    """
    vl = torch.as_tensor(valid_len).reshape(-1).expand(q.shape[0])
    return swa_decode_plain(q[:, 0], k_cache, v_cache, vl,
                            softcap)[:, None]


def attention_fwd(p, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, *, window: int, kv_cache=None,
                  cache_index=None, q_chunk: int = 1024, kv_chunk: int = 1024,
                  skip_masked_blocks: bool = True, attn_mode: str = "auto"):
    """Full attention block. Returns (y, new_kv) where new_kv is
    (k, v) of this call (for prefill cache building) or the updated cache.

    Train/prefill: kv_cache is None -> chunked causal attention over x itself.
    Decode: kv_cache = (k, v) ring/linear buffers, cache_index = write slot
    (an int); the new token's k and v go into a copy of each buffer, and the
    query attends over the un-repeated caches through the decode kernel.
    """
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = apply_rope(q, positions, cfg.rope_theta, mrope=cfg.mrope)
    k = apply_rope(k, positions, cfg.rope_theta, mrope=cfg.mrope)

    if kv_cache is None:
        kr = _repeat_kv(k, cfg.num_heads)
        vr = _repeat_kv(v, cfg.num_heads)
        o = chunked_attention(q, kr, vr, causal=True, window=window,
                              q_chunk=q_chunk, kv_chunk=kv_chunk,
                              skip_masked_blocks=skip_masked_blocks,
                              softcap=cfg.attn_logit_softcap, mode=attn_mode)
        new_cache = (k, v)
    else:
        k_cache, v_cache = kv_cache
        index = int(cache_index)
        slot = index % k_cache.shape[1]                       # ring buffer
        k_cache, v_cache = k_cache.clone(), v_cache.clone()
        k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
        valid = min(index + 1, k_cache.shape[1])
        o = swa_ops.decode_attention(q, k_cache, v_cache, valid,
                                     softcap=cfg.attn_logit_softcap)
        new_cache = (k_cache, v_cache)
    y = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    return y, new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_defs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.activation in ("swiglu", "geglu"):
        return {
            "wi_gate": ParamDef((d, f), ("embed", "mlp")),
            "wi_up": ParamDef((d, f), ("embed", "mlp")),
            "wo": ParamDef((f, d), ("mlp", "embed")),
        }
    return {
        "wi": ParamDef((d, f), ("embed", "mlp")),
        "wo": ParamDef((f, d), ("mlp", "embed")),
    }


def mlp_fwd(p, x: torch.Tensor, activation: str) -> torch.Tensor:
    dt = x.dtype
    if activation in ("swiglu", "geglu"):
        g = torch.einsum("bsd,df->bsf", x, p["wi_gate"].to(dt))
        u = torch.einsum("bsd,df->bsf", x, p["wi_up"].to(dt))
        act = F.silu(g) if activation == "swiglu" else gelu(g)
        h = act * u
    else:
        h = gelu(torch.einsum("bsd,df->bsf", x, p["wi"].to(dt)))
    return torch.einsum("bsf,fd->bsd", h, p["wo"].to(dt))


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def _text_only(cfg: ModelConfig) -> None:
    if cfg.family in ("audio", "vlm"):
        raise NotImplementedError(
            f"the {cfg.family} front end of {cfg.arch_id} is not ported yet "
            "(ROADMAP.md A18b)")


def embed_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    _text_only(cfg)
    return {"tok": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                            scale=1.0)}


def head_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    _text_only(cfg)
    if cfg.tie_embeddings:
        return {}
    return {"out": ParamDef((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))}


def embed_fwd(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """tokens: (B, S) integer ids -> (B, S, d_model) in the config's dtype."""
    _text_only(cfg)
    return p["tok"][tokens].to(torch_dtype(cfg.dtype))


def head_fwd(p_head, p_embed, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, p_embed["tok"].to(dt))
    return torch.einsum("bsd,dv->bsv", x, p_head["out"].to(dt))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  impl: str = "gather") -> torch.Tensor:
    """Mean next-token cross entropy in f32. logits (..., V); labels (...)
    integer ids; ``mask`` (...) weights the positions (a masked mean).

    ``impl="gather"`` picks each gold logit by its index;
    ``impl="onehot"`` selects it with an iota comparison and a sum over
    the vocabulary, the JAX package's form for vocab-sharded logits. Both
    give the reference's ``models/layers.py::cross_entropy``.
    """
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    if impl == "onehot":
        iota = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.sum(torch.where(iota == labels[..., None], logits, 0.0),
                         dim=-1)
    elif impl == "gather":
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    else:
        raise ValueError(f"unknown cross-entropy impl {impl!r}")
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
