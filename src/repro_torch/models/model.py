"""Model assembly: residual blocks -> layer groups -> logits.

The JAX package's ``models/model.py`` in PyTorch, with its parameter and
cache trees: the layers of each repetition of the block pattern are stacked
under ``"layers"`` with a leading group dimension, and the remainder layers
are ``tail{j}_{kind}`` entries, so the reference's weights carry across as a
plain copy (``repro_torch.convert.params_from_numpy``). Where the reference
runs ``jax.lax.scan`` over the groups, this module loops over the group
index in Python.

It has the attention block with a dense or a mixture-of-experts MLP
(``models.moe``), the RG-LRU block with a dense MLP, and the Mamba-2 SSD
block, a norm and the SSD mixer with no MLP: every block of the ten
assigned configurations. A block returns its MoE router's aux loss, and the
forward sums them over the layers.

Public entry points:
  model_defs(cfg)                  -> ParamDef tree
  init_model(gen, cfg)             -> materialized params on gen's device
  forward(params, tokens, cfg, ...) -> logits, aux, caches|None (training,
                                      prefill; vlm patch_embeds)
  cache_specs(cfg, batch, len, window) -> decode-cache shapes and dtypes
  init_cache(cfg, batch, len, window, device) -> zeroed decode caches
  decode_step(params, cache, tokens, index, cfg) -> logits, new cache
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM
from repro_torch.models.params import init_params, stack_defs, torch_dtype
from repro_torch.utils import pytree as pt

PyTree = Any


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _check_kind(kind: str) -> None:
    if kind not in ("attn", "rglru", "ssd"):
        raise ValueError(kind)


def block_defs(cfg: ModelConfig, kind: str) -> Dict[str, PyTree]:
    _check_kind(kind)
    if kind == "attn":
        ffn = MOE.moe_defs(cfg) if cfg.moe is not None else L.mlp_defs(cfg)
        return {"norm1": L.norm_defs(cfg), "attn": L.attention_defs(cfg),
                "norm2": L.norm_defs(cfg), "ffn": ffn}
    if kind == "ssd":
        return {"norm1": L.norm_defs(cfg), "ssd": SSM.ssd_defs(cfg)}
    return {"norm1": L.norm_defs(cfg), "rglru": RG.rglru_defs(cfg),
            "norm2": L.norm_defs(cfg), "ffn": L.mlp_defs(cfg)}


def block_fwd(p, x: torch.Tensor, positions, cfg: ModelConfig, kind: str, *,
              window: int, cache=None, cache_index=None,
              q_chunk: int = 1024, kv_chunk: int = 1024,
              skip_masked_blocks: bool = True, attn_mode: str = "auto"):
    """One residual block. Returns (y, new_cache, aux_loss), the aux loss
    an f32 scalar tensor: the MoE router's, zero for the other blocks."""
    _check_kind(kind)
    aux = x.new_zeros((), dtype=torch.float32)
    h = L.norm_fwd(p["norm1"], x, cfg.norm)
    if kind == "ssd":
        ssm_state, conv = cache if cache is not None else (None, None)
        h, new_cache = SSM.ssd_block_fwd(p["ssd"], h, cfg,
                                         ssm_state=ssm_state, conv_state=conv)
        return x + h, new_cache, aux
    if kind == "attn":
        h, new_cache = L.attention_fwd(
            p["attn"], h, positions, cfg, window=window,
            kv_cache=cache, cache_index=cache_index,
            q_chunk=q_chunk, kv_chunk=kv_chunk,
            skip_masked_blocks=skip_masked_blocks, attn_mode=attn_mode)
    else:
        rec, conv = cache if cache is not None else (None, None)
        h, new_cache = RG.rglru_block_fwd(p["rglru"], h, cfg,
                                          rec_state=rec, conv_state=conv)
    x = x + h
    h = L.norm_fwd(p["norm2"], x, cfg.norm)
    if kind == "attn" and cfg.moe is not None:
        h, aux = MOE.moe_fwd(p["ffn"], h, cfg)
    else:
        h = L.mlp_fwd(p["ffn"], h, cfg.activation)
    return x + h, new_cache, aux


# ---------------------------------------------------------------------------
# Layer grouping
# ---------------------------------------------------------------------------


def _grouping(cfg: ModelConfig) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
    """(pattern, n_groups, tail_kinds)."""
    kinds = cfg.layer_kinds
    pat = cfg.block_pattern or (kinds[0],)
    plen = len(pat)
    n_groups = len(kinds) // plen
    tail = kinds[n_groups * plen:]
    return tuple(pat), n_groups, tuple(tail)


def model_defs(cfg: ModelConfig) -> Dict[str, PyTree]:
    pat, n_groups, tail = _grouping(cfg)
    group = {f"b{i}_{k}": block_defs(cfg, k) for i, k in enumerate(pat)}
    defs: Dict[str, PyTree] = {
        "embed": L.embed_defs(cfg),
        "layers": stack_defs(group, n_groups) if n_groups else {},
        "final_norm": L.norm_defs(cfg),
        "head": L.head_defs(cfg),
    }
    for j, k in enumerate(tail):
        defs[f"tail{j}_{k}"] = block_defs(cfg, k)
    return defs


def init_model(gen: torch.Generator, cfg: ModelConfig) -> PyTree:
    """Params drawn from ``gen`` on its device (``models.params``)."""
    return init_params(gen, model_defs(cfg), cfg.param_dtype)


def _group(tree: PyTree, g: int) -> PyTree:
    """Group ``g`` of a tree stacked along a leading group dimension."""
    return pt.tree_map(lambda t: t[g], tree)


def _stack(trees) -> PyTree:
    """Per-group trees stacked along a new leading group dimension."""
    return pt.tree_map(lambda *ts: torch.stack(ts), *trees)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """The shape and dtype of one cache tensor (a leaf of the spec tree)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _block_cache_spec(cfg: ModelConfig, kind: str, batch: int,
                      cache_len: int) -> PyTree:
    """Specs of one block's decode cache."""
    _check_kind(kind)
    dt = torch_dtype(cfg.dtype)
    if kind == "attn":
        shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
        return (TensorSpec(shape, dt), TensorSpec(shape, dt))
    if kind == "ssd":
        dinner, nheads, hd, n = SSM.ssd_dims(cfg)
        conv_dim = dinner + 2 * cfg.ssm.ngroups * n
        return (TensorSpec((batch, nheads, hd, n), torch.float32),
                TensorSpec((batch, cfg.ssm.conv_width - 1, conv_dim), dt))
    w = cfg.rglru_width or cfg.d_model
    return (TensorSpec((batch, w), torch.float32),
            TensorSpec((batch, cfg.conv1d_width - 1, w), dt))


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int,
                window: int) -> PyTree:
    """Cache spec tree matching the params layout (stacked groups + tail).

    ``cache_len`` applies to attention KV buffers; when ``window`` is set the
    buffer is a ring of min(window, cache_len) slots.
    """
    pat, n_groups, tail = _grouping(cfg)
    attn_len = min(window, cache_len) if window else cache_len

    def spec(kind):
        return _block_cache_spec(cfg, kind, batch,
                                 attn_len if kind == "attn" else cache_len)

    out: Dict[str, PyTree] = {}
    if n_groups:
        group = {f"b{i}_{k}": spec(k) for i, k in enumerate(pat)}
        out["layers"] = pt.tree_map(
            lambda s: TensorSpec((n_groups,) + s.shape, s.dtype), group)
    for j, k in enumerate(tail):
        out[f"tail{j}_{k}"] = spec(k)
    return out


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, window: int,
               device=None) -> PyTree:
    """Zeroed decode caches on ``device``, laid out as :func:`cache_specs`."""
    return pt.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                             device=device),
                       cache_specs(cfg, batch, cache_len, window))


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def forward(params: PyTree, tokens: torch.Tensor, cfg: ModelConfig, *,
            patch_embeds: Optional[torch.Tensor] = None,
            window: int = 0, collect_cache: bool = False,
            remat: bool = True, q_chunk: int = 1024, kv_chunk: int = 1024,
            skip_masked_blocks: bool = True, attn_mode: str = "auto",
            logits_slice: Optional[int] = None):
    """Full-sequence forward. Returns (logits, aux_loss, caches|None).

    tokens: (B, S), or (B, Q, S) for multi-codebook audio (logits then
    (B, S, Q, V)); patch_embeds: (B, P, E) for a vlm config, projected over
    positions 0 .. P - 1 (they take the text positions, as in the
    reference). aux_loss: the MoE routers' aux losses summed over the
    groups, then the tail layers, in f32.

    window: 0 -> cfg.sliding_window (natively windowed archs) else full attn.
    collect_cache: also return per-layer (k, v) / states for decode handoff.
    logits_slice: if set, only the last `logits_slice` positions get logits.
    remat: accepted for the reference's signature; the activations are kept
    for the backward pass, not recomputed.

    With ``collect_cache=False`` (training) the forward is differentiable
    and ``torch.func.vmap`` can batch it over clients: the scans go through
    ``SSDScan`` / ``RGLRUScan`` (their kernels forward on CUDA, their plain
    versions' VJPs backward), attention through the plain-torch
    :func:`~repro_torch.models.layers.chunked_attention`, whose block
    choices depend on shapes alone.
    """
    del remat
    pat, n_groups, tail = _grouping(cfg)
    window = window or cfg.sliding_window
    x = L.embed_fwd(params["embed"], tokens, cfg, patch_embeds=patch_embeds)
    bsz, seq = x.shape[0], x.shape[1]
    positions = torch.arange(seq, device=x.device)[None].expand(bsz, seq)
    kw = dict(window=window, q_chunk=q_chunk, kv_chunk=kv_chunk,
              skip_masked_blocks=skip_masked_blocks, attn_mode=attn_mode)

    aux = x.new_zeros((), dtype=torch.float32)
    caches: Dict[str, PyTree] = {}
    group_caches, group_aux = [], []
    for g in range(n_groups):
        gp = _group(params["layers"], g)
        gc = {}
        ga = x.new_zeros((), dtype=torch.float32)
        for i, k in enumerate(pat):
            name = f"b{i}_{k}"
            x, gc[name], a = block_fwd(gp[name], x, positions, cfg, k, **kw)
            ga = ga + a
        group_caches.append(gc)
        group_aux.append(ga)
    if n_groups:
        aux = aux + torch.sum(torch.stack(group_aux))
        if collect_cache:
            caches["layers"] = _stack(group_caches)
    for j, k in enumerate(tail):
        name = f"tail{j}_{k}"
        x, c, a = block_fwd(params[name], x, positions, cfg, k, **kw)
        aux = aux + a
        if collect_cache:
            caches[name] = c
    x = L.norm_fwd(params["final_norm"], x, cfg.norm)
    if logits_slice is not None:
        x = x[:, -logits_slice:]
    logits = L.head_fwd(params["head"], params["embed"], x, cfg)
    return logits, aux, (caches if collect_cache else None)


# ---------------------------------------------------------------------------
# Decode step (one token against a cache)
# ---------------------------------------------------------------------------


def decode_step(params: PyTree, cache: PyTree, tokens: torch.Tensor,
                cache_index: int, cfg: ModelConfig, *, window: int = 0):
    """tokens: (B, 1), or (B, Q, 1) for multi-codebook audio. Returns
    (logits, new_cache); the cache given is left as it was."""
    pat, n_groups, tail = _grouping(cfg)
    window = window or cfg.sliding_window
    x = L.embed_fwd(params["embed"], tokens, cfg)
    bsz = x.shape[0]
    positions = torch.full((bsz, 1), int(cache_index), dtype=torch.int64,
                           device=x.device)
    new_cache: Dict[str, PyTree] = {}
    if n_groups:
        group_caches = []
        for g in range(n_groups):
            gp, gcache = _group(params["layers"], g), _group(cache["layers"], g)
            gc = {}
            for i, k in enumerate(pat):
                name = f"b{i}_{k}"
                x, gc[name], _ = block_fwd(gp[name], x, positions, cfg, k,
                                           window=window, cache=gcache[name],
                                           cache_index=cache_index)
            group_caches.append(gc)
        new_cache["layers"] = _stack(group_caches)
    for j, k in enumerate(tail):
        name = f"tail{j}_{k}"
        x, c, _ = block_fwd(params[name], x, positions, cfg, k, window=window,
                            cache=cache[name], cache_index=cache_index)
        new_cache[name] = c
    x = L.norm_fwd(params["final_norm"], x, cfg.norm)
    logits = L.head_fwd(params["head"], params["embed"], x, cfg)
    return logits, new_cache
