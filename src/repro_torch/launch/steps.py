"""Step programs (train, prefill, serve) and the abstract inputs they take.

The JAX package's ``launch/steps.py`` in PyTorch: the programs the dry run
traces for every (arch x shape x mesh) on meta tensors
(``launch/dryrun.py``), and that ``chip_smoke.py`` runs on the card at the
assigned shapes. A step runs where its inputs lie: build the params, the
optimizer state and the batch on a device (CUDA for a real run, ``meta``
for a trace) and call it. Nothing in a step reads a tensor's value, so a
meta trace computes no value and allocates nothing; the serve step's
``cache_index`` is a Python int (the reference's traced scalar never
changes a shape either).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.models.layers import cross_entropy
from repro_torch.models.params import abstract_params
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import Optimizer, apply_updates
from repro_torch.utils import pytree as pt

PyTree = Any


def decode_window(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """KV window for decode shapes. Natively windowed archs use their own
    window; full-attention archs switch to the sliding-window variant only
    for long_500k; decode_32k keeps the full cache."""
    if cfg.sliding_window:
        return cfg.sliding_window
    if shape.name == "long_500k":
        return cfg.long_context_window
    return 0


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Meta tensors standing in for every model input (no storage): tokens
    (B, S), or (B, Q, S) for audio, and labels alike for training; vlm
    patch embeddings (B, min(max_patches, S), E) in bf16; for decode one
    token per sequence, the cache of ``cache_specs`` and a 0-d int32
    ``cache_index``."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    audio = cfg.family == "audio"
    if shape.kind in ("train", "prefill"):
        toks = _meta((b, cfg.num_codebooks, s) if audio else (b, s), i32)
        specs: Dict[str, Any] = {"tokens": toks}
        if shape.kind == "train":
            specs["labels"] = _meta(toks.shape, i32)
        if cfg.family == "vlm" and cfg.max_patches:
            specs["patch_embeds"] = _meta(
                (b, min(cfg.max_patches, s), cfg.vision_embed_dim),
                torch.bfloat16)
        return specs
    toks = _meta((b, cfg.num_codebooks, 1) if audio else (b, 1), i32)
    cache = pt.tree_map(lambda t: _meta(t.shape, t.dtype),
                        M.cache_specs(cfg, b, s, decode_window(cfg, shape)))
    return {"tokens": toks, "cache": cache, "cache_index": _meta((), i32)}


def abstract_model_params(cfg: ModelConfig) -> PyTree:
    return abstract_params(M.model_defs(cfg), cfg.param_dtype)


def abstract_opt_state(cfg: ModelConfig, optimizer: Optimizer) -> PyTree:
    """The optimizer's init on the meta params: its state's shapes and
    dtypes, no storage."""
    return optimizer.init(abstract_model_params(cfg))


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, *,
                    q_chunk: int = 1024, kv_chunk: int = 1024,
                    attn_mode: str = "auto", remat: bool = True,
                    skip_masked_blocks: bool = True,
                    ce_impl: str = "gather", batch_axes=None) -> Callable:
    """``train_step(params, opt_state, batch) -> (new_params, new_opt,
    {"loss", "ce"})``: the loss ``ce + aux`` of ``forward(remat=...)`` and
    its gradients, then ``optimizer.update`` and ``apply_updates``. Nothing
    is written in place; a param the loss does not reach gets a zero
    gradient, as ``jax.grad`` gives it."""

    def loss_fn(p, batch):
        logits, aux, _ = M.forward(
            p, batch["tokens"], cfg, patch_embeds=batch.get("patch_embeds"),
            remat=remat, q_chunk=q_chunk, kv_chunk=kv_chunk,
            attn_mode=attn_mode, skip_masked_blocks=skip_masked_blocks,
            batch_axes=batch_axes)
        labels = batch["labels"]
        if cfg.family == "audio":
            labels = labels.transpose(1, 2)             # (B,Q,S)->(B,S,Q)
        ce = cross_entropy(logits, labels, impl=ce_impl)
        return ce + aux, ce

    def train_step(params: PyTree, opt_state: PyTree,
                   batch: Dict[str, Any]):
        leaves, treedef = pt.tree_flatten(params)
        with torch.enable_grad():
            live = [t.detach().requires_grad_(True) for t in leaves]
            loss, ce = loss_fn(pt.tree_unflatten(treedef, live), batch)
            grads = torch.autograd.grad(loss, live, allow_unused=True,
                                        materialize_grads=True)
        del live
        with torch.no_grad():
            updates, new_opt = optimizer.update(
                pt.tree_unflatten(treedef, list(grads)), opt_state, params)
            del grads
            new_params = apply_updates(params, updates)
        return new_params, new_opt, {"loss": loss.detach(),
                                     "ce": ce.detach()}

    return train_step


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig, *,
                      q_chunk: int = 1024, kv_chunk: int = 1024,
                      attn_mode: str = "auto",
                      skip_masked_blocks: bool = True,
                      batch_axes=None) -> Callable:
    """``prefill_step(params, batch) -> (next_token int32, caches)``: the
    forward over the prompt with its caches collected and the logits of
    the last position only."""
    window = cfg.sliding_window

    @torch.no_grad()
    def prefill_step(params: PyTree, batch: Dict[str, Any]):
        logits, _, caches = M.forward(
            params, batch["tokens"], cfg,
            patch_embeds=batch.get("patch_embeds"),
            window=window, collect_cache=True, remat=False,
            q_chunk=q_chunk, kv_chunk=kv_chunk, attn_mode=attn_mode,
            skip_masked_blocks=skip_masked_blocks, logits_slice=1,
            batch_axes=batch_axes)
        return torch.argmax(logits, dim=-1).to(torch.int32), caches

    return prefill_step


def make_serve_step(cfg: ModelConfig, shape: ShapeConfig) -> Callable:
    """``serve_step(params, cache, tokens, cache_index) -> (next_token
    int32, new_cache)``: one token per sequence against the cache, at
    :func:`decode_window`; ``cache_index`` a Python int."""
    window = decode_window(cfg, shape)

    @torch.no_grad()
    def serve_step(params: PyTree, cache: PyTree, tokens: torch.Tensor,
                   cache_index: int):
        logits, new_cache = M.decode_step(params, cache, tokens, cache_index,
                                          cfg, window=window)
        return torch.argmax(logits, dim=-1).to(torch.int32), new_cache

    return serve_step


def default_optimizer() -> Optimizer:
    return adamw(3e-4, weight_decay=0.1)
