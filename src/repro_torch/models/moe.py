"""Mixture-of-Experts FFN: shared + routed experts, top-k routing.

The JAX package's ``models/moe.py`` in PyTorch. Two implementations,
selected by ``MoEConfig.impl``:

* ``dense``  — every expert computes every token; combine weights mask the
  experts a token did not choose. Exact and simple (the reduced configs).
* ``gshard`` — capacity-based one-hot dispatch and combine products. Tokens
  are cut into groups; per group each expert takes at most ``capacity``
  (token, choice) pairs in token-major order, and the overflow is dropped
  (GShard semantics).

The router and expert products are plain large matrix products, which the
reference leaves to XLA outside any Pallas kernel, so they stay
``torch.einsum`` / ``torch.bmm`` here. ``MoEConfig.expert_axis`` is a GSPMD
layout hint that changes no value; a single-controller forward has nothing
to pin, and this module ignores it.

Every function is pure and takes its sizes from static shapes (no
``.item()``, no in-place write), so ``torch.func.vmap`` batches it over
clients.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamDef


def moe_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    m = cfg.moe
    d, f, e = cfg.d_model, m.expert_d_ff, m.num_experts
    defs = {
        "router": ParamDef((d, e), ("embed", None)),
        "wi_gate": ParamDef((e, d, f), ("expert", "embed", "mlp")),
        "wi_up": ParamDef((e, d, f), ("expert", "embed", "mlp")),
        "wo": ParamDef((e, f, d), ("expert", "mlp", "embed")),
    }
    if m.num_shared_experts:
        sf = m.shared_d_ff or m.expert_d_ff * m.num_shared_experts
        defs["shared_wi_gate"] = ParamDef((d, sf), ("embed", "mlp"))
        defs["shared_wi_up"] = ParamDef((d, sf), ("embed", "mlp"))
        defs["shared_wo"] = ParamDef((sf, d), ("mlp", "embed"))
        defs["shared_gate"] = ParamDef((d,), ("embed",), init="zeros")
    return defs


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, and on ties the lower index first (a stable sort;
    ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(p, x: torch.Tensor, m) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """x (T, d) -> (weights (T, k) f32 renormalised over the k choices,
    indices (T, k), aux loss f32 scalar). The aux loss is the Switch
    load-balance term from the top-1 choice alone:
    ``E * sum_e mean_prob_e * top1_frac_e * coef``."""
    logits = torch.einsum("td,de->te", x, p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    weights, idx = top_k(probs, m.num_experts_per_tok)
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    e = m.num_experts
    me = torch.mean(probs, dim=0)                                # mean prob
    ce = torch.mean(_one_hot(idx[:, 0], e, torch.float32), dim=0)  # top-1
    aux = e * torch.sum(me * ce) * m.router_aux_loss_coef
    return weights, idx, aux


def _expert_ffn(p, x: torch.Tensor, prefix: str = "") -> torch.Tensor:
    """x: (E, C, d) -> (E, C, d), every expert a batched product over the
    leading expert dimension."""
    dt = x.dtype
    g = torch.bmm(x, p[prefix + "wi_gate"].to(dt))
    u = torch.bmm(x, p[prefix + "wi_up"].to(dt))
    return torch.bmm(F.silu(g) * u, p[prefix + "wo"].to(dt))


def _shared_ffn(p, x: torch.Tensor) -> torch.Tensor:
    """The shared experts on x (T, d), scaled by their sigmoid gate."""
    dt = x.dtype
    g = torch.einsum("td,df->tf", x, p["shared_wi_gate"].to(dt))
    u = torch.einsum("td,df->tf", x, p["shared_wi_up"].to(dt))
    y = torch.einsum("tf,fd->td", F.silu(g) * u, p["shared_wo"].to(dt))
    gate = torch.sigmoid(
        torch.einsum("td,d->t", x, p["shared_gate"].to(dt)))[..., None]
    return y * gate.to(dt)


def moe_fwd_dense(p, x: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact dense path: (B, S, d) -> (B, S, d), plus the aux loss. The
    combine row of a token holds its k weights at its k experts: one-hot
    rows times the weights, summed over the choices (the k experts are
    distinct, so each entry is one weight, as the reference's scatter-add
    writes it)."""
    m = cfg.moe
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    weights, idx, aux = _router(p, xt, m)
    combine = torch.sum(_one_hot(idx, m.num_experts, torch.float32)
                        * weights[..., None], dim=1)             # (T, E)
    all_out = _expert_ffn(p, xt.expand(m.num_experts, b * s, d))
    y = torch.einsum("etd,te->td", all_out.float(), combine).to(x.dtype)
    if m.num_shared_experts:
        y = y + _shared_ffn(p, xt)
    return y.reshape(b, s, d), aux


def gshard_plan(tokens: int, m, group_size: int = 4096) -> Tuple[int, int, int]:
    """(groups, group size, capacity) for ``tokens`` tokens: the largest
    group count up to ``tokens // group_size`` that divides the tokens, and
    each expert's slots per group, ``k * gs * capacity_factor / E`` rounded
    down, at least 1 and at most the group size."""
    g = max(1, min(tokens // group_size, tokens))
    while tokens % g:
        g -= 1
    gs = tokens // g
    cap = max(1, int(m.num_experts_per_tok * gs * m.capacity_factor
                     / m.num_experts))
    return g, gs, min(cap, gs)


def gshard_dispatch(weights: torch.Tensor, idx: torch.Tensor, e: int,
                    cap: int):
    """weights, idx (g, gs, k) -> (pos, keep, disp, comb): each (token,
    choice)'s place in its expert's queue of the group, counted over the
    pairs before it in token-major order; whether that place is below the
    capacity; the (g, gs, E, cap) dispatch mask; and the combine weights,
    zero for a dropped pair."""
    onehot = _one_hot(idx, e, torch.int64)                       # (g,gs,k,E)
    g, gs, k = idx.shape
    flat = onehot.reshape(g, gs * k, e)
    pos_flat = torch.cumsum(flat, dim=1) - flat
    pos = torch.sum(pos_flat.reshape(onehot.shape) * onehot, dim=-1)
    keep = pos < cap                                             # (g,gs,k)
    w = weights * keep.to(weights.dtype)
    slot = _one_hot(pos, cap, torch.float32)                     # (g,gs,k,cap)
    sel = onehot.float()[..., None] * slot[..., None, :]         # (g,gs,k,E,cap)
    disp = torch.sum(sel * keep[..., None, None], dim=2)         # (g,gs,E,cap)
    comb = torch.sum(sel * w[..., None, None], dim=2)            # (g,gs,E,cap)
    return pos, keep, disp, comb


def moe_fwd_gshard(p, x: torch.Tensor, cfg: ModelConfig,
                   group_size: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based dispatch (:func:`gshard_plan`): a (token, choice)
    pair takes the next slot of its expert's queue in its group, in
    token-major order, and a pair past the capacity is dropped (its weight
    is zero; the token keeps its other choices and the shared experts)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    k, e = m.num_experts_per_tok, m.num_experts
    g, gs, cap = gshard_plan(t, m, group_size)
    xt = x.reshape(g, gs, d)

    weights, idx, aux = _router(p, xt.reshape(t, d), m)          # (t, k)
    _, _, disp, comb = gshard_dispatch(weights.reshape(g, gs, k),
                                       idx.reshape(g, gs, k), e, cap)
    ex_in = torch.einsum("gsec,gsd->egcd", disp.to(x.dtype), xt)
    ex_out = _expert_ffn(p, ex_in.reshape(e, g * cap, d))        # (E,g*cap,d)
    ex_out = ex_out.reshape(e, g, cap, d)
    y = torch.einsum("gsec,egcd->gsd", comb.to(x.dtype), ex_out)
    y = y.reshape(t, d)
    if m.num_shared_experts:
        y = y + _shared_ffn(p, x.reshape(t, d))
    return y.reshape(b, s, d), aux


def moe_fwd(p, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.moe.impl == "dense":
        return moe_fwd_dense(p, x, cfg)
    return moe_fwd_gshard(p, x, cfg)
