"""Vectorized client-cohort engine, generic over the task substrate
(``repro_torch.core.tasks``).

The per-client loop trains one client per call: a fan-out of C clients
pays C x K eager steps, each a few dozen kernel launches. This module
stacks per-client state along a leading client axis — params snapshot,
momentum, learning rate, FedProx anchor and the K mini-batches — and
trains the whole cohort with ``torch.func.vmap`` over clients of
:func:`~repro_torch.core.client.functional_sgd_step`, one batched step per
local step, in a Python loop over K. Batches are the substrate's ``(inputs,
targets)`` pairs; inputs may be a dict (the arch tasks' tokens), stacked
leaf by leaf. An arch model's scans fold the client axis into their
kernels' batch axis (``SSDScan`` / ``RGLRUScan``), one launch per layer
and step for the whole chunk.

* Uniform K (sync rounds, the async seeding): the loop runs exactly K
  steps.
* Ragged K (burst re-dispatch after adaptive K has diverged): the steps
  pad to a power-of-two bucket and a ``(client, step)`` mask makes the
  padded steps exact no-ops — a masked step keeps ``(params, momentum)``
  bitwise unchanged and adds no loss.

The client axis pads to a power-of-two bucket too (padded rows are
discarded), so the rows of a dispatch depend on the bucket alone: a later
CUDA graph per bucket can replay them.

**Memory plans** (``repro_torch.core.budget``): a clamped ``plan.width``
splits the client axis into chunks run one after another; a clamped
``plan.k_chunk`` splits each chunk's steps into segments, threading the
``(params, momentum)`` carry between them on the device and summing the
segment deltas, as the JAX package does. Each segment stages only its
own batches on the device.

Semantics are the loop's: the same batcher streams (every draw happens
up front, in client order, whatever the plan), the same momentum carry,
the same per-round lr decay, the same FedProx anchor. The results equal
the loop's and the JAX package's (``repro/core/cohort.py``) to float
tolerance. Momentum rows stay on the device between fan-outs; the delta
rows handed out are views of one stacked tensor, which no consumer writes
in place. The pod-sharded engine is a later slice of the port
(``client_engine="cohort_sharded"`` raises, naming ROADMAP.md A17).
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import tasks as tasks_mod
from repro_torch.core.client import functional_sgd_step
from repro_torch.core.server import ClientUpdate
from repro_torch.utils import pytree as pt

PyTree = Any

#: engines this module executes (everything but the per-client loop)
COHORT_ENGINES = ("cohort",)


def bucket_size(n: int) -> int:
    """Next power of two >= n (n >= 1): the pad size that lets ragged
    client counts and per-client K values share one set of shapes."""
    if n < 1:
        raise ValueError(f"bucket_size needs n >= 1, got {n}")
    return 1 << (int(n) - 1).bit_length()


def _check_engine(engine: str) -> None:
    if engine == "cohort_sharded":
        raise NotImplementedError(
            "client_engine='cohort_sharded' is not ported yet (ROADMAP.md "
            "A17)")
    if engine not in COHORT_ENGINES:
        raise ValueError(f"run_cohort got engine {engine!r}: expected one "
                         f"of {COHORT_ENGINES} ('loop' is Client.run_local)")


def _where(keep: torch.Tensor, new: PyTree, old: PyTree) -> PyTree:
    """Per client row: ``new`` where ``keep``, else ``old``, bitwise."""
    return pt.tree_map(
        lambda n, o: torch.where(keep.view(-1, *([1] * (n.dim() - 1))), n, o),
        new, old)


def _steps(task, p0: PyTree, mu: PyTree, xs, ys, lrs: torch.Tensor,
           mask: Optional[torch.Tensor], beta: float, prox_mu: float):
    """Train every stacked client row over the steps of ``xs``: ``(C, k,
    bs, ...)`` on the device. ``mask`` (``(C, k)`` f32, or None when every
    step is real) turns a client's padded steps into no-ops. Returns
    ``(params - p0, momentum, per-client loss sums)``, stacked."""

    def one(p, m, bx, by, lr, anchor):
        return functional_sgd_step(task, p, m, bx, by, lr, beta, prox_mu,
                                   anchor)

    step = torch.func.vmap(one)
    p, m = p0, mu
    loss_sum = torch.zeros(lrs.shape, dtype=torch.float32, device=lrs.device)
    for k in range(ys.shape[1]):
        p2, m2, loss = step(p, m, pt.tree_map(lambda a: a[:, k], xs),
                            ys[:, k], lrs, p0)
        if mask is None:
            p, m = p2, m2
            loss_sum = loss_sum + loss
        else:
            keep = mask[:, k] > 0
            p, m = _where(keep, p2, p), _where(keep, m2, m)
            loss_sum = loss_sum + loss * mask[:, k]
    return pt.tree_sub(p, p0), m, loss_sum


def _pad_steps(batch, k_pad: int):
    """Pad a ``(k, bs, ...)`` batch array, or a dict of them, to ``k_pad``
    steps by repeating its last batch (valid data, masked out, never
    applied)."""
    k = pt.tree_leaves(batch)[0].shape[0]
    if k == k_pad:
        return batch
    return pt.tree_map(
        lambda a: np.concatenate([a, np.repeat(a[-1:], k_pad - k, axis=0)]),
        batch)


def _np_stack(rows):
    """Per-client batch rows stacked along a new client axis, leaf by leaf
    (inputs may be dicts of arrays)."""
    return pt.tree_map(lambda *ls: np.stack(ls), *rows)


def _run_chunk(task, fed, p_src, mus, lrs_list, x_rows, y_rows,
               ks: Sequence[int], prox_mu: float, template: PyTree,
               k_chunk: Optional[int]):
    """Train one client chunk: pad and stack on the device, then run its
    steps — at once, or in ``k_chunk``-step segments when the plan says
    the full K does not fit. Returns ``(deltas, momentum, losses)``
    stacked over the padded chunk (callers keep the real rows) with the
    losses as host floats."""
    device = pt.tree_leaves(template)[0].device
    c_real = len(mus)
    c_pad = bucket_size(c_real)
    uniform = len(set(ks)) == 1
    k_pad = ks[0] if uniform else bucket_size(max(ks))

    # batches: stacked on the host, moved to the device one segment at a
    # time; padded client rows repeat row 0's batches with lr 0
    xs = _np_stack([_pad_steps(x, k_pad) for x in x_rows]
                   + [_pad_steps(x_rows[0], k_pad)] * (c_pad - c_real))
    ys = _np_stack([_pad_steps(y, k_pad) for y in y_rows]
                   + [_pad_steps(y_rows[0], k_pad)] * (c_pad - c_real))
    lrs = torch.zeros((c_pad,), dtype=torch.float32)
    lrs[:c_real] = torch.tensor(lrs_list, dtype=torch.float32)
    lrs = lrs.to(device)
    mask = counts = None
    if not uniform:
        mask_np = np.zeros((c_pad, k_pad), np.float32)
        for i, k in enumerate(ks):
            mask_np[i, :k] = 1.0
        mask = torch.from_numpy(mask_np).to(device)
        counts = np.maximum(mask_np.sum(axis=1), 1.0)
    zeros_mu = pt.tree_zeros_like(template)
    mu = pt.tree_map(lambda *rows: torch.stack(rows),
                     *(list(mus) + [zeros_mu] * (c_pad - c_real)))
    if isinstance(p_src, list):
        p = pt.tree_map(lambda *rows: torch.stack(rows),
                        *(p_src + [template] * (c_pad - c_real)))
    else:                        # a shared snapshot: a view, not C copies
        p = pt.tree_map(lambda t: t.expand(c_pad, *t.shape), p_src)

    seg = k_pad if k_chunk is None or k_chunk >= k_pad else k_chunk
    # the FedProx anchor would differ per segment, so the planner never
    # splits K under FedProx
    assert seg == k_pad or prox_mu == 0.0, "K segments under FedProx"
    delta = None
    loss_sum = torch.zeros((c_pad,), dtype=torch.float32, device=device)
    for s0 in range(0, k_pad, seg):
        s1 = min(s0 + seg, k_pad)
        bx, by = task.to_device((pt.tree_map(lambda a: a[:, s0:s1], xs),
                                 ys[:, s0:s1]), device)
        d, mu, l_seg = _steps(task, p, mu, bx, by, lrs,
                              None if mask is None else mask[:, s0:s1],
                              fed.local_momentum, prox_mu)
        loss_sum = loss_sum + l_seg
        delta = d if delta is None else pt.tree_add(delta, d)
        if s1 < k_pad:
            p = pt.tree_add(p, d)
    sums = loss_sum.cpu().numpy().astype(np.float64)
    losses = sums / (float(k_pad) if uniform else counts)
    return delta, mu, [float(x) for x in losses]


def run_cohort(task, clients: Sequence,
               params: Union[PyTree, Sequence[PyTree]], ks: Sequence[int],
               snapshot_iters: Sequence[int], prox_mu: float = 0.0,
               per_client_params: bool = False, engine: str = "cohort",
               plan=None) -> List[Tuple[ClientUpdate, float]]:
    """Train ``clients`` for ``ks`` local steps each, stacked.

    Stands in for ``[c.run_local(params, k, it, prox_mu) for ...]``: the
    same batcher streams, momentum carry and lr schedule, equal to float
    tolerance. ``params`` is one shared snapshot tree, or with
    ``per_client_params=True`` a sequence of one snapshot per client
    (collapsed to the shared form when every entry is the same object).
    ``plan`` (a :class:`~repro_torch.core.budget.CohortPlan`) splits the
    client axis into ``plan.width`` chunks and each chunk's steps into
    ``plan.k_chunk`` segments; without one the fan-out is one dispatch."""
    _check_engine(engine)
    c_real = len(clients)
    if c_real == 0:
        return []
    if not (len(ks) == len(snapshot_iters) == c_real):
        raise ValueError("clients / ks / snapshot_iters length mismatch")
    task = tasks_mod.as_task(task)

    per_client = per_client_params
    if per_client:
        if len(params) != c_real:
            raise ValueError("per_client_params needs one snapshot per "
                             f"client, got {len(params)} for {c_real}")
        if all(p is params[0] for p in params):
            params, per_client = params[0], False
    template = params[0] if per_client else params

    # every client is staged up front, in client order: the batcher draws
    # are the same under every plan, so no plan can fork an RNG stream
    mus, lrs_list, x_rows, y_rows = [], [], [], []
    for c, k in zip(clients, ks):
        mu, lr = c.stage_cohort(template)
        bx, by = c.batcher.next_stacked(k)
        mus.append(mu)
        lrs_list.append(lr)
        x_rows.append(bx)
        y_rows.append(by)

    fed = clients[0].fed
    width = c_real
    k_chunk = None
    if plan is not None:
        width = max(1, min(int(plan.width), c_real))
        if prox_mu == 0.0 and int(plan.k_chunk) < max(ks):
            k_chunk = int(plan.k_chunk)

    delta_rows, mu_rows, loss_rows = [], [], []
    for lo in range(0, c_real, width):
        hi = min(lo + width, c_real)
        p_src = list(params[lo:hi]) if per_client else params
        deltas, new_mu, losses = _run_chunk(
            task, fed, p_src, mus[lo:hi], lrs_list[lo:hi], x_rows[lo:hi],
            y_rows[lo:hi], ks[lo:hi], prox_mu, template, k_chunk)
        for i in range(hi - lo):
            delta_rows.append(pt.tree_map(lambda t: t[i], deltas))
            mu_rows.append(pt.tree_map(lambda t: t[i], new_mu))
            loss_rows.append(losses[i])

    out: List[Tuple[ClientUpdate, float]] = []
    for i, (c, k, it) in enumerate(zip(clients, ks, snapshot_iters)):
        c.commit_cohort(mu_rows[i])
        upd = ClientUpdate(c.client_id, it, k, delta_rows[i], c.num_samples)
        out.append((upd, loss_rows[i]))
    return out
