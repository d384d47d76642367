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
in place.

**The pod engine** (``engine="cohort_sharded"``): the padded client bucket
splits into ``C_pad / n_pods`` rows per pod over the ``pod`` axis of a
mesh (``launch/mesh.py``; both are powers of two, so the split is even).
Each pod runs the same vmapped steps over its own rows on its own device,
and only the results cross back to the home device, as the JAX package's
``shard_map`` does. One process drives every pod; pods that share a
device (the mesh's test hook) run one after another.

**Compressed pod collectives**: under ``cohort_sharded`` with
``FedConfig.delta_compression`` set, each pod flattens its own delta rows
in ``FlatSpec`` order, adds the clients' staged error-feedback rows
(``Client.stage_residual``) and quantizes row by row on its device, with
the math of ``core.compression`` (per-QBLOCK absmax int8, or bf16). Only
the wire blocks and the refreshed residual rows come back; the engine
emits :class:`~repro_torch.core.compression.CompressedDelta` updates,
which ``Client.compress_update`` passes through, and commits each
residual row to its client (``Client.commit_residual``) as a tensor of
its own on the client's device. An adversary then corrupts these updates
in wire form, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import compression
from repro_torch.core import tasks as tasks_mod
from repro_torch.core.client import functional_sgd_step
from repro_torch.core.server import ClientUpdate
from repro_torch.launch import mesh as mesh_lib
from repro_torch.sharding import specs
from repro_torch.utils import pytree as pt

PyTree = Any

#: engines this module executes (everything but the per-client loop)
COHORT_ENGINES = ("cohort", "cohort_sharded")


def bucket_size(n: int) -> int:
    """Next power of two >= n (n >= 1): the pad size that lets ragged
    client counts and per-client K values share one set of shapes."""
    if n < 1:
        raise ValueError(f"bucket_size needs n >= 1, got {n}")
    return 1 << (int(n) - 1).bit_length()


def _check_engine(engine: str) -> None:
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


def _pod_devices(engine: str, c_pad: int, device: torch.device):
    """The device of each pod a ``c_pad``-row chunk splits over: the home
    device alone for the ``cohort`` engine; for ``cohort_sharded`` the pod
    mesh's, as many pods as the devices allow up to ``c_pad``."""
    if engine != "cohort_sharded":
        return (device,)
    n_pods = mesh_lib.pod_count(max_pods=c_pad, device=device)
    return mesh_lib.make_cohort_mesh(n_pods, device).pod_devices()


def _wire_rows(deltas: PyTree, res: torch.Tensor, mode: str):
    """One pod's compressor: its delta rows flattened in ``FlatSpec`` order
    and padded to the residual rows' width, plus the residual rows, in
    wire form row by row with ``core.compression``'s math. Returns (q,
    scales or None for bf16, new residual rows), stacked."""
    rows = torch.cat([l.reshape(l.shape[0], -1).float()
                      for l in pt.tree_leaves(deltas)], dim=1)
    if rows.shape[1] != res.shape[1]:
        rows = torch.nn.functional.pad(rows, (0, res.shape[1] - rows.shape[1]))
    vec = rows + res
    if mode == "int8":
        # rows are whole QBLOCKs, so the flat quantizer blocks them row
        # by row
        q, scales = compression._quantize_int8(vec.reshape(-1))
        deq = compression._dequantize_int8(q, scales).reshape(vec.shape)
        return (q.reshape(vec.shape), scales.reshape(vec.shape[0], -1),
                vec - deq)
    q = vec.to(torch.bfloat16)
    return q, None, vec - q.float()


def _run_pod(task, fed, dev: torch.device, p, mu, xs, ys, lrs, mask,
             k_pad: int, seg: int, prox_mu: float):
    """Train one pod's client rows on ``dev``: its steps at once, or in
    ``seg``-step segments. Returns ``(deltas, momentum, loss sums)`` on
    ``dev``."""
    to_dev = lambda t: t.to(dev)
    p, mu = pt.tree_map(to_dev, p), pt.tree_map(to_dev, mu)
    lrs = lrs.to(dev)
    mask = None if mask is None else mask.to(dev)
    delta = None
    loss_sum = torch.zeros(lrs.shape, dtype=torch.float32, device=dev)
    for s0 in range(0, k_pad, seg):
        s1 = min(s0 + seg, k_pad)
        bx, by = task.to_device((pt.tree_map(lambda a: a[:, s0:s1], xs),
                                 ys[:, s0:s1]), dev)
        d, mu, l_seg = _steps(task, p, mu, bx, by, lrs,
                              None if mask is None else mask[:, s0:s1],
                              fed.local_momentum, prox_mu)
        loss_sum = loss_sum + l_seg
        delta = d if delta is None else pt.tree_add(delta, d)
        if s1 < k_pad:
            p = pt.tree_add(p, d)
    return delta, mu, loss_sum


def _gather_rows(parts, device: torch.device):
    """Per-pod stacked results joined along the client axis on the home
    device (one pod's pass as they are)."""
    if len(parts) == 1:
        return parts[0]
    return pt.tree_map(lambda *ts: None if ts[0] is None else torch.cat(
        [t.to(device) for t in ts]), *parts)


def _run_chunk(task, fed, engine: str, p_src, mus, lrs_list, x_rows,
               y_rows, ks: Sequence[int], prox_mu: float, template: PyTree,
               k_chunk: Optional[int], wire=None):
    """Train one client chunk: pad and stack on the device, split the rows
    over the pods, then run each pod's steps — at once, or in
    ``k_chunk``-step segments when the plan says the full K does not fit.
    ``wire`` is ``(mode, residual rows)`` for the compressed pod
    collective. Returns ``(deltas, momentum, losses, wire_out)`` stacked
    over the padded chunk (callers keep the real rows) with the losses as
    host floats; with ``wire``, ``deltas`` is None and ``wire_out`` is
    ``(q, scales, new residual rows)``."""
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
    res = None
    if wire is not None:
        res_rows = list(wire[1])
        res = torch.stack(res_rows + [torch.zeros_like(res_rows[0])]
                          * (c_pad - c_real))

    seg = k_pad if k_chunk is None or k_chunk >= k_pad else k_chunk
    # the FedProx anchor would differ per segment, so the planner never
    # splits K under FedProx
    assert seg == k_pad or prox_mu == 0.0, "K segments under FedProx"
    pods = _pod_devices(engine, c_pad, device)

    def split(t):
        return ((None,) * len(pods) if t is None
                else specs.split_cohort(t, len(pods)))

    outs = []
    for dev, *rows in zip(pods, *map(split, (p, mu, xs, ys, lrs, mask,
                                              res))):
        with mesh_lib.on_device(dev):
            delta, mu_p, loss_p = _run_pod(task, fed, dev, *rows[:6], k_pad,
                                           seg, prox_mu)
            if wire is not None:
                # the pod's own rows leave its device in wire form
                delta = _wire_rows(delta, rows[6].to(dev), wire[0])
        outs.append((delta, mu_p, loss_p))
    deltas = _gather_rows([o[0] for o in outs], device)
    new_mu = _gather_rows([o[1] for o in outs], device)
    loss_sum = _gather_rows([o[2] for o in outs], device)
    sums = loss_sum.cpu().numpy().astype(np.float64)
    losses = sums / (float(k_pad) if uniform else counts)
    losses = [float(x) for x in losses]
    if wire is not None:
        return None, new_mu, losses, deltas
    return deltas, new_mu, losses, None


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
    ``plan.k_chunk`` segments; without one the fan-out is one dispatch.

    ``engine="cohort_sharded"`` splits each chunk's padded rows over the
    pods of the mesh; with ``delta_compression`` set the updates come back
    in wire form and each client's error-feedback row is committed."""
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

    # compressed pod collectives: the pods quantize their own delta rows
    res_spec = None
    res_rows: List[torch.Tensor] = []
    mode = fed.delta_compression
    if engine == "cohort_sharded" and mode != "off":
        res_spec = pt.FlatSpec(template, block=compression.BLOCK)
        res_rows = [c.stage_residual(res_spec) for c in clients]

    delta_rows, mu_rows, loss_rows, res_commits = [], [], [], []
    for lo in range(0, c_real, width):
        hi = min(lo + width, c_real)
        p_src = list(params[lo:hi]) if per_client else params
        deltas, new_mu, losses, wire_out = _run_chunk(
            task, fed, engine, p_src, mus[lo:hi], lrs_list[lo:hi],
            x_rows[lo:hi], y_rows[lo:hi], ks[lo:hi], prox_mu, template,
            k_chunk, None if res_spec is None else (mode, res_rows[lo:hi]))
        for i in range(hi - lo):
            if wire_out is not None:
                q, scales, new_res = wire_out
                delta_rows.append(compression.CompressedDelta(
                    mode, q[i], None if scales is None else scales[i],
                    res_spec.n))
                res_commits.append(new_res[i])
            else:
                delta_rows.append(pt.tree_map(lambda t: t[i], deltas))
            mu_rows.append(pt.tree_map(lambda t: t[i], new_mu))
            loss_rows.append(losses[i])

    out: List[Tuple[ClientUpdate, float]] = []
    for i, (c, k, it) in enumerate(zip(clients, ks, snapshot_iters)):
        c.commit_cohort(mu_rows[i])
        if res_spec is not None:
            # a row of its own on the client's device: a view would keep
            # the fan-out's whole stacked residual alive
            c.commit_residual(res_commits[i].to(c.device, copy=True))
        upd = ClientUpdate(c.client_id, it, k, delta_rows[i], c.num_samples)
        out.append((upd, loss_rows[i]))
    return out
