"""Client-side local training (Algorithm 2), generic over the task substrate
(repro_torch.core.tasks).

A client downloads (x_t, K), performs K local SGD-with-momentum steps on
mini-batches of its own dataset (Eq. 2), and uploads the pseudo-gradient
Delta = x_K - x_0 (Eq. 4): momentum 0.5 with per-round lr decay 0.995
(Appendix B.4). The loss, sampler and batch layout come from the task, so
the same client trains the paper's MLP rows and an arch task's token
dicts. The K batches are drawn in one ``next_stacked(k)`` call,
which leaves the sampler exactly where k ``next()`` calls would, and are
moved to the device once. With ``FedConfig.delta_compression`` set, the
simulator puts each update in wire form through :meth:`Client.compress_update`,
with an error-feedback residual that carries what the wire lost into the
client's next delta.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core import compression, tasks
from repro_torch.core.server import ClientUpdate
from repro_torch.utils import pytree as pt
from repro_torch.utils import tracing
from repro_torch.utils.device import resolve_device

PyTree = Any


def local_sgd_step(task, carry, bx, by, lr: float, beta: float,
                   prox_mu: float, anchor: PyTree):
    """One SGD-with-momentum step (Eq. 2) on one mini-batch:
    ``m = beta*m + g``, ``p = p - lr*m``. FedProx: prox_mu > 0 anchors to
    the round's initial weights (Eq. 39). Returns ((p, m), loss)."""
    p, m = carry
    leaves, treedef = pt.tree_flatten(p)
    leaves = [l.detach().requires_grad_(True) for l in leaves]
    prox = (prox_mu, anchor) if prox_mu > 0 else None
    loss = task.loss(pt.tree_unflatten(treedef, leaves), (bx, by), prox=prox)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        m = [beta * mi + g for mi, g in zip(pt.tree_leaves(m), grads)]
        p = [pi - lr * mi for pi, mi in zip(leaves, m)]
    return ((pt.tree_unflatten(treedef, p), pt.tree_unflatten(treedef, m)),
            loss.detach())


def functional_sgd_step(task, p: PyTree, m: PyTree, bx, by, lr,
                        beta: float, prox_mu: float, anchor: PyTree):
    """:func:`local_sgd_step` as a pure function of its inputs, which
    ``torch.func.vmap`` can batch over clients (the cohort engine): the
    gradient comes from ``torch.func.grad_and_value``, not from leaves
    set to require grad. Same arithmetic, ``m = beta*m + g``, ``p = p -
    lr*m``, and the same FedProx anchor. Returns (p, m, loss)."""
    prox = (prox_mu, anchor) if prox_mu > 0 else None
    grads, loss = torch.func.grad_and_value(
        lambda q: task.loss(q, (bx, by), prox=prox))(p)
    m = pt.tree_map(lambda mi, g: beta * mi + g, m, grads)
    p = pt.tree_map(lambda pi, mi: pi - lr * mi, p, m)
    return p, m, loss


def _local_k_steps(task, params: PyTree, mu_state: PyTree, xs, ys, lr: float,
                   beta: float = 0.5, prox_mu: float = 0.0):
    """K optimizer steps over stacked batches xs: (K, bs, ...), leaf by
    leaf when the inputs are a dict (the arch tasks' tokens).
    Returns (delta, new_momentum, mean_loss)."""
    carry, losses = (params, mu_state), []
    for k in range(ys.shape[0]):
        with tracing.span("client.step", rows=1):
            bx = pt.tree_map(lambda a: a[k], xs)
            carry, loss = local_sgd_step(task, carry, bx, ys[k], lr, beta,
                                         prox_mu, params)
        losses.append(loss)
    new_params, new_mu = carry
    return pt.tree_sub(new_params, params), new_mu, torch.stack(losses).mean()


class Client:
    """One federated client: local data + persistent optimizer state."""

    def __init__(self, client_id: int, task, dataset, fed: FedConfig,
                 seed: int = 0, device=None):
        """``device`` (where batches go) defaults to CUDA, raising when
        there is none."""
        self.client_id = client_id
        self.task = tasks.as_task(task)
        self.fed = fed
        self.device = resolve_device(device)
        # the reference's seed derivation, so the sample streams are equal
        self.batcher = self.task.make_batcher(
            dataset, fed.local_batch_size, seed * 10_007 + client_id)
        self.num_samples = self.task.num_samples(dataset)
        self.round_idx = 0
        self._mu: Optional[PyTree] = None
        # error-feedback residual: the quantization error of the last
        # emitted delta, folded into the next one; released when the
        # client's session ends
        self._residual: Optional[torch.Tensor] = None
        self._flatspec: Optional[pt.FlatSpec] = None

    def _lr(self) -> float:
        """This round's lr, rounded to f32 as the reference feeds it."""
        return float(np.float32(
            self.fed.local_lr * (self.fed.local_lr_decay ** self.round_idx)))

    # --- cohort-engine hooks (repro_torch.core.cohort stacks many clients)
    def stage_cohort(self, params: PyTree):
        """The per-client state the cohort engine stacks: (momentum, lr)."""
        if self._mu is None:
            self._mu = pt.tree_zeros_like(params)
        return self._mu, self._lr()

    def commit_cohort(self, mu: PyTree) -> None:
        """Scatter one cohort row back: the new momentum and the round
        count, as :meth:`run_local` leaves them."""
        self._mu = mu
        self.round_idx += 1

    def run_local(self, params: PyTree, k: int, snapshot_iter: int,
                  prox_mu: float = 0.0) -> Tuple[ClientUpdate, float]:
        """K local steps -> (ClientUpdate, mean local loss)."""
        if self._mu is None:
            self._mu = pt.tree_zeros_like(params)
        with tracing.span("client.stage"):
            bx, by = self.task.to_device(self.batcher.next_stacked(k),
                                         self.device)
        delta, self._mu, loss = _local_k_steps(
            self.task, params, self._mu, bx, by, self._lr(),
            beta=self.fed.local_momentum, prox_mu=prox_mu)
        tracing.count("client.steps", k)
        with tracing.span("client.collect"):
            self.round_idx += 1
            upd = ClientUpdate(self.client_id, snapshot_iter, k, delta,
                               self.num_samples)
            return upd, float(loss)

    def compress_update(self, upd: ClientUpdate) -> ClientUpdate:
        """Put an outgoing update in wire form per ``fed.delta_compression``,
        folding in (and refreshing) the error-feedback residual. No-op when
        compression is off or the delta is already compressed."""
        mode = self.fed.delta_compression
        if mode == "off" or compression.is_compressed(upd.delta):
            return upd
        if self._flatspec is None:
            self._flatspec = pt.FlatSpec(upd.delta, block=compression.BLOCK)
        vec = self._flatspec.flatten(upd.delta)
        if self._residual is not None:
            vec = vec + self._residual
        cd = compression.quantize_vec(vec, mode, self._flatspec.n)
        self._residual = vec - compression.dequantize(cd)
        return ClientUpdate(upd.client_id, upd.snapshot_iter, upd.k_used,
                            cd, upd.num_samples)

    def stage_residual(self, spec: pt.FlatSpec) -> torch.Tensor:
        """The error-feedback row an engine that quantizes on the device
        folds into this client's delta. ``spec`` is the fan-out's shared
        flat layout, adopted as this client's, so a later
        :meth:`compress_update` keeps the same padded length."""
        if self._flatspec is None:
            self._flatspec = spec
        if self._residual is None:
            return spec.zeros()
        return self._residual

    def commit_residual(self, residual: torch.Tensor) -> None:
        """Scatter one refreshed error-feedback row back after the engine
        compressed this client's delta itself (:meth:`compress_update`
        no-ops on an update already in wire form)."""
        self._residual = residual

    def release_residual(self) -> None:
        """Drop the error-feedback residual (the client's session ended)."""
        self._residual = None
