"""Server-side protocol: AsyncFedED (Algorithm 1) and the baselines'
aggregation rules (FedAsync, FedBuff, synchronous FedAvg/FedProx).

Servers are pure protocol logic — no clocks, no sockets. The discrete-event
simulator (repro_torch.core.simulator) drives them. The server works on the
device its initial params lie on.

The AsyncFedED server has both backends, both GMIS modes and the per-leaf
variant, compressed (int8 and bf16) deltas, the flat backend's batched
burst drain for every wire form, model sharding of the flat state
(``FedConfig.model_shards``: the vector and every GMIS snapshot split over
the ``model`` axis of the mesh, ``kernels/fedagg/sharded.py``), and
checkpoints of the global model in the JAX package's format. The baselines
mix parameter trees in plain torch, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.configs.base import FedConfig
from repro_torch.core import compression, screening
from repro_torch.core.adaptive_k import AdaptiveK
from repro_torch.core.aggregation import (asyncfeded_aggregate,
                                          asyncfeded_aggregate_per_leaf,
                                          asyncfeded_aggregate_with_dist)
from repro_torch.core.gmis import DisplacementGMIS, RingGMIS
from repro_torch.kernels.fedagg import fedagg, ops, sharded
from repro_torch.launch import mesh as mesh_lib
from repro_torch.sharding import specs
from repro_torch.utils import pytree as pt
from repro_torch.utils import tracing

PyTree = Any

#: the flat aggregation entry points, bound to ``ops`` or to their
#: model-sharded twins in ``sharded``
_AGG_OPS = ("flat_aggregate", "flat_aggregate_displacement",
            "flat_aggregate_q", "flat_aggregate_displacement_q",
            "flat_aggregate_batched", "flat_aggregate_batched_q")


def _staged(t: torch.Tensor) -> torch.Tensor:
    """``t``, a tensor the flat server allocated and filled to stage a
    drain's operands (or a tuple of its shards), counted in
    ``server.copy_bytes``."""
    if tracing.active():
        tracing.count("server.copy_bytes", sum(
            s.numel() * s.element_size()
            for s in (t if isinstance(t, tuple) else (t,))))
    return t


@dataclasses.dataclass
class ClientUpdate:
    client_id: int
    snapshot_iter: int
    k_used: int
    delta: PyTree
    num_samples: int = 1


@dataclasses.dataclass
class ServerReply:
    params: PyTree
    iteration: int
    k_next: int


@dataclasses.dataclass
class UpdateRecord:
    iteration: int
    client_id: int
    lag: int
    gamma: float
    eta: float
    k_used: int
    k_next: int
    dist: float
    delta_norm: float
    #: norm-screening verdict for this arrival: "accept" (also the value
    #: whenever screening is off), "clip" (``eta`` is then the effective
    #: multiplier on the RAW delta) or "reject" (nothing applied, ``eta``
    #: = 0 and the iteration counter did not move).
    screen: str = "accept"


class AsyncServer:
    """Base class for asynchronous servers (one aggregation per arrival)."""

    is_async = True

    def __init__(self, params: PyTree, fed: FedConfig):
        self.params = params
        self.fed = fed
        self.t = 1                       # global iteration (paper: x_1 initial)
        self.history: List[UpdateRecord] = []
        # norm screening: None when fed.screen == "off"
        self.screen = screening.make_screen(fed)
        # built at the first delta a tree path has to (un)flatten
        self._despec: Optional[pt.FlatSpec] = None

    def _delta_spec(self) -> pt.FlatSpec:
        """The padded flat layout of a delta, as the clients flatten it."""
        if self._despec is None:
            self._despec = pt.FlatSpec(self.params, block=compression.BLOCK)
        return self._despec

    def _delta_tree(self, delta) -> PyTree:
        """A delta in tree form, whatever form it arrived in."""
        if not compression.is_compressed(delta):
            return delta
        return self._delta_spec().unflatten(compression.dequantize(delta))

    def _decompress(self, upd: ClientUpdate) -> ClientUpdate:
        if compression.is_compressed(upd.delta):
            return dataclasses.replace(upd, delta=self._delta_tree(upd.delta))
        return upd

    def _delta_vec(self, delta) -> np.ndarray:
        """The flat delta as host f32 numpy (dequantized when it arrived in
        wire form): what direction screens consume."""
        if compression.is_compressed(delta):
            return compression.dequantize(delta).cpu().numpy()
        return self._delta_spec().flatten(delta).cpu().numpy()

    def _screen_delta(self, upd: ClientUpdate):
        """Screen one arriving delta. Returns ``(upd', verdict, scale,
        raw_norm)``: ``upd'`` carries the clipped delta, or is None when
        the update is rejected; ``raw_norm`` is None when screening is off,
        so the off path builds records exactly as without screening. A
        compressed delta is screened on its DEQUANTIZED norm and clipped in
        its wire form (exact on int8 scales). Direction screens
        (``needs_vector``) also receive the flat delta vector."""
        if self.screen is None:
            return upd, "accept", 1.0, None
        raw = compression.delta_norm(upd.delta)
        if getattr(self.screen, "needs_vector", False):
            verdict, scale = self.screen.observe(
                raw, upd.client_id, vec=self._delta_vec(upd.delta))
        else:
            verdict, scale = self.screen.observe(raw, upd.client_id)
        if verdict == "reject":
            return None, verdict, 0.0, raw
        if verdict == "clip":
            upd = dataclasses.replace(
                upd, delta=compression.scale_delta(upd.delta, scale))
        return upd, verdict, scale, raw

    def screen_stats(self) -> Optional[dict]:
        return None if self.screen is None else self.screen.stats()

    def on_connect(self, client_id: int) -> ServerReply:
        raise NotImplementedError

    def on_update(self, upd: ClientUpdate) -> ServerReply:
        raise NotImplementedError

    def on_update_batch(self, upds: List[ClientUpdate]) -> List[ServerReply]:
        """Drain a burst of arrivals. Default: apply one at a time, then hand
        every client the final model. A batch of one is exactly
        ``on_update``."""
        replies = [self.on_update(u) for u in upds]
        if len(replies) == 1:
            return replies
        return [ServerReply(self.params, self.t, r.k_next) for r in replies]

    def batch_limit(self) -> Optional[int]:
        return None

    def on_disconnect(self, client_id: int) -> None:
        """The client's session ended; default: nothing registered."""

    def finalize(self, now: float) -> None:
        """End-of-run hook; default: nothing pending."""


class AsyncFedEDServer(AsyncServer):
    """Algorithm 1: Euclidean-distance staleness + adaptive eta_g and K.

    Two backends, selected with ``backend=``:

    * ``"pytree"`` — the reference: plain torch passes over the parameter
      tree per update (Eq. 6 distance, delta norm, Eq. 5 AXPY).
    * ``"pallas"`` (the name is the JAX package's, so one ``FedConfig``
      drives both) — the flat-state server: the global model lives as ONE
      padded flat f32 vector (``pt.FlatParams``), the GMIS stores flat
      vectors, and every update is a norms sweep and an AXPY sweep
      (``kernels.fedagg``): hand-written CUDA kernels on the GPU, their
      plain versions on the CPU. An int8 delta goes through the int8
      sweeps, a bf16 one through the f32 sweeps; a burst drained by
      :meth:`on_update_batch` goes through the batched pair. With
      ``fed.model_shards`` = S > 1 the flat vector, every GMIS snapshot and
      every delta are split into S contiguous shards over the ``model``
      axis of a mesh (``launch/mesh.py``), padded to ``BLOCK * S``, and
      every sweep runs per shard with one fixed-order sum of the partials
      (``kernels/fedagg/sharded.py``).
    """

    name = "asyncfeded"

    def __init__(self, params: PyTree, fed: FedConfig,
                 gmis_mode: str = "ring", per_leaf: bool = False,
                 backend: str = "pytree"):
        if backend not in ("pytree", "pallas"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "pallas" and per_leaf:
            raise ValueError("per-leaf staleness needs the pytree backend")
        self.backend = backend
        # the model axis: S > 1 splits the flat vector and, through the
        # GMIS, every snapshot; aggregation goes through the sharded twins
        self._shards = fed.model_shards if backend == "pallas" else 1
        self._mesh = None
        agg = ops
        if self._shards > 1:
            self._mesh = mesh_lib.make_fedagg_mesh(
                self._shards, device=pt.tree_leaves(params)[0].device)
            agg = sharded
        self._agg = {name: getattr(agg, name) for name in _AGG_OPS}
        self._flat: Optional[pt.FlatParams] = None
        self._zeros = None
        super().__init__(params, fed)    # routes through the params setter
        self.per_leaf = per_leaf
        self.gmis_mode = gmis_mode
        if gmis_mode == "ring":
            self.gmis = RingGMIS(depth=fed.gmis_depth)
        elif gmis_mode == "displacement":
            self.gmis = DisplacementGMIS()
        else:
            raise ValueError(gmis_mode)
        self.gmis.append(self.t, self._gmis_state())
        self.kctl = AdaptiveK(fed.k_initial, fed.gamma_bar, fed.kappa,
                              fed.k_min, fed.k_max)

    # --- flat-state plumbing: ``params`` stays the canonical tree view ---
    @property
    def params(self) -> PyTree:
        if self.backend == "pallas":
            if self._shards > 1 and self._flat._tree_cache is None:
                # the tree view leaves the server (downloads, eval): built
                # from one gathered copy on the home device, once per model
                self._flat._tree_cache = self._flat.spec.unflatten(
                    specs.gather_flat(self._flat.vec, self._mesh.home))
            return self._flat.tree       # lazily unflattened views, cached
        return self._params

    @params.setter
    def params(self, value: PyTree) -> None:
        if self.backend == "pallas":
            # padded to BLOCK * S, so that every model shard is a whole
            # number of kernel blocks; the padding is zeros
            self._flat = pt.FlatParams.from_tree(
                value, block=fedagg.BLOCK * self._shards)
            self._zeros = self._split(self._flat.spec.zeros())
            if self._shards > 1:
                self._flat = pt.FlatParams(self._split(self._flat.vec),
                                           self._flat.spec,
                                           tree_cache=value)
        else:
            self._params = value

    def _split(self, vec: torch.Tensor):
        """A padded flat vector (or a (B, n) stack) in the server's layout:
        itself, or its model shards."""
        return vec if self._mesh is None else specs.split_flat(vec,
                                                               self._mesh)

    def _gmis_state(self):
        """What the GMIS stores: flat vectors under the flat backend (a
        tensor is a one-leaf tree), full trees otherwise."""
        return self._flat.vec if self.backend == "pallas" else self.params

    def save_checkpoint(self, directory: str,
                        step: Optional[int] = None) -> str:
        """Persist the global model (default step: the iteration counter).
        The flat backend saves the PADDED flat vector with its layout
        (``checkpoint.save_flat``); the tree backend the params tree."""
        step = self.t if step is None else step
        if self.backend == "pallas":
            vec = self._flat.vec
            if self._shards > 1:
                vec = specs.gather_flat(vec, self._mesh.home)
            return checkpoint.save_flat(
                vec, self._flat.spec.n, directory, step,
                block=self._flat.spec.block, model_shards=self._shards)
        return checkpoint.save_pytree(self.params, directory, step)

    def restore_checkpoint(self, directory: str,
                           step: Optional[int] = None) -> None:
        """Restore the global model saved by :meth:`save_checkpoint`, by
        this package or the JAX one. A flat checkpoint must hold this
        model's true-element count and is re-padded (and re-split) to this
        server's layout, so a vector saved under one ``model_shards``
        restores exactly under another."""
        if self.backend == "pallas":
            vec, _ = checkpoint.restore_flat(
                directory, step, n=self._flat.spec.n,
                n_padded=self._flat.spec.n_padded)
            home = (self._flat.vec.device if self._mesh is None
                    else self._mesh.home)
            self._flat = self._flat.replace(
                self._split(torch.from_numpy(vec).to(home)))
        else:
            self.params = checkpoint.restore_pytree(self.params, directory,
                                                    step)

    def _register(self, client_id: int) -> None:
        if self.gmis_mode == "displacement":
            self.gmis.register_snapshot(client_id, self.t, self._gmis_state())
        else:
            self.gmis.register_snapshot(client_id, self.t)

    def on_connect(self, client_id: int) -> ServerReply:
        self._register(client_id)
        return ServerReply(self.params, self.t, self.kctl.get(client_id))

    # ------------------------------------------------------------ backends --
    def _aggregate_pytree(self, upd: ClientUpdate):
        fed = self.fed
        if self.gmis_mode == "displacement":
            dist = self.gmis.distance_from(upd.client_id, upd.snapshot_iter,
                                           self.params)
            res = asyncfeded_aggregate_with_dist(
                self.params, dist, upd.delta, lam=fed.lam, eps=fed.eps,
                cap=fed.staleness_cap)
            self.gmis.release(upd.client_id)
        else:
            stale, _ = self.gmis.get(upd.snapshot_iter)
            agg = (asyncfeded_aggregate_per_leaf if self.per_leaf
                   else asyncfeded_aggregate)
            res = agg(self.params, stale, upd.delta, lam=fed.lam,
                      eps=fed.eps, cap=fed.staleness_cap)
        self.params = res.params
        return res.gamma, res.eta, res.dist, res.delta_norm, upd.delta

    def _wire_padded(self, cd):
        """A compressed payload's (q, scales) padded to the server's flat
        length. Clients pad to BLOCK; a sharded server pads to BLOCK * S,
        which can be longer: appended zero q blocks carry zero scales and
        dequantize to exactly 0."""
        n_pad = self._flat.spec.n_padded
        if cd.q.shape[0] == n_pad:
            return cd.q, cd.scales
        q = _staged(torch.nn.functional.pad(cd.q,
                                            (0, n_pad - cd.q.shape[0])))
        scales = cd.scales
        if scales is not None:
            scales = _staged(torch.nn.functional.pad(
                scales, (0, n_pad // fedagg.QBLOCK - scales.shape[0])))
        return q, scales

    def _flat_delta(self, delta: PyTree) -> torch.Tensor:
        """A delta tree flattened to the server's padded length; what its
        casts, concatenation and padding fill counts in
        ``server.copy_bytes``."""
        spec = self._flat.spec
        if tracing.active():
            cast = sum(4 * n for n, dt in zip(spec.sizes, spec.dtypes)
                       if dt != torch.float32)
            tracing.count("server.copy_bytes", cast + 4 * spec.n + (
                4 * spec.n_padded if spec.n_padded != spec.n else 0))
        return spec.flatten(delta)

    def _split_scales(self, scales: torch.Tensor):
        """int8 scales (or a stack of them) in the server's layout: beside
        the q blocks of :meth:`_split`."""
        return (scales if self._mesh is None
                else specs.split_scales(scales, self._mesh))

    def _aggregate_flat(self, upd: ClientUpdate):
        fed = self.fed
        disp = self.gmis_mode == "displacement"
        cd = upd.delta if compression.is_compressed(upd.delta) else None
        if cd is not None and cd.mode == "int8":
            # q and scales go straight into the int8 kernels, dequantized
            # in registers
            q, qscales = self._wire_padded(cd)
            sq, sscales = self._split(q), self._split_scales(qscales)
            if disp:
                new_vec, gamma, eta, dist, dnorm = (
                    self._agg["flat_aggregate_displacement_q"](
                        self._flat.vec, self.gmis.displacement(upd.client_id),
                        sq, sscales, self._zeros, lam=fed.lam, eps=fed.eps,
                        cap=fed.staleness_cap))
                self.gmis.release(upd.client_id)
            else:
                stale, _ = self.gmis.get(upd.snapshot_iter)
                new_vec, gamma, eta, dist, dnorm = self._agg[
                    "flat_aggregate_q"](
                    self._flat.vec, stale, sq, sscales, lam=fed.lam,
                    eps=fed.eps, cap=fed.staleness_cap)
            self._flat = self._flat.replace(new_vec)
            # the ring GMIS ignores the delta; only displacement
            # accumulators need it in f32
            d = (self._split(compression.dequantize(
                    dataclasses.replace(cd, q=q, scales=qscales)))
                 if disp else cd)
            return gamma, eta, dist, dnorm, d
        # a bf16 payload rides the f32 kernels (upcast on load)
        d = self._split(self._wire_padded(cd)[0] if cd is not None
                        else self._flat_delta(upd.delta))
        if disp:
            new_vec, gamma, eta, dist, dnorm = self._agg[
                "flat_aggregate_displacement"](
                self._flat.vec, self.gmis.displacement(upd.client_id), d,
                self._zeros, lam=fed.lam, eps=fed.eps, cap=fed.staleness_cap)
            self.gmis.release(upd.client_id)
        else:
            stale, _ = self.gmis.get(upd.snapshot_iter)
            new_vec, gamma, eta, dist, dnorm = self._agg["flat_aggregate"](
                self._flat.vec, stale, d, lam=fed.lam, eps=fed.eps,
                cap=fed.staleness_cap)
        self._flat = self._flat.replace(new_vec)
        # eta * (a bf16 vector) is bf16 in PyTorch and f32 in JAX: the
        # displacement accumulators take the payload in f32
        return gamma, eta, dist, dnorm, (pt.tree_map(lambda t: t.float(), d)
                                         if disp else d)

    def _reject_reply(self, upd: ClientUpdate, raw_norm: float
                      ) -> ServerReply:
        """A screened-out arrival: the model and the iteration counter do
        not move; the client resumes from the current model."""
        k_next = self.kctl.get(upd.client_id)
        self.history.append(UpdateRecord(
            self.t, upd.client_id, self.t - upd.snapshot_iter,
            float("nan"), 0.0, upd.k_used, k_next, float("nan"), raw_norm,
            "reject"))
        self._register(upd.client_id)
        return ServerReply(self.params, self.t, k_next)

    def on_update(self, upd: ClientUpdate) -> ServerReply:
        with tracing.span("server.update"):
            return self._update(upd)

    def _update(self, upd: ClientUpdate) -> ServerReply:
        upd2, verdict, scale, raw_norm = self._screen_delta(upd)
        if upd2 is None:
            return self._reject_reply(upd, raw_norm)
        upd = upd2
        if self.backend == "pallas":
            gamma, eta, dist, dnorm, delta = self._aggregate_flat(upd)
        else:
            # decompressed here: the delta also feeds gmis.on_aggregate
            upd = self._decompress(upd)
            gamma, eta, dist, dnorm, delta = self._aggregate_pytree(upd)
        # true staleness: tau = t - snapshot at APPLY time, before this
        # update advances the iteration counter
        lag = self.t - upd.snapshot_iter
        self.t += 1
        self.gmis.append(self.t, self._gmis_state())
        self.gmis.on_aggregate(eta, delta)
        # the one wait on the device per arrival: the record's scalars
        gamma, eta_f, dist, dnorm = torch.stack(
            [gamma, eta, dist, dnorm]).tolist()
        k_next = self.kctl.observe(upd.client_id, gamma)
        self.history.append(UpdateRecord(
            self.t, upd.client_id, lag, gamma, eta_f * scale, upd.k_used,
            k_next, dist, dnorm if raw_norm is None else raw_norm, verdict))
        self._register(upd.client_id)
        return ServerReply(self.params, self.t, k_next)

    def on_update_batch(self, upds: List[ClientUpdate]) -> List[ServerReply]:
        """A burst of arrivals. On the flat ring-GMIS server it goes through
        the batched sweeps, sequential-equivalent to B ``on_update`` calls
        (``aggregation.sequential_batch_schedule``); screening inside the
        burst reuses the batched norms (``screen.decide_batch``). A burst of
        one, the tree backend, displacement GMIS, a burst mixing wire forms
        and a direction screen drain one at a time and re-register every
        drained client at the final model. A burst of int8 deltas goes
        through the int8 twins of the batched sweeps."""
        modes = {u.delta.mode if compression.is_compressed(u.delta)
                 else "off" for u in upds}
        batched = (self.backend == "pallas" and self.gmis_mode == "ring"
                   and len(upds) > 1 and len(modes) == 1
                   and not getattr(self.screen, "needs_vector", False))
        with tracing.span("server.drain", updates=len(upds),
                          path="batched" if batched else "single"):
            if batched:
                return self._drain_batched(upds, modes.pop())
            replies = [self.on_update(u) for u in upds]
            if len(replies) > 1:
                # every drained client resumes from the window's final
                # model: re-anchor its snapshot there (in displacement
                # mode on_update zeroed it at an intermediate model)
                for u in upds:
                    self._register(u.client_id)
                replies = [ServerReply(self.params, self.t, r.k_next)
                           for r in replies]
            return replies

    def _drain_batched(self, upds: List[ClientUpdate],
                       mode: str) -> List[ServerReply]:
        """:meth:`on_update_batch` through the batched sweeps, for a burst
        of one wire form ``mode``."""
        fed = self.fed
        with tracing.span("server.stack"):
            snaps = [self.gmis.get(u.snapshot_iter)[0] for u in upds]
            # a sharded server stacks each shard's snapshots on its own
            # device
            stales = _staged(
                torch.stack(snaps) if self._mesh is None else
                tuple(torch.stack(rows) for rows in zip(*snaps)))
        # the kernel-emitted raw norms feed the screen in arrival order;
        # its scale factors fold into the schedule
        screen_fn = (None if self.screen is None else
                     lambda dns: self.screen.decide_batch(
                         dns, [u.client_id for u in upds]))
        if mode == "int8":
            with tracing.span("server.flatten"):
                wires = [self._wire_padded(u.delta) for u in upds]
                qs = _staged(torch.stack([q for q, _ in wires]))
                qscales = _staged(torch.stack([s for _, s in wires]))
            new_vec, etas, gammas, dists, dnorms, scales = (
                self._agg["flat_aggregate_batched_q"](
                    self._flat.vec, stales, self._split(qs),
                    self._split_scales(qscales), lam=fed.lam, eps=fed.eps,
                    cap=fed.staleness_cap, screen=screen_fn))
        else:
            # "off" flattens trees; "bf16" stacks the payloads, which ride
            # the f32 kernels
            with tracing.span("server.flatten"):
                deltas = _staged(torch.stack([
                    self._wire_padded(u.delta)[0] if mode == "bf16"
                    else self._flat_delta(u.delta) for u in upds]))
            new_vec, etas, gammas, dists, dnorms, scales = (
                self._agg["flat_aggregate_batched"](
                    self._flat.vec, stales, self._split(deltas), lam=fed.lam,
                    eps=fed.eps, cap=fed.staleness_cap, screen=screen_fn))
        self._flat = self._flat.replace(new_vec)
        with tracing.span("server.record"):
            return self._record_batch(upds, etas, gammas, dists, dnorms,
                                      scales)

    def _record_batch(self, upds: List[ClientUpdate], etas, gammas, dists,
                      dnorms, scales) -> List[ServerReply]:
        """A batched drain's history, Eq. 8, GMIS append, registrations
        and replies."""
        k_nexts = []
        for i, upd in enumerate(upds):
            verdict = ("accept" if scales is None
                       else screening.verdict_of_scale(float(scales[i])))
            # pre-increment staleness, as in on_update: the server state at
            # this update's turn in the sequential equivalence
            lag = self.t - upd.snapshot_iter
            if verdict == "reject":
                k_next = self.kctl.get(upd.client_id)
                self.history.append(UpdateRecord(
                    self.t, upd.client_id, lag, float("nan"), 0.0,
                    upd.k_used, k_next, float("nan"), float(dnorms[i]),
                    "reject"))
            else:
                self.t += 1
                gamma = float(gammas[i])
                k_next = self.kctl.observe(upd.client_id, gamma)
                self.history.append(UpdateRecord(
                    self.t, upd.client_id, lag, gamma, float(etas[i]),
                    upd.k_used, k_next, float(dists[i]), float(dnorms[i]),
                    verdict))
            k_nexts.append(k_next)
        # no client is handed an intermediate model, so only the final
        # version enters the GMIS
        self.gmis.append(self.t, self._gmis_state())
        for upd in upds:
            self._register(upd.client_id)
        return [ServerReply(self.params, self.t, k) for k in k_nexts]

    def batch_limit(self) -> Optional[int]:
        if self.backend == "pallas" and self.gmis_mode == "ring":
            delta_bytes = {"off": 4, "bf16": 2, "int8": 1}[
                self.fed.delta_compression]
            return fedagg.batched_b_max(delta_bytes)
        return None

    def on_disconnect(self, client_id: int) -> None:
        """Release the snapshot registration made at this client's final
        reply (displacement mode otherwise keeps accumulating for it)."""
        self.gmis.release(client_id)


class FedAsyncServer(AsyncServer):
    """FedAsync (Xie et al.): x <- (1-a) x + a x_local, the mixing weight
    alpha_t = alpha0 * s(lag) scaled by one of three staleness decays:

    * ``constant`` — s = 1 (no decay);
    * ``poly``     — s = (lag + 1) ** -poly_a;
    * ``hinge``    — s = 1 for lag <= b, else 1 / (a (lag - b) + 1).
    """

    MODES = ("constant", "poly", "hinge")

    def __init__(self, params: PyTree, fed: FedConfig, mode: str = "constant"):
        super().__init__(params, fed)
        assert mode in self.MODES, mode
        self.mode = mode
        self.name = f"fedasync+{mode}"
        self.gmis = RingGMIS(depth=fed.gmis_depth)
        self.gmis.append(self.t, params)

    def on_connect(self, client_id: int) -> ServerReply:
        return ServerReply(self.params, self.t, self.fed.k_initial)

    def _alpha(self, lag: int) -> float:
        a0 = self.fed.fedasync_alpha
        if self.mode == "constant":
            return a0
        if self.mode == "poly":
            return a0 * float(lag + 1) ** (-self.fed.poly_a)
        a, b = self.fed.hinge_a, self.fed.hinge_b
        s = 1.0 if lag <= b else 1.0 / (a * (lag - b) + 1.0)
        return a0 * s

    def on_update(self, upd: ClientUpdate) -> ServerReply:
        upd2, verdict, scale, raw_norm = self._screen_delta(upd)
        if upd2 is None:
            # rejected: nothing mixes, the counter does not move
            self.history.append(UpdateRecord(
                self.t, upd.client_id, self.t - upd.snapshot_iter,
                float("nan"), 0.0, upd.k_used, self.fed.k_initial,
                float("nan"), raw_norm, "reject"))
            return ServerReply(self.params, self.t, self.fed.k_initial)
        upd = self._decompress(upd2)     # f32 before any arithmetic
        stale, actual = self.gmis.get(upd.snapshot_iter)
        x_local = pt.tree_add(stale, upd.delta)
        # the ring may have clamped to its oldest version: x_local is built
        # from that snapshot, so the decay is taken at the clamped lag
        lag = self.t - actual
        alpha = self._alpha(lag)
        # new tensors every time: the ring holds the trees it mixed
        self.params = pt.tree_map(
            lambda xg, xl: ((1.0 - alpha) * xg.float()
                            + alpha * xl.float()).to(xg.dtype),
            self.params, x_local)
        self.t += 1
        self.gmis.append(self.t, self.params)
        self.history.append(UpdateRecord(
            self.t, upd.client_id, lag, float("nan"), alpha, upd.k_used,
            self.fed.k_initial, float("nan"),
            float("nan") if raw_norm is None else raw_norm, verdict))
        return ServerReply(self.params, self.t, self.fed.k_initial)


class FedBuffServer(AsyncServer):
    """FedBuff (Nguyen et al.): buffered asynchronous aggregation."""

    name = "fedbuff"

    def __init__(self, params: PyTree, fed: FedConfig):
        super().__init__(params, fed)
        #: buffered (delta in wire form, snapshot_iter) pairs
        self.buffer: List[tuple] = []

    def on_connect(self, client_id: int) -> ServerReply:
        return ServerReply(self.params, self.t, self.fed.k_initial)

    def _flush(self, client_id: int, k_used: int) -> None:
        scale = self.fed.lam / len(self.buffer)
        # decompressed only at flush time
        mean = self._delta_tree(self.buffer[0][0])
        for d, _ in self.buffer[1:]:
            mean = pt.tree_add(mean, self._delta_tree(d))
        # the flush's staleness: its oldest snapshot, before the increment
        lag = self.t - min(snap for _, snap in self.buffer)
        self.params = pt.tree_axpy(scale, mean, self.params)
        self.buffer = []
        self.t += 1
        self.history.append(UpdateRecord(
            self.t, client_id, lag, float("nan"), scale, k_used,
            self.fed.k_initial, float("nan"), float("nan")))

    def on_update(self, upd: ClientUpdate) -> ServerReply:
        upd2, verdict, scale, raw_norm = self._screen_delta(upd)
        if upd2 is None:
            # rejected before buffering: the flush never sees this delta
            self.history.append(UpdateRecord(
                self.t, upd.client_id, self.t - upd.snapshot_iter,
                float("nan"), 0.0, upd.k_used, self.fed.k_initial,
                float("nan"), raw_norm, "reject"))
            return ServerReply(self.params, self.t, self.fed.k_initial)
        self.buffer.append((upd2.delta, upd2.snapshot_iter))
        if len(self.buffer) >= self.fed.fedbuff_size:
            self._flush(upd.client_id, upd.k_used)
        return ServerReply(self.params, self.t, self.fed.k_initial)

    def finalize(self, now: float) -> None:
        """Flush a partly filled buffer at the end of a run, scaled by its
        actual size; recorded with client_id -1."""
        if self.buffer:
            self._flush(-1, 0)


class SyncServer:
    """Synchronous rounds (FedAvg Eq. 38; FedProx shares the rule — its
    difference is the client-side proximal term)."""

    is_async = False
    #: norm screening is an asynchronous-arrival defense: off here
    screen = None

    def __init__(self, params: PyTree, fed: FedConfig, name: str = "fedavg"):
        self.params = params
        self.fed = fed
        self.name = name
        self.t = 1
        self.history: List[UpdateRecord] = []

    def screen_stats(self) -> Optional[dict]:
        return None

    def on_connect(self, client_id: int) -> ServerReply:
        return ServerReply(self.params, self.t, self.fed.k_initial)

    def round(self, updates: List[ClientUpdate]) -> ServerReply:
        """One round: the deltas weighted by ``num_samples / total``,
        summed in client order."""
        total = float(sum(u.num_samples for u in updates))
        acc = None
        for u in updates:
            scaled = pt.tree_scale(u.delta, u.num_samples / total)
            acc = scaled if acc is None else pt.tree_add(acc, scaled)
        self.params = pt.tree_add(self.params, acc)
        self.t += 1
        self.history.append(UpdateRecord(
            self.t, -1, 0, 0.0, 1.0, updates[0].k_used,
            self.fed.k_initial, 0.0, 0.0))
        return ServerReply(self.params, self.t, self.fed.k_initial)

    def finalize(self, now: float) -> None:
        """End-of-run hook: synchronous rounds leave nothing pending."""


def make_server(name: str, params: PyTree, fed: FedConfig, **kw):
    """Build a server by aggregator name. AsyncFedED variants accept
    ``backend="pytree"|"pallas"`` and ``gmis_mode`` via ``**kw``."""
    name = name.lower()
    if name == "asyncfeded":
        return AsyncFedEDServer(params, fed, **kw)
    if name == "asyncfeded-perleaf":
        return AsyncFedEDServer(params, fed, per_leaf=True, **kw)
    if name == "asyncfeded-displacement":
        return AsyncFedEDServer(params, fed, gmis_mode="displacement", **kw)
    if name.startswith("fedasync+"):
        mode = name.split("+", 1)[1]
        if mode in FedAsyncServer.MODES:
            return FedAsyncServer(params, fed, mode=mode, **kw)
    if name == "fedbuff":
        return FedBuffServer(params, fed, **kw)
    if name in ("fedavg", "fedprox"):
        return SyncServer(params, fed, name=name, **kw)
    raise ValueError(f"unknown aggregator {name!r}")
