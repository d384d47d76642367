"""Attack models for the adversarial scenario layer.

A configurable fraction of clients is byzantine: every delta they emit is
corrupted *at emission time*, in the simulator's dispatch path — after
local training, before compression and the event queue — so both server
backends see the identical attacked stream for a given seed. Honest
clients' deltas pass through untouched, and with ``attack="none"`` (the
default) no adversary object exists at all.

Registry (names mirrored by ``configs.base.ATTACKS``):

* ``sign-flip``      — Delta -> -strength * Delta;
* ``gaussian-noise`` — Delta -> Delta + sigma * N(0, I) with sigma scaled
  to ``noise_scale`` times the delta's RMS entry;
* ``scale``          — Delta -> boost * Delta;
* ``zero``           — Delta -> 0 (free-rider).

Attacks draw from their own numpy PCG64 stream (the run seed plus
:data:`_SEED_SALT`, as in the JAX package), so a seed picks the same
corrupted clients and the same noise in both packages. ``gaussian-noise``
draws one normal array per leaf in the port's leaf order, which is
``jax.tree.flatten``'s (``utils.pytree``), on the host, and moves each
result back to its leaf's device and dtype. Every attack honors an
``onset`` knob in ``attack_params``: a corrupted client's first ``onset``
emissions stay honest.

Every attack also takes a delta in wire form
(:class:`~repro_torch.core.compression.CompressedDelta`): sign-flip, scale
and zero are exact there (int8 scaling touches only the f32 scales);
gaussian-noise dequantizes, perturbs and re-quantizes on the payload's
device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ATTACKS, FedConfig
from repro_torch.core import compression
from repro_torch.utils import pytree as pt

PyTree = Any

#: offset folded into the run seed for the adversary's private RNG stream
_SEED_SALT = 777_767


def _sign_flip(delta: PyTree, rng: np.random.Generator, *,
               strength: float = 10.0) -> PyTree:
    if compression.is_compressed(delta):
        return compression.scale_delta(delta, -float(strength))
    return pt.tree_scale(delta, -float(strength))


def _gaussian_noise(delta: PyTree, rng: np.random.Generator, *,
                    noise_scale: float = 10.0) -> PyTree:
    if compression.is_compressed(delta):
        vec = compression.dequantize(delta).cpu().numpy()
        n = max(int(delta.n), 1)      # true elements; padding is zeros
        rms = float(np.sqrt(float(np.sum(vec * vec)) / n))
        sigma = float(noise_scale) * max(rms, 1e-8)
        noisy = vec + rng.normal(0.0, sigma, vec.shape).astype(np.float32)
        return compression.quantize_vec(
            torch.from_numpy(noisy).to(delta.q.device), delta.mode, delta.n)
    n = max(pt.tree_size(delta), 1)
    rms = float(np.sqrt(float(pt.tree_sq_norm(delta)) / n))
    sigma = float(noise_scale) * max(rms, 1e-8)

    def noisy_leaf(leaf):
        noise = np.asarray(rng.normal(0.0, sigma, tuple(leaf.shape)))
        # the noise is rounded to the leaf's dtype and added in it, as the
        # reference adds on host numpy
        out = leaf.detach().cpu() + torch.from_numpy(noise).to(leaf.dtype)
        return out.to(leaf.device)

    return pt.tree_map(noisy_leaf, delta)


def _scale(delta: PyTree, rng: np.random.Generator, *,
           boost: float = 10.0) -> PyTree:
    if compression.is_compressed(delta):
        return compression.scale_delta(delta, float(boost))
    return pt.tree_scale(delta, float(boost))


def _zero(delta: PyTree, rng: np.random.Generator) -> PyTree:
    if compression.is_compressed(delta):
        # scale by 0 zeroes the dequantized values exactly and keeps the
        # wire shape and dtype
        return compression.scale_delta(delta, 0.0)
    return pt.tree_zeros_like(delta)


#: attack name -> corruption fn(delta, rng, **params). Keys mirror
#: ``configs.base.ATTACKS`` minus "none".
ATTACK_FNS = {
    "sign-flip": _sign_flip,
    "gaussian-noise": _gaussian_noise,
    "scale": _scale,
    "zero": _zero,
}


class Adversary:
    """The byzantine cohort for one run: a fixed set of corrupted client
    ids (drawn once from the adversary's private stream) and the attack
    applied to every delta they emit."""

    def __init__(self, fed: FedConfig, *, seed: int):
        if fed.attack not in ATTACK_FNS:
            raise ValueError(f"unknown attack {fed.attack!r}: expected one "
                             f"of {ATTACKS}")
        self.attack = fed.attack
        self.fn = ATTACK_FNS[fed.attack]
        self.params = dict(fed.attack_params)
        # a corrupted client's first ``onset`` emissions stay honest
        self.onset = int(self.params.pop("onset", 0))
        self._emitted: dict = {}
        self.rng = np.random.default_rng(seed + _SEED_SALT)
        n_adv = int(round(fed.attack_frac * fed.num_clients))
        ids = self.rng.choice(fed.num_clients, size=n_adv, replace=False)
        self.corrupt_ids = frozenset(int(i) for i in ids)
        self.applied = 0

    def corrupt(self, upd):
        """Corrupt one emitted ClientUpdate (returns a new record; honest
        clients' updates pass through untouched)."""
        if upd.client_id not in self.corrupt_ids:
            return upd
        seen = self._emitted.get(upd.client_id, 0)
        self._emitted[upd.client_id] = seen + 1
        if seen < self.onset:
            return upd
        self.applied += 1
        return dataclasses.replace(
            upd, delta=self.fn(upd.delta, self.rng, **self.params))

    def stats(self) -> dict:
        return {"attack": self.attack,
                "corrupt_clients": sorted(self.corrupt_ids),
                "applied": self.applied}


def make_adversary(fed: FedConfig, *, seed: int) -> Optional[Adversary]:
    """The run's adversary, or None when the config is benign:
    ``attack="none"``, a zero fraction, or a fraction that rounds to zero
    clients."""
    if fed.attack == "none" or fed.attack_frac <= 0.0:
        return None
    if int(round(fed.attack_frac * fed.num_clients)) == 0:
        return None
    return Adversary(fed, seed=seed)
