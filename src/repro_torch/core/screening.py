"""Server-side norm screening — the byzantine defense layer (DESIGN.md §11).

AsyncFedED's adaptive weight eta_g (Eq. 5-7) trusts every arriving delta:
a corrupted update with an exploded norm moves the global model by design
(eta shrinks only like 1/gamma while the applied step grows like
eta * ||Delta||, which is bounded below by dist-driven terms but unbounded
above in ||Delta||). The natural screening statistic is the same ||Delta||
the fedagg kernels already emit in their norms sweep, so the defense costs
one scalar comparison per arrival.

:class:`NormScreen` keeps a **per-client** EWMA of accepted update norms
and flags any arrival whose norm exceeds ``k * ewma[client]``:

* ``"clip"``   — scale the delta down to the threshold (norm-preserving
  direction, bounded magnitude);
* ``"reject"`` — drop the update entirely: the model and iteration counter
  do not move, the client just resumes from the current model.

The baseline is per-client rather than global because honest delta norms
on the paper's non-IID tasks spread over ~two orders of magnitude across
clients (power-law sample counts x adaptive K): no single global
threshold separates "an amplified attack on a small client" from "a
naturally large honest update", and a global EWMA dragged low by small
clients permanently locks out the large honest ones (rejected norms never
feed the EWMA, so lockout self-reinforces). Against each client's own
history, a norm-amplified corruption is always an outlier.

Robustness details that matter:

* the bootstrap reference is the **median** of the first ``warmup``
  arrivals, so a minority of adversarial norms in the warmup window
  cannot poison the baseline;
* the warmup window itself screens **provisionally** once two samples
  exist, against ``k * median`` of the norms collected so far — otherwise
  a single amplified update landing among the first arrivals (when
  gamma is small and eta ~ lam/eps applies it at full strength) poisons
  the model before any threshold exists. Provisionally flagged norms stay
  out of the warmup buffer;
* a client with no baseline yet (first contact after warmup) is screened
  against ``k * max(known baselines, bootstrap)`` — the loosest honest
  scale on record — so heterogeneous honest newcomers are never locked
  out while grossly amplified first contacts are still caught;
* only **accepted** norms update a baseline — if clipped/rejected norms
  fed it, a sustained attack would ratchet the threshold upward until the
  attack passes.

Norm screening has a provable blind spot: a strength-1 sign-flip emits
``-Delta``, whose norm EQUALS the honest norm — no norm statistic, per
client or global, can separate it from the honest update it mirrors.
:class:`CosineScreen` (policy ``"cosine"``) closes that hole with a
direction statistic: each client keeps a unit-EWMA of its OWN accepted
update directions, and an arrival whose cosine against that baseline
falls below ``cos_min`` is rejected (the mid-run-compromise threat
model — see the class docstring for why the client's own history is the
only usable reference). Direction screens declare ``needs_vector = True``
and receive
the flat delta vector alongside the norm; burst drains fall back to
sequential aggregation for them, since the batched Gram sweep emits only
norms.

Screening is decided in arrival order (the baselines are stateful), which
is why the batched drain path hands this object the kernel-emitted norms
of a burst plus the matching client ids and receives per-update scale
factors back (:meth:`NormScreen.decide_batch`).
"""
from __future__ import annotations

from typing import Hashable, List, MutableMapping, Optional, Tuple

import numpy as np

from repro_torch.configs.base import SCREEN_POLICIES, FedConfig

#: verdict -> delta multiplier semantics: "accept" applies the delta as-is,
#: "clip" applies scale * delta with scale = threshold / norm in (0, 1),
#: "reject" applies nothing (scale 0).
VERDICTS = ("accept", "clip", "reject")


class NormScreen:
    """k x EWMA delta-norm screen with per-client baselines. ``observe``
    consumes one arriving ||Delta|| (in arrival order) and returns
    ``(verdict, scale)``."""

    #: norm screens consume only the scalar ||Delta|| the kernels emit
    needs_vector = False

    def __init__(self, policy: str, *, k: float = 3.0, alpha: float = 0.2,
                 warmup: int = 8,
                 store: Optional[MutableMapping[Hashable, float]] = None):
        if policy not in ("clip", "reject"):
            raise ValueError(f"screen policy must be 'clip' or 'reject', "
                             f"got {policy!r}")
        if k <= 0 or not (0.0 < alpha <= 1.0) or warmup < 1:
            raise ValueError(f"bad screen knobs k={k} alpha={alpha} "
                             f"warmup={warmup}")
        self.policy = policy
        self.k = float(k)
        self.alpha = float(alpha)
        self.warmup = int(warmup)
        #: global bootstrap reference — median of the warmup window; stays
        #: fixed afterward (per-client EWMAs take over the tracking)
        self.ewma: Optional[float] = None
        # per-client EWMA baselines. ``store`` injects an external backing
        # map — the population engine passes its stacked-array-backed view
        # (core.population.EwmaStore) so baselines live in the active-set
        # table instead of an unbounded dict; mutated only in place.
        self._baseline: MutableMapping[Hashable, float] = (
            {} if store is None else store)
        self._warm: List[float] = []
        self.counts = {"accept": 0, "clip": 0, "reject": 0}

    @property
    def threshold(self) -> Optional[float]:
        """Loosest current threshold (what a first-contact client is
        screened against); None while still warming up."""
        if self.ewma is None:
            return None
        return self.k * max(self._baseline.values(), default=self.ewma)

    def _flag(self, norm: float, thr: float) -> Tuple[str, float]:
        if self.policy == "clip":
            self.counts["clip"] += 1
            return "clip", thr / norm
        self.counts["reject"] += 1
        return "reject", 0.0

    def _accept(self, norm: float, client_id: Hashable) -> Tuple[str, float]:
        self.counts["accept"] += 1
        base = self._baseline.get(client_id)
        self._baseline[client_id] = (
            norm if base is None else base + self.alpha * (norm - base))
        return "accept", 1.0

    def observe(self, norm: float,
                client_id: Hashable = None) -> Tuple[str, float]:
        norm = float(norm)
        if self.ewma is None:
            # median-initialized warmup; once two samples exist, screen
            # provisionally against k * running-median so an early
            # amplified update cannot land at full strength before any
            # baseline exists
            if len(self._warm) >= 2:
                prov = self.k * float(np.median(self._warm))
                if norm > prov:
                    return self._flag(norm, prov)
            self._warm.append(norm)
            if len(self._warm) >= self.warmup:
                self.ewma = float(np.median(self._warm))
                # a corrupt client landing inside the warmup window would
                # otherwise have seeded its own baseline at the amplified
                # norm and passed its own screen forever: prune every
                # warmup-seeded baseline the settled median disowns (the
                # client re-bootstraps through the first-contact clip)
                cut = self.k * self.ewma
                # prune IN PLACE: ``_baseline`` may be an injected
                # array-backed store (population mode) that rebinding
                # would silently disconnect from the active-set table
                for c in [c for c, b in self._baseline.items() if b > cut]:
                    del self._baseline[c]
                self._warm = []
            return self._accept(norm, client_id)
        base = self._baseline.get(client_id)
        # first contact after warmup screens against the loosest honest
        # scale on record rather than any single global average — cross-
        # client honest norms spread orders of magnitude, and a tighter
        # bootstrap threshold would lock naturally-large clients out
        # before they ever seed a baseline
        ref = base if base is not None else max(
            self._baseline.values(), default=self.ewma)
        thr = self.k * max(ref, 0.0)
        if thr <= 0.0 or norm <= thr:
            return self._accept(norm, client_id)
        return self._flag(norm, thr)

    def decide_batch(self, norms, client_ids=None, *,
                     shared_baseline: bool = False) -> np.ndarray:
        """Screen a burst of kernel-emitted norms in arrival order; returns
        the per-update scale factors (1 accept, (0,1) clip, 0 reject) that
        the sequential-equivalence schedule folds into its recursion.
        ``client_ids`` aligns with ``norms``.

        Omitting ``client_ids`` used to silently collapse every arrival
        onto the single shared baseline key ``None`` — per-client EWMAs
        (the whole point of the screen, DESIGN.md §11) degraded to one
        global baseline with no warning. A caller that genuinely wants
        that degraded mode must now say so with ``shared_baseline=True``;
        otherwise missing ids are an error."""
        if client_ids is None:
            if not shared_baseline:
                raise ValueError(
                    "decide_batch needs client_ids aligned with norms — "
                    "omitting them collapses every arrival onto one shared "
                    "baseline key and defeats the per-client EWMAs; pass "
                    "shared_baseline=True to opt into that degraded mode")
            client_ids = [None] * len(norms)
        return np.asarray(
            [self.observe(float(n), cid)[1]
             for n, cid in zip(norms, client_ids)], np.float32)

    def stats(self) -> dict:
        out = dict(self.counts)
        out["policy"] = self.policy
        out["ewma"] = self.ewma
        out["threshold"] = self.threshold
        out["clients"] = len(self._baseline)
        return out


class CosineScreen:
    """Per-client-EWMA cosine screen (policy ``"cosine"``).

    A strength-1 sign-flip emits the honest update mirrored through the
    origin: its norm EQUALS the honest norm, so no norm statistic — per
    client or global — can see it. Its direction can. The only reliable
    direction reference on this system's tasks is the client's OWN
    history: measured on the paper's synthetic tasks (both IID and
    non-IID heterogeneity), cross-client delta cosines sit at ~-0.03 +/-
    0.06 — there is no cross-client descent consensus to compare against,
    and leave-one-out / global-reference variants were tried and flag
    honest clients as often as flippers — while SAME-client consecutive
    deltas align at ~+0.73. So each client keeps a unit EWMA of its own
    accepted update directions, and an arrival whose cosine against that
    baseline falls below ``cos_min`` is rejected. A flip lands at ~-0.7
    against a ~+0.7 honest baseline: the margin is enormous in both
    directions, which is what makes the screen deployable.

    Threat model: MID-RUN COMPROMISE — an established client turning
    byzantine (``attack_params={"onset": n}``), the realistic way
    devices go bad in a federation. A from-genesis flipper that never
    emits an honest delta establishes a self-consistent (mirrored)
    history and is invisible to any self-referential statistic; it is
    equally invisible to norm screens, and catching it would require
    trusted reference data the server does not have (FLTrust-style).

    Only ACCEPTED arrivals update a client's direction EWMA — after the
    flip onset every rejected arrival leaves the honest baseline frozen,
    so a compromised client stays locked out rather than slowly
    normalizing its mirrored direction into its own reference. The first
    ``warmup`` accepted arrivals per client build the baseline without
    enforcement.

    Rejection is the only flag verdict: "clipping" a direction has no
    norm-screen analogue (scaling a mirrored vector keeps it mirrored).
    Zero-norm arrivals carry no direction and pass through — magnitude
    anomalies are :class:`NormScreen`'s jurisdiction, which is why the
    robustness matrix runs the two screens as alternatives, not a stack.
    Memory: one flat f32 direction per active client — the price of a
    direction statistic; the norm screen stays the O(1)-per-client
    default.
    """

    #: direction screens need the flat delta vector, not just its norm;
    #: the server's burst drain goes sequential for them (the batched
    #: Gram sweep emits only norms)
    needs_vector = True

    def __init__(self, *, alpha: float = 0.2, warmup: int = 8,
                 cos_min: float = -0.2):
        if not (0.0 < alpha <= 1.0) or warmup < 1 \
                or not (-1.0 <= cos_min <= 1.0):
            raise ValueError(f"bad cosine-screen knobs alpha={alpha} "
                             f"warmup={warmup} cos_min={cos_min}")
        self.policy = "cosine"
        self.alpha = float(alpha)
        self.warmup = int(warmup)
        self.cos_min = float(cos_min)
        self._dir: dict = {}     # client -> unit EWMA of accepted dirs
        self._nobs: dict = {}    # client -> accepted-arrival count
        self.counts = {"accept": 0, "clip": 0, "reject": 0}

    @staticmethod
    def _cosine(a: np.ndarray, b: np.ndarray) -> Optional[float]:
        """Cosine aligned on the shorter padded length (both paddings are
        zeros, so truncation is exact); None when either side has no
        direction."""
        m = min(a.shape[0], b.shape[0])
        a, b = a[:m], b[:m]
        na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
        if na <= 0.0 or nb <= 0.0:
            return None
        return float(np.dot(a, b) / (na * nb))

    def observe(self, norm: float, client_id: Hashable = None, *,
                vec: Optional[np.ndarray] = None) -> Tuple[str, float]:
        if vec is None:
            raise ValueError("CosineScreen.observe needs the flat delta "
                             "vector (vec=); the caller must honor "
                             "needs_vector")
        vec = np.asarray(vec, np.float32).ravel()
        base = self._dir.get(client_id)
        cos = None if base is None else self._cosine(vec, base)
        if (cos is not None and self._nobs.get(client_id, 0) >= self.warmup
                and cos < self.cos_min):
            self.counts["reject"] += 1
            return "reject", 0.0
        self.counts["accept"] += 1
        n = float(np.linalg.norm(vec))
        if n > 0.0:
            u = vec / n
            if base is None:
                new = u
            else:
                m = min(u.shape[0], base.shape[0])
                new = (1.0 - self.alpha) * base[:m] + self.alpha * u[:m]
                nn = float(np.linalg.norm(new))
                if nn > 0.0:
                    new = new / nn
            self._dir[client_id] = new
            self._nobs[client_id] = self._nobs.get(client_id, 0) + 1
        return "accept", 1.0

    def stats(self) -> dict:
        out = dict(self.counts)
        out["policy"] = self.policy
        out["threshold"] = self.cos_min
        out["clients"] = len(self._dir)
        return out


def make_screen(fed: FedConfig, *,
                store: Optional[MutableMapping] = None):
    """Build the screen a server should run under ``fed`` — None when
    screening is off (the default), so defense-off runs carry zero extra
    state and replay existing traces byte-identically. ``store`` injects
    an external per-client baseline map (population mode; norm screens
    only — the cosine screen's baselines are scalars keyed per client and
    stay dict-backed)."""
    if fed.screen == "off":
        return None
    if fed.screen not in SCREEN_POLICIES:
        raise ValueError(f"unknown screen policy {fed.screen!r}: expected "
                         f"one of {SCREEN_POLICIES}")
    if fed.screen == "cosine":
        return CosineScreen(alpha=fed.screen_alpha,
                            warmup=fed.screen_warmup)
    return NormScreen(fed.screen, k=fed.screen_k, alpha=fed.screen_alpha,
                      warmup=fed.screen_warmup, store=store)


def verdict_of_scale(scale: float) -> str:
    """Invert a decide_batch scale factor back to its verdict string."""
    if scale == 0.0:
        return "reject"
    return "accept" if scale >= 1.0 else "clip"
