"""Memory-budgeted planning of cohort fan-outs.

The cohort engine (``repro_torch.core.cohort``) holds C client rows of
parameters, momentum, deltas, K staged mini-batches and one step's
activations on the device at once. This module turns a byte budget
(``FedConfig.memory_budget_mb``) into an execution plan before any device
allocation, from the shape arithmetic of
``configs.shapes.cohort_footprint_bytes`` and the task's estimates
(``LocalTask.batch_bytes`` / ``activation_bytes``).

The ladder, applied in order until the estimate fits:

1. **full cohort** — one dispatch over the padded client bucket;
2. **clamped vmap width** — the client axis splits into power-of-two
   chunks run one after another (width >= 2);
3. **K microbatches** — each chunk's local steps split into
   ``k_chunk``-step segments, the (params, momentum) carry threaded
   through on the device (not under FedProx, whose anchor is the round's
   initial weights for all K steps);
4. **loop** — below a 2-client chunk the plan sends the fan-out to the
   per-client loop.

Every plan computes what the unconstrained dispatch computes (cutting the
width or the steps reorders no client's arithmetic), and the plans equal
the JAX package's (``repro/core/budget.py``) for the same inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import FedConfig
from repro_torch.configs.shapes import cohort_footprint_bytes, delta_wire_bytes
from repro_torch.core import tasks
from repro_torch.launch import mesh


def _bucket(n: int) -> int:
    """Next power of two >= n (``cohort.bucket_size``, without importing
    the engine)."""
    return 1 << (int(n) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class CohortPlan:
    """The execution plan one fan-out runs under."""

    engine: str          # "cohort" | "loop" (fallback)
    width: int           # max stacked clients per dispatch (pow2 bucket)
    k_chunk: int         # max local steps per segment
    est_bytes: int       # footprint of one dispatch under this plan
    full_bytes: int      # unconstrained single-dispatch footprint
    budget_bytes: int    # 0 = unlimited
    reason: str = "fits"

    @property
    def constrained(self) -> bool:
        return self.reason != "fits"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _pod_count(fed: FedConfig, clients: int, device=None) -> int:
    """Pods the sharded engine will split this fan-out over: 1 for the
    single-device engines; otherwise what the pod mesh of ``device`` (the
    fan-out's home device) yields for the padded client bucket."""
    if fed.client_engine != "cohort_sharded":
        return 1
    return max(1, mesh.pod_count(max_pods=_bucket(max(clients, 1)),
                                 device=device))


def plan_cohort(task, fed: FedConfig, *, clients: int, k: int,
                param_bytes: int, prox_mu: float = 0.0, ragged: bool = False,
                budget_bytes: Optional[int] = None,
                pods: Optional[int] = None,
                model_shards: Optional[int] = None,
                device=None) -> CohortPlan:
    """Plan one fan-out of ``clients`` clients x ``k`` local steps.

    ``ragged`` means the clients' K differ: the engine then pads the steps
    to the power-of-two bucket of ``max(ks)``, so the plan charges the
    padded staged batches. ``budget_bytes`` overrides
    ``fed.memory_budget_mb``; 0 means unlimited. ``pods`` and
    ``model_shards`` override the per-device divisors; by default the pods
    are what the ``cohort_sharded`` engine's mesh on ``device`` gives (None
    means CUDA) and the shards ``fed.model_shards``."""
    task = tasks.as_task(task)
    if budget_bytes is None:
        budget_bytes = int(fed.memory_budget_mb * 2 ** 20)
    if pods is None:
        pods = _pod_count(fed, clients, device)
    pods = max(1, int(pods))
    if model_shards is None:
        model_shards = fed.model_shards
    model_shards = max(1, int(model_shards))
    bb = task.batch_bytes(fed)
    ab = task.activation_bytes(fed)
    # a compressed delta row is charged at its wire size
    db = delta_wire_bytes(param_bytes, fed.delta_compression)

    def fp(width: int, k_chunk: int) -> int:
        per_pod = max(1, -(-int(width) // pods))     # ceil division
        return cohort_footprint_bytes(param_bytes, bb, ab, per_pod, k_chunk,
                                      delta_bytes=db,
                                      model_shards=model_shards)

    width = _bucket(max(clients, 1))
    k_chunk = max(int(k), 1)
    if ragged:
        k_chunk = _bucket(k_chunk)     # what the masked steps stage
    full = fp(width, k_chunk)
    engine = fed.client_engine
    if budget_bytes <= 0 or full <= budget_bytes:
        return CohortPlan(engine, width, k_chunk, full, full, budget_bytes)

    # at least one client row per pod, and never narrower than 2
    width_floor = max(2, pods)
    reasons = []
    while width > width_floor and fp(width, k_chunk) > budget_bytes:
        width //= 2
    if fp(width, k_chunk) <= budget_bytes:
        reasons.append(f"vmap width clamped to {width}")
    elif prox_mu > 0:
        reasons.append("K-microbatching unavailable under FedProx")
    else:
        while k_chunk > 1 and fp(width, k_chunk) > budget_bytes:
            k_chunk = max(1, k_chunk // 2)
        if fp(width, k_chunk) <= budget_bytes:
            reasons.append(f"vmap width clamped to {width}, "
                           f"K-scan split into {k_chunk}-step microbatches")
    if fp(width, k_chunk) > budget_bytes:
        engine = "loop"
        reasons.append(f"budget below a {width_floor}-client cohort chunk: "
                       "falling back to the per-client loop")
    return CohortPlan(engine, width, k_chunk, fp(width, k_chunk), full,
                      budget_bytes, reason="; ".join(reasons))
