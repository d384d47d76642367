"""The four assigned input shapes, and the stacked-cohort footprint law the
memory-budget planner applies (``repro_torch.core.budget``).

The law is pure shape arithmetic — no tensors, no allocation — so the
planner can evaluate it before any model state exists. The shape, the
constants and the formulas are the JAX package's
(``repro/configs/shapes.py``), so one ``FedConfig`` plans the same fan-outs
in both packages.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import SHAPES, ShapeConfig

#: the assigned training shape; ``core.tasks.arch_task`` cuts its sequence
#: and batch to the run's
TRAIN_4K = ShapeConfig(name="train_4k", seq_len=4_096, global_batch=256,
                       kind="train")
PREFILL_32K = ShapeConfig(name="prefill_32k", seq_len=32_768,
                          global_batch=32, kind="prefill")
#: one new token against a cache of ``seq_len`` slots
DECODE_32K = ShapeConfig(name="decode_32k", seq_len=32_768,
                         global_batch=128, kind="decode")
LONG_500K = ShapeConfig(name="long_500k", seq_len=524_288, global_batch=1,
                        kind="decode")

for _s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K):
    SHAPES.register(_s.name)(_s)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)

#: Stacked per-client parameter-state copies a cohort dispatch holds live:
#: the params row, the momentum row, the delta output row, and one
#: gradient-sized temporary inside the backward pass.
PARAM_STATE_COPIES = 4

#: Elements per int8 scale block of the compressed delta transport
#: (``kernels.fedagg.fedagg.QBLOCK``).
DELTA_SCALE_BLOCK = 1024


def delta_wire_bytes(param_bytes: int, mode: str) -> int:
    """Transport bytes of ONE client delta under ``mode``
    (``FedConfig.delta_compression``): int8 carries 1 byte per element plus
    one f32 scale per ``DELTA_SCALE_BLOCK`` elements, bf16 2 bytes per
    element, "off" the f32 vector (``param_bytes``)."""
    elems = int(param_bytes) // 4
    if mode == "int8":
        return elems + 4 * (elems // DELTA_SCALE_BLOCK)
    if mode == "bf16":
        return 2 * elems
    return int(param_bytes)


def cohort_footprint_bytes(param_bytes: int, batch_bytes: int,
                           act_bytes: int, clients: int, k_steps: int,
                           delta_bytes: Optional[int] = None,
                           model_shards: int = 1) -> int:
    """Estimated device bytes of ONE stacked-cohort dispatch::

        footprint(C, K) = C * ((3 * P + D) / S + K * B + A)

    Every stacked client row carries three parameter copies (params,
    momentum, the backward temporary), its delta row at its wire size
    ``D`` (``delta_bytes``, default the f32 ``param_bytes``), its K staged
    mini-batches of ``B`` bytes and one step's activations ``A`` (steps run
    one after another, so activations do not multiply by K). ``S =
    model_shards`` divides the parameter-shaped rows only."""
    if delta_bytes is None:
        delta_bytes = int(param_bytes)
    shards = max(1, int(model_shards))
    param_state = ((PARAM_STATE_COPIES - 1) * int(param_bytes)
                   + int(delta_bytes))
    per_client = (-(-param_state // shards)        # ceil: shards round up
                  + int(k_steps) * int(batch_bytes) + int(act_bytes))
    return int(clients) * per_client


def flat_state_bytes(param_bytes: int, gmis_depth: int,
                     model_shards: int = 1) -> int:
    """Per-device bytes of the flat server's state: the padded flat vector,
    the zeros vector of the displacement sweeps and up to ``gmis_depth``
    ring-GMIS snapshots, all parameter-shaped and split over the ``model``
    axis, so each device holds ``1 / S`` of every copy::

        per_device = (2 + gmis_depth) * ceil(P / S)
    """
    shards = max(1, int(model_shards))
    per_copy = -(-int(param_bytes) // shards)
    return (2 + max(0, int(gmis_depth))) * per_copy
