"""Where a CUDA simulation and a CPU simulation of the same seed and initial
model part, drain by drain.

    PYTHONPATH=src python -m repro_torch.tools.trace_drift \\
        --scenario synthetic-burst --window auto --max-time 10

Runs the scenario (loop engine) on the card twice and on the CPU once, all
three from the card run's initial model, and prints one JSON object per
drain: its size, the relative difference between the CUDA and CPU models
before and after it, the largest relative difference between the two runs'
client deltas in it, and, for a drain of two or more arrivals, the largest
difference between the batched norms kernel's outputs and the plain
version's on the CPU from the same inputs (dist0_sq and dn_sq relative,
cross and Gram terms relative to the product of their vectors' norms). The
last line sums it up: whether the two card runs agree to the bit, and the
first record whose (iteration, client, lag, k_next) differs between card and
CPU. It needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch import configs
from repro_torch.core.simulator import FederatedSimulation
from repro_torch.kernels.fedagg import fedagg
from repro_torch.utils import pytree as pt


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _kernel_error(x, xs, d) -> float:
    """Batched norms on the card against the plain version on the CPU."""
    got = fedagg.split_batched(fedagg.norms_batched_packed(x, xs, d).cpu(),
                               d.shape[0])
    d0, dn, cross, gram = fedagg.norms_batched_plain(x.cpu(), xs.cpu(),
                                                     d.cpu())
    return max(float(((got[0] - d0).abs() / d0.clamp_min(1e-30)).max()),
               float(((got[1] - dn).abs() / dn.clamp_min(1e-30)).max()),
               float(((got[2] - cross).abs() / (d0[:, None] * dn[None])
                      .sqrt().clamp_min(1e-30)).max()),
               float(((got[3] - gram).abs() / (dn[:, None] * dn[None])
                      .sqrt().clamp_min(1e-30)).max()))


def run(task, fed, device: str, max_time: float, init=None):
    """One simulation; returns (initial model on the CPU, result, drains),
    each drain (sizes, model before, deltas, model after, kernel error)."""
    sim = FederatedSimulation(task, fed, "asyncfeded", seed=0, device=device,
                              init_params=init)
    init = pt.tree_map(lambda t: t.cpu(), sim.server.params)
    drains = []
    inner = sim.server.on_update_batch

    def drain(ups):
        before = sim.server._flat.vec.cpu()
        deltas = [pt.tree_flatten_to_vector(u.delta).cpu() for u in ups]
        err = None
        if device == "cuda" and len(ups) > 1:
            spec = sim.server._flat.spec
            err = _kernel_error(
                sim.server._flat.vec,
                torch.stack([sim.server.gmis.get(u.snapshot_iter)[0]
                             for u in ups]),
                torch.stack([spec.flatten(u.delta) for u in ups]))
        out = inner(ups)
        drains.append((len(ups), before, deltas, sim.server._flat.vec.cpu(),
                       err))
        return out

    sim.server.on_update_batch = drain
    res = sim.run(max_time=max_time, max_updates=100_000)
    return init, res, drains


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="synthetic-burst")
    ap.add_argument("--window", default="auto",
                    help='"auto" or a window in virtual seconds')
    ap.add_argument("--max-time", type=float, default=10.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_drift: needs a CUDA card")
    task = configs.SCENARIOS[args.scenario]
    window = args.window if args.window == "auto" else float(args.window)
    fed = dataclasses.replace(task.fed, client_engine="loop",
                              batch_window=window)
    init, card, card_drains = run(task, fed, "cuda", args.max_time)
    _, again, _ = run(task, fed, "cuda", args.max_time, init)
    _, cpu, cpu_drains = run(task, fed, "cpu", args.max_time, init)
    record = 0
    for i, (g, c) in enumerate(zip(card_drains, cpu_drains)):
        print(json.dumps({
            "drain": i, "B": g[0], "first_record": record,
            "model_before": _rel(g[1], c[1]),
            "deltas": max(_rel(a, b) for a, b in zip(g[2], c[2])),
            "model_after": _rel(g[3], c[3]), "kernel_vs_cpu": g[4]}))
        record += g[0]
    key = lambda h: [(r.iteration, r.client_id, r.lag, r.k_next) for r in h]
    first = next((i for i, (a, b) in enumerate(zip(key(card.history),
                                                    key(cpu.history)))
                  if a != b), None)
    print(json.dumps({
        "scenario": args.scenario, "window": args.window,
        "updates": [card.total_updates, cpu.total_updates],
        "card_runs_bitwise_equal": [r.gamma for r in card.history]
        == [r.gamma for r in again.history],
        "first_differing_record": first,
        "card": None if first is None else key(card.history)[first],
        "cpu": None if first is None else key(cpu.history)[first]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
