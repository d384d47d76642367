"""Federated training from the command line or from Python.

Two modes, one runtime (the task substrate, ``repro_torch.core.tasks``):

* ``paper`` — the paper's reproduction: the discrete-event simulation of
  Synthetic-1-1 / FEMNIST / Shakespeare with any aggregator;
* ``arch`` — one of the assigned architectures behind an ``ArchTask``, at
  the reduced scale, through the same ``FederatedSimulation``: the event
  runtime, the behavior models, the cohort engine planned against the
  memory budget, the auto drain window, ``server.finalize()`` and the
  ``SimResult`` telemetry all apply.

The port of the JAX package's ``launch/train.py``, with the same keywords
and output keys, plus ``device`` (CUDA unless the caller asks for the CPU).

Usage:
  python -m repro_torch.launch.train --mode paper --task synthetic-1-1 \\
      --algorithm asyncfeded --max-time 60
  python -m repro_torch.launch.train --mode arch --arch mamba2-1.3b \\
      --steps 20 --engine cohort --memory-budget-mb 256 [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from repro_torch import configs
from repro_torch.configs.base import CLIENT_ENGINES
from repro_torch.core import tasks
from repro_torch.core.simulator import FederatedSimulation


def run_paper(task_name: str, algorithm: str, max_time: float, seed: int,
              suspension_prob: float, *, device=None) -> dict:
    task = configs.PAPER_TASKS[task_name]
    fed = dataclasses.replace(task.fed, suspension_prob=suspension_prob)
    sim = FederatedSimulation(task, fed, algorithm=algorithm, seed=seed,
                              device=device)
    res = sim.run(max_time=max_time)
    out = {
        "task": task_name, "algorithm": algorithm, "seed": seed,
        "updates": res.total_updates,
        "final_accuracy": res.points[-1].accuracy,
        "max_accuracy": res.max_accuracy(),
        "curve": [(p.time, p.iteration, p.accuracy) for p in res.points],
    }
    print(f"[train:paper] {task_name} {algorithm}: "
          f"{res.total_updates} updates, "
          f"final acc {res.points[-1].accuracy:.4f}")
    return out


def run_arch_federated(arch: str, steps: int = 20, num_clients: int = 4,
                       k_local: int = 2, seed: int = 0,
                       use_pallas_agg: bool = False, *,
                       algorithm: str = "asyncfeded",
                       client_engine: str = "cohort",
                       batch_window="auto",
                       behavior: str = "paper",
                       memory_budget_mb: float = 0.0,
                       seq_len: int = 64, global_batch: int = 4,
                       num_layers: int = 2, d_model: int = 256,
                       eval_every: int = 5, device=None) -> dict:
    """Reduced-scale federated pretraining of an assigned architecture: a
    thin wrapper over :class:`FederatedSimulation` on an ``ArchTask``.

    Every client runs ``models.model.forward`` train steps on its own token
    stream; arrivals come from the behavior model; cohort fan-outs are
    planned against ``memory_budget_mb``; the drain window autotunes
    (``batch_window="auto"``); ``server.finalize()`` fires at the end of
    the run. ``steps`` bounds the number of aggregated updates.
    ``use_pallas_agg`` routes aggregation through the flat-state server
    (``backend="pallas"``), whose sweeps on CUDA are the fedagg kernels.
    """
    task = tasks.arch_task(arch, seq_len=seq_len, global_batch=global_batch,
                           num_layers=num_layers, d_model=d_model)
    fed = dataclasses.replace(
        task.fed, num_clients=num_clients, k_initial=k_local,
        client_engine=client_engine, batch_window=batch_window,
        memory_budget_mb=memory_budget_mb,
        backend="pallas" if use_pallas_agg else "pytree")
    sim = FederatedSimulation(task, fed, algorithm=algorithm, seed=seed,
                              behavior=behavior, device=device)
    t0 = time.time()
    res = sim.run(max_time=float("inf"), eval_every=eval_every,
                  max_updates=steps)
    wall = time.time() - t0
    for rec in res.history[:: max(1, len(res.history) // 8)]:
        print(f"[train:arch] iter {rec.iteration:3d} client "
              f"{rec.client_id} gamma {rec.gamma:.3f} eta {rec.eta:.3f} "
              f"K_next {rec.k_next}")
    losses = [p.loss for p in res.points]
    out = {"arch": arch, "algorithm": algorithm, "losses": losses,
           "wall_s": wall, "first_loss": losses[0], "last_loss": losses[-1],
           "updates": res.total_updates, "drains": res.total_drains,
           "summary": res.summary(),
           "history": [dataclasses.asdict(h) for h in res.history]}
    if res.plan is not None:
        out["plan"] = res.plan
    print(f"[train:arch] {arch} {algorithm}: {res.total_updates} updates "
          f"in {res.total_drains} drains, eval loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} ({wall:.1f}s wall)")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["paper", "arch"], default="paper")
    ap.add_argument("--task", default="synthetic-1-1")
    ap.add_argument("--algorithm", default="asyncfeded")
    ap.add_argument("--max-time", type=float, default=60.0)
    ap.add_argument("--suspension-prob", type=float, default=0.1)
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--k-local", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pallas-agg", action="store_true",
                    help="aggregate through the flat-state server "
                         "(the fedagg kernels on CUDA)")
    ap.add_argument("--engine", default="cohort", choices=list(CLIENT_ENGINES))
    ap.add_argument("--behavior", default="paper")
    ap.add_argument("--window", default="auto",
                    help="drain window: a float or 'auto'")
    ap.add_argument("--memory-budget-mb", type=float, default=0.0,
                    help="per-dispatch cohort budget (0 = unlimited)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.mode == "paper":
        out = run_paper(args.task, args.algorithm, args.max_time, args.seed,
                        args.suspension_prob, device=args.device)
    else:
        window = (args.window if args.window == "auto"
                  else float(args.window))
        out = run_arch_federated(args.arch, args.steps, args.clients,
                                 args.k_local, args.seed, args.pallas_agg,
                                 algorithm=args.algorithm,
                                 client_engine=args.engine,
                                 behavior=args.behavior,
                                 batch_window=window,
                                 memory_budget_mb=args.memory_budget_mb,
                                 device=args.device)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
