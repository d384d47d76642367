"""Quickstart on the PyTorch port: AsyncFedED in ~40 lines.

Trains the paper's Synthetic-1-1 task with 10 heterogeneous clients under
the discrete-event simulator and compares AsyncFedED against FedAvg and
FedAsync — the paper's Fig. 2 in miniature — with ``repro_torch``, the
PyTorch port. It runs on the CUDA card; ``--device cpu`` runs it on the CPU.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import os

import numpy as np

from repro_torch import configs
from repro_torch.core.simulator import FederatedSimulation

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None,
                help="torch device (default: cuda, which must be present)")
args = ap.parse_args()

# seconds of VIRTUAL time (deterministic clock); QUICKSTART_MAX_TIME
# shrinks it for a quick check
MAX_TIME = float(os.environ.get("QUICKSTART_MAX_TIME", "30"))

task = configs.SYNTHETIC_1_1
print(f"task={task.name}  clients={task.fed.num_clients}  "
      f"suspension P={task.fed.suspension_prob}\n")

results = {}
for algorithm in ("asyncfeded", "fedavg", "fedasync+constant"):
    sim = FederatedSimulation(task, task.fed, algorithm=algorithm, seed=0,
                              device=args.device)
    res = sim.run(max_time=MAX_TIME, eval_every=10)
    results[algorithm] = res
    print(f"{algorithm:20s} updates={res.total_updates:4d} "
          f"max_acc={res.max_accuracy():.4f} "
          f"t90={res.time_to_accuracy(0.9 * res.max_accuracy()):6.1f}s")

# peek at the AsyncFedED internals: staleness gamma and the adaptive K
hist = results["asyncfeded"].history
print("\nAsyncFedED internals (last 5 aggregations):")
print(f"{'iter':>6} {'client':>6} {'gamma':>8} {'eta_g':>8} {'K_next':>6}")
for r in hist[-5:]:
    print(f"{r.iteration:6d} {r.client_id:6d} {r.gamma:8.3f} "
          f"{r.eta:8.3f} {r.k_next:6d}")
gammas = [r.gamma for r in hist[len(hist) // 2:]]
print(f"\nmedian gamma (2nd half) = {np.median(gammas):.2f} "
      f"(setpoint gamma_bar = {task.fed.gamma_bar})")
