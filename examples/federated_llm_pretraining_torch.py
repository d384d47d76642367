"""End-to-end example on the PyTorch port: federated pretraining of an
assigned architecture.

Each simulated client runs real ``forward`` train steps on its own token
stream; the server aggregates pseudo-gradients with AsyncFedED over the
full parameter tree, at the reduced scale (same model family, 2 layers,
d_model 256), through the discrete-event runtime of the paper tasks:
pluggable client behavior, the cohort engine planned against a memory
budget, the auto drain window and the end-of-run ``finalize()``. The twin
of ``examples/federated_llm_pretraining.py`` with ``repro_torch``; it runs
on the CUDA card, ``--device cpu`` on the CPU.

Shows: per-update staleness gamma, the adaptive global lr eta, the K
controller, and the eval loss dropping.

Run:  PYTHONPATH=src python examples/federated_llm_pretraining_torch.py \\
          [--arch mamba2-1.3b] [--steps 30] [--engine cohort] \\
          [--memory-budget-mb 256] [--device cpu]
"""
import argparse

from repro_torch.launch.train import run_arch_federated

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="h2o-danube-1.8b")
ap.add_argument("--steps", type=int, default=30)
ap.add_argument("--clients", type=int, default=4)
ap.add_argument("--engine", default="cohort",
                choices=["loop", "cohort", "cohort_sharded"])
ap.add_argument("--memory-budget-mb", type=float, default=0.0,
                help="per-dispatch cohort budget in MiB (0 = unlimited); "
                     "the chosen plan is reported below")
ap.add_argument("--pallas-agg", action="store_true",
                help="aggregate through the flat-state server (the fedagg "
                     "kernels on CUDA)")
ap.add_argument("--device", default=None,
                help="torch device (default: cuda, which must be present)")
args = ap.parse_args()

out = run_arch_federated(args.arch, steps=args.steps,
                         num_clients=args.clients, k_local=2, seed=0,
                         use_pallas_agg=args.pallas_agg,
                         client_engine=args.engine,
                         memory_budget_mb=args.memory_budget_mb,
                         device=args.device)
print(f"\neval loss: {out['first_loss']:.4f} -> {out['last_loss']:.4f} "
      f"over {out['updates']} aggregations in {out['drains']} drains "
      f"({out['wall_s']:.1f}s wall)")
ks = [h["k_next"] for h in out["history"]]
print(f"adaptive K ranged over [{min(ks)}, {max(ks)}]")
if "plan" in out:
    p = out["plan"]
    print(f"memory plan: engine={p['engine']} width={p['width']} "
          f"k_chunk={p['k_chunk']} ({p['reason']})")
