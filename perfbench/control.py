#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from (not run by the
benchmark's runs).

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 [--seconds s]

For each seed it prints one JSON line per variant with the numbers the
judge compares:

* ``program`` — the port, as a run of the cell judges it (the lower
  reading);
* a training cell's ``tf32`` — the control: the reference in the program's
  place with every matrix product's operands rounded to TF32, the step
  below the configuration's float32 with TF32 off (a routed model's
  control chooses its experts by itself, and the judge follows those
  choices as it follows the program's);
* a training cell's ``half_rows`` — a fault: the reference in the
  program's place training on half of each batch's rows, the mean taken
  over the rest;
* a server cell's ``bf16`` — the control: the port itself with the deltas
  in its own bf16 wire form, one step below their float32.

A training cell's variants follow the set-up's stage only (no window is
needed); a server cell's runs the cell's whole window. A fault that
leaves the model unchanged reads 1 by the leaf gaps' measure and needs no
run.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import bench, judge  # noqa: E402


def fedtrain_readings(cell: bench.Cell, seed: int, device: str):
    from perfbench.runners import fedtrain
    from perfbench.reference import federation

    p = fedtrain.execute(cell, seed, 0.0, False, device)
    cfg, tr = cell.config, cell.traffic
    checks, _ = judge.fedtrain(cfg, tr, seed, p.device, p.drains,
                               p.setup_drains, p.history, p.captured,
                               cell.limits)
    yield "program", checks
    followed = [[c for c, _, _ in d] for d in p.drains[:p.setup_drains]]
    for name, kw in (("tf32", {"prec": "tf32"}),
                     ("half_rows", {"rows": tr["rows"] // 2})):
        v = federation.follow(cfg, tr, seed, followed, p.device, **kw)
        it = iter(v.rounds)
        drains = [[(c, *next(it)) for c in d] for d in followed]
        captured = {"eval_loss": v.eval_loss, "delta": v.delta_norms,
                    "grad1": v.grad1_norms, "change": v.change_norms,
                    "routes": v.router and v.router.made}
        checks, _ = judge.fedtrain(cfg, tr, seed, p.device, drains,
                                   len(drains), v.records, captured,
                                   cell.limits)
        yield name, checks


def server_readings(cell: bench.Cell, seed: int, device: str,
                    seconds: float):
    from perfbench.runners import server_uploads
    for name, wire in (("program", "f32"), ("bf16", "bf16")):
        out = server_uploads.run(cell, seed, seconds, False, device,
                                 time.time(), wire=wire)
        yield name, out.checks


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = bench.load_cell(args.workload)
    with open(ROOT / "BENCHMARK.json") as f:
        seconds = args.seconds or json.load(f)["run_seconds"]
    for seed in (int(s) for s in args.seeds.split(",")):
        if cell.traffic["runner"] == "fedtrain":
            readings = fedtrain_readings(cell, seed, args.device)
        else:
            readings = server_readings(cell, seed, args.device, seconds)
        for name, checks in readings:
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "variant": name,
                              "numbers": {k: v for k, (v, _) in
                                          checks.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
