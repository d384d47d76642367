#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the machine it is started on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. It prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` (with ``--trace 1`` also ``busy_s`` and
``window_s``), with ``--trace 1`` a ``breakdown``, and last ``checks``: each
number that decides ``correct`` with its limit, which also close standard
error. It exits non-zero and prints no result when CUDA is missing or has
fewer devices than the cell asks for, when a file of the cell is missing,
or when the process holds JAX or the JAX package ``repro`` after the run.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import bench, guard  # noqa: E402


def main(argv) -> int:
    t_process = bench.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = bench.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("perfbench: CUDA is not available", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    drv = bench.runner(cell.traffic["runner"])
    out = drv.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                  t_process)
    res = bench.result(cell, out, bool(args.trace))
    found = guard.loaded()
    if found:
        print(f"perfbench: the process holds {', '.join(found)}",
              file=sys.stderr)
        return 4
    bench.emit(res, out.notes)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
