#!/usr/bin/env python3
"""Run one cell of the port's benchmark once with the port's own recorder on
(``repro_torch.utils.tracing``).

    python3 perfbench/program_run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

From the root of a checkout, on the machine with the chip. The run is
``perfbench/run.py``'s, with the recorder on:

* ``--trace 1``: from the device trace's start to its stop, the window's
  spans mapped onto the device trace (:mod:`perfbench.program_trace`). The
  result line adds the per-layer numbers of :data:`program_trace.METRICS`
  that the cell's runner reads, and ``program`` (per span name: count,
  host s, device s and device events of the work it queued, device-idle
  s inside its host spans; the window's idle by innermost program span;
  the counters). The notes compare ``client.steps`` with the
  harness's window steps, and the run's ``gmis.clamps`` with the judge's.
* ``--trace 0``: from the run's start to its end, so that the end-to-end
  metrics carry what the recorder costs when it is on.
"""
from __future__ import annotations

import argparse
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import bench, guard, program_trace, trace  # noqa: E402


class _RecordingTrace(trace.DeviceTrace):
    """The device trace, with the program's recorder on from its start to
    its stop (the counters of the run before it are kept in ``before``)."""

    last = None

    def __init__(self, device):
        super().__init__(device)
        self.before = self.recording = self.launched = None
        self.started_at = self.stopped_at = self.clock_ns = None

    def start(self) -> None:
        from repro_torch.utils import tracing
        super().start()
        self.before = tracing.collect()
        tracing.enable()
        self.started_at = time.perf_counter()
        # the profiler's clock less the host's, where no marker says so
        self.clock_ns = time.time_ns() - time.perf_counter_ns()

    def stop(self):
        from repro_torch.utils import tracing
        self.stopped_at = time.perf_counter()
        self.recording = tracing.collect()
        events = super().stop()
        self.launched = program_trace.launched(self.prof, self.cuda)
        _RecordingTrace.last = self
        return events


def _counter(rec, name: str) -> int:
    return 0 if rec is None else rec.counters.get(name, 0)


def run(cell: bench.Cell, seed: int, seconds: float, traced: bool,
        device: str, t_process: float):
    """One run of ``cell`` with the recorder on. Returns (result, notes)."""
    from repro_torch.utils import tracing
    runner = cell.traffic["runner"]
    drv = bench.runner(runner)
    saved = trace.DeviceTrace
    trace.DeviceTrace = _RecordingTrace
    _RecordingTrace.last = None
    tracing.enable()
    try:
        out = drv.run(cell, seed, seconds, traced, device, t_process)
    finally:
        trace.DeviceTrace = saved
        rest = tracing.collect()
    res = bench.result(cell, out, traced)
    notes = list(out.notes)
    if traced:
        dt, ctx = _RecordingTrace.last, out.ctx
        rec, events = dt.recording, dt.launched
        off = program_trace.host_offset_ns(events, dt.marker_host)
        if off is None:
            off = dt.clock_ns
        t0 = getattr(ctx, "t0", dt.started_at)
        t1 = getattr(ctx, "t1", dt.stopped_at)
        ctx.program = program_trace.summarize(rec, events, t0, t1, off)
        for name, (unit, read, of) in program_trace.METRICS.items():
            value = read(ctx) if of == runner else None
            if value is not None:
                res["metrics"][name] = {"value": value, "unit": unit}
        idle = sorted(ctx.program.idle.items(), key=lambda kv: -kv[1])
        res["program"] = {"spans": ctx.program.table(), "idle": dict(idle),
                          "counters": ctx.program.counters}
        notes.append("info: idle by innermost program span: " + ", ".join(
            f"{k} {v:.6f} s" for k, v in idle[:8]))
        if hasattr(ctx, "steps"):
            notes.append(f"info: client.steps "
                         f"{_counter(rec, 'client.steps')}, the harness's "
                         f"window steps {ctx.steps}")
        clamps = sum(_counter(r, "gmis.clamps")
                     for r in (dt.before, rec, rest))
        lookups = sum(_counter(r, "gmis.lookups")
                      for r in (dt.before, rec, rest))
        judged = re.search(r"ring clamps (\d+)", " ".join(out.notes))
        notes.append(f"info: gmis.clamps {clamps} of gmis.lookups {lookups}"
                     + ("" if judged is None
                        else f", the judge's ring clamps {judged.group(1)}"))
    res["checks"] = res.pop("checks")
    return res, notes


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
        print("program_run: CUDA is not available", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"program_run: {args.workload} needs {cell.chips} devices",
              file=sys.stderr)
        return 3
    res, notes = run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                     t_process)
    found = guard.loaded()
    if found:
        print(f"program_run: the process holds {', '.join(found)}",
              file=sys.stderr)
        return 4
    bench.emit(res, notes)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
