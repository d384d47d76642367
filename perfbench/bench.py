"""Plumbing of the harness: cells found by name, per-layer readers loaded
by name, the set-up clock, and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Its files are
found by name alone: ``perfbench/configs/<config>.json``,
``perfbench/traffic/<traffic>.json`` (whose ``runner`` names a module of
``perfbench/runners``), ``perfbench/limits/<cell>.json`` (the limits of
the numbers that decide ``correct``) and, for each per-layer metric,
``perfbench/metrics/<metric>.py`` with a function ``read(ctx)``.

A model configuration enters from new files alone. Its file
(``perfbench/configs/<config>.json``) names the port's registered
architecture (``port_arch``), whose fields its keys replace (a section
such as ``ssm`` or ``moe`` replaces the sub-configuration's keys), and
its ``reference``, which names two modules:

* ``perfbench/reference/<reference>.py``: ``forward(params, tokens, cfg,
  prec)``, the plain model; ``leaf_specs(cfg)``, every leaf in the port's
  tree layout (built from :mod:`perfbench.weights`' parts); ``TINY``, a
  configuration the benchmark's tests run on the CPU;
* ``perfbench/work/<reference>.py``: ``forward_flops(cfg, rows, seq)``
  (built from :mod:`perfbench.work.flops`' parts).

A model that routes tokens to experts (its file has a ``moe`` section)
chooses them, on the port's side, through
``repro_torch.models.moe.top_k(scores, k)``, once per routed layer and
forward: :mod:`perfbench.tap` records the scores and indices of each call
through set-up. Its reference module's ``forward`` takes a keyword
``route`` and, in each routed layer, calls ``route(scores, k)`` with its
own scores ``(..., E)``, in the order of its forward; the callback
(:class:`perfbench.reference.route.Follow`) returns the indices the
program chose for the same forward and layer, and the routing weights are
gathered from the reference's own scores at them. The cell's limits file
lists ``route_gap`` and ``route_errors``: without them the cell is
refused.

With its traffic file, if new, its cells' limit files, its metrics' readers
and its entries in ``BENCHMARK.json``, that is all it brings.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _for_cell(metric: dict, cell: str, reported=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = _read_json(root / "BENCHMARK.json")
    work = [w for w in bench["workloads"] if w["name"] == name]
    if not work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    e2e = [m for m in bench["end_to_end"] if _for_cell(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _for_cell(m, name, names)]
    pb = root / "perfbench"
    return Cell(name, _read_json(root / conf["file"]),
                _read_json(pb / "traffic" / f"{w['traffic']}.json"),
                _read_json(pb / "limits" / f"{name}.json"), w["chips"],
                e2e, per_layer)


def runner(name: str):
    return importlib.import_module(f"perfbench.runners.{name}")


def reader(metric: str, root: Path = ROOT) -> Callable[[Any], Optional[float]]:
    """``read`` of ``perfbench/metrics/<metric>.py``."""
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def process_start() -> float:
    """The ``time.time()`` at which this process started (Linux), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


@dataclasses.dataclass
class Outcome:
    """What a runner hands back from one run."""
    attempted: int
    failed: int
    #: end-to-end metric name -> value (the untraced run)
    end_to_end: Dict[str, float]
    #: number compared -> (value, limit); ``correct`` is every value at or
    #: under its limit
    checks: Dict[str, tuple]
    device: dict
    #: the traced run's context for the per-layer readers, else None
    ctx: Any = None
    breakdown: Optional[dict] = None
    notes: List[str] = dataclasses.field(default_factory=list)


def correct(checks: Dict[str, tuple]) -> bool:
    return all(v == v and v <= lim for v, lim in checks.values())


def result(cell: Cell, out: Outcome, trace: bool) -> dict:
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = reader(m["name"])(out.ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    res = {"correct": correct(out.checks), "attempted": out.attempted,
           "failed": out.failed, "metrics": metrics, "device": out.device}
    if trace and out.breakdown is not None:
        res["breakdown"] = out.breakdown
    res["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in out.checks.items()}
    return res


def emit(res: dict, notes: List[str]) -> None:
    """Notes, then each compared number beside its limit as the last lines
    of standard error; the result as the last line of standard output."""
    for line in notes:
        print(line, file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
