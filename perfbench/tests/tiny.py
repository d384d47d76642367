"""Cells of the benchmark cut to a size the CPU runs in a second: every
width small, the shapes' relations kept (two SSD chunks a sequence, grouped
heads, a window shorter than the sequence). Each reference module brings
its model's tiny configuration as ``TINY``."""
from __future__ import annotations

import copy
import importlib
import json
import pkgutil

from perfbench import bench, reference
from perfbench.reference import danube, mamba2


def _tiny_configs() -> list:
    """``TINY`` of every module of ``perfbench/reference`` that has one."""
    mods = [importlib.import_module(f"perfbench.reference.{m.name}")
            for m in pkgutil.iter_modules(reference.__path__)]
    return [m.TINY for m in mods if hasattr(m, "TINY")]


#: every model's tiny configuration, found by file
CONFIGS = _tiny_configs()
MAMBA2 = mamba2.TINY
DANUBE = danube.TINY
TRAIN_LIMITS = {"eval_loss_gap": 1e-4, "grad1_gap": 1e-4, "delta_gap": 1e-4,
                "change_gap": 1e-4, "rule_gap": 1e-4, "trace_errors": 0,
                "nonfinite_updates": 0}
AGG_LIMITS = {"rule_gap": 1e-4, "model_gap": 1e-4, "trace_errors": 0}


def _traffic(name: str) -> dict:
    with open(bench.ROOT / "perfbench" / "traffic" / f"{name}.json") as f:
        return json.load(f)


def fedtrain_cell(cfg: dict = MAMBA2) -> bench.Cell:
    tr = _traffic("fedtrain-4clients")
    tr.update(rows=2, seq_len=16, q_chunk=8, kv_chunk=8)
    return bench.Cell("tiny-fedtrain", copy.deepcopy(cfg), tr,
                      dict(TRAIN_LIMITS), 1, [], [])


def agg_cell() -> bench.Cell:
    tr = _traffic("uploads-burst32")
    tr["fed"]["gmis_depth"] = 4
    # enough drains in set-up that the f32 rounding of the stored models
    # is a small share of the model's change, however short the window
    tr["warmup_drains"] = 60
    return bench.Cell("tiny-agg", copy.deepcopy(MAMBA2), tr,
                      dict(AGG_LIMITS), 1, [], [])
