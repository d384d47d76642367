"""Cells of the benchmark cut to a size the CPU runs in a second: every
width small, the shapes' relations kept (two SSD chunks a sequence, grouped
heads, a window shorter than the sequence)."""
from __future__ import annotations

import copy
import json

from perfbench import bench

MAMBA2 = {"name": "tiny-mamba2", "port_arch": "mamba2-1.3b",
          "reference": "mamba2", "family": "ssm", "num_layers": 2,
          "d_model": 32, "vocab_size": 96, "tie_embeddings": True,
          "norm": "rmsnorm",
          "ssm": {"state_dim": 8, "head_dim": 8, "expand": 2, "conv_width": 4,
                  "chunk_size": 8, "ngroups": 1},
          "dtype": "float32"}
DANUBE = {"name": "tiny-danube", "port_arch": "h2o-danube-1.8b",
          "reference": "danube", "family": "dense", "num_layers": 2,
          "d_model": 32, "num_heads": 4, "num_kv_heads": 2, "head_dim": 8,
          "d_ff": 48, "vocab_size": 96, "sliding_window": 12,
          "rope_theta": 10000.0, "tie_embeddings": False, "norm": "rmsnorm",
          "dtype": "float32"}
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
