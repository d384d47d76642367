"""Dry run: prove that every (architecture x input shape x mesh) builds,
and say what it costs, with no device.

The JAX package's ``launch/dryrun.py`` lowers and compiles each step
program against ``ShapeDtypeStruct`` inputs on 256 or 512 forced host
devices. The port is single-controller and has no SPMD partitioner, so its
dry run is a **trace on meta tensors**: the params, the optimizer state and
the inputs are meta tensors (shapes and dtypes, no storage), and the step of
``launch/steps.py`` runs on them under ``torch.utils.flop_counter.
FlopCounterMode``. A meta tensor carries no value, so nothing is computed
and nothing is allocated on any device; the kernels' wrappers trace their
plain versions. Each record holds:

* ``traced_flops_global``: the products the trace counts (matmuls,
  einsums, convolutions; FlopCounterMode counts no elementwise op), every
  layer counted, for the whole step; XLA's numbers count a scanned layer's
  body once, so they have no counterpart here;
* ``memory``: the argument and output bytes per device, each leaf's bytes
  over its layout on the mesh (``sharding/specs.py``: the params by
  ``param_spec_tree``, the batch by ``batch_spec``, the decode cache by
  ``cache_spec_tree``), each dim rounded up;
* the analytic totals of ``launch/analytic.py`` and the roofline terms
  ``t_compute`` (analytic flops per device over the H100's peak for the
  config's dtype) and ``t_memory`` (analytic bytes over the HBM rate), and
  the larger of the two as the bottleneck.

What the reference's record has and this one does not: ``collectives`` and
``t_collective`` (parsed from XLA's partitioned HLO; a single controller
emits no collective to parse), XLA's temp and alias bytes (the card runs of
``chip_smoke.py`` measure the peak instead), and the lower and compile
seconds (``trace_s`` is the trace's wall). The HLO parsers and
``utils/xla.py`` have no twin. Nor have the reference's
``--constrain-batch`` and ``--expert-axis``: they pin GSPMD layouts, and
the port's ``forward`` and MoE layers take no layout to pin.

Artifacts go under ``artifacts/dryrun_torch/``, apart from the reference's.

Usage:
  python -m repro_torch.launch.dryrun --arch mamba2-1.3b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both
  python -m repro_torch.launch.dryrun --aggregate --all --both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.analytic import analytic_cost
from repro_torch.sharding import specs as sh
from repro_torch.utils import pytree as pt

PyTree = Any

OUT_DIR = "artifacts/dryrun_torch"


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6*N_active*D (train) / 2*N_active*D (prefill/decode)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch          # decode: one token per seq


def peak_flops(cfg: ModelConfig) -> float:
    """The H100's peak for the config's activation dtype."""
    return (mesh_lib.PEAK_FLOPS_F32 if cfg.dtype == "float32"
            else mesh_lib.PEAK_FLOPS_BF16)


def tree_bytes(tree: PyTree, specs: PyTree, mesh) -> int:
    """Per-device bytes of a tree of tensors laid out by a spec tree of
    the same structure (a spec ``()`` is replicated)."""
    leaves, treedef = pt.tree_flatten(tree)
    return sum(sh.leaf_bytes(t, spec, mesh)
               for t, spec in zip(leaves, pt.leaves_up_to(treedef, specs)))


def _batch_layout(batch: Dict[str, Any], bspec) -> Dict[str, Any]:
    """Every input's leading (batch) dim by the batch spec."""
    return {k: (bspec[0],) for k in batch}


@dataclasses.dataclass
class Program:
    """A step with its meta arguments and their layouts."""
    step: Any
    args: tuple
    arg_specs: tuple
    out_specs: Any          # callable: outputs -> spec tree


def build_program(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                  attn_mode: str = "auto", rules=None,
                  ce_impl: str = "gather", preset: str = "tp",
                  cache_shard: str = "largest") -> Program:
    """The step of ``shape.kind`` on meta arguments, laid out on ``mesh``
    as the reference's ``build_lowering`` shards them."""
    if rules is None and preset != "tp":
        rules = sh.preset_rules(preset, mesh)
    pspecs = sh.param_spec_tree(cfg, mesh, rules)
    params = steps_lib.abstract_model_params(cfg)
    bspec = sh.batch_spec(mesh, shape.global_batch,
                          include_model=(preset == "dp"))

    if shape.kind == "train":
        opt = steps_lib.default_optimizer()
        step = steps_lib.make_train_step(cfg, opt, attn_mode=attn_mode,
                                         ce_impl=ce_impl)
        batch = steps_lib.input_specs(cfg, shape)
        opt_specs = {"step": (), "m": pspecs, "v": pspecs}
        return Program(
            step, (params, opt.init(params), batch),
            (pspecs, opt_specs, _batch_layout(batch, bspec)),
            lambda out: (pspecs, opt_specs, {"loss": (), "ce": ()}))

    if shape.kind == "prefill":
        step = steps_lib.make_prefill_step(cfg, shape, attn_mode=attn_mode)
        batch = steps_lib.input_specs(cfg, shape)
        return Program(
            step, (params, batch), (pspecs, _batch_layout(batch, bspec)),
            lambda out: ((bspec[0],), sh.cache_layout(
                out[1], mesh, shape.global_batch, prefer=cache_shard)))

    ins = steps_lib.input_specs(cfg, shape)
    window = steps_lib.decode_window(cfg, shape)
    cspecs = sh.cache_spec_tree(cfg, mesh, shape.global_batch, shape.seq_len,
                                window, prefer=cache_shard)
    step = steps_lib.make_serve_step(cfg, shape)
    # the index is a Python int in the trace; its 0-d int32 stand-in is
    # what the argument bytes count, replicated
    return Program(
        lambda p, c, t, _i: step(p, c, t, shape.seq_len - 1),
        (params, ins["cache"], ins["tokens"], ins["cache_index"]),
        (pspecs, cspecs, (bspec[0],), ()),
        lambda out: ((bspec[0],), cspecs))


def trace(program: Program) -> Dict[str, Any]:
    """Run ``program`` on its meta arguments under FlopCounterMode: the
    products counted, the meta outputs and the trace's wall seconds."""
    t0 = time.time()
    with FlopCounterMode(display=False) as fc:
        out = program.step(*program.args)
    return {"flops": int(fc.get_total_flops()), "out": out,
            "trace_s": time.time() - t0}


def run_one(arch: str, shape_name: str, multi_pod: bool,
            out_dir: str = OUT_DIR, attn_mode: str = "auto",
            tag: str = "", rules=None, verbose: bool = True,
            ce_impl: str = "gather", param_dtype: str = "",
            preset: str = "tp", cache_shard: str = "largest",
            cfg_override: Optional[ModelConfig] = None,
            shape_override: Optional[ShapeConfig] = None,
            mesh: Optional[mesh_lib.LogicalMesh] = None,
            trace_cache: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One record: the step of ``shape_name`` for ``arch`` traced on meta
    tensors and laid out on the production mesh (``multi_pod``) or on
    ``mesh``. ``cfg_override`` / ``shape_override`` run a cut config or
    shape under the same names. ``trace_cache``, a dict shared by the
    calls for one program on several meshes, keeps the first call's trace
    for the others (the trace does not depend on the mesh)."""
    cfg = _config(arch, param_dtype, cfg_override)
    shape = shape_override or configs.get_shape(shape_name)
    mesh = mesh or mesh_lib.make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh.name,
        "chips": chips, "kind": shape.kind, "attn_mode": attn_mode,
        "ce_impl": ce_impl, "param_dtype": cfg.param_dtype,
        "preset": preset,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "attn_variant": _attn_variant(cfg, shape),
        "device": "meta",
    }
    t0 = time.time()
    try:
        program = build_program(cfg, shape, mesh, attn_mode=attn_mode,
                                rules=rules, ce_impl=ce_impl, preset=preset,
                                cache_shard=cache_shard)
        cache = {} if trace_cache is None else trace_cache
        if "trace" not in cache:
            cache["trace"] = trace(program)
        tr = cache["trace"]
        arg_bytes = sum(tree_bytes(a, s, mesh)
                        for a, s in zip(program.args, program.arg_specs))
        out_bytes = tree_bytes(tr["out"], program.out_specs(tr["out"]), mesh)
        mf = model_flops(cfg, shape)
        an = analytic_cost(cfg, shape, chips, attn_mode=attn_mode)
        flops_dev, bytes_dev = an["flops_per_device"], an["bytes_per_device"]
        rec.update({
            "ok": True,
            "trace_s": round(tr["trace_s"], 2),
            # every layer and every product of the step, all devices' work
            "traced_flops_global": tr["flops"],
            "traced_flops_per_device": tr["flops"] / chips,
            # analytic napkin-math totals (launch/analytic.py)
            "analytic_flops_per_device": flops_dev,
            "analytic_bytes_per_device": bytes_dev,
            "attn_context_tokens": an["attn_context_tokens"],
            "memory": {"argument_bytes": arg_bytes,
                       "output_bytes": out_bytes},
            "model_flops_global": mf,
            "model_flops_per_device": mf / chips,
            # roofline terms (seconds), H100 SXM data-sheet peaks
            "t_compute": flops_dev / peak_flops(cfg),
            "t_memory": bytes_dev / mesh_lib.HBM_BW,
            "useful_flops_ratio": mf / chips / max(flops_dev, 1.0),
        })
        terms = {"compute": rec["t_compute"], "memory": rec["t_memory"]}
        rec["bottleneck"] = max(terms, key=terms.get)
    except Exception as e:  # noqa: BLE001 — record it, keep the matrix going
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
    rec["wall_s"] = round(time.time() - t0, 2)
    _write(rec, out_dir, f"{arch}--{shape_name}--{mesh.name}"
                         + (f"--{tag}" if tag else ""))
    if verbose:
        if rec["ok"]:
            print(f"[dryrun] {arch:24s} {shape_name:12s} {mesh.name:8s} OK "
                  f"trace={rec['trace_s']:7.1f}s "
                  f"traced={rec['traced_flops_global']:.3e} "
                  f"analytic/dev={rec['analytic_flops_per_device']:.3e} "
                  f"args/dev={rec['memory']['argument_bytes']:.3e}B "
                  f"bottleneck={rec['bottleneck']}", flush=True)
        else:
            print(f"[dryrun] {arch:24s} {shape_name:12s} {mesh.name:8s} "
                  f"FAIL {rec['error']}", flush=True)
    return rec


def _attn_variant(cfg: ModelConfig, shape: ShapeConfig) -> str:
    if shape.name == "long_500k" and not cfg.sliding_window:
        return "swa-%d (long-context variant)" % cfg.long_context_window
    return "swa-%d" % cfg.sliding_window if cfg.sliding_window else "full"


def _config(arch: str, param_dtype: str = "",
            cfg_override: Optional[ModelConfig] = None) -> ModelConfig:
    cfg = cfg_override or configs.get_arch(arch)
    if param_dtype:
        cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    return cfg


def _write(rec: Dict[str, Any], out_dir: str, stem: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, stem + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def run_aggregate(arch: str, multi_pod: bool, out_dir: str = OUT_DIR,
                  gmis_mode: str = "ring") -> Dict[str, Any]:
    """The AsyncFedED aggregation step itself (Eq. 5-7) on the arch's
    params laid out on the production mesh, traced on meta tensors: ring
    (``asyncfeded_aggregate``: x_t, x_stale, delta) or displacement
    (``asyncfeded_aggregate_with_dist``: x_t, a scalar dist, delta). The
    op is elementwise and reductions, which FlopCounterMode does not count
    (``traced_flops_global`` is 0)."""
    from repro_torch.core.aggregation import (asyncfeded_aggregate,
                                              asyncfeded_aggregate_with_dist)
    cfg = configs.get_arch(arch)
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    pspecs = sh.param_spec_tree(cfg, mesh)
    params = steps_lib.abstract_model_params(cfg)
    rec: Dict[str, Any] = {"arch": arch, "mesh": mesh.name, "chips": chips,
                           "kind": "aggregate", "gmis_mode": gmis_mode,
                           "params": cfg.param_count(), "device": "meta"}
    t0 = time.time()
    try:
        if gmis_mode == "displacement":
            dist = torch.empty((), dtype=torch.float32, device="meta")
            args, specs = (params, dist, params), (pspecs, (), pspecs)
            fn = lambda x, d_, d: asyncfeded_aggregate_with_dist(
                x, d_, d, lam=1.0, eps=1.0)
        else:
            args, specs = (params, params, params), (pspecs,) * 3
            fn = lambda x, xs, d: asyncfeded_aggregate(x, xs, d, lam=1.0,
                                                       eps=1.0)
        with FlopCounterMode(display=False) as fc:
            out = fn(*args)
        arg_bytes = sum(tree_bytes(a, s, mesh) for a, s in zip(args, specs))
        out_bytes = (tree_bytes(out.params, pspecs, mesh)
                     + 4 * (len(out) - 1))
        nbytes = cfg.param_count() * 4
        # pure streaming: read x_t, x_stale (ring only), delta; write x_{t+1}
        analytic = nbytes / chips * (4 if gmis_mode == "ring" else 3)
        rec.update({
            "ok": True, "trace_s": round(time.time() - t0, 2),
            "traced_flops_global": int(fc.get_total_flops()),
            "memory": {"argument_bytes": arg_bytes,
                       "output_bytes": out_bytes},
            "analytic_bytes_per_device": analytic,
            "t_memory": analytic / mesh_lib.HBM_BW,
        })
    except Exception as e:  # noqa: BLE001
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}"})
    _write(rec, out_dir, f"{arch}--aggregate-{gmis_mode}--{mesh.name}")
    status = "OK" if rec["ok"] else f"FAIL {rec.get('error')}"
    print(f"[dryrun] {arch:24s} aggregate/{gmis_mode:12s} {mesh.name:8s} "
          f"{status}", flush=True)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true",
                    help="run single-pod AND multi-pod meshes")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape)")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--attn-mode", default="auto")
    ap.add_argument("--ce-impl", default="gather")
    ap.add_argument("--param-dtype", default="")
    ap.add_argument("--preset", default="tp", choices=["tp", "dp", "ep"])
    ap.add_argument("--cache-shard", default="largest",
                    choices=["largest", "last"])
    ap.add_argument("--aggregate", action="store_true",
                    help="trace the AsyncFedED aggregation step instead of "
                         "a model step")
    ap.add_argument("--gmis-mode", default="ring",
                    choices=["ring", "displacement"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    archs = (configs.ALL_ARCH_IDS if (args.all or not args.arch)
             else [args.arch])
    meshes = [False, True] if args.both else [args.multi_pod]
    t0 = time.time()
    n_fail = 0
    if args.aggregate:
        for mp in meshes:
            for arch in archs:
                rec = run_aggregate(arch, mp, out_dir=args.out,
                                    gmis_mode=args.gmis_mode)
                n_fail += 0 if rec["ok"] else 1
        print(f"[dryrun] done, failures: {n_fail}, wall "
              f"{time.time() - t0:.1f} s", flush=True)
        raise SystemExit(1 if n_fail else 0)

    shapes = ([s.name for s in configs.ALL_SHAPES]
              if (args.all or not args.shape) else [args.shape])
    kw = dict(attn_mode=args.attn_mode, tag=args.tag, ce_impl=args.ce_impl,
              param_dtype=args.param_dtype, preset=args.preset,
              cache_shard=args.cache_shard)
    # one trace per (arch, shape), laid out on each mesh in turn
    for arch in archs:
        for shape in shapes:
            traces: Dict[str, Any] = {}
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                suffix = f"--{args.tag}" if args.tag else ""
                path = os.path.join(
                    args.out, f"{arch}--{shape}--{mesh_name}{suffix}.json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("ok"):
                            print(f"[dryrun] skip existing {path}",
                                  flush=True)
                            continue
                rec = run_one(arch, shape, mp, out_dir=args.out,
                              trace_cache=traces, **kw)
                n_fail += 0 if rec["ok"] else 1
    print(f"[dryrun] done, failures: {n_fail}, wall {time.time() - t0:.1f} s",
          flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
