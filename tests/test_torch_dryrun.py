"""The port's dry run (``repro_torch.launch.dryrun``), its cost models and
its layout rules against the JAX package's.

* ``analytic_cost`` and ``model_flops`` equal the reference's exactly over
  all ten archs x four shapes x ``attn_mode`` in {auto, scan, unrolled} on
  256 and 512 chips.
* The layouts: ``param_spec_tree`` (through ``partition_spec_tree``) under
  the ``tp``, ``dp`` and ``ep`` presets and a rule with a tuple of axes,
  ``batch_spec``, ``activation_spec`` and ``cache_spec_tree`` (both
  ``prefer`` modes, decode_32k and long_500k windows) equal the
  reference's ``PartitionSpec`` s entry for entry, for all ten archs on both
  production meshes. The reference's functions read only ``axis_names`` and
  ``devices.shape``, so they get an object with those and no devices.
* ``run_one`` on meta tensors: for reduced archs at a train, a prefill and
  a decode shape, the record is ok, its traced flops equal FlopCounterMode's
  count of the same step run on the CPU with real tensors, and its argument
  bytes on a 1 x 1 mesh equal the CPU step's inputs' bytes.
* ``run_aggregate`` (ring and displacement) on meta, and the roofline
  constants are the H100's.
"""
import dataclasses
import os
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as C
from repro.launch import analytic as JA
from repro.sharding import specs as JSH

_xla_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as JD  # noqa: E402  (sets XLA_FLAGS)
if _xla_flags is None:                 # the reference's import sets it; put
    os.environ.pop("XLA_FLAGS", None)  # it back for the rest of the worker
else:
    os.environ["XLA_FLAGS"] = _xla_flags

from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import analytic as TA  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch import mesh as TMESH  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sharding import specs as TSH  # noqa: E402
from repro_torch.utils import pytree as pt  # noqa: E402

MESHES = [(("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16))]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (small steps; the xdist
    workers share the cores). Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ref_mesh(axes, shape):
    """What the reference's layout functions read of a mesh."""
    return types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, object))


def port_mesh(axes, shape):
    return TMESH.LogicalMesh(axes, shape)


def ref_specs(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))]


@pytest.mark.parametrize("arch", C.ALL_ARCH_IDS)
def test_analytic_cost_and_model_flops_exact(arch):
    jcfg, tcfg = C.get_arch(arch), TC.get_arch(arch)
    for jshape, tshape in zip(C.ALL_SHAPES, TC.ALL_SHAPES):
        assert TD.model_flops(tcfg, tshape) == JD.model_flops(jcfg, jshape)
        for mode in ("auto", "scan", "unrolled"):
            for chips in (256, 512):
                assert TA.analytic_cost(tcfg, tshape, chips, mode) == \
                    JA.analytic_cost(jcfg, jshape, chips, mode)


def test_production_meshes():
    """The reference's axis names and shapes, no devices."""
    one, two = (TMESH.make_production_mesh(),
                TMESH.make_production_mesh(multi_pod=True))
    assert (one.axis_names, one.shape, one.size) == (("data", "model"),
                                                     (16, 16), 256)
    assert (two.axis_names, two.shape, two.size) == (
        ("pod", "data", "model"), (2, 16, 16), 512)
    host = TMESH.make_host_mesh(device="cpu")
    assert (host.axis_names, host.shape) == (("data", "model"), (1, 1))
    with pytest.raises(ValueError):
        TMESH.make_host_mesh((2, 1), device="cpu")


def test_roofline_constants_are_the_h100s():
    assert TMESH.PEAK_FLOPS_BF16 == 989e12
    assert TMESH.PEAK_FLOPS_F32 == 67e12
    assert TMESH.HBM_BW == 3.35e12
    assert not hasattr(TMESH, "ICI_BW")
    src = Path(TMESH.__file__).resolve().parents[1]
    for path in src.rglob("*.py"):
        text = path.read_text()
        for tpu in ("v5e", "197e12", "819e9", "TPU v5"):
            assert tpu not in text, f"{path}: {tpu}"


RULESETS = ["tp", "dp", "ep", "tuple"]


def rules_for(preset, mod, mesh):
    if preset == "tp":
        return None
    if preset == "tuple":
        return {"vocab": "model", "heads": "model", "kv_heads": "model",
                "mlp": "model", "expert": ("model",),
                "embed": ("pod", "data")}
    return mod.preset_rules(preset, mesh)


@pytest.mark.parametrize("arch", C.ALL_ARCH_IDS)
def test_param_specs_equal_the_references(arch):
    jcfg, tcfg = C.get_arch(arch), TC.get_arch(arch)
    for axes, shape in MESHES:
        jm, tm = ref_mesh(axes, shape), port_mesh(axes, shape)
        for preset in RULESETS:
            want = ref_specs(JSH.param_spec_tree(
                jcfg, jm, rules_for(preset, JSH, jm)))
            got_tree = TSH.param_spec_tree(tcfg, tm,
                                           rules_for(preset, TSH, tm))
            _, treedef = pt.tree_flatten(TM.model_defs(tcfg))
            assert pt.leaves_up_to(treedef, got_tree) == want, (preset, axes)
        if preset in ("dp", "ep"):
            assert TSH.preset_rules(preset, tm) == JSH.preset_rules(preset,
                                                                    jm)
    assert TSH.DEFAULT_RULES == JSH.DEFAULT_RULES


@pytest.mark.parametrize("axes,shape", MESHES)
def test_batch_and_activation_specs(axes, shape):
    jm, tm = ref_mesh(axes, shape), port_mesh(axes, shape)
    for b in (1, 2, 4, 16, 32, 48, 128, 256, 512, 1024):
        for inc in (False, True):
            assert TSH.batch_spec(tm, b, inc) == tuple(
                JSH.batch_spec(jm, b, include_model=inc))
        assert TSH.activation_spec(tm, b) == tuple(
            JSH.activation_spec(jm, b))


@pytest.mark.parametrize("arch", C.ALL_ARCH_IDS)
def test_cache_specs_equal_the_references(arch):
    """decode_32k and long_500k at their decode windows, and a short
    full cache, under both ``prefer`` modes: the group dim shifted, the
    largest (or last) channel dim over ``model``."""
    jcfg, tcfg = C.get_arch(arch), TC.get_arch(arch)
    cases = [(s, s.global_batch, s.seq_len) for s in C.ALL_SHAPES
             if s.kind == "decode"] + [(C.DECODE_32K, 8, 100)]
    for axes, shape in MESHES:
        jm, tm = ref_mesh(axes, shape), port_mesh(axes, shape)
        for s, batch, slots in cases:
            window = TS.decode_window(tcfg, TC.get_shape(s.name))
            for prefer in ("largest", "last"):
                want = ref_specs(JSH.cache_spec_tree(
                    jcfg, jm, batch, slots, window, prefer=prefer))
                got = TSH.cache_spec_tree(tcfg, tm, batch, slots, window,
                                          prefer=prefer)
                _, treedef = pt.tree_flatten(
                    TM.cache_specs(tcfg, batch, slots, window))
                assert pt.leaves_up_to(treedef, got) == want


def reduced(arch, **kw):
    cfg = dataclasses.replace(TC.reduced(TC.get_arch(arch), **kw),
                              dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl="dense"))
    return cfg


def materialize(tree, seed: int, vocab: int):
    """Real CPU tensors of a meta tree: token ids below ``vocab``, floats
    from a seeded normal."""
    g = torch.Generator().manual_seed(seed)

    def leaf(t):
        if t.dtype.is_floating_point:
            return (0.5 * torch.randn(t.shape, generator=g)).to(t.dtype)
        return torch.randint(0, vocab, t.shape, generator=g, dtype=t.dtype)
    return pt.tree_map(leaf, tree)


SMALL = {"train": TC.ShapeConfig("train_4k", 64, 2, "train"),
         "prefill": TC.ShapeConfig("prefill_32k", 64, 2, "prefill"),
         "decode": TC.ShapeConfig("decode_32k", 96, 2, "decode")}
RUN_ARCHS = ["recurrentgemma-2b", "mamba2-1.3b", "qwen2-moe-a2.7b",
             "musicgen-large", "qwen2-vl-72b", "granite-34b"]


@pytest.mark.parametrize("arch", RUN_ARCHS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_run_one_traces_the_cpu_steps_flops(arch, kind, tmp_path):
    """The meta trace counts the flops the same step counts on the CPU
    with real tensors (the kernels' plain versions run in both), and on a
    1 x 1 mesh its argument bytes are the CPU inputs' bytes."""
    cfg, shape = reduced(arch), SMALL[kind]
    mesh = TMESH.make_host_mesh(device="cpu")
    rec = TD.run_one(arch, shape.name, False, out_dir=str(tmp_path),
                     cfg_override=cfg, shape_override=shape, mesh=mesh,
                     verbose=False)
    assert rec["ok"], rec.get("traceback")
    assert rec["device"] == "meta" and rec["chips"] == 1
    assert (tmp_path / f"{arch}--{shape.name}--1x1.json").exists()

    program = TD.build_program(cfg, shape, mesh)
    args = materialize(program.args, 1, cfg.vocab_size)
    if kind == "train":
        args = (materialize(TS.abstract_model_params(cfg), 2, 0),
                TS.default_optimizer().init(
                    materialize(TS.abstract_model_params(cfg), 2, 0)),
                args[2])
    with FlopCounterMode(display=False) as fc:
        program.step(*args)
    assert rec["traced_flops_global"] == fc.get_total_flops() > 0
    nbytes = sum(t.numel() * t.element_size()
                 for t in pt.tree_leaves(args))
    assert rec["memory"]["argument_bytes"] == nbytes


def test_run_one_shares_one_trace_across_meshes(tmp_path, monkeypatch):
    """``--both`` traces each program once: the second mesh's record reuses
    the first's trace through ``trace_cache`` and lays it out anew."""
    calls = []
    inner = TD.trace
    monkeypatch.setattr(TD, "trace", lambda p: calls.append(1) or inner(p))
    cfg, shape = reduced("mamba2-1.3b"), SMALL["train"]
    cache = {}
    recs = [TD.run_one("mamba2-1.3b", shape.name, mp, out_dir=str(tmp_path),
                       cfg_override=cfg, shape_override=shape, verbose=False,
                       trace_cache=cache) for mp in (False, True)]
    assert all(r["ok"] for r in recs) and len(calls) == 1
    assert [r["chips"] for r in recs] == [256, 512]
    assert recs[0]["traced_flops_global"] == recs[1]["traced_flops_global"]
    assert (recs[0]["memory"]["argument_bytes"]
            > recs[1]["memory"]["argument_bytes"])


@pytest.mark.parametrize("mode", ["ring", "displacement"])
def test_run_aggregate_on_meta(mode, tmp_path):
    rec = TD.run_aggregate("mamba2-1.3b", True, out_dir=str(tmp_path),
                           gmis_mode=mode)
    assert rec["ok"] and rec["chips"] == 512 and rec["device"] == "meta"
    params = TS.abstract_model_params(TC.get_arch("mamba2-1.3b"))
    mesh = TMESH.make_production_mesh(multi_pod=True)
    per_dev = TD.tree_bytes(params, TSH.param_spec_tree(
        TC.get_arch("mamba2-1.3b"), mesh), mesh)
    n = 3 if mode == "ring" else 2
    assert rec["memory"]["argument_bytes"] == n * per_dev + 4 * (3 - n)
    assert rec["t_memory"] == rec["analytic_bytes_per_device"] / 3.35e12
