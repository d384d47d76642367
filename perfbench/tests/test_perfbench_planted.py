"""A configuration enters the benchmark from its own files alone: a
Mamba-2 + attention hybrid, planted here as ``perfbench.reference.<toy>``
and ``perfbench.work.<toy>`` in ``sys.modules`` only (no file of the
harness names it), gets its weight layout, its flop count, its port
configuration and a judged run of the tiny federation on the CPU."""
import sys
import time
import types

import pytest
import torch

from perfbench import bench, weights
from perfbench.reference import danube, mamba2
from perfbench.reference.ops import rmsnorm
from perfbench.runners import fedtrain
from perfbench.tests import tiny
from perfbench.work import flops

TOY = "planted_hybrid"
#: five layers of ("ssd", "attn"): two whole groups and ``tail0_ssd``
CFG = {"name": "tiny-hybrid", "port_arch": "mamba2-1.3b", "reference": TOY,
       "family": "hybrid", "block_pattern": ["ssd", "attn"], "num_layers": 5,
       "d_model": 32, "num_heads": 4, "num_kv_heads": 2, "head_dim": 8,
       "d_ff": 48, "vocab_size": 96, "sliding_window": 12,
       "rope_theta": 10000.0, "tie_embeddings": False, "norm": "rmsnorm",
       "ssm": {"state_dim": 8, "head_dim": 8, "expand": 2, "conv_width": 4,
               "chunk_size": 8, "ngroups": 2},
       "dtype": "float32"}
BLOCKS = {"ssd": (weights.ssd_specs, mamba2.block),
          "attn": (weights.attn_specs, danube.block)}


def _layers(cfg):
    """(where, kind) of each layer in order: (group, position) inside the
    stacked groups, then the tail's index."""
    pat = cfg["block_pattern"]
    groups, rest = divmod(cfg["num_layers"], len(pat))
    return ([((g, i), k) for g in range(groups) for i, k in enumerate(pat)]
            + [(j, k) for j, k in enumerate(pat[:rest])]), groups


def _leaf_specs(cfg):
    layers, groups = _layers(cfg)
    specs = weights.outer_specs(cfg)
    for where, kind in layers:
        block = BLOCKS[kind][0](cfg)
        if isinstance(where, int):
            specs += weights.tail(where, kind, block)
        elif where[0] == 0:
            specs += weights.stacked(where[1], kind, block, groups)
    return specs


def _forward(params, tokens, cfg, prec):
    x = params["embed"]["tok"][tokens.long()]
    for where, kind in _layers(cfg)[0]:
        if isinstance(where, int):
            p = params[f"tail{where}_{kind}"]
        else:
            g, i = where
            p = _index(params["layers"][f"b{i}_{kind}"], g)
        x = BLOCKS[kind][1](p, x, cfg, prec)
    return prec.mm(rmsnorm(x, params["final_norm"]["scale"]),
                   params["head"]["out"])


def _index(tree, g):
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def _forward_flops(cfg, rows, seq):
    kinds = [k for _, k in _layers(cfg)[0]]
    tokens = rows * seq
    mlp = 6 * cfg["d_model"] * cfg["d_ff"]
    attn = (flops.attn_proj(cfg) + mlp) * tokens + flops.attn_scores(
        cfg, rows, seq)
    return (kinds.count("ssd") * flops.ssd_layer(cfg, rows, seq)
            + kinds.count("attn") * attn + flops.head(cfg, tokens))


@pytest.fixture(autouse=True)
def _planted(monkeypatch):
    ref = types.ModuleType(f"perfbench.reference.{TOY}")
    ref.leaf_specs, ref.forward = _leaf_specs, _forward
    work = types.ModuleType(f"perfbench.work.{TOY}")
    work.forward_flops = _forward_flops
    monkeypatch.setitem(sys.modules, ref.__name__, ref)
    monkeypatch.setitem(sys.modules, work.__name__, work)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_no_harness_file_names_the_toy():
    here = bench.ROOT / "perfbench" / "tests" / "test_perfbench_planted.py"
    for path in (bench.ROOT / "perfbench").rglob("*"):
        if path.is_file() and path != here and path.suffix in (".py",
                                                              ".json"):
            assert TOY not in path.read_text(), path


def test_layout_is_the_ports():
    from repro_torch.models import model as M
    from repro_torch.utils import pytree as pt
    defs = M.model_defs(fedtrain.port_config(CFG))
    want = sorted(weights.leaves(defs).items())
    specs = weights.leaf_specs(CFG)
    assert [(s.path, s.shape) for s in specs] == [
        (path, tuple(d.shape)) for path, d in want]
    assert ("tail0_ssd", "ssd", "in_proj") in {s.path for s in specs}
    flat, tree = weights.draw(CFG, 3, "cpu")
    assert torch.equal(pt.tree_flatten_to_vector(tree), flat)


def test_port_config_carries_the_pattern_and_the_ssm():
    pc = fedtrain.port_config(CFG)
    assert pc.block_pattern == ("ssd", "attn")
    assert pc.layer_kinds == ("ssd", "attn", "ssd", "attn", "ssd")
    assert (pc.ssm.ngroups, pc.ssm.state_dim, pc.ssm.chunk_size) == (2, 8, 8)
    assert (pc.family, pc.num_heads, pc.tie_embeddings) == ("hybrid", 4,
                                                            False)
    assert fedtrain.has_ssd(CFG)


def test_flops_are_the_modules():
    assert flops.train_step_flops(CFG, 2, 16) == 3 * _forward_flops(
        CFG, 2, 16) > 0


def test_federation_runs_and_is_judged_correct():
    out = fedtrain.run(tiny.fedtrain_cell(CFG), 2 ** 31 + 7, 0.3, False,
                       "cpu", time.time())
    assert out.attempted > 0
    assert bench.correct(out.checks), out.checks


def test_ssd_launches_are_counted():
    """A traced run records the shape of every SSD launch of a
    configuration with an ``ssm`` section (the launch itself needs the
    card: here it refuses CPU tensors after being counted)."""
    from repro_torch.kernels.ssd import ssd
    run = types.SimpleNamespace(cfg=CFG, open=True, ssd_shapes=[])
    saved = fedtrain._ssd_launch()
    try:
        fedtrain._Run._count_ssd_launches(run)
        x = torch.zeros(2, 16, 8, 8)
        b = torch.zeros(2, 16, 2, 8)
        with pytest.raises(ValueError):
            ssd.launch(x, torch.zeros(2, 16, 8), torch.zeros(8), b, b,
                       chunk=8)
    finally:
        fedtrain._restore_ssd_launch(saved)
    assert run.ssd_shapes == [(2, 16, 8, 8, 2, 8, 8, False)]
