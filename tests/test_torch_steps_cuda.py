"""The step programs (``repro_torch.launch.steps``) on the card, at the
reduced size (f32). Every test needs a CUDA card and skips without one; the
file imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_steps_cuda.py

* A train step with ``remat`` on and off gives the same loss, params and
  optimizer state to the bit (the checkpointed groups recompute the same
  kernels and GEMMs), and remat launches the SSD scan twice per layer.
* A serve step against a 2048-slot ring at batch 128 launches
  ``swa_decode_attention`` once per attention layer.
* FlopCounterMode's count of a card step, plus the count of each launched
  kernel's plain version at its launch's shapes (FlopCounterMode cannot
  see a hand-written kernel), equals the meta trace's count of the same
  step (``launch/dryrun.py``), which traces the plain versions.
"""
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.kernels.rglru import rglru
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ssd
from repro_torch.kernels.swa_attn import swa_attn
from repro_torch.launch import dryrun, mesh as meshes, steps
from repro_torch.models import model as M
from repro_torch.models.ssm import ssd_dims
from repro_torch.utils import pytree as pt

requires_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                   reason="needs a CUDA card")

B, S = 2, 256


def _reduced(arch, layers=3, **kw):
    cfg = dataclasses.replace(configs.reduced(configs.get_arch(arch)),
                              num_layers=layers, dtype="float32", **kw)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl="dense"))
    return cfg


def _batch(cfg, seed, device):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                         dtype=torch.int32)
    labels = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                           dtype=torch.int32)
    return {"tokens": toks.to(device), "labels": labels.to(device)}


def _params(cfg, device):
    return pt.tree_map(lambda t: t.to(device),
                       M.init_model(torch.Generator().manual_seed(0), cfg))


def ssd_plain_flops(cfg, batch: int, seq: int) -> int:
    """FlopCounterMode's count of the SSD scan's plain version at one
    launch's shapes in ``cfg``'s SSD layer, traced on meta tensors."""
    _, h, p, n = ssd_dims(cfg)
    g = cfg.ssm.ngroups
    meta = lambda *shape: torch.empty(shape, device="meta")
    chunk = ssd.chunk_of(cfg.ssm.chunk_size, seq)
    with FlopCounterMode(display=False) as fc:
        ssd_ops.ssd_rows_plain(meta(batch, seq, h, p), meta(batch, seq, h),
                               meta(batch * h), meta(batch, seq, g, n),
                               meta(batch, seq, g, n), chunk)
    return fc.get_total_flops()


def swa_plain_flops(cfg, batch: int, slots: int) -> int:
    meta = lambda *shape: torch.empty(shape, device="meta")
    with FlopCounterMode(display=False) as fc:
        swa_attn.swa_decode_plain(
            meta(batch, cfg.num_heads, cfg.head_dim),
            meta(batch, slots, cfg.num_kv_heads, cfg.head_dim),
            meta(batch, slots, cfg.num_kv_heads, cfg.head_dim),
            torch.empty((batch,), dtype=torch.int32, device="meta"))
    return fc.get_total_flops()


@requires_cuda
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_remat_equals_no_remat_bitwise(arch):
    cfg = _reduced(arch)
    dev = torch.device("cuda")
    params, batch = _params(cfg, dev), _batch(cfg, 1, dev)
    outs, launches = [], []
    for remat in (True, False):
        opt = steps.default_optimizer()
        ssd.ssd_scan.launches = rglru.rglru_scan.launches = 0
        outs.append(steps.make_train_step(cfg, opt, remat=remat)(
            params, opt.init(params), batch))
        torch.cuda.synchronize()
        launches.append(ssd.ssd_scan.launches + rglru.rglru_scan.launches)
    (p1, s1, m1), (p2, s2, m2) = outs
    assert torch.equal(m1["loss"], m2["loss"])
    for x, y in zip(pt.tree_leaves((p1, s1)), pt.tree_leaves((p2, s2))):
        assert torch.equal(x, y)
    scans = sum(k in ("ssd", "rglru") for k in cfg.layer_kinds)
    # the tail layers are not checkpointed: grouped scans run twice
    pat, n_groups, tail = M._grouping(cfg)
    grouped = n_groups * sum(k in ("ssd", "rglru") for k in pat)
    assert launches == [scans + grouped, scans]


@requires_cuda
def test_serve_step_at_a_2048_slot_ring_batch_128():
    cfg = _reduced("recurrentgemma-2b", layers=6, sliding_window=2048)
    shape = configs.ShapeConfig("decode_32k", 32768, 128, "decode")
    dev = torch.device("cuda")
    params = _params(cfg, dev)
    window = steps.decode_window(cfg, shape)
    assert window == 2048
    g = torch.Generator(device=dev).manual_seed(3)
    cache = pt.tree_map(
        lambda s: (0.5 * torch.randn(s.shape, generator=g, device=dev)
                   ).to(s.dtype),
        M.cache_specs(cfg, 128, shape.seq_len, window))
    toks = torch.randint(0, cfg.vocab_size, (128, 1), device=dev,
                         dtype=torch.int32)
    swa_attn.swa_decode_attention.launches = 0
    tok, new = steps.make_serve_step(cfg, shape)(params, cache, toks,
                                                 shape.seq_len - 1)
    torch.cuda.synchronize()
    n_attn = sum(k == "attn" for k in cfg.layer_kinds)
    assert swa_attn.swa_decode_attention.launches == n_attn == 2
    assert tok.shape == (128, 1) and tok.dtype == torch.int32
    cpu_tok, _ = steps.make_serve_step(cfg, shape)(
        pt.tree_map(lambda t: t.cpu(), params),
        pt.tree_map(lambda t: t.cpu(), cache), toks.cpu(), shape.seq_len - 1)
    assert (cpu_tok == tok.cpu()).float().mean() > 0.95


@requires_cuda
@pytest.mark.parametrize("arch,kind", [("mamba2-1.3b", "train"),
                                       ("h2o-danube-1.8b", "train"),
                                       ("recurrentgemma-2b", "decode")])
def test_card_flops_plus_kernels_equal_the_meta_trace(arch, kind, tmp_path):
    cfg = _reduced(arch)
    dev = torch.device("cuda")
    mesh = meshes.make_host_mesh(device="cpu")
    if kind == "train":
        shape = configs.ShapeConfig("train_4k", S, B, "train")
    else:
        shape = configs.ShapeConfig("decode_32k", 512, B, "decode")
    rec = dryrun.run_one(arch, shape.name, False, out_dir=str(tmp_path),
                         cfg_override=cfg, shape_override=shape, mesh=mesh,
                         verbose=False)
    assert rec["ok"], rec.get("traceback")
    params = _params(cfg, dev)
    ssd.ssd_scan.launches = swa_attn.swa_decode_attention.launches = 0
    with FlopCounterMode(display=False) as fc:
        if kind == "train":
            opt = steps.default_optimizer()
            steps.make_train_step(cfg, opt)(params, opt.init(params),
                                            _batch(cfg, 2, dev))
        else:
            window = steps.decode_window(cfg, shape)
            cache = pt.tree_map(
                lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                M.cache_specs(cfg, B, shape.seq_len, window))
            steps.make_serve_step(cfg, shape)(
                params, cache, torch.zeros((B, 1), dtype=torch.int32,
                                           device=dev), shape.seq_len - 1)
    torch.cuda.synchronize()
    kernels = 0
    if ssd.ssd_scan.launches:
        kernels += ssd.ssd_scan.launches * ssd_plain_flops(cfg, B, S)
    if swa_attn.swa_decode_attention.launches:
        kernels += swa_attn.swa_decode_attention.launches * swa_plain_flops(
            cfg, B, min(steps.decode_window(cfg, shape) or shape.seq_len,
                        shape.seq_len))
    if arch == "h2o-danube-1.8b":
        assert kernels == 0
    else:
        assert kernels > 0
    assert fc.get_total_flops() + kernels == rec["traced_flops_global"]
