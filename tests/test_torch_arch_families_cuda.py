"""The seven architectures of the last architecture slice on the card
against the same on the CPU, at the reduced size (f32): granite-34b,
phi3-medium-14b, qwen2-moe-a2.7b, qwen3-moe-30b-a3b, moonshot-v1-16b-a3b
(MoE, dense as the reduced serve config sets it, and gshard),
musicgen-large (audio) and qwen2-vl-72b (vlm, with patch embeddings).
Every attention layer's decode step launches the decode kernel; the CPU is
fed the card's tokens and every step's logits agree to rtol/atol 1e-4, as
tests/test_torch_arch_cuda.py holds the other architectures. Every test
needs a CUDA card and skips without one; the file imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_arch_families_cuda.py
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.core import tasks
from repro_torch.kernels.swa_attn import swa_attn
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.utils import pytree as pt

requires_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                   reason="needs a CUDA card")

ARCHS = ["granite-34b", "phi3-medium-14b", "qwen2-moe-a2.7b",
         "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "musicgen-large",
         "qwen2-vl-72b"]


def _reduced(arch, impl="dense"):
    cfg = dataclasses.replace(configs.reduced(configs.get_arch(arch)),
                              num_layers=3, dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               impl=impl))
    return cfg


@requires_cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_cuda_matches_cpu(arch):
    """Prefill of 40 tokens and eight decode steps on the card and on the
    CPU from the same weights."""
    cfg = _reduced(arch)
    params = M.init_model(torch.Generator().manual_seed(0), cfg)
    gparams = pt.tree_map(lambda t: t.cuda(), params)
    prompt = serve.make_prompt(cfg, 2, 40, 1, torch.device("cpu"))
    swa_attn.swa_decode_attention.launches = 0
    got = serve.generate(gparams, cfg, prompt.cuda(), 9, keep_logits=True)
    assert swa_attn.swa_decode_attention.launches == 8 * cfg.num_layers
    q = cfg.num_codebooks if cfg.family == "audio" else 1
    assert tuple(got.tokens.shape) == (2, 9 * q)
    want = serve.generate(params, cfg, prompt, 9, feed=got.tokens.cpu(),
                          keep_logits=True)
    for a, b in zip(got.logits, want.logits):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


@requires_cuda
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b",
                                  "moonshot-v1-16b-a3b", "qwen2-vl-72b"])
def test_forward_on_cuda_matches_cpu(arch):
    """The training forward: gshard MoE (with its drops) and the vlm's
    patch embeddings over 16 of 64 positions; logits and aux."""
    cfg = _reduced(arch, impl="gshard")
    params = M.init_model(torch.Generator().manual_seed(2), cfg)
    gparams = pt.tree_map(lambda t: t.cuda(), params)
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
    pe = (torch.randn(2, 16, cfg.vision_embed_dim, generator=g)
          if cfg.family == "vlm" else None)
    want, waux, _ = M.forward(params, toks, cfg, patch_embeds=pe,
                              q_chunk=32, kv_chunk=32)
    got, gaux, _ = M.forward(gparams, toks.cuda(), cfg,
                             patch_embeds=None if pe is None else pe.cuda(),
                             q_chunk=32, kv_chunk=32)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gaux.cpu(), waux, rtol=1e-4, atol=1e-7)


@requires_cuda
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "musicgen-large",
                                  "qwen2-vl-72b"])
def test_arch_task_gradients_on_cuda_match_cpu(arch):
    """One arch of each new family: the ArchTask loss and its gradient on
    the card equal the CPU's."""
    t = tasks.arch_task(arch, seq_len=32, global_batch=2, num_layers=2,
                        d_model=128)
    params = t.init(torch.Generator().manual_seed(4), "cpu")
    batch = t.to_device(t.make_batcher(0, 0, seed=5).next(),
                        torch.device("cpu"))
    gbatch = t.to_device(t.make_batcher(0, 0, seed=5).next(),
                         torch.device("cuda"))
    grads, loss = torch.func.grad_and_value(lambda p: t.loss(p, batch))(
        params)
    ggrads, gloss = torch.func.grad_and_value(lambda p: t.loss(p, gbatch))(
        pt.tree_map(lambda x: x.cuda(), params))
    torch.testing.assert_close(gloss.cpu(), loss, rtol=1e-5, atol=1e-6)
    for a, b in zip(pt.tree_leaves(ggrads), pt.tree_leaves(grads)):
        scale = float(b.abs().max()) or 1.0
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * scale
