"""The seven architectures of the last architecture slice against the JAX
package: granite-34b (MQA, 48 query heads on one kv head, layernorm, gelu,
tied head) and phi3-medium-14b (GQA) of the dense family,
qwen2-moe-a2.7b, qwen3-moe-30b-a3b and moonshot-v1-16b-a3b (mixture of
experts, dense and gshard), musicgen-large (audio: four codebooks summed
in, four heads out) and qwen2-vl-72b (vlm: M-RoPE, patch embeddings
projected over the first positions).

At the reduced size (``reduced()``, f32, MoE dense as the reference's serve
and arch task set it): the parameter trees, the forward's logits, caches and
MoE aux loss (and the gshard form's), the decode step from the same caches,
decode against the port's own forward, the audio (B, Q, S) and vlm
``patch_embeds`` front ends, the serve loop's tokens, and the ArchTask loss,
eval metrics and gradients of one arch of each new family. The reference's
weights are drawn with jax.random and carried across
(``convert.params_from_numpy``); tokens come from numpy seeds.

Tolerances, as tests/test_torch_arch_models.py: logits and aux rtol/atol
1e-4; decode against forward 1e-3/1e-4; gradients rtol 1e-4, atol 1e-6
(tests/test_torch_arch_task.py).
"""
import dataclasses
import functools
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as C
from repro.core import tasks as jtasks
from repro.launch import serve as jserve
from repro.models import model as JM
from repro.models.params import count_params as jcount
from repro.models.params import is_def as jis_def
from repro_torch import configs as TC
from repro_torch.convert import params_from_numpy
from repro_torch.core import tasks
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import params as TP
from repro_torch.utils import pytree as pt
from torch_threads import one_torch_thread  # noqa: F401


ARCHS = ["granite-34b", "phi3-medium-14b", "qwen2-moe-a2.7b",
         "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "musicgen-large",
         "qwen2-vl-72b"]
MOE = ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"]
#: batch, prompt length, patches (vlm), decode steps
B, S, P, STEPS = 2, 32, 16, 3


def cfgs(arch, impl="dense"):
    """The reference's and the port's reduced f32 configs of ``arch``, MoE
    in the form ``impl``."""
    out = []
    for mod in (C, TC):
        cfg = dataclasses.replace(mod.reduced(mod.get_arch(arch)),
                                  dtype="float32")
        if cfg.moe is not None:
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, impl=impl))
        out.append(cfg)
    return out


def inputs(cfg, seed=0, b=B, s=S):
    """Tokens (B, S), or (B, Q, S) for audio, and a vlm's (B, P, E) patch
    embeddings (None for the others), from a numpy seed."""
    rng = np.random.default_rng(seed)
    shape = (b, cfg.num_codebooks, s) if cfg.family == "audio" else (b, s)
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    pe = None
    if cfg.family == "vlm":
        pe = rng.normal(size=(b, P, cfg.vision_embed_dim)).astype(np.float32)
    return toks, pe


def jdef_paths(defs):
    """{key path: shape} of a reference def-tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(defs, is_leaf=jis_def)
    return {tuple(k.key for k in path): d.shape for path, d in flat}


def tdef_paths(defs, prefix=()):
    out = {}
    for k, v in defs.items():
        if isinstance(v, dict):
            out.update(tdef_paths(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v.shape
    return out


@functools.lru_cache(maxsize=None)
def reference_params(arch, seed):
    """The reference's weights of reduced ``arch`` (MoE in either form:
    the trees are the same), drawn once per module."""
    return JM.init_model(jax.random.PRNGKey(seed), cfgs(arch)[0])


def tt(a):
    return None if a is None else torch.from_numpy(a)


def close(t, j, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """One arch's configs, the reference's params and the port's copy, the
    inputs, and the reference's results computed once: the forward (logits,
    aux, caches) and STEPS decode steps from zeroed caches."""
    arch = request.param
    jcfg, tcfg = cfgs(arch)
    jp = reference_params(arch, 1)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks, pe = inputs(jcfg, seed=1)
    ref = {"forward": JM.forward(
        jp, jnp.asarray(toks), jcfg,
        patch_embeds=None if pe is None else jnp.asarray(pe),
        collect_cache=True, q_chunk=16, kv_chunk=16, remat=False)}
    cache = JM.init_cache(jcfg, B, 8, jcfg.sliding_window)
    ref["decode"] = []
    step = jax.jit(lambda p, c, tk, i: JM.decode_step(p, c, tk, i, jcfg))
    for t in range(STEPS):
        lg, cache = step(jp, cache, jnp.asarray(toks[..., t:t + 1]),
                         jnp.int32(t))
        ref["decode"].append(lg)
    ref["decode_cache"] = cache
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, toks=toks,
                pe=pe, ref=ref)


class TestAgainstReference:
    def test_param_tree(self, case):
        jcfg, tcfg = case["jcfg"], case["tcfg"]
        jdefs, tdefs = JM.model_defs(jcfg), TM.model_defs(tcfg)
        assert tdef_paths(tdefs) == jdef_paths(jdefs)
        assert TP.count_params(tdefs) == jcount(jdefs)
        assert tcfg.param_count() == jcfg.param_count()
        assert [tuple(t.shape) for t in pt.tree_leaves(case["tp"])] == [
            a.shape for a in jax.tree.leaves(case["jp"])]

    def test_forward_logits_aux_and_caches(self, case):
        tcfg = case["tcfg"]
        tl, ta, tc = TM.forward(case["tp"], tt(case["toks"]).long(), tcfg,
                                patch_embeds=tt(case["pe"]), q_chunk=16,
                                kv_chunk=16, collect_cache=True)
        jl, ja, jc = case["ref"]["forward"]
        want = ((B, S, tcfg.num_codebooks, tcfg.vocab_size)
                if tcfg.family == "audio" else (B, S, tcfg.vocab_size))
        assert tuple(tl.shape) == want
        close(tl, jl)
        assert ta.dtype == torch.float32 and ta.dim() == 0
        close(ta, ja, 1e-4, 1e-7)
        if tcfg.moe is not None:
            assert float(ta) > 0
        for t, j in zip(pt.tree_leaves(tc), jax.tree.leaves(jc)):
            close(t, j)

    def test_decode_steps(self, case):
        tcfg = case["tcfg"]
        tcache = TM.init_cache(tcfg, B, 8, tcfg.sliding_window, "cpu")
        toks = tt(case["toks"]).long()
        for t in range(STEPS):
            lg, tcache = TM.decode_step(case["tp"], tcache,
                                        toks[..., t:t + 1], t, tcfg)
            close(lg, case["ref"]["decode"][t])
        for t, j in zip(pt.tree_leaves(tcache),
                        jax.tree.leaves(case["ref"]["decode_cache"])):
            close(t, j)


@pytest.mark.parametrize("arch", MOE)
def test_gshard_forward(arch):
    """The full configs' MoE form on the reduced model: the forward's
    logits and aux equal the reference's gshard forward."""
    jcfg, tcfg = cfgs(arch, impl="gshard")
    jp = reference_params(arch, 1)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks, _ = inputs(jcfg, seed=5)
    jl, ja, _ = JM.forward(jp, jnp.asarray(toks), jcfg, q_chunk=16,
                           kv_chunk=16, remat=False)
    tl, ta, _ = TM.forward(tp, tt(toks).long(), tcfg, q_chunk=16,
                           kv_chunk=16)
    close(tl, jl)
    close(ta, ja, 1e-4, 1e-7)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Token-by-token decode reproduces the forward's last logits
    (tests/test_models.py::test_decode_matches_forward), audio's four
    codebooks at once."""
    _, tcfg = cfgs(arch)
    params = TM.init_model(torch.Generator().manual_seed(1), tcfg)
    toks = tt(inputs(tcfg, seed=2, s=16)[0]).long()
    full, _, _ = TM.forward(params, toks, tcfg, q_chunk=8, kv_chunk=8)
    cache = TM.init_cache(tcfg, B, 16, tcfg.sliding_window, "cpu")
    for t in range(16):
        lg, cache = TM.decode_step(params, cache, toks[..., t:t + 1], t, tcfg)
    close(lg[:, 0], full[:, -1], rtol=1e-3, atol=1e-4)


def test_audio_front_end_order():
    """Codebook q's tokens look up ``tok`` (q = 0) or ``tok_extra[q - 1]``,
    summed in that order; head q > 0 is ``out_extra[q - 1]``."""
    _, tcfg = cfgs("musicgen-large")
    p = TM.init_model(torch.Generator().manual_seed(3), tcfg)
    toks = tt(inputs(tcfg, seed=3)[0]).long()
    x = TL.embed_fwd(p["embed"], toks, tcfg)
    want = p["embed"]["tok"][toks[:, 0]]
    for q in range(1, tcfg.num_codebooks):
        want = want + p["embed"]["tok_extra"][q - 1][toks[:, q]]
    assert torch.equal(x, want)
    logits = TL.head_fwd(p["head"], p["embed"], x, tcfg)
    torch.testing.assert_close(logits[:, :, 0], x @ p["head"]["out"])
    torch.testing.assert_close(logits[:, :, 2],
                               x @ p["head"]["out_extra"][1])


def test_vlm_patches_cover_the_first_positions():
    """The projected patches replace positions 0 .. P - 1 and the token
    embeddings stay at P ..; with no patch_embeds the text embeds stand."""
    _, tcfg = cfgs("qwen2-vl-72b")
    p = TM.init_model(torch.Generator().manual_seed(4), tcfg)
    toks, pe = inputs(tcfg, seed=4)
    toks, pe = tt(toks).long(), tt(pe)
    x = TL.embed_fwd(p["embed"], toks, tcfg, patch_embeds=pe)
    text = TL.embed_fwd(p["embed"], toks, tcfg)
    torch.testing.assert_close(x[:, :P], pe @ p["embed"]["vision_proj"])
    assert torch.equal(x[:, P:], text[:, P:])
    assert torch.equal(text, p["embed"]["tok"][toks])


@pytest.mark.parametrize("arch", ["musicgen-large", "qwen2-moe-a2.7b"])
def test_serve_matches_reference(arch):
    """The serve loop against the reference's from the same weights: an
    audio prompt (B, Q, S) from the same default_rng draw, Q tokens per
    step, returned (B, gen_len * Q) as the reference's reshape gives."""
    want = np.asarray(jserve.serve(arch, batch=B, prompt_len=16, gen_len=4,
                                   verbose=False))
    jcfg, _ = cfgs(arch)
    jp = JM.init_model(jax.random.PRNGKey(0), jcfg)
    got = tserve.serve(arch, batch=B, prompt_len=16, gen_len=4,
                       verbose=False, device="cpu",
                       params=params_from_numpy(jax.tree.map(np.asarray, jp),
                                                device="cpu"))
    ncb = jcfg.num_codebooks if jcfg.family == "audio" else 1
    assert tuple(got.shape) == want.shape == (B, 4 * ncb)
    np.testing.assert_array_equal(got.numpy(), want)


#: the ArchTask comparison's size: the reference's test_tasks.py arch
TINY = dict(seq_len=16, global_batch=2, num_layers=1, d_model=64)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "musicgen-large",
                                  "qwen2-vl-72b"])
def test_arch_task_loss_and_gradients(arch):
    """One arch of each new family: the MoE aux loss enters the loss, audio
    labels are transposed to the logits' (B, S, Q), a vlm batch carries its
    patch embeddings; loss, eval metrics and every leaf's gradient equal
    the reference's."""
    j = jtasks.arch_task(arch, **TINY)
    t = tasks.arch_task(arch, **TINY)
    assert dataclasses.asdict(t.cfg) == dataclasses.asdict(j.cfg)
    jp = j.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jbatch = j.make_batcher(0, 0, seed=11).next()
    tbatch = t.to_device(jbatch, torch.device("cpu"))
    if t.cfg.family == "vlm":
        assert tuple(tbatch[0]["patch_embeds"].shape) == (2, 16, 64)
    jloss, jgrads = jax.jit(jax.value_and_grad(j.loss))(jp, jbatch)
    grads, loss = torch.func.grad_and_value(lambda p: t.loss(p, tbatch))(tp)
    close(loss, jloss, 1e-5, 0)
    for g, jg in zip(pt.tree_leaves(grads), jax.tree.leaves(jgrads)):
        close(g, jg, 1e-4, 1e-6)
    acc, eloss = t.eval_metrics(tp, tbatch)
    jacc, jeloss = jax.jit(j.eval_metrics)(jp, jbatch)
    close(eloss, jeloss, 1e-5, 0)
    assert float(acc) == float(jacc)


@pytest.mark.parametrize("example,argv", [
    ("displacement_gmis_at_scale_torch.py", []),
    ("serve_batched_torch.py", ["--arch", "musicgen-large", "--batch", "2",
                                "--gen-len", "4"])])
def test_examples_run_on_the_cpu(example, argv, monkeypatch, capsys):
    """The twins of the reference's two examples run with ``--device cpu``:
    the displacement GMIS on reduced phi3-medium-14b gives the ring's
    gammas (the script asserts it) and prints qwen2-vl-72b's memory; the
    serve example returns an audio model's 4 tokens per step."""
    path = Path(__file__).resolve().parents[1] / "examples" / example
    monkeypatch.setattr(sys, "argv", [str(path), *argv, "--device", "cpu"])
    runpy.run_path(str(path), run_name="__main__")
    out = capsys.readouterr().out
    if example.startswith("displacement"):
        assert "identical across GMIS modes" in out
        assert "18.6 TB" in out
    else:
        assert "generated token matrix: (2, 16)" in out
