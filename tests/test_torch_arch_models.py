"""The port's architecture models (models/params, layers, ssm, rglru, model)
against the JAX package's, for the three configurations of the serving
slices, recurrentgemma-2b (RG-LRU and local attention), h2o-danube-1.8b
(sliding window attention) and mamba2-1.3b (the SSD block), at the reduced
size (``reduced()``, f32) and at a depth with a tail of remainder layers (a
deeper stack for mamba2, whose pattern is one block). The reference's
weights are drawn once with jax.random and carried across
(``convert.params_from_numpy``); tokens come from numpy.

Tolerances: logits rtol/atol 1e-4 (f32 throughout; the sums of the dense
products, the chunked softmax and the scans go in other orders, and
torch's softplus and silu differ from jax.nn's in the last bit of some
elements); decode against forward 1e-3/1e-4, the reference's own
(tests/test_models.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as C
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import ssm as JS
from repro.models.params import count_params as jcount
from repro.models.params import init_params as jinit_params
from repro.models.params import is_def as jis_def
from repro_torch import configs as TC
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import params as TP
from repro_torch.models import ssm as TS
from repro_torch.utils import pytree as pt
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["recurrentgemma-2b", "h2o-danube-1.8b", "mamba2-1.3b"]
#: the architectures with attention layers (a sliding window to ring)
WINDOWED = ARCHS[:2]
#: (num_layers) depths: the reduced default, and one with a tail
DEPTHS = [None, 5]


def cfgs(arch, num_layers=None, **changes):
    """The reference's and the port's reduced f32 configs of ``arch``."""
    out = []
    for mod in (C, TC):
        cfg = dataclasses.replace(mod.reduced(mod.get_arch(arch)),
                                  dtype="float32", **changes)
        if num_layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=num_layers)
        out.append(cfg)
    return out


def both_params(jcfg, seed=0):
    jp = JM.init_model(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def tokens(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def close(t, j, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


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


@pytest.mark.parametrize("depth", DEPTHS, ids=["reduced", "tail"])
@pytest.mark.parametrize("arch", ARCHS)
class TestAgainstReference:
    def test_param_tree_names_and_shapes(self, arch, depth):
        jcfg, tcfg = cfgs(arch, depth)
        jdefs, tdefs = JM.model_defs(jcfg), TM.model_defs(tcfg)
        assert tdef_paths(tdefs) == jdef_paths(jdefs)
        assert TP.count_params(tdefs) == jcount(jdefs)
        if depth is None:
            assert tcfg.param_count() == jcfg.param_count()
        # the reference's weights carry across as a plain copy
        jp, tp = both_params(jcfg)
        assert [tuple(t.shape) for t in pt.tree_leaves(tp)] == [
            a.shape for a in jax.tree.leaves(jp)]

    def test_forward_logits(self, arch, depth):
        jcfg, tcfg = cfgs(arch, depth)
        jp, tp = both_params(jcfg, seed=1)
        toks = tokens(jcfg, 2, 32, seed=1)
        jl, _, jc = JM.forward(jp, jnp.asarray(toks), jcfg, q_chunk=16,
                               kv_chunk=16, collect_cache=True, remat=False)
        tl, _, tc = TM.forward(tp, torch.from_numpy(toks).long(), tcfg,
                               q_chunk=16, kv_chunk=16, collect_cache=True)
        assert tl.shape == (2, 32, tcfg.vocab_size)
        close(tl, jl)
        for t, j in zip(pt.tree_leaves(tc), jax.tree.leaves(jc)):
            close(t, j)

    def test_decode_step_logits(self, arch, depth):
        """From the same cache (zeros, then one real step), the port's
        decode step gives the reference's logits and caches."""
        jcfg, tcfg = cfgs(arch, depth)
        jp, tp = both_params(jcfg, seed=2)
        toks = tokens(jcfg, 2, 3, seed=2)
        jcache = JM.init_cache(jcfg, 2, 8, jcfg.sliding_window)
        tcache = TM.init_cache(tcfg, 2, 8, tcfg.sliding_window, "cpu")
        assert [tuple(t.shape) for t in pt.tree_leaves(tcache)] == [
            a.shape for a in jax.tree.leaves(jcache)]
        for t in range(3):
            jl, jcache = JM.decode_step(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                                        jnp.int32(t), jcfg)
            tl, tcache = TM.decode_step(tp, tcache,
                                        torch.from_numpy(toks[:, t:t + 1]).long(),
                                        t, tcfg)
            close(tl, jl)
        for t, j in zip(pt.tree_leaves(tcache), jax.tree.leaves(jcache)):
            close(t, j)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_ranges(arch):
    """The port's own init draws the reference's distributions: ones and
    zeros where it has them, N(0, scale^2) elsewhere, and a = sigmoid(Lambda)
    in [0.9, 0.999] for the RG-LRU."""
    _, tcfg = cfgs(arch)
    defs = TM.model_defs(tcfg)
    params = TM.init_model(torch.Generator().manual_seed(0), tcfg)
    for d, p in zip(pt.tree_leaves(defs), pt.tree_leaves(params)):
        assert tuple(p.shape) == d.shape and p.dtype == torch.float32
        if d.init == "ones":
            assert bool((p == 1).all())
        elif d.init == "zeros":
            assert bool((p == 0).all())
        elif d.init == "lru_lambda":
            a = torch.sigmoid(p)
            assert bool(((a >= 0.9 - 1e-6) & (a <= 0.999 + 1e-6)).all())
        elif p.numel() >= 4096:
            assert abs(float(p.std()) / d.scale - 1.0) < 0.05
            assert abs(float(p.mean())) < 0.05 * d.scale
    again = TM.init_model(torch.Generator().manual_seed(0), tcfg)
    assert all(torch.equal(a, b) for a, b in zip(pt.tree_leaves(params),
                                                 pt.tree_leaves(again)))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Token-by-token decode reproduces the full forward's last logits
    (tests/test_models.py::test_decode_matches_forward)."""
    _, tcfg = cfgs(arch)
    params = TM.init_model(torch.Generator().manual_seed(1), tcfg)
    toks = torch.from_numpy(tokens(tcfg, 2, 16, seed=1)).long()
    full, _, _ = TM.forward(params, toks, tcfg, q_chunk=8, kv_chunk=8)
    cache = TM.init_cache(tcfg, 2, 16, tcfg.sliding_window, "cpu")
    for t in range(16):
        lg, cache = TM.decode_step(params, cache, toks[:, t:t + 1], t, tcfg)
    close(lg[:, 0], full[:, -1], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("arch", WINDOWED)
def test_ring_decode_matches_windowed_forward(arch):
    """Ring-buffer decode with window 8 equals the full forward with the
    same window once the context exceeds it
    (tests/test_models.py::test_sliding_window_ring_decode_matches_windowed_forward)."""
    jcfg, tcfg = cfgs(arch, sliding_window=8)
    jp, tp = both_params(jcfg, seed=5)
    toks = tokens(tcfg, 1, 24, seed=5)
    tt = torch.from_numpy(toks).long()
    full, _, _ = TM.forward(tp, tt, tcfg, window=8, q_chunk=8, kv_chunk=8)
    cache = TM.init_cache(tcfg, 1, 24, 8, "cpu")
    for t in range(24):
        lg, cache = TM.decode_step(tp, cache, tt[:, t:t + 1], t, tcfg,
                                   window=8)
    close(lg[:, 0], full[:, -1], rtol=1e-3, atol=1e-4)
    jfull, _, _ = JM.forward(jp, jnp.asarray(toks), jcfg, window=8,
                             q_chunk=8, kv_chunk=8, remat=False)
    close(full, jfull)


@pytest.mark.parametrize("mode", ["unrolled", "scan"])
@pytest.mark.parametrize("window", [0, 32])
def test_chunked_attention_modes(mode, window):
    """Both of the reference's lowerings: the port skips fully masked chunk
    pairs only in ``unrolled`` mode, and both equal the reference's."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, 128, 4, 32)).astype(np.float32)
               for _ in range(3))
    got = TL.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=True, window=window, q_chunk=32,
                               kv_chunk=32, mode=mode)
    want = JL.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                causal=True, window=window, q_chunk=32,
                                kv_chunk=32, mode=mode)
    close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mrope", [False, True], ids=["rope", "mrope"])
def test_rope(mrope):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 3, 16)).astype(np.float32)
    pos = (rng.integers(0, 100, (3, 2, 8)) if mrope
           else rng.integers(0, 100, (2, 8)))
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4,
                        mrope=mrope)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4, mrope=mrope)
    close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm(kind):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 24)).astype(np.float32)
    p = {"scale": rng.normal(size=24).astype(np.float32),
         "bias": rng.normal(size=24).astype(np.float32)}
    got = TL.norm_fwd({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x), kind)
    want = JL.norm_fwd({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), kind)
    close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_mlp_gelu_is_the_tanh_form(activation):
    """jax.nn.gelu defaults to the tanh approximation; the port uses it."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    names = (("wi_gate", "wi_up", "wo") if activation != "gelu"
             else ("wi", "wo"))
    p = {n: rng.normal(size=(16, 32) if n != "wo" else (32, 16)
                       ).astype(np.float32) for n in names}
    got = TL.mlp_fwd({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x), activation)
    want = JL.mlp_fwd({k: jnp.asarray(v) for k, v in p.items()},
                      jnp.asarray(x), activation)
    close(got, want, rtol=1e-5, atol=1e-5)


#: the configurations that raised naming ROADMAP.md A18 before their slice
#: was ported (MoE, audio, vlm), and the first one ported after raising
LATER = ("qwen2-moe-a2.7b", "musicgen-large", "qwen2-vl-72b")
PORTED = ("mamba2-1.3b",)


@pytest.mark.parametrize("arch", sorted(C.ARCHS.names()))
def test_later_families_raise(arch):
    """Every registered configuration, the MoE, audio and vlm ones that
    raised before the last architecture slice (``LATER``) included, now
    declares the reference's tree at its full size: names, shapes, the
    parameter count and the analytic count."""
    jcfg = C.get_arch(arch)
    tcfg = TC.ModelConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(jcfg)})
    jdefs, tdefs = JM.model_defs(jcfg), TM.model_defs(tcfg)
    assert tdef_paths(tdefs) == jdef_paths(jdefs)
    assert TP.count_params(tdefs) == jcount(jdefs)
    assert tcfg.param_count() == jcfg.param_count()
    assert set(LATER + PORTED) <= set(C.ARCHS.names())


def test_ssd_cache_specs_equal():
    """The SSD decode cache: an f32 (B, H, P, N) state and a (B, W-1,
    conv_dim) conv window in the model's dtype, per layer, stacked."""
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = (dataclasses.replace(cfg, dtype=dtype)
                      for cfg in cfgs("mamba2-1.3b"))
        js = jax.tree.leaves(JM.cache_specs(jcfg, 3, 40, 0))
        ts = pt.tree_leaves(TM.cache_specs(tcfg, 3, 40, 0))
        assert [tuple(t.shape) for t in ts] == [j.shape for j in js]
        assert [str(t.dtype).removeprefix("torch.") for t in ts] == [
            str(j.dtype) for j in js]


@pytest.mark.parametrize("mode", ["prefill", "continue", "decode",
                                  "short"])
def test_ssd_block_matches_reference(mode):
    """The Mamba-2 block at the reduced mamba2-1.3b width, on the
    reference's weights: a prefill of three chunks from zero state, a
    prefill continuing from a state (the scan's h0), one decode step, and a
    prefill shorter than the chunk (the chunk cut to S)."""
    jcfg, tcfg = cfgs("mamba2-1.3b")
    jp = jinit_params(jax.random.PRNGKey(6), JS.ssd_defs(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(7)
    s = {"decode": 1, "short": 20}.get(mode, 96)
    x = rng.normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    dinner, nheads, hd, n = JS.ssd_dims(jcfg)
    conv_dim = dinner + 2 * jcfg.ssm.ngroups * n
    state = (None, None) if mode in ("prefill", "short") else (
        rng.normal(size=(2, nheads, hd, n)).astype(np.float32),
        rng.normal(size=(2, jcfg.ssm.conv_width - 1, conv_dim)
                   ).astype(np.float32))
    jst = [None if a is None else jnp.asarray(a) for a in state]
    tst = [None if a is None else torch.from_numpy(a) for a in state]
    jy, (jssm, jconv) = JS.ssd_block_fwd(jp, jnp.asarray(x), jcfg,
                                         ssm_state=jst[0], conv_state=jst[1])
    ty, (tssm, tconv) = TS.ssd_block_fwd(tp, torch.from_numpy(x), tcfg,
                                         ssm_state=tst[0], conv_state=tst[1])
    assert ty.shape == (2, s, jcfg.d_model)
    for t, j in ((ty, jy), (tssm, jssm), (tconv, jconv)):
        close(t, j)


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(8)
    b, h, p, g, n = 3, 4, 8, 2, 16
    arrs = (rng.normal(size=(b, h, p, n)), rng.normal(size=(b, h, p)),
            np.log1p(np.exp(rng.normal(size=(b, h)))),
            -np.exp(0.3 * rng.normal(size=(h,))),
            rng.normal(size=(b, g, n)), rng.normal(size=(b, g, n)))
    arrs = [a.astype(np.float32) for a in arrs]
    jy, jst = JS.ssd_decode_step(*map(jnp.asarray, arrs))
    ty, tst = TS.ssd_decode_step(*map(torch.from_numpy, arrs))
    close(ty, jy, rtol=1e-5, atol=1e-5)
    close(tst, jst, rtol=1e-5, atol=1e-5)
