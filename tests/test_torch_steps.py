"""The port's step programs (``repro_torch.launch.steps``) against the JAX
package's (``repro.launch.steps``) on the CPU.

* One train step (``forward(remat=True)``, cross entropy + aux, AdamW) of a
  dense arch (h2o-danube-1.8b) and an SSD arch (mamba2-1.3b) at the
  reduced size, in f32, from the reference's weights: the loss and ce to
  rtol 1e-4, the gradient-derived Adam moments to 1e-4 of their largest
  element, the step counter exactly, and the new params to rtol 1e-4 where
  the gradient stands clear of float noise (AdamW's first step is
  sign-like: an element whose gradient is within noise of zero moves by up
  to lr either way; the test counts and bounds those elements).
* A prefill step and a serve step of recurrentgemma-2b and mamba2-1.3b:
  the next tokens equal, the caches to rtol 1e-4.
* ``input_specs``, ``abstract_model_params`` and ``abstract_opt_state``:
  the reference's shapes and dtypes for all ten archs x four shapes, as
  meta tensors.
* ``remat=True`` equals ``remat=False`` on the CPU, to the bit (the
  checkpointed groups recompute the same ops), and saves fewer bytes for
  the backward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_f32
from repro import configs as C
from repro.launch import steps as JS
from repro.models import model as JM
from repro_torch import configs as TC
from repro_torch.convert import params_from_numpy
from repro_torch.launch import steps as TS
from repro_torch.models import model as TM
from repro_torch.utils import pytree as pt
from torch_threads import one_torch_thread  # noqa: F401

B, S = 2, 64
RTOL = 1e-4


def port_cfg(jcfg):
    """The port's copy of a reference config (same fields)."""
    cfg = TC.reduced(TC.get_arch(jcfg.arch_id), num_layers=jcfg.num_layers)
    cfg = dataclasses.replace(cfg, dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl=jcfg.moe.impl))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return cfg


def tokens(cfg, seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def ref_params(jcfg, seed=0):
    return jax.tree.map(np.asarray,
                        JM.init_model(jax.random.PRNGKey(seed), jcfg))


@pytest.fixture(scope="module", params=["h2o-danube-1.8b", "mamba2-1.3b"])
def train_case(request):
    jcfg = reduced_f32(request.param)
    tcfg = port_cfg(jcfg)
    jp = ref_params(jcfg)
    toks, labels = tokens(jcfg, 1), tokens(jcfg, 2)
    jopt, topt = JS.default_optimizer(), TS.default_optimizer()
    jstep = jax.jit(JS.make_train_step(jcfg, jopt))
    jparams = jax.tree.map(jnp.asarray, jp)
    jnew, jstate, jmet = jstep(jparams, jopt.init(jparams),
                               {"tokens": jnp.asarray(toks),
                                "labels": jnp.asarray(labels)})
    # the gradients, for the noise floor of the sign-like first step
    def loss(p):
        logits, aux, _ = JM.forward(p, jnp.asarray(toks), jcfg)
        from repro.models.layers import cross_entropy
        return cross_entropy(logits, jnp.asarray(labels)) + aux
    jgrad = jax.jit(jax.grad(loss))(jparams)
    tp = params_from_numpy(jp, device="cpu")
    tbatch = {"tokens": torch.from_numpy(toks),
              "labels": torch.from_numpy(labels)}
    tnew, tstate, tmet = TS.make_train_step(tcfg, topt)(
        tp, topt.init(tp), tbatch)
    return dict(arch=request.param, jnew=jnew, jstate=jstate, jmet=jmet,
                jgrad=jgrad, tnew=tnew, tstate=tstate, tmet=tmet,
                tcfg=tcfg, tp=tp, tbatch=tbatch)


def leaves_np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def test_train_step_loss_and_ce(train_case):
    c = train_case
    for key in ("loss", "ce"):
        assert float(c["tmet"][key]) == pytest.approx(
            float(c["jmet"][key]), rel=RTOL)
    assert c["tmet"]["loss"].dim() == 0


def test_train_step_opt_state(train_case):
    c = train_case
    assert int(c["tstate"]["step"]) == int(c["jstate"]["step"]) == 1
    assert c["tstate"]["step"].dtype == torch.int32
    for key in ("m", "v"):
        for a, b in zip(leaves_np(c["jstate"][key]),
                        [t.numpy() for t in pt.tree_leaves(c["tstate"][key])]):
            assert b.shape == a.shape and b.dtype == a.dtype
            np.testing.assert_allclose(b, a, rtol=RTOL,
                                       atol=RTOL * np.abs(a).max() + 1e-30)


def test_train_step_params(train_case):
    """New params to rtol 1e-4, except where AdamW's sign-like first step
    takes the sign of a gradient within float noise of zero: such an
    element may move by up to lr either way. Every element off by more
    than rtol has |g| under 1e-3 of its leaf's largest |g|, is within 2 lr
    of the reference's, and they are under 0.1% of the nonzero gradients
    (counted: ``excluded``)."""
    c = train_case
    lr = 3e-4
    excluded = nonzero = 0
    for a, b, g in zip(leaves_np(c["jnew"]),
                       [t.numpy() for t in pt.tree_leaves(c["tnew"])],
                       leaves_np(c["jgrad"])):
        off = np.abs(b - a) > RTOL * np.abs(a) + 1e-7
        assert np.all(np.abs(g[off]) <= 1e-3 * np.abs(g).max())
        assert np.all(np.abs(b - a) <= 2 * lr * 1.001)
        excluded += int(off.sum())
        nonzero += int((g != 0).sum())
    print(f"{c['arch']}: {excluded} of {nonzero} nonzero gradients flip")
    assert excluded < 1e-3 * nonzero


def test_train_step_writes_nothing_in_place(train_case):
    """The params and opt state given are left as they were."""
    c = train_case
    step = TS.make_train_step(c["tcfg"], TS.default_optimizer())
    before = [t.clone() for t in pt.tree_leaves(c["tp"])]
    st = TS.default_optimizer().init(c["tp"])
    step(c["tp"], st, c["tbatch"])
    assert int(st["step"]) == 0
    for x, y in zip(before, pt.tree_leaves(c["tp"])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-1.3b"])
def test_prefill_and_serve_steps(arch):
    """The prefill step's next token and caches, then a serve step from
    the reference's decode cache (``cache_specs`` at 2S slots, the prefill's
    caches laid in) at index S: tokens equal, caches to rtol 1e-4."""
    jcfg = reduced_f32(arch)
    tcfg = port_cfg(jcfg)
    jp = ref_params(jcfg)
    tp = params_from_numpy(jp, device="cpu")
    toks = tokens(jcfg, 3)
    shape = C.ShapeConfig("prefill_t", S, B, "prefill")
    tshape = TC.ShapeConfig("prefill_t", S, B, "prefill")
    jtok, jcache = jax.jit(JS.make_prefill_step(jcfg, shape, q_chunk=16,
                                                kv_chunk=16))(
        jax.tree.map(jnp.asarray, jp), {"tokens": jnp.asarray(toks)})
    ttok, tcache = TS.make_prefill_step(tcfg, tshape, q_chunk=16,
                                        kv_chunk=16)(
        tp, {"tokens": torch.from_numpy(toks)})
    assert ttok.dtype == torch.int32
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for a, b in zip(leaves_np(jcache), pt.tree_leaves(tcache)):
        np.testing.assert_allclose(b.numpy(), a, rtol=RTOL,
                                   atol=RTOL * np.abs(a).max())

    # one serve step against a seeded cache at decode_32k's window rule
    dshape = C.ShapeConfig("decode_t", 2 * S, B, "decode")
    tdshape = TC.ShapeConfig("decode_t", 2 * S, B, "decode")
    window = JS.decode_window(jcfg, dshape)
    assert TS.decode_window(tcfg, tdshape) == window
    rng = np.random.default_rng(4)
    cache = jax.tree.map(
        lambda s: (0.5 * rng.standard_normal(s.shape)).astype(s.dtype),
        JM.cache_specs(jcfg, B, 2 * S, window))
    new_tok = tokens(jcfg, 5, (B, 1))
    jtok, jnew = jax.jit(JS.make_serve_step(jcfg, dshape))(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, cache),
        jnp.asarray(new_tok), jnp.int32(S))
    tcache_in = params_from_numpy(cache, device="cpu")
    ttok, tnew = TS.make_serve_step(tcfg, tdshape)(
        tp, tcache_in, torch.from_numpy(new_tok), S)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for a, b in zip(leaves_np(jnew), pt.tree_leaves(tnew)):
        np.testing.assert_allclose(b.numpy(), a, rtol=RTOL,
                                   atol=RTOL * np.abs(a).max())
    for a, b in zip(leaves_np(cache), pt.tree_leaves(tcache_in)):
        np.testing.assert_array_equal(a, b.numpy())   # the input unchanged


def _sds(tree):
    return [(tuple(x.shape), np.dtype(x.dtype).name)
            for x in jax.tree.leaves(tree)]


def _meta(tree):
    out = []
    for t in pt.tree_leaves(tree):
        assert t.device.type == "meta"
        out.append((tuple(t.shape), str(t.dtype).replace("torch.", "")))
    return out


@pytest.mark.parametrize("arch", C.ALL_ARCH_IDS)
def test_abstract_inputs_match_the_reference(arch):
    """input_specs at the four shapes, the abstract params and the
    default optimizer's state: the reference's shapes and dtypes, leaf for
    leaf, as meta tensors (no storage)."""
    jcfg, tcfg = C.get_arch(arch), TC.get_arch(arch)
    for jshape, tshape in zip(C.ALL_SHAPES, TC.ALL_SHAPES):
        assert dataclasses.asdict(jshape) == dataclasses.asdict(tshape)
        assert _meta(TS.input_specs(tcfg, tshape)) == _sds(
            JS.input_specs(jcfg, jshape))
    assert _meta(TS.abstract_model_params(tcfg)) == _sds(
        JS.abstract_model_params(jcfg))
    assert _meta(TS.abstract_opt_state(tcfg, TS.default_optimizer())) == _sds(
        JS.abstract_opt_state(jcfg, JS.default_optimizer()))


def test_shapes_and_mesh_config_equal_the_reference():
    assert [dataclasses.asdict(s) for s in TC.ALL_SHAPES] == [
        dataclasses.asdict(s) for s in C.ALL_SHAPES]
    for s in C.ALL_SHAPES:
        assert dataclasses.asdict(TC.get_shape(s.name)) == \
            dataclasses.asdict(C.get_shape(s.name))
    assert dataclasses.asdict(TC.MeshConfig()) == \
        dataclasses.asdict(C.MeshConfig())


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b",
                                  "qwen2-moe-a2.7b"])
def test_remat_equals_no_remat(arch):
    """One train step with remat on and off: the loss, the new params and
    the optimizer state equal to the bit; and the forward keeps fewer
    bytes for the backward with remat (one input per group, the rest
    recomputed)."""
    jcfg = reduced_f32(arch, num_layers=3)
    tcfg = port_cfg(jcfg)
    tp = params_from_numpy(ref_params(jcfg), device="cpu")
    batch = {"tokens": torch.from_numpy(tokens(jcfg, 6)),
             "labels": torch.from_numpy(tokens(jcfg, 7))}
    outs = []
    for remat in (True, False):
        opt = TS.default_optimizer()
        outs.append(TS.make_train_step(tcfg, opt, remat=remat, q_chunk=16,
                                       kv_chunk=16)(tp, opt.init(tp), batch))
    (p1, s1, m1), (p2, s2, m2) = outs
    assert torch.equal(m1["loss"], m2["loss"])
    for x, y in zip(pt.tree_leaves((p1, s1)), pt.tree_leaves((p2, s2))):
        assert torch.equal(x, y)

    saved = []
    live = pt.tree_map(lambda t: t.detach().requires_grad_(True), tp)
    for remat in (True, False):
        nbytes = [0]

        def pack(t):
            nbytes[0] += t.numel() * t.element_size()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            TM.forward(live, batch["tokens"], tcfg, remat=remat, q_chunk=16,
                       kv_chunk=16)
        saved.append(nbytes[0])
    assert saved[0] < saved[1]


def test_serve_step_frees_each_layers_cache_copy():
    """Each attention layer's updated cache copy is gone when the serve
    step returns, with the cyclic collector off: no reference cycle keeps
    it (the tree walkers once were self-referential closures, which kept
    every flattened leaf alive until a collection; a decode_32k step then
    held every layer's copy at once)."""
    import gc
    import weakref

    from repro_torch.models import layers as TL
    cfg = port_cfg(reduced_f32("h2o-danube-1.8b", num_layers=4))
    shape = TC.ShapeConfig("decode_t", 2 * S, B, "decode")
    params = TM.init_model(torch.Generator().manual_seed(0), cfg)
    cache = TM.init_cache(cfg, B, shape.seq_len,
                          TS.decode_window(cfg, shape))
    refs = []
    inner = TL.attention_fwd

    def recording(*a, **k):
        y, new = inner(*a, **k)
        refs.extend(weakref.ref(t) for t in new)
        return y, new
    TL.attention_fwd = recording
    enabled = gc.isenabled()
    gc.disable()
    try:
        TS.make_serve_step(cfg, shape)(params, cache,
                                       torch.zeros((B, 1), dtype=torch.int32),
                                       S)
        assert len(refs) == 2 * cfg.num_layers
        assert sum(r() is not None for r in refs) == 0
    finally:
        TL.attention_fwd = inner
        if enabled:
            gc.enable()
