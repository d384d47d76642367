"""The port's mixture-of-experts FFN (models/moe.py) against the JAX
package's ``repro.models.moe``: the router (softmax in f32, top-k with the
lower index first on ties, renormalised weights, the Switch aux loss from
the top-1 choice), the dense form, the gshard form without drops
(capacity_factor 8) and with drops (0.5; the (token, choice) queue
positions against a loop over the pairs in token-major order), the shared
experts and their sigmoid gate, the gradients of both forms against
``jax.grad``, and both forms under ``torch.func.vmap`` against a loop.

The reference's weights are drawn once with jax.random and carried across
(``convert.params_from_numpy``); inputs come from numpy seeds; the
reference's forwards and gradients run jitted (faster than op by op on the
CPU). Tolerances:
rtol/atol 1e-4 for outputs and aux (f32; the expert products sum in other
orders), gradients rtol 1e-4, atol 1e-6 (as tests/test_torch_arch_task.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as C
from repro.models import moe as JMOE
from repro.models.params import init_params as jinit
from repro_torch import configs as TC
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe as TMOE
from repro_torch.utils import pytree as pt
from torch_threads import one_torch_thread  # noqa: F401


#: (B, S) of the inputs, and the group size that cuts their 32 tokens into
#: four groups of 8 (the reference's default of 4096 gives one group)
B, S, GROUP = 2, 16, 8


def cfgs(shared=True, impl="dense", cf=1.25, experts=8, k=3):
    """The reference's and the port's reduced qwen2-moe-a2.7b, d_model 64,
    with ``experts`` experts, top-``k``, one shared expert or none."""
    out = []
    for mod in (C, TC):
        cfg = mod.reduced(mod.get_arch("qwen2-moe-a2.7b"), d_model=64)
        moe = dataclasses.replace(
            cfg.moe, num_experts=experts, num_experts_per_tok=k,
            capacity_factor=cf, impl=impl,
            num_shared_experts=1 if shared else 0,
            shared_d_ff=64 if shared else 0)
        out.append(dataclasses.replace(cfg, moe=moe, dtype="float32"))
    return out


def both(jcfg, seed=0):
    """The reference's params (the shared gate drawn too: its init is
    zeros, which would hide the gate) and the port's copy."""
    jp = jinit(jax.random.PRNGKey(seed), JMOE.moe_defs(jcfg))
    if "shared_gate" in jp:
        jp["shared_gate"] = 0.5 * jax.random.normal(
            jax.random.PRNGKey(seed + 100), jp["shared_gate"].shape)
    jp = jax.tree.map(np.asarray, jp)
    return jp, params_from_numpy(jp, device="cpu")


def xs(seed=0, d=64):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(
        np.float32)


def close(t, j, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j),
                               rtol=rtol, atol=atol)


class TestRouter:
    def test_weights_indices_aux(self):
        jcfg, tcfg = cfgs()
        jp, tp = both(jcfg)
        x = xs().reshape(B * S, 64)
        jw, ji, ja = JMOE._router(jp, jnp.asarray(x), jcfg.moe)
        tw, ti, ta = TMOE._router(tp, torch.from_numpy(x), tcfg.moe)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        close(tw, jw, 1e-5, 1e-6)
        close(ta, ja, 1e-5, 0)
        assert ta.dtype == torch.float32 and tw.dtype == torch.float32
        torch.testing.assert_close(tw.sum(-1), torch.ones(B * S))

    def test_aux_uses_the_top1_choice_only(self):
        """The aux is E * sum_e mean_prob_e * top1_frac_e * coef, the
        fractions counted over each token's first choice alone."""
        _, tcfg = cfgs()
        _, tp = both(cfgs()[0])
        x = torch.from_numpy(xs().reshape(B * S, 64))
        w, idx, aux = TMOE._router(tp, x, tcfg.moe)
        probs = torch.softmax(x @ tp["router"], dim=-1)
        e = tcfg.moe.num_experts
        top1 = torch.bincount(idx[:, 0], minlength=e).float() / (B * S)
        want = e * torch.sum(probs.mean(0) * top1) \
            * tcfg.moe.router_aux_loss_coef
        torch.testing.assert_close(aux, want, rtol=1e-6, atol=0)

    @pytest.mark.parametrize("tie", ["all", "pairs"])
    def test_ties_take_the_lower_index_first(self, tie):
        """``jax.lax.top_k`` puts the lower index first on ties; the port's
        stable sort gives the same indices (``torch.topk`` promises no
        order)."""
        jcfg, tcfg = cfgs(k=3)
        jp, tp = both(jcfg)
        r = np.array(jp["router"])
        if tie == "all":
            r[:] = 0.0                      # every expert ties
        else:
            r[:, 5] = r[:, 1]               # 1 and 5 tie, 2 and 6, 0 and 7
            r[:, 6] = r[:, 2]
            r[:, 7] = r[:, 0]
        jp = dict(jp, router=r)
        tp = dict(tp, router=torch.from_numpy(r.copy()))
        x = xs(3).reshape(B * S, 64)
        _, ji, _ = JMOE._router(jp, jnp.asarray(x), jcfg.moe)
        tw, ti, _ = TMOE._router(tp, torch.from_numpy(x), tcfg.moe)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        if tie == "all":
            assert (ti == torch.arange(3)).all()
            torch.testing.assert_close(tw, torch.full_like(tw, 1 / 3))
        else:
            vals, _ = TMOE.top_k(torch.softmax(
                torch.from_numpy(x) @ tp["router"], -1), 8)
            assert bool((vals[:, :-1] == vals[:, 1:]).any())


def gshard_positions(idx, cap):
    """A loop over each group's (token, choice) pairs in token-major order:
    a pair's place in its expert's queue, and whether it is kept."""
    g, gs, k = idx.shape
    pos = np.zeros_like(idx)
    for gi in range(g):
        count = {}
        for s in range(gs):
            for c in range(k):
                e = int(idx[gi, s, c])
                pos[gi, s, c] = count.get(e, 0)
                count[e] = count.get(e, 0) + 1
    return pos, pos < cap


class TestForward:
    @pytest.mark.parametrize("shared", [True, False],
                             ids=["shared", "routed"])
    def test_dense(self, shared):
        jcfg, tcfg = cfgs(shared=shared)
        jp, tp = both(jcfg, seed=1)
        x = xs(1)
        jy, ja = jax.jit(lambda p, x: JMOE.moe_fwd(p, x, jcfg))(
            jp, jnp.asarray(x))
        ty, ta = TMOE.moe_fwd(tp, torch.from_numpy(x), tcfg)
        close(ty, jy)
        close(ta, ja, 1e-5, 0)

    def test_shared_expert_and_gate(self):
        jcfg, tcfg = cfgs()
        jp, tp = both(jcfg, seed=2)
        x = xs(2).reshape(B * S, 64)
        close(TMOE._shared_ffn(tp, torch.from_numpy(x)),
              JMOE._shared_ffn(jp, jnp.asarray(x)))
        # the SwiGLU of the shared experts, scaled per token by
        # sigmoid(x . shared_gate)
        xt = torch.from_numpy(x)
        h = (torch.nn.functional.silu(xt @ tp["shared_wi_gate"])
             * (xt @ tp["shared_wi_up"])) @ tp["shared_wo"]
        gate = torch.sigmoid(xt @ tp["shared_gate"])[:, None]
        assert float((gate - 0.5).abs().max()) > 0.1
        torch.testing.assert_close(TMOE._shared_ffn(tp, xt), h * gate,
                                   rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("cf", [8.0, 0.5], ids=["no-drop", "drops"])
    @pytest.mark.parametrize("group", [4096, GROUP], ids=["one-group",
                                                           "groups"])
    def test_gshard(self, cf, group):
        """Capacity 8 keeps every pair; 0.5 drops some (the reference's
        overflow), the same pairs as the reference, whose positions come
        from the loop over the pairs. Without drops gshard is the dense
        form."""
        jcfg, tcfg = cfgs(impl="gshard", cf=cf)
        jp, tp = both(jcfg, seed=3)
        x = xs(3)
        jy, ja = jax.jit(lambda p, x: JMOE.moe_fwd_gshard(
            p, x, jcfg, group_size=group))(jp, jnp.asarray(x))
        ty, ta = TMOE.moe_fwd_gshard(tp, torch.from_numpy(x), tcfg,
                                     group_size=group)
        close(ty, jy)
        close(ta, ja, 1e-5, 0)
        g, gs, cap = TMOE.gshard_plan(B * S, tcfg.moe, group)
        assert (g, gs) == ((1, 32) if group == 4096 else (4, 8))
        w, idx, _ = TMOE._router(tp, torch.from_numpy(x).reshape(-1, 64),
                                 tcfg.moe)
        k = tcfg.moe.num_experts_per_tok
        pos, keep, disp, comb = TMOE.gshard_dispatch(
            w.reshape(g, gs, k), idx.reshape(g, gs, k), 8, cap)
        wpos, wkeep = gshard_positions(idx.reshape(g, gs, k).numpy(), cap)
        np.testing.assert_array_equal(pos.numpy(), wpos)
        np.testing.assert_array_equal(keep.numpy(), wkeep)
        assert float(disp.sum()) == float(keep.sum())
        if cf == 8.0:
            assert bool(keep.all())
            dcfg = dataclasses.replace(
                tcfg, moe=dataclasses.replace(tcfg.moe, impl="dense"))
            torch.testing.assert_close(
                ty, TMOE.moe_fwd(tp, torch.from_numpy(x), dcfg)[0],
                rtol=1e-5, atol=1e-6)
        else:
            assert 0 < int((~keep).sum()) < keep.numel()

    def test_gshard_at_decode_drops_as_the_reference(self):
        """Batch 4 of one token each at a full config's 60 experts, top-4:
        cap = max(1, int(4 * 4 * 1.25 / 60)) = 1, so a second pair for an
        expert in the step is dropped, in both packages."""
        jcfg, tcfg = cfgs(impl="gshard", experts=60, k=4)
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=1.25))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=1.25))
        assert TMOE.gshard_plan(4, tcfg.moe) == (1, 4, 1)
        jp, tp = both(jcfg, seed=4)
        r = np.array(jp["router"])
        r[:, 7] = 3.0 * np.abs(r).max()     # every token's first choice
        jp = dict(jp, router=r)
        tp = dict(tp, router=torch.from_numpy(r.copy()))
        x = np.random.default_rng(4).normal(size=(4, 1, 64)).astype(
            np.float32) + 1.0
        jy, _ = jax.jit(lambda p, x: JMOE.moe_fwd_gshard(p, x, jcfg))(
            jp, jnp.asarray(x))
        ty, _ = TMOE.moe_fwd_gshard(tp, torch.from_numpy(x), tcfg)
        close(ty, jy)
        _, idx, _ = TMOE._router(tp, torch.from_numpy(x).reshape(4, 64),
                                 tcfg.moe)
        assert (idx[:, 0] == 7).all()


def _loss_fns(jcfg, tcfg, impl, group):
    """The same scalar of both packages: a fixed projection of the MoE
    output plus the aux loss."""
    r = np.random.default_rng(9).normal(size=(B, S, 64)).astype(np.float32)
    jfwd = (JMOE.moe_fwd_dense if impl == "dense" else
            lambda p, x, c: JMOE.moe_fwd_gshard(p, x, c, group_size=group))
    tfwd = (TMOE.moe_fwd_dense if impl == "dense" else
            lambda p, x, c: TMOE.moe_fwd_gshard(p, x, c, group_size=group))

    def jloss(p, x):
        y, aux = jfwd(p, x, jcfg)
        return jnp.sum(y * r) + 100.0 * aux

    def tloss(p, x):
        y, aux = tfwd(p, x, tcfg)
        return torch.sum(y * torch.from_numpy(r)) + 100.0 * aux
    return jloss, tloss


@pytest.mark.parametrize("impl,cf", [("dense", 1.25), ("gshard", 1.25),
                                     ("gshard", 0.5)])
def test_gradients_equal_jax_grad(impl, cf):
    """Gradients of every leaf and of the input, through the router's
    softmax, the renormalised weights and the aux loss, against
    ``jax.grad`` (the gshard dispatch with and without drops)."""
    jcfg, tcfg = cfgs(impl=impl, cf=cf)
    jp, tp = both(jcfg, seed=5)
    x = xs(5)
    jloss, tloss = _loss_fns(jcfg, tcfg, impl, GROUP)
    (jgp, jgx) = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    tgp, tgx = torch.func.grad(tloss, argnums=(0, 1))(tp, torch.from_numpy(x))
    close(tgx, jgx, 1e-4, 1e-6)
    assert sorted(tgp) == sorted(jgp)
    for name in jgp:
        close(tgp[name], jgp[name], 1e-4, 1e-6)
        assert float(tgp[name].abs().max()) > 0, name


@pytest.mark.parametrize("impl", ["dense", "gshard"])
def test_vmap_equals_loop(impl):
    """Three clients, each with its own params and input: the vmapped
    forward and gradient equal one call per client (the forward is pure,
    with its capacity from static shapes)."""
    _, tcfg = cfgs(impl=impl, cf=0.5)
    rng = np.random.default_rng(6)
    _, tp = both(cfgs()[0], seed=6)
    params = [pt.tree_map(lambda a: a * float(1 + 0.1 * c) + 0.01
                          * torch.from_numpy(rng.normal(size=tuple(a.shape))
                                             .astype(np.float32)), tp)
              for c in range(3)]
    xs3 = torch.from_numpy(rng.normal(size=(3, B, S, 64)).astype(np.float32))
    fwd = (TMOE.moe_fwd_dense if impl == "dense" else
           lambda p, x: TMOE.moe_fwd_gshard(p, x, tcfg, group_size=GROUP))
    f = (lambda p, x: fwd(p, x, tcfg)) if impl == "dense" else fwd
    loss = lambda p, x: torch.sum(f(p, x)[0] ** 2) + f(p, x)[1]
    stack = pt.tree_map(lambda *ls: torch.stack(ls), *params)
    ys, auxs = torch.func.vmap(f)(stack, xs3)
    grads = torch.func.vmap(torch.func.grad(loss))(stack, xs3)
    for c in range(3):
        y, aux = f(params[c], xs3[c])
        torch.testing.assert_close(ys[c], y, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(auxs[c], aux, rtol=1e-6, atol=0)
        g = torch.func.grad(loss)(params[c], xs3[c])
        for name in g:
            torch.testing.assert_close(grads[name][c], g[name], rtol=1e-4,
                                       atol=1e-6)


def test_defs_equal_reference():
    for shared in (True, False):
        jcfg, tcfg = cfgs(shared=shared)
        jd, td = JMOE.moe_defs(jcfg), TMOE.moe_defs(tcfg)
        assert sorted(jd) == sorted(td)
        for name in jd:
            assert (jd[name].shape, jd[name].axes, jd[name].init) == (
                td[name].shape, td[name].axes, td[name].init)
