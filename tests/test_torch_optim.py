"""The port's optimizers and schedules (``repro_torch.optim``) against the
JAX package's (``repro.optim``), called op by op as the reference defines
them.

What is exact: SGD, momentum and Nesterov momentum over 20 steps (params,
state, updates, to the bit); Adam's moments and step counter; the
schedules' ``constant``; ``apply_updates`` in f32 and bf16. What differs in
the last bits, and the stated tolerance:

* ``b ** step`` is PyTorch's pow against XLA's: within 1 ulp of f32 over
  steps 1-1,000 where the result is a normal float (XLA flushes the
  subnormal tail of ``0.9 ** step`` to zero; ``1 - b ** step`` is then 1 in
  both). Adam's bias corrections ``1 - b ** step`` differ by that ulp of
  the power and their own rounding at most, so its updates
  hold to 5e-7 of the size of their Adam and weight-decay terms (a few
  ulps) element by element, from the same params at every step;
* ``cos`` is PyTorch's against XLA's, within 1 ulp; the cosine schedules
  hold to that ulp carried through ``0.5 * (1 + cos)`` (a cancellation near
  the end of the decay) plus 2 ulps of the result, over steps 0-1,000;
* ``clip_by_global_norm``: the per-leaf sums reduce in PyTorch's order, so
  the scaled leaves hold to rtol 1e-6.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.optim import optimizers as JOO
from repro_torch import optim as TO
from repro_torch.optim import optimizers as TOO
from repro_torch.utils import pytree as pt
from torch_threads import one_torch_thread  # noqa: F401

STEPS = 20
SCHED_STEPS = np.arange(0, 1001, dtype=np.int32)


def tree_np(seed: int, dtype=np.float32):
    """A seeded nested tree: dict keys out of order, a list, a 0-d leaf."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((5, 7)).astype(dtype),
            "b": [rng.standard_normal((3,)).astype(dtype),
                  rng.standard_normal((2, 2, 4)).astype(dtype)],
            "a": np.asarray(rng.standard_normal(), dtype)}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    return pt.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def np_leaves(tree):
    if isinstance(tree, dict) or isinstance(tree, list):
        return [np.asarray(x) for x in jax.tree.leaves(tree)]
    return [np.asarray(tree)]


def t_leaves(tree):
    return [t.numpy() for t in pt.tree_leaves(tree)]


def ulps(a, b) -> np.ndarray:
    a = np.asarray(a, np.float32).reshape(-1)
    b = np.asarray(b, np.float32).reshape(-1)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def grads_np(k: int, like):
    rng = np.random.default_rng(100 + k)
    return jax.tree.map(lambda a: rng.standard_normal(a.shape)
                        .astype(a.dtype), like)


def test_leaf_order_is_the_references():
    tree = tree_np(0)
    for a, b in zip(np_leaves(tree), t_leaves(to_torch(tree))):
        np.testing.assert_array_equal(a, b)


EXACT = {
    "sgd": (lambda m: m.sgd(0.1)),
    "sgd-decay": (lambda m: m.sgd(m.exponential_decay(0.1, 0.995))),
    "momentum": (lambda m: m.momentum(0.1, 0.5)),
    "momentum-const": (lambda m: m.momentum(m.constant(0.05), 0.9)),
    "nesterov": (lambda m: m.momentum(0.1, 0.9, nesterov=True)),
}


@pytest.mark.parametrize("name", sorted(EXACT))
def test_exact_optimizers_run_bitwise(name):
    """20 steps from the same params and gradients: the updates, the
    state and the params equal the reference's to the bit."""
    jo, to = EXACT[name](JO), EXACT[name](TO)
    tree = tree_np(1)
    jp, tp = to_jax(tree), to_torch(tree)
    js, ts = jo.init(jp), to.init(tp)
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    for k in range(STEPS):
        g = grads_np(k, tree)
        ju, js = jo.update(to_jax(g), js, jp)
        tu, ts = to.update(to_torch(g), ts, tp)
        for a, b in zip(np_leaves(ju), t_leaves(tu)):
            np.testing.assert_array_equal(a, b)
        jp, tp = JOO.apply_updates(jp, ju), TOO.apply_updates(tp, tu)
    for a, b in zip(np_leaves(jp), t_leaves(tp)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(np_leaves(js), t_leaves(ts)):
        np.testing.assert_array_equal(a, b)


#: name -> (optimizer from a module, lr from a module, weight decay)
ADAMS = {
    "adam": (lambda m, lr: m.adam(lr), lambda m: 1e-3, 0.0),
    "adam-wd": (lambda m, lr: m.adam(lr, weight_decay=0.01),
                lambda m: 1e-3, 0.01),
    "adamw": (lambda m, lr: m.adamw(lr), lambda m: 3e-4, 0.1),
    "adamw-cosine": (lambda m, lr: m.adamw(lr),
                     lambda m: m.cosine(3e-4, 15), 0.1),
    "adamw-warmup": (lambda m, lr: m.adamw(lr),
                     lambda m: m.warmup_cosine(3e-4, 5, 20), 0.1),
}


@pytest.mark.parametrize("name", sorted(ADAMS))
def test_adam_family(name):
    """20 steps, each from the reference's params of that step: the step
    counter and both moments to the bit, the updates to 5e-7 of the size
    of their two terms (the bias corrections' pow; the Adam term and the
    weight decay may cancel), and the params a free-running port reaches
    after 20 steps to 1e-6 of the largest param."""
    make, lr, wd = ADAMS[name]
    jlr = lr(JO)
    jo, to = make(JO, jlr), make(TO, lr(TO))
    tree = tree_np(2)
    jp, fp = to_jax(tree), to_torch(tree)
    js, ts, fs = jo.init(jp), to.init(to_torch(tree)), to.init(fp)
    for k in range(STEPS):
        g = grads_np(k, tree)
        ju, js_next = jo.update(to_jax(g), js, jp)
        tu, ts = to.update(to_torch(g), ts, to_torch(np_tree(jp)))
        fu, fs = to.update(to_torch(g), fs, fp)
        assert int(ts["step"]) == int(js_next["step"]) == k + 1
        assert ts["step"].dtype == torch.int32
        for key in ("m", "v"):
            for a, b in zip(np_leaves(js_next[key]), t_leaves(ts[key])):
                np.testing.assert_array_equal(a, b)
        rate = float(JOO._lr(jlr, js_next["step"]))
        for a, b, p in zip(np_leaves(ju), t_leaves(tu), np_leaves(jp)):
            decay = np.abs(np.float32(rate * wd) * p)
            assert np.all(np.abs(b - a) <= 5e-7 * (np.abs(a) + 2 * decay))
        js = js_next
        jp, fp = JOO.apply_updates(jp, ju), TOO.apply_updates(fp, fu)
    scale = max(np.abs(a).max() for a in np_leaves(jp))
    for a, b in zip(np_leaves(jp), t_leaves(fp)):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 * scale)


def np_tree(jtree):
    return jax.tree.map(np.asarray, jtree)


@pytest.mark.parametrize("b", [0.9, 0.95, 0.999, 0.995])
def test_pow_of_step_within_one_ulp(b):
    """``b ** step`` (Adam's bias corrections, exponential decay) over
    steps 1-1,000: within 1 ulp of the reference's where the reference's
    result is a normal f32; below that XLA flushes to zero, and ``1 - b **
    step`` is 1 in both."""
    steps = np.arange(1, 1001, dtype=np.int32)
    j = np.asarray(b ** jnp.asarray(steps).astype(jnp.float32))
    t = (b ** torch.from_numpy(steps).float()).numpy()
    normal = j >= np.finfo(np.float32).tiny
    assert ulps(j[normal], t[normal]).max() <= 1
    # the bias correction 1 - b ** step: the power's ulp, and its own
    # rounding where the subtraction is not exact (b ** step < 0.5)
    bj, bt = np.float32(1) - j, np.float32(1) - t
    assert np.all(np.abs(bj - bt)
                  <= np.spacing(np.maximum(j, t)) + np.spacing(bj))
    np.testing.assert_array_equal(bj[~normal], bt[~normal])


def test_bf16_updates_cast_to_the_gradient_dtype():
    """bf16 params and gradients: AdamW's arithmetic in f32, the updates
    cast back to bf16, the moments f32."""
    tree = tree_np(3)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    tp = pt.tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16), tree)
    jo, to = JO.adamw(1e-2), TO.adamw(1e-2)
    js, ts = jo.init(jp), to.init(tp)
    g = grads_np(0, tree)
    ju, js = jo.update(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                    g), js, jp)
    tu, ts = to.update(pt.tree_map(
        lambda a: torch.from_numpy(a).to(torch.bfloat16), g), ts, tp)
    for a, b in zip(jax.tree.leaves(ju), pt.tree_leaves(tu)):
        assert b.dtype == torch.bfloat16
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), rtol=8e-3)
    assert all(t.dtype == torch.float32 for t in pt.tree_leaves(ts["m"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_bitwise(dtype):
    tree, ups = tree_np(4), tree_np(5)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    jp = JOO.apply_updates(jax.tree.map(lambda a: jnp.asarray(a, jd), tree),
                           jax.tree.map(lambda a: jnp.asarray(a, jd), ups))
    tp = TOO.apply_updates(
        pt.tree_map(lambda a: torch.from_numpy(a).to(td), tree),
        pt.tree_map(lambda a: torch.from_numpy(a).to(td), ups))
    for a, b in zip(jax.tree.leaves(jp), pt.tree_leaves(tp)):
        assert b.dtype == td
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())


@pytest.mark.parametrize("max_norm", [0.5, 3.0, 1e3])
def test_clip_by_global_norm(max_norm):
    """Scaled (or left) by min(1, max_norm / |g|), the norm over the leaves
    in the reference's order; rtol 1e-6 (per-leaf sum order)."""
    g = tree_np(6)
    ja = JOO.clip_by_global_norm(to_jax(g), max_norm)
    tb = TOO.clip_by_global_norm(to_torch(g), max_norm)
    for a, b in zip(np_leaves(ja), t_leaves(tb)):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
    norm = math.sqrt(sum(float(np.sum(np.square(x, dtype=np.float64)))
                         for x in np_leaves(g)))
    got = math.sqrt(sum(float(np.sum(np.square(x, dtype=np.float64)))
                        for x in t_leaves(tb)))
    assert got == pytest.approx(min(norm, max_norm), rel=1e-6)


def test_clip_divides_truly():
    """``max_norm / gn`` is a true division: at a norm whose reciprocal
    rounds, ``reciprocal() * max_norm`` would differ in the last bit."""
    g = {"x": np.full((1,), 3.0, np.float32)}
    ja = JOO.clip_by_global_norm(to_jax(g), 1.0)
    tb = TOO.clip_by_global_norm(to_torch(g), 1.0)
    np.testing.assert_array_equal(np.asarray(ja["x"]), tb["x"].numpy())


def sched_pair(name, args):
    return getattr(JO, name)(*args), getattr(TO, name)(*args)


def eval_sched(jf, tf):
    j = np.array([np.asarray(jf(jnp.int32(s))) for s in SCHED_STEPS],
                 np.float32)
    t = np.array([tf(torch.tensor(s, dtype=torch.int32)).numpy()
                  for s in SCHED_STEPS], np.float32)
    return j, t


@pytest.mark.parametrize("name,args", [("constant", (3e-4,)),
                                       ("exponential_decay", (0.1, 0.995)),
                                       ("exponential_decay", (1.0, 0.9))])
def test_constant_and_exponential_schedules(name, args):
    """constant to the bit; exponential decay within 1 ulp (pow), both as
    f32 0-d tensors over steps 0-1,000."""
    jf, tf = sched_pair(name, args)
    out = tf(torch.tensor(7, dtype=torch.int32))
    assert out.dtype == torch.float32 and out.dim() == 0
    j, t = eval_sched(jf, tf)
    if name == "constant":
        np.testing.assert_array_equal(j, t)
    normal = j >= np.finfo(np.float32).tiny
    assert ulps(j[normal], t[normal]).max() <= 1


@pytest.mark.parametrize("name,args,ff", [
    ("cosine", (3e-4, 700), 0.1), ("cosine", (1.0, 1000, 0.0), 0.0),
    ("warmup_cosine", (3e-4, 100, 700), 0.1),
    ("warmup_cosine", (1.0, 0, 500, 0.2), 0.2)])
def test_cosine_schedules(name, args, ff):
    """Over steps 0-1,000: the argument of cos equal to the bit, cos within
    1 ulp, the schedule within that ulp carried through
    ``lr * wu * (ff + (1 - ff) * 0.5 * (1 + cos))`` plus 2 ulps of the
    result."""
    jf, tf = sched_pair(name, args)
    j, t = eval_sched(jf, tf)
    lr = args[0]
    if name == "cosine":
        total, wu, warm = args[1], np.ones_like(j), 0
    else:
        warm, total = args[1], args[2]
        wu = np.clip(SCHED_STEPS.astype(np.float32) / max(warm, 1), 0, 1)
    den = total if name == "cosine" else max(total - warm, 1)
    s = torch.from_numpy(SCHED_STEPS).float()
    tt_ = torch.clamp(torch.div(s - (0 if name == "cosine" else warm),
                                torch.tensor(float(den))), 0, 1)
    jt = np.clip((SCHED_STEPS.astype(np.float32)
                  - np.float32(0 if name == "cosine" else warm))
                 / np.float32(den), 0, 1)
    np.testing.assert_array_equal(jt, tt_.numpy())
    arg = (math.pi * tt_).numpy()
    np.testing.assert_array_equal(np.asarray(jnp.pi * jnp.asarray(jt)), arg)
    jc = np.asarray(jnp.cos(jnp.asarray(arg)))
    assert ulps(jc, torch.cos(torch.from_numpy(arg)).numpy()).max() <= 1
    bound = (lr * wu * (1 - ff) * 0.5 * np.spacing(np.abs(jc))
             + 2 * np.spacing(np.abs(j)))
    assert np.all(np.abs(j - t) <= bound)
