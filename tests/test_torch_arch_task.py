"""The port's architecture task (``repro_torch.core.tasks.ArchTask``), its
loss and its gradients against the JAX package's.

* ``as_task`` resolves every handle the reference resolves (a
  ``ModelConfig``, an ``ArchScenarioConfig``, the registered scenario
  names, an arch id) to the reference's reduced config and shape, and an
  architecture the port cannot build raises naming ROADMAP.md A18b.
* ``TRAIN_4K``, the byte estimates, the eval stream, the planner's plans
  over an ``ArchTask`` and ``cross_entropy`` (both impls, with a mask)
  equal the reference's.
* The loss, the eval metrics and the gradients of the loss of a tiny
  h2o-danube-1.8b (the reference's own test size: 1 layer, d_model 64,
  16 tokens, batch 2), mamba2-1.3b (64 tokens: the SSD state crosses a
  32-step chunk) and recurrentgemma-2b (its three-block pattern) equal the
  reference's: gradients through ``torch.func.grad_and_value`` against
  ``jax.grad`` at rtol 1e-4, atol 1e-6 (f32; the scans and the products sum
  in other orders). The reference's weights are carried across
  (``convert.params_from_numpy``).
* ``SSDScan`` and ``RGLRUScan`` under ``torch.func.vmap(grad_and_value(...))``
  over three clients with their own params equal the per-client loop, and
  the scan runs once for the three (the vmap rule folds the clients).
* The decode-only kernel entry refuses a gradient.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as C
from repro.configs import shapes as jshapes
from repro.core import budget as jbudget
from repro.core import tasks as jtasks
from repro.models import layers as JL
from repro_torch import configs as TC
from repro_torch.configs import shapes
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import budget, tasks
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.swa_attn import ops as swa_ops
from repro_torch.kernels.swa_attn.swa_attn import swa_decode_attention
from repro_torch.models import layers as TL
from repro_torch.utils import pytree as pt


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: its steps are small, and
    with pytest-xdist's workers sharing the cores, every worker's default
    pool of one thread per core spins at each op's barrier. Restored after,
    for the other modules of the worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARCHS = ["h2o-danube-1.8b", "mamba2-1.3b", "recurrentgemma-2b"]
#: the tiny size of each: the reference's test_tasks.py arch, with 64
#: tokens for mamba2 (two of its reduced 32-step chunks)
TINY = {"h2o-danube-1.8b": dict(seq_len=16, global_batch=2, num_layers=1,
                                d_model=64),
        "mamba2-1.3b": dict(seq_len=64, global_batch=2, num_layers=1,
                            d_model=64),
        "recurrentgemma-2b": dict(seq_len=16, global_batch=2, num_layers=1,
                                  d_model=64)}
SCENARIO_NAMES = ["arch-danube-smoke", "arch-mamba2-smoke",
                  "arch-danube-budgeted"]


def same_task(t, j):
    """The port's ArchTask has the reference's config, shape and fed."""
    assert isinstance(t, tasks.ArchTask) and isinstance(j, jtasks.ArchTask)
    assert dataclasses.asdict(t.cfg) == dataclasses.asdict(j.cfg)
    assert dataclasses.asdict(t.shape) == dataclasses.asdict(j.shape)
    assert dataclasses.asdict(t.fed) == dataclasses.asdict(j.fed)
    assert t.name == j.name and (t.q_chunk, t.kv_chunk) == (j.q_chunk,
                                                            j.kv_chunk)


class TestCoercion:
    @pytest.mark.parametrize("name", SCENARIO_NAMES)
    def test_scenario_names(self, name):
        t = tasks.as_task(name)
        same_task(t, jtasks.as_task(name))
        assert t.fed.client_engine == "cohort"
        assert t.fed.batch_window == "auto"
        assert tasks.as_task(TC.SCENARIOS[name]) == t

    def test_budgeted_scenario_carries_fed(self):
        t = tasks.as_task(TC.SCENARIOS["arch-danube-budgeted"])
        assert t.fed.memory_budget_mb == 64 and t.fed.num_clients == 8

    @pytest.mark.parametrize("arch", ARCHS)
    def test_model_config_and_arch_id(self, arch):
        j = jtasks.as_task(C.get_arch(arch))
        same_task(tasks.as_task(TC.get_arch(arch)), j)
        same_task(tasks.as_task(arch), jtasks.as_task(arch))
        same_task(tasks.arch_task(arch, full_scale=True),
                  jtasks.arch_task(arch, full_scale=True))
        same_task(tasks.arch_task(arch, **TINY[arch]),
                  jtasks.arch_task(arch, **TINY[arch]))

    def test_passthrough_and_paper_tasks(self):
        t = tasks.arch_task("h2o-danube-1.8b", **TINY["h2o-danube-1.8b"])
        assert tasks.as_task(t) is t
        assert isinstance(tasks.as_task("synthetic-1-1"), tasks.PaperTask)
        assert tasks.as_task("synthetic-256").name == "synthetic-256"
        assert hash(t) == hash(tasks.arch_task("h2o-danube-1.8b",
                                               **TINY["h2o-danube-1.8b"]))

    def test_rejects_garbage(self):
        with pytest.raises(TypeError):
            tasks.as_task(42)

    def test_unbuilt_architectures_name_a18b(self):
        moe = dataclasses.replace(
            TC.get_arch("h2o-danube-1.8b"), arch_id="danube-moe",
            family="moe", moe=MoEConfig(num_experts=4, num_experts_per_tok=2,
                                        expert_d_ff=64))
        with pytest.raises(NotImplementedError, match="A18b"):
            tasks.as_task(moe)
        for arch in ("qwen3-moe-30b-a3b", "musicgen-large", "qwen2-vl-72b"):
            assert arch in C.ARCHS
            with pytest.raises(NotImplementedError, match="A18b"):
                tasks.as_task(arch)


class TestShapesAndEstimates:
    def test_train_4k_equals_reference(self):
        assert (dataclasses.asdict(shapes.TRAIN_4K)
                == dataclasses.asdict(jshapes.TRAIN_4K))
        assert TC.base.SHAPES["train_4k"] is shapes.TRAIN_4K

    @pytest.mark.parametrize("arch", ARCHS)
    @pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
    def test_byte_estimates(self, arch, full):
        t = tasks.arch_task(arch, full_scale=full)
        j = jtasks.arch_task(arch, full_scale=full)
        for fed in (t.fed, TC.SCENARIOS["arch-danube-budgeted"].fed):
            assert t.batch_bytes(fed) == j.batch_bytes(fed)
            assert t.activation_bytes(fed) == j.activation_bytes(fed)
        assert t.num_samples(0) == j.num_samples(0)

    @pytest.mark.parametrize("name", SCENARIO_NAMES)
    def test_data_equals_reference(self, name):
        t, j = tasks.as_task(name), jtasks.as_task(name)
        ids, (ex, ey) = t.load_data(t.fed, seed=3)
        jids, (jx, jy) = j.load_data(j.fed, seed=3)
        assert ids == jids
        np.testing.assert_array_equal(ex["tokens"], jx["tokens"])
        np.testing.assert_array_equal(ey, jy)
        fn, (px, _) = t.load_population_data(t.fed, seed=3)
        assert fn(7) == 7
        np.testing.assert_array_equal(px["tokens"], jx["tokens"])
        bx, by = t.make_batcher(1, 32, seed=5).next_stacked(2)
        jbx, jby = j.make_batcher(1, 32, seed=5).next_stacked(2)
        np.testing.assert_array_equal(bx["tokens"], jbx["tokens"])
        np.testing.assert_array_equal(by, jby)

    @pytest.mark.parametrize("name", SCENARIO_NAMES)
    def test_plans_equal_reference(self, name):
        t, j = tasks.as_task(name), jtasks.as_task(name)
        pbytes = 4 * 1_000_000
        for budget_mb in (0, 1, 8, 64, 256):
            for clients, k, ragged in ((8, 2, False), (5, 3, True),
                                       (4, 2, False)):
                kw = dict(clients=clients, k=k, param_bytes=pbytes,
                          ragged=ragged, budget_bytes=budget_mb * 2 ** 20)
                assert (budget.plan_cohort(t, t.fed, **kw).to_dict()
                        == jbudget.plan_cohort(j, j.fed, **kw).to_dict())


def tiny(arch):
    """The port's and the reference's tiny task of ``arch``, the
    reference's params and the port's copy, and one seeded batch each."""
    j = jtasks.arch_task(arch, **TINY[arch])
    t = tasks.arch_task(arch, **TINY[arch])
    jp = j.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jbatch = j.make_batcher(0, 0, seed=11).next()
    tbatch = t.to_device(jbatch, torch.device("cpu"))
    return t, j, tp, jp, tbatch, jbatch


#: FedProx weight and the anchor's scale of the prox-gradient case
PROX_MU, ANCHOR = 0.1, 0.5


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """:func:`tiny` and the reference's results on it, computed once:
    (loss, grads) without and with a FedProx anchor, and eval (accuracy,
    loss), jitted (faster than op-by-op on the CPU); the prox weight is an
    argument, so one compile serves both losses."""
    t, j, tp, jp, tbatch, jbatch = tiny(request.param)
    janchor = jax.tree.map(lambda a: a * ANCHOR, jp)
    loss = jax.jit(jax.value_and_grad(
        lambda p, b, a, mu: j.loss(p, b, prox=(mu, a))))
    ref = {"grad": loss(jp, jbatch, janchor, 0.0),
           "prox": loss(jp, jbatch, janchor, PROX_MU),
           "eval": jax.jit(j.eval_metrics)(jp, jbatch)}
    return t, tp, tbatch, ref


def close(t, j, rtol, atol):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j),
                               rtol=rtol, atol=atol)


def close_grads(grads, jgrads):
    leaves, jleaves = pt.tree_leaves(grads), jax.tree.leaves(jgrads)
    assert len(leaves) == len(jleaves)
    for g, jg in zip(leaves, jleaves):
        close(g, jg, 1e-4, 1e-6)


class TestLoss:
    @pytest.mark.parametrize("impl", ["gather", "onehot"])
    @pytest.mark.parametrize("masked", [False, True])
    def test_cross_entropy(self, impl, masked):
        rng = np.random.default_rng(0)
        logits = rng.normal(0, 3, (2, 5, 97)).astype(np.float32)
        labels = rng.integers(0, 97, (2, 5)).astype(np.int32)
        mask = (rng.random((2, 5)) > 0.4).astype(np.float32) if masked \
            else None
        want = JL.cross_entropy(logits, labels, mask=mask, impl=impl)
        got = TL.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels).long(),
                               mask=None if mask is None
                               else torch.from_numpy(mask), impl=impl)
        close(got, want, 1e-5, 0)
        with pytest.raises(ValueError):
            TL.cross_entropy(torch.from_numpy(logits),
                             torch.from_numpy(labels).long(), impl="dense")

    def test_loss_and_eval_metrics(self, pair):
        t, tp, tbatch, ref = pair
        close(t.loss(tp, tbatch), ref["grad"][0], 1e-5, 0)
        acc, loss = t.eval_metrics(tp, tbatch)
        jacc, jloss = ref["eval"]
        close(loss, jloss, 1e-5, 0)
        assert float(acc) == float(jacc)

    def test_gradients_equal_reference(self, pair):
        """C1 on the CPU: the gradient of the loss reaches every leaf,
        through the scans' Functions, and equals ``jax.grad``."""
        t, tp, tbatch, ref = pair
        grads, loss = torch.func.grad_and_value(
            lambda p: t.loss(p, tbatch))(tp)
        close(loss, ref["grad"][0], 1e-5, 0)
        close_grads(grads, ref["grad"][1])
        # every parameter, the scans' included, gets a gradient
        assert all(float(g.abs().max()) > 0 for g in pt.tree_leaves(grads))

    def test_prox_gradient_equals_reference(self, pair):
        t, tp, tbatch, ref = pair
        anchor = pt.tree_map(lambda a: a * ANCHOR, tp)
        grads, loss = torch.func.grad_and_value(
            lambda p: t.loss(p, tbatch, prox=(PROX_MU, anchor)))(tp)
        close(loss, ref["prox"][0], 1e-5, 0)
        close_grads(grads, ref["prox"][1])

    def test_autograd_equals_torch_func(self, pair):
        """The loop engine's autograd path and the cohort engine's
        torch.func path give the same gradient."""
        t, tp, tbatch, _ = pair
        leaves, treedef = pt.tree_flatten(tp)
        leaves = [l.clone().requires_grad_(True) for l in leaves]
        loss = t.loss(pt.tree_unflatten(treedef, leaves), tbatch)
        auto = torch.autograd.grad(loss, leaves)
        func = pt.tree_leaves(torch.func.grad(lambda p: t.loss(p, tbatch))(tp))
        for a, f in zip(auto, func):
            torch.testing.assert_close(a, f, rtol=1e-6, atol=1e-7)


def count_calls(monkeypatch, module, name):
    """Record the leading dimension of every call of ``module.name``."""
    calls = []
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        calls.append(args[0].shape[0])
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_vmapped_grads_equal_loop(arch, monkeypatch):
    """Three clients with their own params and batches: the vmapped
    ``grad_and_value`` equals the per-client loop, and each scan runs once
    per layer for all three (the Function's vmap rule folds the clients
    into the batch axis)."""
    t, _, tp, _, _, _ = tiny(arch)
    rng = np.random.default_rng(1)
    params = [pt.tree_map(lambda a: a * float(1 + 0.1 * c)
                          + 0.01 * torch.from_numpy(
                              rng.normal(size=tuple(a.shape))
                              .astype(np.float32)), tp) for c in range(3)]
    batches = [t.to_device(t.make_batcher(0, 0, seed=20 + c).next(),
                           torch.device("cpu")) for c in range(3)]
    fn = lambda p, bx, by: t.loss(p, (bx, by))
    loop = [torch.func.grad_and_value(fn)(p, bx, by)
            for p, (bx, by) in zip(params, batches)]
    stack = lambda trees: pt.tree_map(lambda *ls: torch.stack(ls), *trees)
    module, name = ((ssd_ops, "ssd_rows_plain") if arch == "mamba2-1.3b"
                    else (rglru_ops, "rglru_scan"))
    calls = count_calls(monkeypatch, module, name)
    grads, losses = torch.func.vmap(torch.func.grad_and_value(fn))(
        stack(params), stack([b[0] for b in batches]),
        stack([b[1] for b in batches]))
    b = TINY[arch]["global_batch"]
    scans = sum(1 for k in t.cfg.layer_kinds if k in ("ssd", "rglru"))
    # forward: one call per layer over the 3 folded clients
    assert calls[:scans] == [3 * b] * scans
    for c, (g, loss) in enumerate(loop):
        torch.testing.assert_close(losses[c], loss, rtol=1e-5, atol=1e-6)
        for gv, gl in zip(pt.tree_leaves(grads), pt.tree_leaves(g)):
            torch.testing.assert_close(gv[c], gl, rtol=1e-4, atol=1e-6)


class TestGradientGuards:
    def test_swa_decode_refuses_grad(self):
        g = torch.Generator().manual_seed(0)
        q = torch.randn(2, 4, 8, generator=g)
        k = torch.randn(2, 6, 2, 8, generator=g)
        vl = torch.full((2,), 6, dtype=torch.int32)
        swa_decode_attention(q, k, k, vl)                 # no grad: fine
        with pytest.raises(RuntimeError, match="requires grad"):
            swa_decode_attention(q.clone().requires_grad_(True), k, k, vl)
        with torch.no_grad():
            swa_decode_attention(q.clone().requires_grad_(True), k, k, vl)
        with pytest.raises(RuntimeError, match="torch.func"):
            torch.func.vmap(lambda qq: swa_decode_attention(qq, k, k, vl))(
                q[None].expand(3, -1, -1, -1))
        with pytest.raises(RuntimeError, match="torch.func"):
            torch.func.grad(lambda qq: swa_ops.decode_attention(
                qq, k, k, 6).sum())(q[:, None])
