"""The paper models and the client's local training against the reference:
the JAX package's params are carried across with ``params_from_numpy`` and
both packages see the same numpy batches.

Tolerances: forward and backward run the same f32 operations, with matmul,
convolution and reduction sums in another order (and XLA may fuse), so the
loss agrees to rtol 1e-5 and gradients to 1e-4 relative to the largest
entry of their leaf. After K momentum steps the momentum agrees to 1e-4 of
its largest entry, and the deltas to that plus a few ulps of the params
they were taken from. Accuracy counts exact argmax hits and must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as C
from repro.core.client import Client as JClient
from repro.data.pipeline import load_task_datasets
from repro.models import small as jsmall
from repro_torch import configs as TC
from repro_torch.convert import params_from_numpy
from repro_torch.core.client import Client
from repro_torch.models import small
from repro_torch.utils import pytree as pt
from repro_torch.utils.device import as_tensor

TASKS = ("synthetic-1-1", "femnist", "shakespeare")


def jparams(name, seed=0):
    return jsmall.init_task_model(jax.random.PRNGKey(seed),
                                  C.PAPER_TASKS[name])


def batch(name, rows):
    train, _ = load_task_datasets(C.PAPER_TASKS[name], seed=0)
    x, y = train[0]
    return x[:rows], y[:rows]


def close_leafwise(tleaves, jleaves, rel):
    for t, j in zip(tleaves, jleaves):
        j = np.asarray(j, np.float32)
        t = t.detach().numpy()
        assert t.shape == j.shape
        scale = max(float(np.abs(j).max()), 1e-30)
        assert float(np.abs(t - j).max()) <= rel * scale


@pytest.mark.parametrize("name", TASKS)
class TestModels:
    def test_loss_and_accuracy(self, name):
        task, ttask = C.PAPER_TASKS[name], TC.PAPER_TASKS[name]
        p = jparams(name)
        tp = params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
        x, y = batch(name, 64)
        tb = (as_tensor(x, "cpu"), as_tensor(y, "cpu"))
        jl = float(jsmall.task_loss(task, p, (jnp.asarray(x), jnp.asarray(y))))
        tl = float(small.task_loss(ttask, tp, tb))
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        logits_t = small.task_fwd(ttask, tp, tb[0]).detach().numpy()
        logits_j = np.asarray(jsmall.task_fwd(task, p, jnp.asarray(x)))
        np.testing.assert_allclose(logits_t, logits_j, rtol=1e-4,
                                   atol=1e-5)
        assert (float(small.task_accuracy(ttask, tp, tb))
                == float(jsmall.task_accuracy(task, p, (jnp.asarray(x),
                                                        jnp.asarray(y)))))

    def test_gradients(self, name):
        task, ttask = C.PAPER_TASKS[name], TC.PAPER_TASKS[name]
        p = jparams(name, seed=1)
        x, y = batch(name, 16)
        jg = jax.grad(lambda q: jsmall.task_loss(
            task, q, (jnp.asarray(x), jnp.asarray(y))))(p)
        leaves, treedef = pt.tree_flatten(
            params_from_numpy(jax.tree.map(np.asarray, p), device="cpu"))
        leaves = [l.requires_grad_(True) for l in leaves]
        loss = small.task_loss(ttask, pt.tree_unflatten(treedef, leaves),
                               (as_tensor(x, "cpu"), as_tensor(y, "cpu")))
        tg = torch.autograd.grad(loss, leaves)
        close_leafwise(tg, jax.tree.leaves(jg), 1e-4)

    def test_prox_term(self, name):
        task, ttask = C.PAPER_TASKS[name], TC.PAPER_TASKS[name]
        p, a = jparams(name, 2), jparams(name, 3)
        x, y = batch(name, 8)
        jl = float(jsmall.task_loss(task, p, (jnp.asarray(x), jnp.asarray(y)),
                                    prox=(0.1, a)))
        tl = float(small.task_loss(
            ttask, params_from_numpy(jax.tree.map(np.asarray, p), device="cpu"),
            (as_tensor(x, "cpu"), as_tensor(y, "cpu")),
            prox=(0.1, params_from_numpy(jax.tree.map(np.asarray, a), device="cpu"))))
        np.testing.assert_allclose(tl, jl, rtol=1e-5)

    def test_own_init_shapes_and_determinism(self, name):
        ttask = TC.PAPER_TASKS[name]
        a = small.init_task_model(ttask, torch.Generator().manual_seed(0),
                                  torch.device("cpu"))
        b = small.init_task_model(ttask, torch.Generator().manual_seed(0),
                                  torch.device("cpu"))
        ref = jparams(name)
        assert pt.tree_structure(a) == pt.tree_structure(
            params_from_numpy(jax.tree.map(np.asarray, ref), device="cpu"))
        for la, lb, lr in zip(pt.tree_leaves(a), pt.tree_leaves(b),
                              jax.tree.leaves(ref)):
            assert tuple(la.shape) == tuple(lr.shape)
            assert la.dtype == torch.float32 and torch.equal(la, lb)


@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("name", TASKS)
def test_client_run_local(name, k):
    """Two rounds of Client.run_local in both packages on the same data.
    Each round starts from the reference's params and momentum, so a round
    is compared on equal inputs: from ulp-level differences, K steps of the
    CNN can cross a max-pool near-tie in one package and not in the other,
    which routes one gradient elsewhere and is no fault of either."""
    task, ttask = C.PAPER_TASKS[name], TC.PAPER_TASKS[name]
    train, _ = load_task_datasets(task, seed=0)
    fed = task.fed
    jc = JClient(2, task, train[2], fed, seed=0)
    tc = Client(2, ttask, train[2], fed, seed=0, device="cpu")
    p = jparams(name)
    for rnd in range(2):
        tp = params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
        if jc._mu is not None:
            tc._mu = params_from_numpy(jax.tree.map(np.asarray, jc._mu), device="cpu")
        ju, jloss = jc.run_local(p, k, snapshot_iter=rnd + 1)
        tu, tloss = tc.run_local(tp, k, snapshot_iter=rnd + 1)
        assert (tu.client_id, tu.snapshot_iter, tu.k_used, tu.num_samples) \
            == (ju.client_id, ju.snapshot_iter, ju.k_used, ju.num_samples)
        np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
        # a delta is x_K - x_0: besides 1e-4 of its own scale it carries
        # the rounding of the params, a few ulps of their largest entry
        for t, j, q in zip(pt.tree_leaves(tu.delta),
                           jax.tree.leaves(ju.delta), jax.tree.leaves(p)):
            tol = (1e-4 * float(np.abs(np.asarray(j)).max())
                   + 2.0 ** -18 * float(np.abs(np.asarray(q)).max()))
            assert float(np.abs(t.numpy() - np.asarray(j)).max()) <= tol
        close_leafwise(pt.tree_leaves(tc._mu), jax.tree.leaves(jc._mu), 1e-4)
        p = jax.tree.map(lambda a, b: a + b, p, ju.delta)
    assert tc.round_idx == jc.round_idx == 2
    assert (tc.batcher.rng.bit_generator.state
            == jc.batcher.rng.bit_generator.state)
