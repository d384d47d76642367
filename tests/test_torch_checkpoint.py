"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's format: round trips, the flat layout's re-padding, the server's
``save_checkpoint`` / ``restore_checkpoint`` on both backends, and files
that either package writes restoring in the other, in tree and flat form.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import configs as C
from repro.core.server import AsyncFedEDServer as JServer
from repro.core.server import ClientUpdate as JUpdate
from repro.models import small as jsmall
from repro_torch import checkpoint as ckpt
from repro_torch import configs as TC
from repro_torch.convert import params_from_numpy
from repro_torch.core.server import AsyncFedEDServer, ClientUpdate
from repro_torch.utils import pytree as pt
from torch_threads import one_torch_thread  # noqa: F401


def jparams(name, seed=0):
    return jsmall.init_task_model(jax.random.PRNGKey(seed),
                                  C.PAPER_TASKS[name])


def tparams(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def nested():
    g = torch.Generator().manual_seed(0)
    return {"b": [torch.randn(3, generator=g),
                  (torch.randn(2, 2, generator=g),
                   torch.arange(4, dtype=torch.int32))],
            "a": {"z": torch.randn(5, generator=g),
                  "10": torch.randn(1, generator=g),
                  "9": torch.randn(2, generator=g)}}


def equal_trees(a, b):
    la, lb = pt.tree_leaves(a), pt.tree_leaves(b)
    return (pt.tree_structure(a) == pt.tree_structure(b)
            and all(x.dtype == y.dtype and torch.equal(x, y)
                    for x, y in zip(la, lb)))


def test_pytree_round_trip_and_leaf_names(tmp_path):
    tree = nested()
    path = ckpt.save_pytree(tree, str(tmp_path), 7)
    assert path.endswith("step_7.npz")
    back = ckpt.restore_pytree(pt.tree_zeros_like(tree), str(tmp_path))
    assert equal_trees(tree, back)
    # names as jax.tree_util.tree_flatten_with_path gives them
    jtree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)
    jckpt.save_pytree(jtree, str(tmp_path / "ref"), 7)
    with np.load(path) as ours, np.load(tmp_path / "ref" / "step_7.npz") as \
            ref:
        assert list(ours.keys()) == list(ref.keys())
        for k in ref.keys():
            np.testing.assert_array_equal(ours[k], ref[k])
    assert (json.load(open(path + ".json"))
            == json.load(open(str(tmp_path / "ref" / "step_7.npz.json"))))


def test_restore_checks_template_and_picks_latest(tmp_path):
    tree = nested()
    for step in (3, 12, 5):
        ckpt.save_pytree(pt.tree_map(lambda t: t + step, tree),
                         str(tmp_path), step)
    assert ckpt.latest_step(str(tmp_path)) == 12
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    back = ckpt.restore_pytree(tree, str(tmp_path))
    assert equal_trees(back, pt.tree_map(lambda t: t + 12, tree))
    bad = dict(tree, a=dict(tree["a"], z=torch.zeros(6)))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_pytree(bad, str(tmp_path), 3)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_pytree(tree, str(tmp_path / "none"))


@pytest.mark.parametrize("name", ["synthetic-1-1", "femnist", "shakespeare"])
def test_pytree_files_cross_packages(tmp_path, name):
    p = jparams(name)
    jckpt.save_pytree(p, str(tmp_path / "j"), 1)
    back = ckpt.restore_pytree(tparams(jparams(name, seed=1)),
                               str(tmp_path / "j"))
    assert equal_trees(back, tparams(p))
    ckpt.save_pytree(tparams(p), str(tmp_path / "t"), 2)
    jback = jckpt.restore_pytree(jparams(name, seed=1), str(tmp_path / "t"))
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(p)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_flat_round_trip_and_repad(tmp_path):
    vec = torch.zeros(4096)
    vec[:1000] = torch.randn(1000, generator=torch.Generator().manual_seed(1))
    path = ckpt.save_flat(vec, 1000, str(tmp_path), 4, block=2048)
    meta = json.load(open(path + ".json"))
    assert meta == {"n": 1000, "block": 2048, "n_padded": 4096,
                    "model_shards": 1, "dtype": "float32"}
    back, meta2 = ckpt.restore_flat(str(tmp_path), n=1000)
    assert meta2 == meta and np.array_equal(back, vec.numpy())
    for n_padded in (1000, 2048, 65536):
        wide, _ = ckpt.restore_flat(str(tmp_path), 4, n_padded=n_padded)
        assert wide.shape == (n_padded,)
        assert np.array_equal(wide[:1000], vec.numpy()[:1000])
        assert not wide[1000:].any()
    with pytest.raises(ValueError, match="n=999"):
        ckpt.restore_flat(str(tmp_path), n=999)
    with pytest.raises(ValueError, match="n_padded"):
        ckpt.restore_flat(str(tmp_path), n_padded=999)
    vec[2000] = 1.0
    with pytest.raises(ValueError, match="non-zero"):
        ckpt.save_flat(vec, 1000, str(tmp_path), 5)
    with pytest.raises(ValueError, match="1-D"):
        ckpt.save_flat(torch.zeros(2, 2), 1, str(tmp_path), 5)
    assert ckpt.latest_flat_step(str(tmp_path)) == 4


def test_flat_files_cross_packages(tmp_path):
    vec = np.zeros(8192, np.float32)
    vec[:5000] = np.random.default_rng(2).standard_normal(5000)
    jckpt.save_flat(jnp.asarray(vec), 5000, str(tmp_path / "j"), 1,
                    block=4096, model_shards=2)
    ours, meta = ckpt.restore_flat(str(tmp_path / "j"), n=5000,
                                   n_padded=65536)
    assert meta["model_shards"] == 2 and np.array_equal(ours[:5000],
                                                        vec[:5000])
    ckpt.save_flat(torch.from_numpy(vec), 5000, str(tmp_path / "t"), 1,
                   block=4096)
    ref, jmeta = jckpt.restore_flat(str(tmp_path / "t"), n=5000,
                                    n_padded=16384)
    assert np.array_equal(ref[:5000], vec[:5000]) and not ref[5000:].any()
    assert jmeta == json.load(open(str(tmp_path / "t" / "flat_1.npz.json")))


@pytest.mark.parametrize("backend", ["pytree", "pallas"])
def test_server_checkpoint(tmp_path, backend):
    """A server after a few aggregations saves its global model; a fresh
    server restores it bitwise, from the port's file and from the file of
    the reference's server in the same state."""
    fed = dataclasses.replace(TC.SYNTHETIC_1_1.fed, backend=backend)
    p = jparams("synthetic-1-1")
    server = AsyncFedEDServer(tparams(p), fed, backend=backend)
    jserver = JServer(p, fed, backend=backend)
    g = torch.Generator().manual_seed(3)
    for i in range(3):
        delta = pt.tree_map(lambda t: 0.01 * torch.randn(t.shape, generator=g),
                            server.params)
        server.on_connect(i)
        jserver.on_connect(i)
        server.on_update(ClientUpdate(i, 1, 2, delta))
        jserver.on_update(JUpdate(i, 1, 2, jax.tree.map(
            jnp.asarray, pt.tree_map(lambda t: t.numpy(), delta))))
    path = server.save_checkpoint(str(tmp_path / "t"))
    assert os.path.basename(path) == (
        "flat_4.npz" if backend == "pallas" else "step_4.npz")
    fresh = AsyncFedEDServer(tparams(jparams("synthetic-1-1", seed=5)), fed,
                             backend=backend)
    fresh.restore_checkpoint(str(tmp_path / "t"))
    if backend == "pallas":
        assert torch.equal(fresh._flat.vec, server._flat.vec)
    assert equal_trees(fresh.params, server.params)
    # the reference's file of its own server, restored by the port
    jserver.save_checkpoint(str(tmp_path / "j"))
    fresh.restore_checkpoint(str(tmp_path / "j"))
    for a, b in zip(pt.tree_leaves(fresh.params),
                    jax.tree.leaves(jserver.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)
    # and the reverse
    jfresh = JServer(jparams("synthetic-1-1", seed=5), fed, backend=backend)
    jfresh.restore_checkpoint(str(tmp_path / "t"))
    for a, b in zip(jax.tree.leaves(jfresh.params),
                    pt.tree_leaves(server.params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
