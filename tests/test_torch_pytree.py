"""The port's tree layer (repro_torch.utils.pytree) against the reference's
(repro.utils.pytree): leaf order, padding, flat vectors and round trips.

Flat vectors are compared for exact equality: flattening is a copy in both
packages, so any difference is a layout fault, not rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as C
from repro.models import small as jsmall
from repro.utils import pytree as jpt
from repro_torch.convert import params_from_numpy
from repro_torch.utils import pytree as tpt
from torch_threads import one_torch_thread  # noqa: F401

BLOCK = 65536


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def nested_tree():
    """Dict keys out of order, a list, a bf16 leaf and a scalar-shaped leaf."""
    rng = np.random.default_rng(0)
    return {"z": rng.normal(size=(33, 7)).astype(np.float32),
            "a": [rng.normal(size=(129,)).astype(np.float32),
                  rng.normal(size=(2, 3, 5)).astype(np.float32)],
            "m": {"w": rng.normal(size=(4, 4)).astype(jnp.bfloat16),
                  "b": np.asarray(1.5, np.float32)}}


def paper_params(name):
    task = C.PAPER_TASKS[name]
    return to_numpy(jsmall.init_task_model(jax.random.PRNGKey(0), task))


TREES = {"synthetic-1-1": lambda: paper_params("synthetic-1-1"),
         "femnist": lambda: paper_params("femnist"),
         "shakespeare": lambda: paper_params("shakespeare"),
         "nested-bf16": nested_tree}


@pytest.fixture(params=sorted(TREES))
def trees(request):
    np_tree = TREES[request.param]()
    return (jax.tree.map(jnp.asarray, np_tree),
            params_from_numpy(np_tree, device="cpu"))


class TestLeafOrder:
    def test_leaves_match_jax_flatten(self, trees):
        jtree, ttree = trees
        jl = jax.tree.leaves(jtree)
        tl = tpt.tree_leaves(ttree)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            assert tuple(a.shape) == tuple(b.shape)
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          b.float().numpy())

    def test_paper_models_sorted_keys(self):
        tree = params_from_numpy(paper_params("synthetic-1-1"), device="cpu")
        _, treedef = tpt.tree_flatten(tree)
        assert treedef[1] == ("fc0", "fc1", "fc2")
        assert treedef[2][0][1] == ("b", "w")      # fc0.b before fc0.w
        lstm = params_from_numpy(paper_params("shakespeare"), device="cpu")
        assert tpt.tree_flatten(lstm)[1][1] == ("embed", "fc", "lstm1",
                                                "lstm2")

    def test_default_device_needs_cuda(self):
        """Carrying weights across is an entry point: it runs on CUDA unless
        the caller asks for the CPU, and never drops to the CPU itself."""
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present: the default device is valid")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            params_from_numpy(nested_tree())


class TestFlatSpec:
    def test_flat_vector_equals_reference(self, trees):
        jtree, ttree = trees
        js = jpt.FlatSpec(jtree, block=BLOCK)
        ts = tpt.FlatSpec(ttree, block=BLOCK)
        assert (ts.n, ts.n_padded, ts.block) == (js.n, js.n_padded, js.block)
        assert ts.shapes == tuple(tuple(s) for s in js.shapes)
        jv = np.asarray(js.flatten(jtree))
        tv = ts.flatten(ttree)
        assert tv.dtype == torch.float32 and tv.shape == (ts.n_padded,)
        np.testing.assert_array_equal(tv.numpy(), jv)
        np.testing.assert_array_equal(tv[ts.n:].numpy(), 0.0)

    def test_unflatten_round_trip(self, trees):
        _, ttree = trees
        ts = tpt.FlatSpec(ttree, block=BLOCK)
        back = ts.unflatten(ts.flatten(ttree))
        assert tpt.tree_structure(back) == tpt.tree_structure(ttree)
        for a, b in zip(tpt.tree_leaves(ttree), tpt.tree_leaves(back)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)

    def test_reference_unflattens_port_vector(self, trees):
        jtree, ttree = trees
        js = jpt.FlatSpec(jtree, block=BLOCK)
        vec = tpt.FlatSpec(ttree, block=BLOCK).flatten(ttree).numpy()
        for a, b in zip(jax.tree.leaves(js.unflatten(jnp.asarray(vec))),
                        jax.tree.leaves(jtree)):
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          np.asarray(b, np.float32))

    def test_padding_sizes(self):
        tree = {"w": torch.arange(13, dtype=torch.float32),
                "b": {"c": torch.ones((3, 5), dtype=torch.bfloat16)}}
        spec = tpt.FlatSpec(tree, block=64)
        assert spec.n == 13 + 15 and spec.n_padded == 64
        assert spec.zeros().shape == (64,)

    @pytest.mark.parametrize("case", [
        (dtype, block, out) for dtype in ("f32", "bf16")
        for block in (64, 1) for out in ("new", "row")]
        + ["short", "f64", "strided"], ids=str)
    def test_flatten_writes_each_leaf_once(self, case):
        """``flatten`` (a new vector, or a row of a stack given as ``out``)
        equals the concatenation and zero padding it replaced, to the bit,
        with a bf16 leaf, a transposed leaf and a scalar leaf, padded and
        not; it writes its row's tail and nothing outside the row; an
        ``out`` of another length, dtype or layout raises."""
        g = torch.Generator().manual_seed(3)
        dtype, block, out = (case if isinstance(case, tuple)
                             else ("f32", 64, case))
        tree = {"w": torch.randn(13, generator=g),
                "b": {"c": torch.randn(3, 5, generator=g).to(
                          torch.bfloat16 if dtype == "bf16"
                          else torch.float32),
                      "s": torch.tensor(1.5)},
                "t": torch.randn(4, 3, generator=g).t()}
        spec = tpt.FlatSpec(tree, block=block)
        assert spec.n == 13 + 15 + 1 + 12
        assert (spec.n_padded > spec.n) == (block == 64)
        bad = {"short": torch.empty(spec.n_padded - 1),
               "f64": torch.empty(spec.n_padded, dtype=torch.float64),
               "strided": torch.empty(2 * spec.n_padded)[::2]}
        if out in bad:
            with pytest.raises(ValueError):
                spec.flatten(tree, out=bad[out])
            return
        old = torch.nn.functional.pad(
            torch.cat([l.reshape(-1).float() for l in tpt.tree_leaves(tree)]),
            (0, spec.n_padded - spec.n))
        stack = torch.full((3, spec.n_padded), float("nan"))
        vec = spec.flatten(tree, out=stack[1] if out == "row" else None)
        if out == "row":
            assert vec.data_ptr() == stack[1].data_ptr()
            assert torch.isnan(stack[0::2]).all()
        assert vec.dtype == torch.float32 and vec.shape == old.shape
        assert torch.equal(vec.view(torch.int32), old.view(torch.int32))
        assert torch.equal(vec[spec.n:], torch.zeros(spec.n_padded - spec.n))

    def test_tree_bytes_matches(self, trees):
        jtree, ttree = trees
        assert tpt.tree_bytes(ttree) == jpt.tree_bytes(jtree)
        assert tpt.tree_size(ttree) == jpt.tree_size(jtree)


class TestFlatParams:
    def test_cache_invalidation(self):
        tree = {"w": torch.ones((5,))}
        fp = tpt.FlatParams.from_tree(tree, block=8)
        assert fp.tree is tree                       # seeded cache
        fp2 = fp.replace(fp.vec * 2.0)
        torch.testing.assert_close(fp2.tree["w"], torch.full((5,), 2.0))
        assert fp.vec.shape == fp2.vec.shape

    def test_unflatten_gives_views(self):
        tree = {"w": torch.ones((5,)), "b": torch.zeros((3,))}
        fp = tpt.FlatParams.from_tree(tree, block=8)
        fp2 = fp.replace(fp.vec.clone())
        assert fp2.tree["b"].data_ptr() == fp2.vec.data_ptr()


class TestTreeMath:
    """Reductions accumulate in f32 leaf by leaf in both packages; the sums
    inside a leaf run in another order, hence rtol 1e-6."""

    def test_norms_and_dists(self, trees):
        jtree, ttree = trees
        j2 = jax.tree.map(lambda x: x * 0.5 + 0.25, jtree)
        t2 = tpt.tree_map(lambda x: x * 0.5 + 0.25, ttree)
        np.testing.assert_allclose(float(tpt.tree_norm(ttree)),
                                   float(jpt.tree_norm(jtree)), rtol=1e-6)
        np.testing.assert_allclose(float(tpt.tree_dist(ttree, t2)),
                                   float(jpt.tree_dist(jtree, j2)), rtol=1e-6)
        np.testing.assert_allclose(float(tpt.tree_dot(ttree, t2)),
                                   float(jpt.tree_dot(jtree, j2)), rtol=1e-5)

    def test_axpy_and_sub(self, trees):
        jtree, ttree = trees
        ja = jpt.tree_axpy(0.3, jtree, jtree)
        ta = tpt.tree_axpy(0.3, ttree, ttree)
        for a, b in zip(jax.tree.leaves(ja), tpt.tree_leaves(ta)):
            # a bf16 leaf: the port rounds after the multiply and after the
            # add, the reference may round once, so one bf16 ulp (at most
            # 2^-7 relative) apart
            rtol = 2.0 ** -7 if b.dtype == torch.bfloat16 else 1e-6
            np.testing.assert_allclose(b.float().numpy(),
                                       np.asarray(a, np.float32), rtol=rtol)
        for leaf in tpt.tree_leaves(tpt.tree_sub(ttree, ttree)):
            assert not leaf.any()
