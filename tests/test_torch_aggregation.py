"""The port's aggregation math (Eq. 5-8), GMIS and adaptive K on the inputs
of tests/test_aggregation.py, each checked by hand and against the
reference on the same values.

Tolerance: both compute in f32 with the same operations; sums over a leaf
may run in another order, so rtol 1e-6 (1e-5 after a sqrt and a division).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core.gmis import DisplacementGMIS as JDisp
from repro.core.gmis import RingGMIS as JRing
from repro_torch.core import aggregation as agg
from repro_torch.core.adaptive_k import AdaptiveK, update_k
from repro_torch.core.gmis import DisplacementGMIS, RingGMIS
from repro_torch.utils import pytree as pt


def T(v):
    return torch.tensor(v, dtype=torch.float32)


def J(v):
    return jnp.asarray(v, jnp.float32)


def ttree(d):
    """A nested dict of lists as a tree of f32 tensors."""
    return ({k: ttree(v) for k, v in d.items()} if isinstance(d, dict)
            else T(d))


def tree(vals):
    return {"a": vals, "b": {"c": [[1.0, 2.0], [3.0, 4.0]]}}


class TestStaleness:
    def test_hand_computed(self):
        # x_t - x_stale = [3, 4] -> dist 5; delta = [0, 2] -> norm 2; gamma 2.5
        gamma, dist, dnorm = agg.staleness({"w": T([3.0, 4.0])},
                                           {"w": T([0.0, 0.0])},
                                           {"w": T([0.0, 2.0])})
        assert np.isclose(float(dist), 5.0)
        assert np.isclose(float(dnorm), 2.0)
        assert np.isclose(float(gamma), 2.5)

    def test_fresh_update_zero_gamma(self):
        x = ttree(tree([1.0, 2.0]))
        delta = ttree({"a": [0.1, 0.1], "b": {"c": [[1.0, 1.0],
                                                      [1.0, 1.0]]}})
        gamma, _, _ = agg.staleness(x, x, delta)
        assert float(gamma) == 0.0

    def test_zero_delta_huge_gamma(self):
        x_t = ttree(tree([1.0, 2.0]))
        x_s = ttree(tree([0.0, 0.0]))
        gamma, _, _ = agg.staleness(x_t, x_s, pt.tree_zeros_like(x_t))
        assert float(gamma) > 1e10      # effectively discarded by Eq.(7)

    def test_cap(self):
        gamma, _, _ = agg.staleness({"w": T([100.0])}, {"w": T([0.0])},
                                    {"w": T([1.0])}, cap=5.0)
        assert float(gamma) == 5.0

    @pytest.mark.parametrize("cap", [0.0, 0.5])
    def test_matches_reference(self, cap):
        rng = np.random.default_rng(0)
        x, s, d = (rng.normal(size=64).astype(np.float32) for _ in range(3))
        tg = agg.staleness({"w": T(x)}, {"w": T(s)}, {"w": T(d)}, cap)
        jg = jagg.staleness({"w": J(x)}, {"w": J(s)}, {"w": J(d)}, cap)
        np.testing.assert_allclose([float(v) for v in tg],
                                   [float(v) for v in jg], rtol=1e-5)


class TestAdaptiveLR:
    def test_eq7(self):
        assert np.isclose(float(agg.adaptive_lr(T(3.0), 2.0, 1.0)), 0.5)

    def test_max_at_zero_gamma(self):
        assert np.isclose(float(agg.adaptive_lr(T(0.0), 2.0, 4.0)), 0.5)

    def test_true_division_bits(self):
        """lam / (gamma + eps) is an f32 division, as in the reference (not
        a reciprocal times lam, which rounds differently)."""
        g = np.random.default_rng(1).uniform(0, 10, 4096).astype(np.float32)
        np.testing.assert_array_equal(
            agg.adaptive_lr(T(g), 5.0, 5.0).numpy(),
            np.asarray(jagg.adaptive_lr(J(g), 5.0, 5.0)))


class TestGammaEtaFromSq:
    @pytest.mark.parametrize("sq", [(25.0, 4.0), (0.0, 4.0), (0.0, 0.0),
                                    (9.0, 0.0), (1e6, 1e-4), (-0.0, 1.0)])
    @pytest.mark.parametrize("cap", [0.0, 3.0])
    def test_edge_rules_match(self, sq, cap):
        t = agg.gamma_eta_from_sq(T(sq[0]), T(sq[1]), 5.0, 5.0, cap)
        j = jagg.gamma_eta_from_sq(J(sq[0]), J(sq[1]), 5.0, 5.0, cap)
        np.testing.assert_array_equal([float(v) for v in t],
                                      [float(v) for v in j])

    def test_sequential_batch_schedule_is_the_reference(self):
        rng = np.random.default_rng(0)
        b = 3
        args = (rng.uniform(0, 1, b), rng.uniform(0.1, 1, b),
                rng.normal(size=(b, b)), np.eye(b))
        for a, r in zip(agg.sequential_batch_schedule(*args, lam=1.0,
                                                      eps=1.0),
                        jagg.sequential_batch_schedule(*args, lam=1.0,
                                                       eps=1.0)):
            np.testing.assert_array_equal(a, r)


class TestAggregate:
    def test_eq5_applied(self):
        res = agg.asyncfeded_aggregate({"w": T([1.0, 1.0])},
                                       {"w": T([1.0, 1.0])},
                                       {"w": T([2.0, -2.0])}, lam=1.0,
                                       eps=2.0)
        np.testing.assert_allclose(res.params["w"].numpy(), [2.0, 0.0])
        assert np.isclose(float(res.eta), 0.5)

    def test_dist_variant_matches(self):
        rng = np.random.default_rng(0)
        x = rng.normal(size=64).astype(np.float32)
        d = (0.2 * rng.normal(size=64)).astype(np.float32)
        x_t, x_s, dd = {"w": T(x)}, {"w": T(x + 0.1)}, {"w": T(d)}
        r1 = agg.asyncfeded_aggregate(x_t, x_s, dd, lam=1.0, eps=1.0)
        r2 = agg.asyncfeded_aggregate_with_dist(
            x_t, pt.tree_dist(x_t, x_s), dd, lam=1.0, eps=1.0)
        torch.testing.assert_close(r1.params["w"], r2.params["w"])
        assert float(r1.gamma) == float(r2.gamma)

    @pytest.mark.parametrize("cap", [0.0, 3.0])
    def test_matches_reference(self, cap):
        rng = np.random.default_rng(2)
        x = rng.normal(size=(7, 11)).astype(np.float32)
        v = rng.normal(size=513).astype(np.float32)
        t = lambda a, b: {"v": T(a), "w": T(b)}
        j = lambda a, b: {"v": J(a), "w": J(b)}
        args = [(v, x), (v + 0.05, x + 0.05), (v * 0.02, x * 0.02)]
        rt = agg.asyncfeded_aggregate(*[t(*a) for a in args], lam=2.0,
                                      eps=0.5, cap=cap)
        rj = jagg.asyncfeded_aggregate(*[j(*a) for a in args], lam=2.0,
                                       eps=0.5, cap=cap)
        for k in ("v", "w"):
            np.testing.assert_allclose(rt.params[k].numpy(),
                                       np.asarray(rj.params[k]), rtol=1e-6)
        np.testing.assert_allclose([float(rt.gamma), float(rt.eta)],
                                   [float(rj.gamma), float(rj.eta)],
                                   rtol=1e-5)


class TestAdaptiveK:
    def test_eq8_floor(self):
        assert update_k(10, 1.0, 3.0, 1.0) == 12
        assert update_k(10, 5.5, 3.0, 1.0) == 7   # floor(-2.5) = -3
        assert update_k(10, 3.0, 3.0, 1.0) == 10

    def test_clamping_and_nonfinite(self):
        assert update_k(2, 100.0, 3.0, 1.0, k_min=1) == 1
        assert update_k(10, 0.0, 100.0, 1.0, k_max=20) == 20
        assert update_k(10, float("nan"), 3.0, 1.0) == 10

    def test_controller(self):
        ctl = AdaptiveK(k_initial=10, gamma_bar=3.0, kappa=0.5)
        k = ctl.get(0)
        for _ in range(60):
            k = ctl.observe(0, 0.3 * k)
        assert abs(0.3 * k - 3.0) <= 0.5


class TestGMIS:
    def test_ring_eviction(self):
        g = RingGMIS(depth=3)
        for t in range(1, 6):
            g.append(t, {"w": T([float(t)])})
        assert g.num_stored == 3
        _, actual = g.get(1)          # evicted -> clamps to oldest
        assert actual == 3
        params, actual = g.get(4)
        assert actual == 4 and float(params["w"][0]) == 4.0

    def test_ring_empty_store_raises(self):
        for cls in (RingGMIS, JRing):
            with pytest.raises(RuntimeError, match="empty store"):
                cls(depth=4).get(1)

    def test_displacement_matches_ring(self):
        rng = np.random.default_rng(0)
        params = {"w": T(rng.normal(size=32).astype(np.float32))}
        ring, disp = RingGMIS(depth=16), DisplacementGMIS()
        ring.append(1, params)
        disp.register_snapshot("c0", 1, params)
        cur = params
        for t in range(2, 7):
            delta = {"w": T((0.1 * rng.normal(size=32)).astype(np.float32))}
            cur = pt.tree_axpy(0.5, delta, cur)
            ring.append(t, cur)
            disp.on_aggregate(0.5, delta)
        np.testing.assert_allclose(float(disp.distance_from("c0", 1, cur)),
                                   float(ring.distance_from("c0", 1, cur)),
                                   rtol=1e-5)

    def test_displacement_matches_reference(self):
        rng = np.random.default_rng(3)
        p = rng.normal(size=40).astype(np.float32)
        td, jd = DisplacementGMIS(), JDisp()
        td.register_snapshot(0, 1, {"w": T(p)})
        jd.register_snapshot(0, 1, {"w": J(p)})
        for _ in range(4):
            d = (0.1 * rng.normal(size=40)).astype(np.float32)
            td.on_aggregate(T(0.7), {"w": T(d)})
            jd.on_aggregate(J(0.7), {"w": J(d)})
        np.testing.assert_allclose(td.displacement(0)["w"].numpy(),
                                   np.asarray(jd.displacement(0)["w"]),
                                   rtol=1e-6)
        td.release(0)
        assert td.num_stored == 0
