"""The port's adversary against the reference's: the same corrupted
clients and application counts from a seed; sign-flip, scale and zero
bit for bit on trees and on int8 and bf16 wire forms; gaussian-noise per
leaf in the reference's leaf order (rtol 1e-6 on trees, where sigma comes
from a tree norm summed in another order; bit for bit on wire forms, whose
noise is drawn on host numpy from the same vector in both); and attacked
simulations with norm screening, whose event trace and verdict sequence
must equal the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as C
from repro.configs.base import FedConfig as JFedConfig
from repro.core import adversary as jadv
from repro.core import compression as jc
from repro.core.server import ClientUpdate as JUpdate
from repro.core.simulator import FederatedSimulation as JSim
from repro.utils import pytree as jpt
from repro_torch import configs as TC
from repro_torch.configs.base import ATTACKS, FedConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import adversary as adv
from repro_torch.core import compression as tc
from repro_torch.core.server import ClientUpdate
from repro_torch.core.simulator import FederatedSimulation
from repro_torch.utils import pytree as pt


def np_tree(seed, scale=0.05):
    rng = np.random.default_rng(seed)
    f = lambda *s: (scale * rng.normal(size=s)).astype(np.float32)
    # keys out of sorted order and a nested list: the leaf order matters
    return {"z": f(17, 3), "a": [f(40), f(2, 5)], "m": {"y": f(9), "b": f()}}


def jtree(seed):
    return jax.tree.map(jnp.asarray, np_tree(seed))


def ttree(seed):
    return params_from_numpy(np_tree(seed), device="cpu")


def jwire(mode, seed):
    spec = jpt.FlatSpec(np_tree(seed), block=jc.BLOCK)
    return jc.quantize_vec(spec.flatten(np_tree(seed)), mode, spec.n)


def twire(mode, seed):
    t = ttree(seed)
    spec = pt.FlatSpec(t, block=tc.BLOCK)
    return tc.quantize_vec(spec.flatten(t), mode, spec.n)


def leaves_bitwise(port, ref):
    jl, tl = jax.tree.leaves(ref), pt.tree_leaves(port)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert b.shape == a.shape and b.dtype == torch.float32
        assert b.numpy().tobytes() == a.astype(np.float32).tobytes()


def wire_bitwise(port, ref):
    assert (port.mode, port.n) == (ref.mode, ref.n)
    if port.mode == "int8":
        assert port.q.numpy().tobytes() == np.asarray(ref.q).tobytes()
        assert (port.scales.numpy().tobytes()
                == np.asarray(ref.scales).tobytes())
    else:
        np.testing.assert_array_equal(port.q.float().numpy(),
                                      np.asarray(ref.q, np.float32))


ATTACK_KW = {"sign-flip": [{}, {"strength": 1.0}], "scale": [{"boost": 3.0}],
             "zero": [{}]}
DETERMINISTIC = [(name, kw) for name, kws in ATTACK_KW.items() for kw in kws]


class TestAttackFns:
    def test_registry_mirrors_config_and_reference(self):
        assert set(adv.ATTACK_FNS) == set(ATTACKS) - {"none"}
        assert set(adv.ATTACK_FNS) == set(jadv.ATTACK_FNS)
        assert adv._SEED_SALT == jadv._SEED_SALT

    @pytest.mark.parametrize("name,kw", DETERMINISTIC)
    def test_deterministic_attacks_on_trees_bitwise(self, name, kw):
        rng = np.random.default_rng(0)
        got = adv.ATTACK_FNS[name](ttree(1), rng, **kw)
        want = jadv.ATTACK_FNS[name](jtree(1), np.random.default_rng(0), **kw)
        leaves_bitwise(got, want)

    @pytest.mark.parametrize("mode", ["int8", "bf16"])
    @pytest.mark.parametrize("name,kw", DETERMINISTIC)
    def test_deterministic_attacks_on_wire_bitwise(self, name, kw, mode):
        got = adv.ATTACK_FNS[name](twire(mode, 2), None, **kw)
        want = jadv.ATTACK_FNS[name](jwire(mode, 2), None, **kw)
        assert tc.is_compressed(got)
        wire_bitwise(got, want)

    @pytest.mark.parametrize("noise_scale", [10.0, 0.5])
    def test_gaussian_noise_on_trees(self, noise_scale):
        """One normal draw per leaf in jax's leaf order from the same
        stream: leaf by leaf within rtol 1e-6, and the streams end in the
        same state."""
        r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
        got = adv.ATTACK_FNS["gaussian-noise"](ttree(3), r1,
                                               noise_scale=noise_scale)
        want = jadv.ATTACK_FNS["gaussian-noise"](jtree(3), r2,
                                                 noise_scale=noise_scale)
        assert pt.tree_structure(got) == pt.tree_structure(ttree(3))
        for a, b in zip(jax.tree.leaves(want), pt.tree_leaves(got)):
            assert b.dtype == torch.float32 and b.shape == np.shape(a)
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-8)
        assert r1.bit_generator.state == r2.bit_generator.state

    def test_gaussian_noise_follows_leaf_order(self):
        """The first leaf in jax's order ("a"[0], not the first inserted,
        "z") takes the stream's first draws."""
        got = adv.ATTACK_FNS["gaussian-noise"](ttree(3),
                                               np.random.default_rng(5))
        noise_first = (pt.tree_leaves(got)[0]
                       - pt.tree_leaves(ttree(3))[0]).numpy().ravel()
        rng = np.random.default_rng(5)
        first = rng.normal(0.0, 1.0, noise_first.shape)
        corr = np.corrcoef(noise_first, first)[0, 1]
        assert corr > 0.99

    @pytest.mark.parametrize("mode", ["int8", "bf16"])
    def test_gaussian_noise_on_wire_bitwise(self, mode):
        r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
        got = adv.ATTACK_FNS["gaussian-noise"](twire(mode, 4), r1)
        want = jadv.ATTACK_FNS["gaussian-noise"](jwire(mode, 4), r2)
        wire_bitwise(got, want)
        assert r1.bit_generator.state == r2.bit_generator.state


class TestAdversary:
    @pytest.mark.parametrize("frac,clients,seed,onset", [
        (0.2, 10, 0, 0), (0.5, 7, 3, 0), (0.3, 32, 11, 2), (1.0, 4, 1, 1)])
    def test_same_cohort_and_applications(self, frac, clients, seed, onset):
        kw = dict(attack="scale", attack_frac=frac, num_clients=clients,
                  attack_params=(("boost", 2.0), ("onset", float(onset))))
        port = adv.make_adversary(FedConfig(**kw), seed=seed)
        ref = jadv.make_adversary(JFedConfig(**kw), seed=seed)
        d = ttree(0)
        jd = jtree(0)
        for step in range(3 * clients):
            cid = (7 * step) % clients
            got = port.corrupt(ClientUpdate(cid, 1, 5, d))
            want = ref.corrupt(JUpdate(cid, 1, 5, jd))
            leaves_bitwise(got.delta, want.delta)
            assert (got.delta is d) == (want.delta is jd)
        assert port.stats() == ref.stats()
        assert port.stats()["applied"] > 0
        assert port.onset == onset

    def test_onset_keeps_first_emissions_honest(self):
        fed = FedConfig(attack="sign-flip", attack_frac=1.0, num_clients=2,
                        attack_params=(("onset", 2.0),))
        a = adv.make_adversary(fed, seed=0)
        d = ttree(0)
        out = [a.corrupt(ClientUpdate(0, 1, 5, d)).delta is d
               for _ in range(4)]
        assert out == [True, True, False, False] and a.applied == 2

    @pytest.mark.parametrize("kw", [dict(), dict(attack="scale"),
                                    dict(attack_frac=0.3),
                                    dict(attack="zero", attack_frac=0.04)])
    def test_benign_configs_build_none(self, kw):
        """No attack, a zero fraction, or one that rounds to no client."""
        assert adv.make_adversary(FedConfig(**kw), seed=0) is None
        assert jadv.make_adversary(JFedConfig(**kw), seed=0) is None


# ------------------------------------------------------ attacked runs --
def _key(history):
    return [(r.iteration, r.client_id, r.lag, r.k_used, r.k_next, r.screen)
            for r in history]


def parity(task, ttask, fed, max_updates, algorithm="asyncfeded"):
    jsim = JSim(task, fed, algorithm, seed=0)
    init = jax.tree.map(np.asarray, jsim.server.params)
    jres = jsim.run(max_time=1e9, max_updates=max_updates)
    tsim = FederatedSimulation(ttask, fed, algorithm, seed=0, device="cpu",
                               init_params=params_from_numpy(init,
                                                             device="cpu"))
    sizes = []
    if tsim.server.is_async:
        drain = tsim.server.on_update_batch
        tsim.server.on_update_batch = (
            lambda ups: sizes.append(len(ups)) or drain(ups))
    tres = tsim.run(max_time=1e9, max_updates=max_updates)
    assert _key(tres.history) == _key(jres.history)
    assert (tres.total_updates, tres.total_drains) == (jres.total_updates,
                                                       jres.total_drains)
    assert tres.attack == jres.attack and tres.attack["applied"] > 0
    if jres.screen is None:
        assert tres.screen is None
    else:
        # verdict counts exactly; the norm EWMA is summed in another order
        assert tres.screen.keys() == jres.screen.keys()
        for k, v in jres.screen.items():
            if isinstance(v, float):
                assert tres.screen[k] == pytest.approx(v, rel=1e-4), k
            else:
                assert tres.screen[k] == v, k
    np.testing.assert_allclose([p.accuracy for p in tres.points],
                               [p.accuracy for p in jres.points], atol=0.01)
    assert tres.summary()["attack"] == jres.summary()["attack"]
    assert "attack" in tres.to_json()
    return tres, sizes


@pytest.mark.parametrize("backend", ["pallas", "pytree"])
def test_sign_flip_screened_paper_run(backend):
    """SYNTHETIC_1_1 (paper behavior, window 0), 20% sign-flip, reject
    screening, 30 updates: the same trace and the same verdicts."""
    fed = dataclasses.replace(C.SYNTHETIC_1_1.fed, backend=backend,
                              attack="sign-flip", attack_frac=0.2,
                              screen="reject")
    tres, sizes = parity(C.SYNTHETIC_1_1, TC.SYNTHETIC_1_1, fed, 30)
    assert set(sizes) == {1}
    assert tres.screen["reject"] > 0


def test_sign_flip_screened_burst_drain():
    """SYNTHETIC_BURST (loop engine, auto window, flat server), 20%
    sign-flip, reject screening: the attacked deltas reach the batched
    drain's screen (decide_batch), and its verdicts equal the
    reference's."""
    fed = dataclasses.replace(C.SYNTHETIC_BURST.fed, client_engine="loop",
                              attack="sign-flip", attack_frac=0.2,
                              screen="reject")
    tres, sizes = parity(C.SYNTHETIC_BURST, TC.SYNTHETIC_BURST, fed, 60)
    assert max(sizes) >= 2
    assert tres.screen["reject"] > 0


@pytest.mark.parametrize("algorithm,change", [
    ("asyncfeded", dict(backend="pallas", delta_compression="int8",
                        attack="gaussian-noise")),
    ("fedasync+constant", dict(attack="zero", screen="clip")),
    ("fedavg", dict(attack="gaussian-noise")),
])
def test_other_attacked_runs(algorithm, change):
    """int8 wire noise through the int8 sweeps, a free-rider under FedAsync
    with clipping, and noise in synchronous rounds."""
    fed = dataclasses.replace(C.SYNTHETIC_1_1.fed, attack_frac=0.2, **change)
    parity(C.SYNTHETIC_1_1, TC.SYNTHETIC_1_1, fed,
           10 if algorithm == "fedavg" else 30, algorithm)
