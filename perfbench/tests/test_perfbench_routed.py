"""A model that routes tokens to experts is judged against the program's own
expert choices: the reference follows the indices the program recorded
(``perfbench/tap.py``, ``perfbench/reference/route.py``) and judges them
by ``route_gap`` and ``route_errors``.

The model is an attention + MoE decoder, planted as
``perfbench.reference.<toy>`` in ``sys.modules`` only: its reference a
plain softmax top-2-of-8 SwiGLU MoE, its port ``qwen3-moe-30b-a3b`` at tiny
widths with the exact dropless ``dense`` MoE, no aux loss and no shared
expert. Program-side plants exchange the scores of a token's k-th and
(k+1)-th experts before the program chooses, so that it routes them the
other way round: within the tolerance the follow absorbs the flip, beyond
it ``route_errors`` counts it."""
import sys
import time
import types

import pytest
import torch

from perfbench import bench, control, judge, tap, weights
from perfbench.reference import danube
from perfbench.reference import route as routing
from perfbench.reference.ops import rmsnorm, silu
from perfbench.runners import fedtrain
from perfbench.tests import tiny

TOY = "planted_moe"
CFG = {"name": "tiny-moe", "port_arch": "qwen3-moe-30b-a3b",
       "reference": TOY, "family": "moe", "num_layers": 2, "d_model": 32,
       "num_heads": 4, "num_kv_heads": 2, "head_dim": 8, "d_ff": 16,
       "vocab_size": 96, "sliding_window": 0, "rope_theta": 10000.0,
       "tie_embeddings": False, "norm": "rmsnorm", "dtype": "float32",
       "moe": {"num_experts": 8, "num_experts_per_tok": 2,
               "expert_d_ff": 16, "num_shared_experts": 0, "impl": "dense",
               "router_aux_loss_coef": 0.0}}
#: route_gap between the program's 1.1e-7-2.9e-7 and the TF32 control's
#: 1.0e-4-1.4e-4 on the CPU
LIMITS = dict(tiny.TRAIN_LIMITS, route_gap=2e-5, route_errors=0)
SEED = 2 ** 31 + 10
TOL = LIMITS["route_gap"]


def _leaf_specs(cfg):
    m, d = cfg["moe"], cfg["d_model"]
    e, f = m["num_experts"], m["expert_d_ff"]
    block = {k: v for k, v in weights.attn_specs(cfg).items()
             if k[0] != "ffn"}
    block.update({("ffn", "router"): ((d, e), "normal"),
                  ("ffn", "wi_gate"): ((e, d, f), "normal"),
                  ("ffn", "wi_up"): ((e, d, f), "normal"),
                  ("ffn", "wo"): ((e, f, d), "normal")})
    return weights.outer_specs(cfg) + weights.stacked(0, "attn", block,
                                                      cfg["num_layers"])


def _moe(p, h, cfg, prec, choose):
    m = cfg["moe"]
    b, s, d = h.shape
    x = h.reshape(b * s, d)
    scores = torch.softmax(prec.mm(x, p["router"]), dim=-1)
    idx = choose(scores, m["num_experts_per_tok"])
    w = torch.gather(scores, -1, idx)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(m["num_experts"]):
        gate = torch.sum(w * (idx == e), dim=-1, keepdim=True)
        act = silu(prec.mm(x, p["wi_gate"][e])) * prec.mm(x, p["wi_up"][e])
        y = y + gate * prec.mm(act, p["wo"][e])
    return y.reshape(b, s, d)


def _forward(params, tokens, cfg, prec, route=None):
    choose = route or routing.top_k
    x = params["embed"]["tok"][tokens.long()]
    blocks = params["layers"]["b0_attn"]
    for i in range(cfg["num_layers"]):
        p = {k: {n: t[i] for n, t in v.items()} for k, v in blocks.items()}
        x = x + danube.attention(p["attn"], rmsnorm(x, p["norm1"]["scale"]),
                                 cfg, prec)
        x = x + _moe(p["ffn"], rmsnorm(x, p["norm2"]["scale"]), cfg, prec,
                     choose)
    return prec.mm(rmsnorm(x, params["final_norm"]["scale"]),
                   params["head"]["out"])


@pytest.fixture(autouse=True, scope="module")
def _planted():
    ref = types.ModuleType(f"perfbench.reference.{TOY}")
    ref.leaf_specs, ref.forward = _leaf_specs, _forward
    sys.modules[ref.__name__] = ref
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    del sys.modules[ref.__name__]


def _cell(limits=LIMITS):
    cell = tiny.fedtrain_cell(CFG)
    cell.limits = dict(limits)
    return cell


def _twin_draw(draw):
    """Expert 1's router column a hair above expert 0's: the two score
    within rounding of each other on every token."""
    def twin(cfg, seed, device):
        flat, tree = draw(cfg, seed, device)
        r = tree["layers"]["b0_attn"]["ffn"]["router"]
        r[..., 1] = r[..., 0] * (1 + 1e-5)
        return flat, tree
    return twin


def _exchange(lo, hi):
    """A plant over the tap: where a token's k-th and (k+1)-th scores differ
    by [lo, hi) of its largest, the values of the program's scores of the
    two experts are exchanged before it chooses, so that it routes them the
    other way round."""
    install = tap.Tap.install

    def planted_install(self):
        install(self)
        from repro_torch.models import moe
        choose = moe.top_k

        def exchanged(scores, k):
            vals, order = torch.sort(scores, dim=-1, descending=True,
                                     stable=True)
            a, b = order[..., k - 1:k], order[..., k:k + 1]
            va, vb = vals[..., k - 1:k], vals[..., k:k + 1]
            rel = (va - vb) / vals[..., :1]
            hit = (rel >= lo) & (rel < hi)
            e = torch.arange(scores.shape[-1], device=scores.device)
            new = torch.where(hit & (e == a), vb,
                              torch.where(hit & (e == b), va, scores))
            # each expert's gradient still reaches its own score
            return choose(scores + (new - scores).detach(), k)
        moe.top_k = exchanged
    return planted_install


def _run(monkeypatch, plant=None, twins=False):
    if twins:
        monkeypatch.setattr(weights, "draw", _twin_draw(weights.draw))
    if plant is not None:
        monkeypatch.setattr(tap.Tap, "install", plant)
    return fedtrain.execute(_cell(), SEED, 0.0, False, "cpu")


def _judge(p, **kw):
    checks, _ = judge.fedtrain(CFG, p.ctx.traffic, SEED, p.device, p.drains,
                               p.setup_drains, p.history, p.captured, LIMITS,
                               **kw)
    return checks


def _failed(checks):
    return sorted(k for k, (v, lim) in checks.items() if not v <= lim)


@pytest.fixture(scope="module")
def readings():
    """The program and its TF32 control, as ``control.py`` reads them."""
    it = control.fedtrain_readings(_cell(), SEED, "cpu")
    return dict(next(it) for _ in range(2))


def test_port_is_judged_correct_with_no_route_errors(readings):
    checks = readings["program"]
    assert bench.correct(checks), checks
    assert checks["route_errors"][0] == 0
    assert 0 < checks["route_gap"][0] < TOL


def test_tf32_control_reads_incorrect(readings):
    assert _failed(readings["tf32"]), readings["tf32"]


@pytest.fixture(scope="module")
def near_tie_swaps():
    """One run with every sub-tolerance near tie swapped, judged with the
    follow and without it."""
    mp = pytest.MonkeyPatch()
    try:
        p = _run(mp, _exchange(0.0, 0.5 * TOL), twins=True)
        return {"follow": _judge(p), "own": _judge(p, follow_routes=False)}
    finally:
        mp.undo()


def test_swap_within_tolerance_is_followed(near_tie_swaps):
    checks = near_tie_swaps["follow"]
    assert bench.correct(checks), checks
    assert checks["route_errors"][0] == 0


def test_swap_within_tolerance_fails_without_the_follow(near_tie_swaps):
    checks = near_tie_swaps["own"]
    assert "delta_gap" in _failed(checks), checks
    assert checks["route_errors"][0] == 0


def test_swap_beyond_tolerance_is_a_route_error(monkeypatch):
    checks = _judge(_run(monkeypatch, _exchange(4 * TOL, 2.0)))
    assert checks["route_errors"][0] > 0, checks


@pytest.mark.parametrize("missing", routing.CHECKS)
def test_limits_without_the_route_checks_are_refused(missing):
    limits = {k: v for k, v in LIMITS.items() if k != missing}
    with pytest.raises(ValueError, match=missing):
        fedtrain.run(_cell(limits), SEED, 0.0, False, "cpu", time.time())
    with pytest.raises(ValueError, match=missing):
        judge.fedtrain(CFG, _cell().traffic, SEED, "cpu", [], 0, [], {},
                       limits)


def _tapped_moe(t):
    """The port's MoE forward of the tiny model with ``t`` in place of its
    ``top_k`` (or the port's own with None), and its parameters."""
    from repro_torch.models import moe
    pc = fedtrain.port_config(CFG)
    _, tree = weights.draw(CFG, SEED, "cpu")
    p = {k: v[0] for k, v in tree["layers"]["b0_attn"]["ffn"].items()}
    saved = moe.top_k
    if t is not None:
        t.install()

    def fwd(p, x):
        return moe.moe_fwd(p, x, pc)[0]
    return fwd, p, (lambda: setattr(moe, "top_k", saved))


def test_tap_changes_no_bit_of_values_or_gradients():
    x = torch.randn(4, 2, 8, 32, generator=torch.Generator().manual_seed(5))

    def grads(t):
        fwd, p, restore = _tapped_moe(t)
        try:
            loss = lambda q, xi: torch.sum(fwd(q, xi) ** 2)
            return torch.func.vmap(torch.func.grad_and_value(loss),
                                   in_dims=(None, 0))(p, x)
        finally:
            restore()
    plain = grads(None)
    t = tap.Tap(lambda: 4)
    t.recording, t.per_forward = True, 1
    t.fanout([(c, 0, 1) for c in range(4)])
    tapped = grads(t)
    t.done()
    assert torch.equal(plain[1], tapped[1])
    for k in plain[0]:
        assert torch.equal(plain[0][k], tapped[0][k]), k
    assert sorted(t.records) == [(("train", c, 0, 0), 0) for c in range(4)]


def test_routed_pairs_are_the_recorded_choices():
    """Recording through an evaluation and two two-client fan-outs of the
    cohort layout (vmapped): the recorded (token, choice) pairs per expert
    equal those the port's own ``top_k`` chooses, client by client, with
    no tap; a fan-out of K 2 and 1 drops its padded step."""
    from repro_torch.models import moe
    t = tap.Tap(lambda: 2)
    t.recording = True
    fwd, p, restore = _tapped_moe(t)
    gen = torch.Generator().manual_seed(6)
    vfwd = torch.func.vmap(fwd, in_dims=(None, 0))
    ev = torch.randn(2, 8, 32, generator=gen)
    fans = [([(3, 0, 2), (1, 4, 2)], [2, 2]), ([(5, 1, 2), (6, 0, 1)], [2, 1])]
    xs = [[torch.randn(2, 2, 8, 32, generator=gen) for _ in range(2)]
          for _ in fans]
    try:
        t.evaluation(0)
        fwd(p, ev)
        t.done()
        for (jobs, _), x in zip(fans, xs):
            t.fanout(jobs)
            for xi in x:
                vfwd(p, xi)
            t.done()
    finally:
        restore()
    assert t.per_forward == 1
    assert len(t.records) == 8
    assert (("train", 6, 0, 1), 0) not in t.records

    def count(pairs):
        n = torch.zeros(8, dtype=torch.int64)
        for idx in pairs:
            n += torch.bincount(idx.reshape(-1), minlength=8)
        return n
    own = []
    choose = moe.top_k

    def seen(scores, k):
        out = choose(scores, k)
        own.append(out[1])
        return out
    moe.top_k = seen
    try:
        fwd(p, ev)
        for (jobs, ks), x in zip(fans, xs):
            for s, xi in enumerate(x):
                for row, k in enumerate(ks):
                    if s < k:
                        fwd(p, xi[row])
    finally:
        moe.top_k = choose
    assert len(own) == 8
    assert torch.equal(count(idx for _, idx in t.records.values()),
                       count(own))
    assert int(count(own).sum()) == 8 * 16 * 2


def _silent(monkeypatch, program: bool):
    """A reference whose forward ignores the callback; with ``program`` the
    program's choices are not recorded either (as if it chose elsewhere
    than through ``moe.top_k``)."""
    mod = sys.modules[f"perfbench.reference.{TOY}"]
    monkeypatch.setattr(mod, "forward",
                        lambda params, tokens, cfg, prec, route=None:
                        _forward(params, tokens, cfg, prec))
    if program:
        monkeypatch.setattr(tap.Tap, "install", lambda self: None)


@pytest.mark.parametrize("program", [False, True],
                         ids=["reference", "reference-and-program"])
def test_routing_left_unfollowed_is_a_route_error(monkeypatch, program):
    _silent(monkeypatch, program)
    checks = _judge(_run(monkeypatch))
    assert checks["route_errors"][0] > 0, checks
    assert not bench.correct(checks)
