"""The federation of a training cell, followed by the reference through the
drains of its set-up.

Every client downloads the initial model and trains its first round from
it; the server then drains the updates in the groups and the order that
the run's drains took (which clients arrived together is the program's
event trace, and the reference reads it to judge it); each drained client
trains its next round from the model of its reply, with the momentum it
carried and the K the rule handed it, where a later drain followed here
needs it. The inputs are the benchmark's own: the weights of
:mod:`perfbench.weights` and the streams of :mod:`perfbench.feed`, made
again from the seed.

A model that routes tokens to experts follows the program's choices
(:mod:`perfbench.reference.route`): each forward followed is labelled as
the program's tap labels it, ``("eval", 0)`` for the evaluation at x_1 and
``("train", client, round, step)`` for a local step.
"""
from __future__ import annotations

import dataclasses
import importlib
import itertools
from typing import Callable, Dict, List, Optional

import torch

from perfbench import feed, weights
from perfbench.reference import client as client_mod
from perfbench.reference import route as route_mod
from perfbench.reference.ops import Precision, cross_entropy
from perfbench.reference.rule import Record, RuleParams, Server

Leaves = Dict[tuple, torch.Tensor]


def model_forward(cfg: dict, prec: Precision,
                  router: Optional[route_mod.Follow] = None) -> Callable:
    """The reference model's forward; a routed model's takes ``router``."""
    mod = importlib.import_module(f"perfbench.reference.{cfg['reference']}")
    if router is None:
        return lambda tree, tokens: mod.forward(tree, tokens, cfg, prec)
    return lambda tree, tokens: mod.forward(tree, tokens, cfg, prec,
                                            route=router)


def leaf_norms(leaves: Leaves) -> Dict[tuple, float]:
    return {k: float(torch.linalg.vector_norm(v, dtype=torch.float64))
            for k, v in leaves.items()}


def norm(d: Leaves) -> float:
    """The norm over every leaf, summed in float64."""
    return sum(float(torch.linalg.vector_norm(v, dtype=torch.float64)) ** 2
               for v in d.values()) ** 0.5


def dist(a: Leaves, b: Leaves) -> float:
    return norm({k: a[k] - b[k] for k in a})


def first_gradient(delta: Leaves, momentum: Leaves, lr: float) -> Leaves:
    """A round of two steps' first gradient, worked out from the state
    after it: with m_1 = g_1 and m_2 = beta g_1 + g_2, the change is
    -lr (m_1 + m_2), so g_1 = -delta / lr - m_2. The program's side is
    worked out the same way, so both carry the same rounding of the
    change."""
    return {k: -delta[k] / lr - momentum[k] for k in delta}


def step(x: Leaves, eta: float, d: Leaves) -> Leaves:
    return {k: x[k] + eta * d[k] for k in x}


@dataclasses.dataclass
class Followed:
    eval_loss: float
    #: per-leaf norms of the delta of each round trained, per (client,
    #: round: 0 for the first)
    delta_norms: Dict[tuple, Dict[tuple, float]]
    #: per client: per-leaf norms of its first gradient (:func:`first_gradient`)
    grad1_norms: Dict[int, Dict[tuple, float]]
    records: List[Record]
    #: per update followed: (snapshot iteration, K) of the round it carries
    rounds: List[tuple]
    #: per-leaf norms of the global model's change over the drains followed
    change_norms: Dict[tuple, float]
    #: a routed model's router callback, with what it measured and, where
    #: the reference routed by itself, the choices it made
    router: Optional[route_mod.Follow] = None


def follow(cfg: dict, traffic: dict, seed: int, drains: List[List[int]],
           device, prec: str = "f32", rows: Optional[int] = None,
           k_of: Optional[Callable] = None,
           routes: Optional[route_mod.Records] = None,
           route_limit: float = 0.0, follow_routes: bool = True) -> Followed:
    """Follow the seeding fan-out and ``drains`` (each a list of client ids
    in drain order). ``rows`` trains on the first rows of each batch only
    (a fault planted in the reference); ``k_of`` is passed to the rule.
    A routed model follows ``routes``, the program's recorded choices, and
    judges them against ``route_limit``; with no ``routes`` it routes by
    itself and hands its choices back. ``follow_routes=False`` routes by
    itself while judging (a check that the follow matters)."""
    fed = traffic["fed"]
    router = None
    if route_mod.routes(cfg):
        router = route_mod.Follow(routes, route_limit, follow_routes)
    fwd = model_forward(cfg, Precision(prec), router)

    def labelled(label) -> Callable:
        """The forward with each call labelled ``label + (step,)``."""
        steps = itertools.count()

        def call(tree, tokens):
            if router is not None:
                router.begin(label + (next(steps),))
            return fwd(tree, tokens)
        return call

    _, tree = weights.draw(cfg, seed, device)
    x1 = weights.leaves(tree)
    streams = [feed.client_stream(seed, c, cfg, traffic)
               for c in range(fed["num_clients"])]

    def batch(stream):
        toks, labels = stream.next()
        pair = (torch.as_tensor(toks["tokens"], device=device),
                torch.as_tensor(labels, device=device))
        return pair if rows is None else (pair[0][:rows], pair[1][:rows])

    with torch.no_grad():
        ev = batch(feed.eval_stream(seed, cfg, traffic))
        eval_loss = float(cross_entropy(labelled(("eval",))(tree, ev[0]),
                                        ev[1]))
    server = Server(x1, RuleParams.of(fed), dist, norm, step)
    momentum: Dict[int, Optional[Leaves]] = {}
    pending = {c: (x1, 1, fed["k_initial"]) for c in range(len(streams))}
    trained: Dict[int, tuple] = {}
    out = Followed(eval_loss, {}, {}, [], [], {})

    def train(c: int) -> None:
        x, it, k = pending[c]
        n = sum(key[0] == c for key in out.delta_norms)
        delta, momentum[c] = client_mod.local_round(
            labelled(("train", c, n)), x, momentum.get(c),
            [batch(streams[c]) for _ in range(k)],
            fed["local_lr"], fed["local_momentum"])
        out.delta_norms[(c, n)] = leaf_norms(delta)
        if n == 0:
            out.grad1_norms[c] = leaf_norms(first_gradient(
                delta, momentum[c], fed["local_lr"]))
        trained[c] = (it, k, delta)

    for c in range(len(streams)):
        train(c)
    for i, drain in enumerate(drains):
        ups = []
        for c in drain:
            it, k, delta = trained.pop(c)
            ups.append((c, it, delta))
            out.rounds.append((it, k))
        recs = server.drain(ups, k_of)
        out.records += recs
        later = {c for d in drains[i + 1:] for c in d}
        for c, r in zip(drain, recs):
            pending[c] = (server.x, server.t, r.k_next)
            if c in later:
                train(c)
    out.change_norms = leaf_norms({k: server.x[k] - x1[k] for k in x1})
    if router is not None:
        router.finish()
        out.router = router
    return out
