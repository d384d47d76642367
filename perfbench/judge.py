"""The comparison that decides ``correct``.

Each number compared is a gap between what the program produced and what
the plain reference (:mod:`perfbench.reference`) works out from the same
inputs, with a limit from the cell's ``perfbench/limits/<cell>.json``.

Norms are compared leaf by leaf: the gap of a leaf is
``| ||program|| - ||reference|| |`` over the larger of the reference's norm
of that leaf and of the median leaf, and a number is its worst leaf. A leaf
whose first gradient in the reference is under a thousandth of the median
leaf's is left out (its change is round-off alone).

An integer of the event trace (iteration, client, lag, the snapshot and K
of the round an update carries) must equal the reference's. A K the server
hands back must equal Eq. 8 applied to the server's own gamma; the server's
gamma is held to the reference's by ``rule_gap``, so where the two gammas
straddle a step of the floor within that gap the program's K stands, and
the reference continues from it.

In a training cell the reference follows the set-up's drains; every update
of the run, the window's too, is also checked on its own
(:func:`run_errors`, and eta against Eq. 7 on the program's gamma in
``rule_gap``). A model that routes tokens to experts follows the program's
recorded choices and is judged on them (``route_gap``, ``route_errors``:
:mod:`perfbench.reference.route`); its limits file has to list both, or
the cell is refused.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Tuple

from perfbench.reference import federation, route
from perfbench.reference.rule import RuleParams, k_next

TINY = 1e-12


def _rel(p: float, r: float) -> float:
    if not (math.isfinite(p) and math.isfinite(r)):
        return math.inf if (math.isfinite(p) != math.isfinite(r)
                            or p != p) else 0.0
    if abs(p) <= TINY and abs(r) <= TINY:
        return 0.0
    return abs(p - r) / max(abs(r), TINY)


def kept_leaves(grad1: Dict[tuple, float]) -> List[tuple]:
    med = statistics.median(grad1.values())
    return [k for k, v in grad1.items() if v >= 1e-3 * med]


def leaf_gap(prog: Dict[tuple, float], ref: Dict[tuple, float],
             keep: List[tuple]) -> float:
    med = statistics.median(ref[k] for k in keep)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, TINY) for k in keep)


def rule_gap(prog_records, ref_records) -> float:
    """Largest relative gap of gamma and of eta over the updates."""
    gap = 0.0
    for p, r in zip(prog_records, ref_records):
        gap = max(gap, _rel(p.gamma, r.gamma), _rel(p.eta, r.eta))
    return gap


class KJudge:
    """Checks each K the program hands back against Eq. 8 on the program's
    own gamma, and lets the reference continue from the program's K where
    the two gammas sit within ``tolerance`` of each other."""

    def __init__(self, prog_records, rp: RuleParams, tolerance: float):
        self.prog = list(prog_records)
        self.rp, self.tol = rp, tolerance
        self.k: Dict[int, int] = {}
        self.i = 0
        self.errors = 0

    def __call__(self, client: int, gamma: float, k_rule: int) -> int:
        if self.i >= len(self.prog):
            self.errors += 1
            return k_rule
        p = self.prog[self.i]
        self.i += 1
        k_prev = self.k.get(client, self.rp.k_initial)
        consistent = p.k_next == k_next(k_prev, p.gamma, self.rp)
        self.k[client] = p.k_next
        if p.k_next == k_rule:
            self.errors += 0 if consistent else 1
            return k_rule
        if consistent and _rel(p.gamma, gamma) <= self.tol:
            return p.k_next
        self.errors += 1
        self.k[client] = k_rule
        return k_rule


def eta_gap(history, rp: RuleParams) -> float:
    """Largest relative gap of each update's eta from Eq. 7 on its own
    gamma."""
    gap = 0.0
    for h in history:
        g = (min(h.gamma, rp.staleness_cap) if rp.staleness_cap > 0
             else h.gamma)
        gap = max(gap, _rel(h.eta, rp.lam / (g + rp.eps)))
    return gap


def run_errors(drains, history, rp: RuleParams) -> int:
    """Integers of every update of a run, checked on their own: one record
    per upload drained, in the drains' order; the iterations consecutive;
    each lag the iteration before the update less its snapshot; each upload
    carrying the iteration and K of its client's last reply (the initial
    model's iteration 1 and K initial before the first); each K Eq. 8 on
    the server's gamma from the client's previous K."""
    flat = [u for d in drains for u in d]
    bad = abs(len(flat) - len(history))
    reply: Dict[int, tuple] = {}
    i, it = 0, 1
    for d in drains:
        recs = history[i:i + len(d)]
        i += len(d)
        for (c, snap, k_used), h in zip(d, recs):
            it += 1
            last = reply.get(c, (1, rp.k_initial))
            bad += ((h.client_id, h.iteration, h.lag)
                    != (c, it, it - 1 - snap))
            bad += (snap, k_used) != last
            bad += h.k_next != k_next(last[1], h.gamma, rp)
        for (c, _, _), h in zip(d, recs):
            reply[c] = (recs[-1].iteration, h.k_next)
    return bad


def trace_errors(prog_records, ref_records) -> int:
    """Updates whose (iteration, client, lag) differ, and updates missing
    on either side."""
    bad = sum((p.iteration, p.client_id, p.lag)
              != (r.iteration, r.client_id, r.lag)
              for p, r in zip(prog_records, ref_records))
    return bad + abs(len(prog_records) - len(ref_records))


def fedtrain(cfg: dict, traffic: dict, seed: int, device, drains,
             setup_drains: int, history, captured: dict, limits: dict,
             prec: str = "f32", rows=None, follow_routes: bool = True,
             notes: Optional[list] = None) -> Tuple[Dict[str, tuple], int]:
    """The numbers of a training cell: the reference follows the seeding
    fan-out and the set-up's first ``setup_drains`` drains (``drains``: the
    clients of each drain of the run, with the snapshot and K they
    carried, as the program's server got them). ``prec`` and ``rows`` put
    the control or a fault in the reference's place of the program (see
    ``perfbench/control.py``). Every update of the run, the window's too,
    must carry a finite gamma and delta norm and pass :func:`run_errors`
    and Eq. 7. A routed model's reference follows ``captured["routes"]``,
    the program's expert choices (``follow_routes=False``: its own, to
    show that the follow matters), and says in ``notes`` how many tokens it
    followed and how many of them it would have routed otherwise."""
    route.require_checks(cfg, limits)
    routes = captured["routes"] if route.routes(cfg) else None
    followed = drains[:setup_drains]
    n_upd = sum(len(d) for d in followed)
    prog = history[:n_upd]
    rp = RuleParams.of(traffic["fed"])
    kj = KJudge(prog, rp, limits["rule_gap"])
    ref = federation.follow(cfg, traffic, seed, [[c for c, _, _ in d]
                                                for d in followed],
                            device, prec=prec, rows=rows, k_of=kj,
                            routes=routes,
                            route_limit=limits.get("route_gap", 0.0),
                            follow_routes=follow_routes)
    if ref.router is not None and notes is not None:
        notes.append(f"info: routes followed for {ref.router.tokens} routed "
                     f"tokens, {ref.router.flips} of them routed otherwise "
                     f"by the reference alone")
    checks, errors = fedtrain_numbers(
        captured, followed, prog, ref, kj.errors + run_errors(
            drains, history, rp), limits)
    rule = max(checks["rule_gap"][0], eta_gap(history, rp))
    checks["rule_gap"] = (rule, limits["rule_gap"])
    bad = sum(not (math.isfinite(h.gamma) and math.isfinite(h.delta_norm))
              for h in history)
    checks["nonfinite_updates"] = (float(bad), limits["nonfinite_updates"])
    return checks, errors + bad


def fedtrain_numbers(captured: dict, followed, prog, ref, k_errors: int,
                     limits: dict) -> Tuple[Dict[str, tuple], int]:
    keep = sorted(set.intersection(*(set(kept_leaves(g)) for g in
                                     ref.grad1_norms.values())))
    grad1 = max(leaf_gap(captured["grad1"][c], ref.grad1_norms[c], keep)
                for c in ref.grad1_norms)
    delta = max(leaf_gap(captured["delta"][r], ref.delta_norms[r], keep)
                for r in ref.delta_norms)
    change = leaf_gap(captured["change"], ref.change_norms, keep)
    rounds = [(s, k) for d in followed for _, s, k in d]
    errors = (trace_errors(prog, ref.records) + k_errors
              + sum(a != b for a, b in zip(rounds, ref.rounds)))
    numbers = {
        "eval_loss_gap": _rel(captured["eval_loss"], ref.eval_loss),
        "grad1_gap": grad1,
        "delta_gap": delta,
        "change_gap": change,
        "rule_gap": rule_gap(prog, ref.records),
        "trace_errors": float(errors),
    }
    if all(c in limits for c in route.CHECKS):
        r = ref.router
        numbers["route_gap"] = 0.0 if r is None else r.gap
        numbers["route_errors"] = 0.0 if r is None else float(r.errors)
    return {k: (v, limits[k]) for k, v in numbers.items()}, errors


def server_uploads(cfg: dict, traffic: dict, seed: int, device, drains,
                   history, final: dict, limits: dict):
    """The numbers of a server cell: the reference follows every update in
    the pool's coefficients (``drains``: per drain, each upload with the
    iteration and K of its reply). Returns (checks, errors, ring clamps)."""
    import torch

    from perfbench import weights
    from perfbench.reference import pooled

    flat, tree = weights.draw(cfg, seed, device)
    x1_norm = float(torch.linalg.vector_norm(flat, dtype=torch.float64))
    pool = weights.draw_pool(seed, traffic["pool"], flat.numel(),
                             traffic["delta_ratio"] * x1_norm, device)
    rp = RuleParams.of(traffic["fed"])
    kj = KJudge(history, rp, limits["rule_gap"])
    srv = pooled.server(pooled.gram(pool), rp)
    ref, reply_errors = [], 0
    for d in drains:
        recs = srv.drain([(u.client, u.snapshot, u.delta) for u, _, _ in d],
                         kj)
        reply_errors += sum((it, k) != (srv.t, r.k_next)
                            for (_, it, k), r in zip(d, recs))
        ref += recs
    gap = pooled.model_gap(final, weights.leaves(tree),
                           [weights.leaves(weights.carve(cfg, row))
                            for row in pool], srv.x)
    errors = trace_errors(history, ref) + kj.errors + reply_errors
    numbers = {"rule_gap": rule_gap(history, ref), "model_gap": gap,
               "trace_errors": float(errors)}
    return ({k: (v, limits[k]) for k, v in numbers.items()}, errors,
            srv.clamps)
