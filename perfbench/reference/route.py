"""Top-k routing in the reference, following the program's expert choices.

Top-k routing is discontinuous: where two experts' scores lie within
rounding of each other, the program and the reference, which compute the
same float32 arithmetic in different orders, may choose differently, and a
single such flip moves a whole row of an expert's gradient. So the
reference does not choose for itself where it follows a run: a routed
layer of a reference model computes its own scores and hands them, with
its ``k``, to a callback (:class:`Follow`), which returns the indices the
program chose for the same forward and layer. The routing weights are
still gathered from the reference's own scores, so what is compared
downstream is arithmetic only. The callback judges the choices it hands
out:

* ``route_gap``: the largest ``|s_prog - s_ref|`` of a routed token, over
  the largest ``|s_ref|`` in its row, over every token and layer followed;
* ``route_errors``: tokens whose recorded indices are not the top-k of the
  recorded scores (ties to the lower index), and tokens whose indices are
  not a top-k of the reference's scores to within twice the ``route_gap``
  limit (some expert left out scores above a chosen one by more than that,
  relative to the row's largest score); every token of a routed call
  that finds no recorded call of the same shape, or a recorded call of a
  followed forward that the reference never makes; and one for each
  followed forward in which neither side routed, so that a reference that
  ignores the callback and a program that chooses elsewhere than through
  the tap cannot read correct with nothing compared.

A configuration routes when its file has a ``moe`` section; the reference
module of such a model takes the callback as ``forward(params, tokens,
cfg, prec, route=...)`` and calls ``route(scores, k)`` once per routed
layer, in the order of its forward, with scores ``(..., E)``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

#: the checks a routed configuration's limits file lists
CHECKS = ("route_gap", "route_errors")

#: the least row maximum a gap is divided by
_FLOOR = 1e-30

#: (forward label, routed layer) -> (scores (T, E) f32, indices (T, k))
Records = Dict[tuple, Tuple[torch.Tensor, torch.Tensor]]


def routes(cfg: dict) -> bool:
    """Whether the configuration's model routes tokens to experts."""
    return "moe" in cfg


def require_checks(cfg: dict, limits: dict) -> None:
    """Refuse a routed configuration whose limits lack the route checks."""
    missing = [c for c in CHECKS if c not in limits]
    if routes(cfg) and missing:
        raise ValueError(f"configuration {cfg.get('name')!r} routes tokens "
                         f"to experts; its limits file lacks {missing}")


def top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores in descending order, ties to the
    lower index."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][..., :k]


class Follow:
    """The reference's router callback for one followed federation.

    ``program`` holds the program's recorded calls, or None where the
    reference routes by itself (a control in the program's place), in which
    case the calls it makes are kept in :attr:`made` as the program's
    would be. ``follow=False`` measures as usual but hands back the
    reference's own choices (a check that the follow matters). Call
    :meth:`begin` with each forward's label before the forward, and
    :meth:`finish` after the last."""

    def __init__(self, program: Optional[Records], limit: float,
                 follow: bool = True):
        self.program = program
        self.limit = limit
        self.follow = follow
        self.made: Records = {}
        self.gap = 0.0
        self.errors = 0
        #: routed tokens followed, and those of them whose experts the
        #: reference alone would have chosen otherwise
        self.tokens = 0
        self.flips = 0
        self._label = None
        self._layer = 0
        self._layers = {}
        for label, layer in program or ():
            self._layers[label] = max(self._layers.get(label, 0), layer + 1)

    def begin(self, label: tuple) -> None:
        self._close()
        self._label, self._layer = label, 0

    def finish(self) -> None:
        self._close()
        self._label = None

    def _close(self) -> None:
        """Recorded calls of the forward just ended that it never made, and
        a forward that routed on neither side."""
        if self.program is None or self._label is None:
            return
        recorded = self._layers.get(self._label, 0)
        for layer in range(self._layer, recorded):
            self.errors += self.program[(self._label, layer)][1].shape[0]
        if self._layer == 0 and recorded == 0:
            self.errors += 1

    def __call__(self, scores: torch.Tensor, k: int) -> torch.Tensor:
        key = (self._label, self._layer)
        self._layer += 1
        s_ref = scores.detach().reshape(-1, scores.shape[-1]).float()
        own = top_k(scores.detach(), k)
        if self.program is None:
            self.made[key] = (s_ref.clone(), own.reshape(-1, k).clone())
            return own
        rec = self.program.get(key)
        if (rec is None or rec[0].shape != s_ref.shape
                or rec[1].shape != (s_ref.shape[0], k)):
            self.errors += s_ref.shape[0]
            return own
        s_prog, i_prog = rec[0].to(s_ref.device), rec[1].to(s_ref.device)
        self.tokens += s_ref.shape[0]
        self._judge(s_prog, i_prog, s_ref, k)
        ours = own.reshape(-1, k).sort(dim=-1)[0]
        self.flips += int((i_prog.sort(dim=-1)[0] != ours).any(-1).sum())
        if not self.follow:
            return own
        return i_prog.clamp(0, s_ref.shape[1] - 1).reshape(own.shape)

    def _judge(self, s_prog, i_prog, s_ref, k) -> None:
        top = s_ref.abs().amax(dim=-1).clamp_min(_FLOOR)
        self.gap = max(self.gap, float(((s_prog - s_ref).abs().amax(dim=-1)
                                        / top).max()))
        e = s_ref.shape[1]
        valid = ((i_prog >= 0) & (i_prog < e)).all(dim=-1)
        # the program's own top-k of its own scores, in its order
        wrong = (top_k(s_prog, k) != i_prog).any(dim=-1) | ~valid
        # a top-k of the reference's scores within the tolerance
        idx = i_prog.clamp(0, e - 1)
        chosen = torch.zeros_like(s_ref, dtype=torch.bool).scatter_(1, idx,
                                                                    True)
        low = torch.gather(s_ref, 1, idx).amin(dim=-1)
        left = s_ref.masked_fill(chosen, float("-inf")).amax(dim=-1)
        beyond = (left - low > 2 * self.limit * top) & valid
        self.errors += int(wrong.sum()) + int(beyond.sum())
