"""The program's expert choices, recorded where it makes them.

A routed layer of the port chooses its experts through
``repro_torch.models.moe.top_k(scores, k)``. :class:`Tap` stands in that
function's place, as ``fedtrain`` counts ``ssd.launch``: it calls the
port's own ``top_k`` and hands back the same values and indices (the
values gathered at the indices, which equal the sort's to the bit, and so
do their gradients), and sees, per call, the scores it was given and the
indices it returned. Inside the cohort engine's ``vmap(grad_and_value(...))``
it is an ``autograd.Function`` with a vmap rule, as ``SSDScan`` is, so that
it sees plain tensors with the client axis in front.

While set-up runs the tap records each call, labelled with the forward it
belongs to: ``("eval", n)`` for the run's n-th evaluation, ``("train",
client, round, step)`` for a client's local step; and with its routed
layer, the call's place in its forward. The layout of a fan-out's calls is
the engine's: the per-client loop runs each client's K steps in turn, one
forward a step; the cohort engine runs the clients in chunks of its plan's
width, each padded to its power-of-two bucket, every chunk's steps padded
to the bucket of its largest K where the K differ. Padded rows and steps
are dropped. The number of routed layers in one forward is read from the
first evaluation, which runs before any local step.

The tap is removed when the window opens, traced or not: the window runs
the port's ``top_k`` unwrapped, so nothing of the tap's is timed or traced.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

#: a forward's rows: whether the call is vmapped over clients, and the
#: label of each row (None for a padded row)
Layout = Tuple[bool, List[Optional[tuple]]]


class _Choose(torch.autograd.Function):
    """``idx = _Choose.apply(scores, k, tap, batched)``: the port's top-k
    indices, seen by the tap; not differentiable."""

    @staticmethod
    def forward(scores, k, tap, batched):
        idx = tap.top_k(scores, k)[1]
        tap.seen(scores, idx, batched)
        return idx

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, grad):
        return None, None, None, None

    @staticmethod
    def vmap(info, in_dims, scores, k, tap, batched):
        if batched:
            raise RuntimeError("the routing tap follows one client axis")
        s = (scores.expand(info.batch_size, *scores.shape)
             if in_dims[0] is None else scores.movedim(in_dims[0], 0))
        return _Choose.apply(s, k, tap, True), 0


class Tap:
    """Records the program's expert choices while ``recording``.
    ``width()`` gives the cohort plan's width of the fan-out running."""

    def __init__(self, width: Callable[[], int]):
        self.width = width
        #: (forward label, routed layer) -> (scores (T, E) f32, indices (T, k))
        self.records = {}
        self.recording = False
        #: routed calls in one forward (from the first evaluation)
        self.per_forward: Optional[int] = None
        self.top_k = None
        self._jobs = None
        self._forwards: Optional[List[Layout]] = None
        self._calls = 0

    # -- in the port's place -------------------------------------------------
    def install(self) -> None:
        from repro_torch.models import moe
        self.top_k = moe.top_k

        def tapped(scores, k):
            idx = _Choose.apply(scores, k, self, False)
            return torch.gather(scores, -1, idx), idx
        moe.top_k = tapped

    def remove(self) -> None:
        if self.top_k is not None:
            from repro_torch.models import moe
            moe.top_k = self.top_k
            self.top_k = None

    # -- what the calls to come belong to --------------------------------------
    def evaluation(self, n: int) -> None:
        """The calls to come are the run's ``n``-th evaluation."""
        self._start(None, [(False, [("eval", n)])])

    def fanout(self, jobs: List[Tuple[int, int, int]]) -> None:
        """The calls to come train ``jobs`` (client, round, K), in order;
        the engine's layout is read from the first call."""
        self._start(jobs, None)

    def _start(self, jobs, forwards) -> None:
        self._jobs, self._forwards, self._calls = jobs, forwards, 0

    def done(self) -> None:
        """Every call of the evaluation or fan-out has come."""
        if not self.recording:
            return
        if self.per_forward is None:
            if self._jobs is not None:
                raise RuntimeError("a routed local step ran before the "
                                   "first evaluation")
            self.per_forward = self._calls
        forwards = self._forwards
        if forwards is None:
            forwards = self._layout(False) if self.per_forward else []
        if self._calls != len(forwards) * self.per_forward:
            raise RuntimeError(f"{self._calls} routed calls where the "
                               f"engine's layout has {len(forwards)} "
                               f"forwards of {self.per_forward}")
        self._jobs = self._forwards = None

    def _layout(self, batched: bool) -> List[Layout]:
        jobs = self._jobs
        if not batched:
            return [(False, [("train", c, r, s)])
                    for c, r, k in jobs for s in range(k)]
        from repro_torch.core.cohort import bucket_size
        width = max(1, min(int(self.width()), len(jobs)))
        out = []
        for lo in range(0, len(jobs), width):
            chunk = jobs[lo:lo + width]
            ks = [k for _, _, k in chunk]
            k_pad = ks[0] if len(set(ks)) == 1 else bucket_size(max(ks))
            pad = [None] * (bucket_size(len(chunk)) - len(chunk))
            out += [(True, [("train", c, r, s) if s < k else None
                            for c, r, k in chunk] + pad)
                    for s in range(k_pad)]
        return out

    # -- each call -------------------------------------------------------------
    def seen(self, scores: torch.Tensor, idx: torch.Tensor,
             batched: bool) -> None:
        if not self.recording:
            return
        if self._forwards is None:
            if self._jobs is None:
                raise RuntimeError("a routed call outside an evaluation or "
                                   "a fan-out")
            self._forwards = self._layout(batched)
        per = self.per_forward
        if per is None:
            if self._jobs is not None:
                raise RuntimeError("a routed local step ran before the "
                                   "first evaluation")
            f, layer = 0, self._calls
        else:
            f, layer = divmod(self._calls, per)
        self._calls += 1
        if f >= len(self._forwards):
            raise RuntimeError("more routed calls than the engine's layout")
        want, rows = self._forwards[f]
        if want != batched or (batched and scores.shape[0] != len(rows)):
            raise RuntimeError(f"a routed call of shape {tuple(scores.shape)}"
                               " does not fit the engine's layout")
        e, k = scores.shape[-1], idx.shape[-1]
        for i, label in enumerate(rows):
            if label is not None:
                s, ix = (scores[i], idx[i]) if batched else (scores, idx)
                self.records[(label, layer)] = (
                    s.detach().reshape(-1, e).float().clone(),
                    ix.reshape(-1, k).clone())
