"""Upload traffic of a fleet of clients to one AsyncFedED server, made from
the seed and the parameters of a traffic file (runner ``server_uploads``).

Each client computes for ``k x`` its own step time (the traffic's
``step_time`` spread lognormally with ``heterogeneity``), then transmits
for ``tx_time`` scaled by a normal factor (mean 1, spread ``tx_spread``,
at least 0.1). Arrivals cluster on a global Poisson process of burst
epochs (mean gap ``burst_gap``): a client that is ready waits for the next
epoch and lands an exponential ``jitter`` after it, as the port's
``PoissonBurstBehavior`` does. The arrivals of one epoch form one drain, at
most ``limit`` of them (the server's batch limit); the rest go to the next
drain. Times are virtual: the replay goes as fast as the server drains.

The loop is closed: a drained client uploads next with the K and the
snapshot iteration of its reply. Each upload carries one delta of a pool
of ``pool`` vectors, drawn uniformly.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
from typing import List, Tuple

import numpy as np

_SALT = 0xB0B5


@dataclasses.dataclass(frozen=True)
class Upload:
    time: float
    seq: int
    client: int
    snapshot: int
    k: int
    delta: int            # index into the pool
    epoch: float


class Uploads:
    def __init__(self, params: dict, seed: int):
        self.p = params
        self.rng = np.random.default_rng([int(seed), _SALT])
        self.step = params["step_time"] * self.rng.lognormal(
            0.0, params["heterogeneity"], params["clients"])
        self.epochs = [0.0]
        self.queue: List[tuple] = []
        self.seq = 0

    def _epoch_after(self, t: float) -> float:
        while self.epochs[-1] < t:
            self.epochs.append(self.epochs[-1]
                               + self.rng.exponential(self.p["burst_gap"]))
        return self.epochs[bisect.bisect_left(self.epochs, t)]

    def send(self, client: int, now: float, k: int, snapshot: int) -> None:
        """The client starts a round at ``now`` with ``k`` and ``snapshot``."""
        tx = self.p["tx_time"] * max(0.1, self.rng.normal(
            1.0, self.p["tx_spread"]))
        epoch = self._epoch_after(now + k * self.step[client] + tx)
        up = Upload(epoch + self.rng.exponential(self.p["jitter"]), self.seq,
                    client, snapshot, k,
                    int(self.rng.integers(self.p["pool"])), epoch)
        self.seq += 1
        heapq.heappush(self.queue, (up.time, up.seq, up))

    def next_drain(self, limit: int) -> Tuple[float, List[Upload]]:
        """The next drain: the earliest arrival and those of its epoch that
        follow it, at most ``limit``; and the virtual time it ends."""
        first = heapq.heappop(self.queue)[2]
        out = [first]
        while (self.queue and len(out) < limit
               and self.queue[0][2].epoch == first.epoch):
            out.append(heapq.heappop(self.queue)[2])
        return out[-1].time, out
