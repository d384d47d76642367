"""The (pod, model) device mesh of the sharded server and the pod engine.

One process drives every shard and every pod, as the JAX package's single
controller does: a mesh is a list of ``torch.device`` s, not a process
group. The ``model`` axis splits the server's padded flat vector into
contiguous shards, one per device (``kernels/fedagg/sharded.py``); the
``pod`` axis splits a cohort fan-out's clients (``core/cohort.py``). The
two never contract jointly, so each side builds its own mesh over the first
devices of the list.

The devices are the CUDA devices of this process (``torch.cuda.
device_count()``) for a CUDA home device and the one CPU otherwise, the
home device first. :func:`repeat_devices` is a test hook, the counterpart
of XLA's forced host device count: under it the home device is counted
``n`` times, so a single CPU or a single card runs every sharded and pod
code path with ``n`` separate shard allocations and ``n`` launches per
sweep. Only tests and ``chip_smoke.py`` enter it; no path of the package
does.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional, Tuple

import torch

from repro_torch.utils.device import Device, resolve_device

#: the hook's repeat count; None outside :func:`repeat_devices`
_REPEAT: Optional[int] = None


@contextlib.contextmanager
def repeat_devices(n: int) -> Iterator[None]:
    """Test hook: while inside, the home device counts as ``n`` devices
    (every mesh lists it ``n`` times). For tests and ``chip_smoke.py``;
    the forced host device count of the JAX package's tests."""
    global _REPEAT
    if n < 1:
        raise ValueError(f"repeat_devices needs n >= 1, got {n}")
    prev, _REPEAT = _REPEAT, int(n)
    try:
        yield
    finally:
        _REPEAT = prev


def _home(device: Device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def devices(device: Device = None) -> Tuple[torch.device, ...]:
    """The devices a mesh may use, ``device`` (the home device; None means
    CUDA) first."""
    home = _home(device)
    if _REPEAT is not None:
        return (home,) * _REPEAT
    if home.type != "cuda":
        return (home,)
    others = [torch.device("cuda", i) for i in range(torch.cuda.device_count())
              if i != home.index]
    return (home, *others)


def on_device(device: torch.device):
    """The context a kernel for ``device`` launches in: a kernel runs on
    the current CUDA device, so a mesh of several cards switches to each
    shard's or pod's card in turn."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _pow2_floor(n: int) -> int:
    return max(1, 1 << (max(n, 1).bit_length() - 1))


def pod_count(max_pods: Optional[int] = None, device: Device = None) -> int:
    """Usable ``pod``-axis size: the largest power of two <= the device
    count (and <= ``max_pods`` when given), so that a power-of-two client
    bucket always splits evenly over the pods. One device gives 1."""
    n = len(devices(device))
    if max_pods is not None:
        n = min(n, int(max_pods))
    return _pow2_floor(n)


def model_shard_count(max_shards: Optional[int] = None,
                      device: Device = None) -> int:
    """Usable ``model``-axis size: the largest power of two <= the device
    count (and <= ``max_shards`` when given), so that a flat vector padded
    to ``BLOCK * shards`` splits into whole kernel blocks per shard."""
    n = len(devices(device))
    if max_shards is not None:
        n = min(n, int(max_shards))
    return _pow2_floor(n)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(pods, shards)`` grid of devices, row-major: row ``p`` holds pod
    ``p``'s model shards. The home device, where replicated scalars and
    gathered vectors live, is the first."""

    devices: Tuple[torch.device, ...]
    shape: Tuple[int, int]

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def model_devices(self, pod: int = 0) -> Tuple[torch.device, ...]:
        """The devices of one pod's model shards, in shard order."""
        s = self.shape[1]
        return self.devices[pod * s:(pod + 1) * s]

    def pod_devices(self) -> Tuple[torch.device, ...]:
        """The first device of every pod, in pod order."""
        return self.devices[::self.shape[1]]


def make_fedagg_mesh(n_shards: int, n_pods: int = 1,
                     device: Device = None) -> Mesh:
    """The 2-D ``(pod, model)`` mesh over the first ``n_pods * n_shards``
    devices. The server's aggregation uses ``model`` only: one fixed-order
    sum of the squared-norm partials per Eq. 6 distance; the cohort engine
    uses ``pod`` only."""
    devs = devices(device)
    n = n_pods * n_shards
    if n > len(devs):
        raise ValueError(
            f"mesh ({n_pods} pods x {n_shards} model shards) needs {n} "
            f"devices, have {len(devs)}")
    return Mesh(devs[:n], (int(n_pods), int(n_shards)))


def make_cohort_mesh(n_pods: int, device: Device = None) -> Mesh:
    """The 1-D ``pod`` mesh over the first ``n_pods`` devices: the client
    axis of the ``cohort_sharded`` engine. Each pod trains ``C_pad /
    n_pods`` stacked client rows; nothing crosses pods during local
    training."""
    return make_fedagg_mesh(1, n_pods, device)
