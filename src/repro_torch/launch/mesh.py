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

The model layouts of the dry run (``sharding/specs.py``, ``launch/
dryrun.py``) live on a :class:`LogicalMesh` instead: axis names and sizes
and no device, the reference's production meshes ``(data 16, model 16)``
and ``(pod 2, data 16, model 16)`` with its axis names, so that the two
packages' layouts can be compared. Nothing is placed on it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
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


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """Named mesh axes and their sizes, with no devices: what the layout
    rules read (``sharding/specs.py``). A leaf laid out on it is split
    over the axes its spec names, each dim rounded up."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def axis_sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    @property
    def name(self) -> str:
        return "x".join(map(str, self.shape))


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """The production mesh: 16 x 16 = 256 devices, axes (data, model), or
    2 x 16 x 16 = 512, axes (pod, data, model), where ``pod`` is the
    federated client axis."""
    if multi_pod:
        return LogicalMesh(("pod", "data", "model"), (2, 16, 16))
    return LogicalMesh(("data", "model"), (16, 16))


def make_host_mesh(shape: Optional[Tuple[int, ...]] = None,
                   axes: Tuple[str, ...] = ("data", "model"),
                   device: Device = None) -> LogicalMesh:
    """A mesh over the devices this process has (:func:`devices`; one CPU
    or one card gives (1, 1)); ``shape`` must use them all."""
    n = len(devices(device))
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    if math.prod(shape) != n or len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} over axes {axes} does "
                         f"not fit {n} devices")
    return LogicalMesh(tuple(axes), tuple(shape))


# Roofline constants of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
# rates without sparsity, at its 700 W power limit)
#: bf16 tensor-core peak, FLOP/s
PEAK_FLOPS_BF16 = 989e12
#: f32 peak outside the tensor cores (TF32 off), FLOP/s
PEAK_FLOPS_F32 = 67e12
#: HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12
