"""Builds the port's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own by
``nvcc`` for Hopper (``sm_90a``) into ``build/repro_torch/`` at the root of
the checkout, under a name keyed by a hash of the source, the headers beside
it and the flags, and loaded with ``ctypes``. A source that is already built
is loaded as it is. :func:`build_all` starts one ``nvcc`` per source, all at
once, so a process that needs several libraries waits for the slowest
build only.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine with no ``nvcc``. The checks, the stream lookup and the
SM count that the kernel wrappers use before a launch are here too, with
the guard that refuses a launch which would cut a gradient and the fold that
the scans' vmap rules share.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
_loaded: Dict[Path, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built on a machine with the CUDA toolkit")
    return found


def target(source: Path) -> Path:
    """Where ``source`` is built: keyed by its bytes, the bytes of the
    ``.cuh`` headers in its directory, and the flags."""
    source = Path(source)
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def _start(source: Path):
    """Start ``nvcc`` on ``source`` unless it is built; returns the running
    process, its temporary output and its target, or None."""
    out = target(source)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(source: Path, job) -> None:
    """Wait for a build started by :func:`_start`; keep ``nvcc``'s output
    beside the library (:func:`build_log`) and raise with it on failure."""
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(sources: Iterable[Path]) -> None:
    """Build every source that is not built yet, one ``nvcc`` each, all
    started together; raises after all have ended if any failed."""
    sources = [Path(s) for s in sources]
    jobs = [(s, _start(s)) for s in sources if s not in _loaded]
    errors = []
    for s, job in jobs:
        try:
            _finish(s, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(source: Path) -> ctypes.CDLL:
    """The shared library of ``source``, built first if needed."""
    source = Path(source)
    lib = _loaded.get(source)
    if lib is None:
        _finish(source, _start(source))
        lib = _loaded[source] = ctypes.CDLL(str(target(source)))
    return lib


def build_log(source: Path) -> str:
    """What ``nvcc`` printed when it built ``source`` (registers, spills)."""
    log = target(Path(source)).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def refuse_autograd(what: str, *tensors) -> None:
    """Raise when a kernel launch would lose a gradient: a kernel writes
    into fresh outputs that autograd does not see, and it reads raw
    pointers, which a ``torch.func`` transform's wrapped tensors do not
    have. ``what`` names the input in the message. The differentiable entry
    points (``ssd.ops.SSDScan``, ``rglru.ops.RGLRUScan``) call their kernels
    on unwrapped tensors with grad mode off, so only a direct call reaches
    this."""
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            continue
        if torch._C._functorch.is_functorch_wrapped_tensor(t):
            raise RuntimeError(
                f"{what} is a tensor of a torch.func transform: the kernel "
                "has no vmap or grad rule here (call the differentiable "
                "entry point)")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(
                f"{what} requires grad with grad mode on: the kernel has no "
                "backward, so the gradient would be lost (call it under "
                "torch.no_grad())")


def fold_vmapped(t, dim, n: int):
    """A vmapped operand of a vmap rule with its client axis folded into
    its leading axis: (C, B, ...) -> (C * B, ...). ``dim`` is the client
    axis, None when the operand is not batched (it is expanded first); a
    None operand stays None."""
    if t is None:
        return None
    t = t.expand(n, *t.shape) if dim is None else t.movedim(dim, 0)
    return t.reshape(n * t.shape[1], *t.shape[2:]).contiguous()


def check_tensor(name: str, t: torch.Tensor, dtypes, shape,
                 device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous tensor of one of ``dtypes``, of
    ``shape``, on ``device`` and, on CUDA, 16-byte aligned and free of
    autograd (:func:`refuse_autograd`)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if device.type == "cuda":
        refuse_autograd(f"kernel input {name}", t)
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The number of SMs of ``device``, read once: launch shapes that fill
    the card depend on it."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream(device: torch.device) -> int:
    """The current stream of ``device``, which must be the current device:
    a kernel launches on the device current to the calling thread."""
    if device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {device} but the current CUDA device "
                         f"is {torch.cuda.current_device()}: call under "
                         f"torch.cuda.device({device})")
    return torch.cuda.current_stream(device).cuda_stream
