"""Builds the port's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own by
``nvcc`` for Hopper (``sm_90a``) into ``build/repro_torch/`` at the root of
the checkout, under a name keyed by a hash of the source, the headers beside
it and the flags, and loaded with ``ctypes``. A source that is already built
is loaded as it is. :func:`build_all` starts one ``nvcc`` per source, all at
once, so a process that needs several libraries waits for the slowest
build only.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

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
