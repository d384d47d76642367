"""Builds the port's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own by
``nvcc`` for Hopper (``sm_90a``) into ``build/repro_torch/`` at the root of
the checkout, under a name keyed by a hash of the source and the flags, and
loaded with ``ctypes``. A source that is already built is loaded as it is.

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
from typing import Dict

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
    """Where ``source`` is built: keyed by its bytes and the flags."""
    h = hashlib.sha256(Path(source).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def load(source: Path) -> ctypes.CDLL:
    """The shared library of ``source``, built first if needed. ``nvcc``'s
    output is kept beside the library (:func:`build_log`); a failed build
    raises with it."""
    source = Path(source)
    lib = _loaded.get(source)
    if lib is None:
        out = target(source)
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            out.with_suffix(".log").write_text(proc.stdout)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source} "
                                   f"(exit {proc.returncode}):\n{proc.stdout}")
            os.replace(tmp, out)
        lib = _loaded[source] = ctypes.CDLL(str(out))
    return lib


def build_log(source: Path) -> str:
    """What ``nvcc`` printed when it built ``source`` (registers, spills)."""
    log = target(Path(source)).with_suffix(".log")
    return log.read_text() if log.exists() else ""
