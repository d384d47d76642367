"""The import guard: the port's benchmark runs without JAX.

Modules are compared by their top-level name, the part before the first
dot, as a whole: ``repro_torch`` is the port, ``repro`` the JAX package.
"""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden(names: Iterable[str], banned=FORBIDDEN) -> List[str]:
    """The names among ``names`` whose top-level name is banned."""
    return sorted({n for n in names if top_level(n) in banned})


def loaded() -> List[str]:
    """Forbidden modules this process holds now."""
    return forbidden(list(sys.modules))
