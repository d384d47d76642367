"""Spans and counters inside the port, kept in memory until collected.

Off by default. While off, ``with span(...)`` costs one module-level check
and enters one shared no-op object, and :func:`count` returns at once:
nothing is allocated or recorded and no ``torch.cuda`` function runs.

:func:`enable` starts a recording and :func:`collect` ends it and hands it
back. A span records its name, its id, the id of the span open around it,
a few attributes, and ``time.perf_counter()`` at open and close. The
recorder itself touches no device: a device trace taken beside it
(torch.profiler, whose launch records carry the host time of every kernel
and copy) says which span queued which device work, by the launch's host
time (``perfbench/program_trace.py``).

Span names are ``<layer>.<phase>``:

* ``sim.drain``, ``sim.dispatch``, ``sim.eval`` (``core/simulator.py``);
* ``client.fanout``, ``client.plan``, ``client.stage``, ``client.step``,
  ``client.collect`` (``core/simulator.py``, ``core/client.py``,
  ``core/cohort.py``);
* ``server.drain``, ``server.update``, ``server.stack``, ``server.flatten``,
  ``server.record`` (``core/server.py``) and ``server.norms``,
  ``server.schedule``, ``server.apply`` (``kernels/fedagg/ops.py``).

Counters: ``server.copy_bytes`` (bytes the copies that stage a drain's
operands move: each byte of a source read once, each byte of a staged
tensor written once), ``gmis.lookups`` and
``gmis.clamps`` (``RingGMIS.get``), ``client.steps`` (real rows times real
local steps).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional


@dataclasses.dataclass
class Span:
    name: str
    id: int
    #: id of the span open around this one, or None
    parent: Optional[int]
    attrs: dict
    #: ``time.perf_counter()`` at open and close, in s
    host_open: float
    host_close: float


@dataclasses.dataclass
class Recording:
    """What :func:`collect` hands back: the closed spans in the order they
    opened, and the counters."""
    spans: List[Span]
    counters: Dict[str, int]


class _Recorder:
    """One recording. Closed spans are kept as tuples of plain values, so
    that a span leaves nothing behind for the garbage collector to scan."""

    def __init__(self):
        self.opened = 0
        #: (id, parent, name, attrs, host open, host close), in the order
        #: they close
        self.closed: List[tuple] = []
        self.stack: List[int] = []
        self.counters: Dict[str, int] = {}


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()
#: the recording in progress; None while off
_recorder: Optional[_Recorder] = None


class _Open:
    __slots__ = ("rec", "name", "attrs", "id", "parent", "t_open")

    def __init__(self, rec: _Recorder, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        rec = self.rec
        self.id = rec.opened
        rec.opened += 1
        self.parent = rec.stack[-1] if rec.stack else None
        rec.stack.append(self.id)
        self.t_open = time.perf_counter()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec.closed.append((self.id, self.parent, self.name, self.attrs,
                           self.t_open, time.perf_counter()))
        if rec.stack and rec.stack[-1] == self.id:
            rec.stack.pop()
        return False


def span(name: str, **attrs):
    """A context manager that records the span ``name`` while recording is
    on; the shared no-op otherwise."""
    rec = _recorder
    if rec is None:
        return _NOOP
    return _Open(rec, name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording is on."""
    rec = _recorder
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + int(n)


def active() -> bool:
    """Whether a recording is in progress (for counts that cost work to
    compute)."""
    return _recorder is not None


def enable() -> None:
    """Start a new recording, dropping any in progress."""
    global _recorder
    _recorder = _Recorder()


def collect() -> Optional[Recording]:
    """End the recording and return it (None if none was on). Spans still
    open are left out."""
    global _recorder
    rec, _recorder = _recorder, None
    if rec is None:
        return None
    return Recording([Span(name, sid, parent, attrs, t_open, t_close)
                      for sid, parent, name, attrs, t_open, t_close
                      in sorted(rec.closed)], rec.counters)
