"""The port's own spans and counters (``repro_torch.utils.tracing``) on the
device trace's clock, and the per-layer numbers read from them.

torch.profiler records, beside each kernel and copy on the device, the
host call that queued it (the CUDA runtime or driver call, with the same
correlation id) on the same clock. So each device event belongs to the
spans that were open on the host when it was queued: no device event or
clock of the program's own is needed, and the attribution does not depend
on when the device got to the work. Host times map onto the trace's clock
through the marker kernel that :meth:`perfbench.trace.DeviceTrace.start`
launches: the host time just before it, against the time of the call that
queued it. Per span name, over the spans that open inside the window:

* ``count`` and ``host_s``, the host seconds inside the window;
* ``busy_s``, the device seconds of the work the spans queued (the union
  of their device events inside the window), and ``events``, how many
  device events they queued;
* ``idle_s``, the device-idle seconds inside the spans' host intervals.

``idle`` charges each idle gap of the window to the innermost program span
open on the host at the gap's middle (``other`` outside every span).
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

from perfbench.trace import _MARKER, busy_intervals


@dataclasses.dataclass
class Launched:
    """A device event and the host time of the call that queued it, on the
    trace's clock (None when the trace holds no such call)."""
    name: str
    start_ns: int
    end_ns: int
    launch_ns: Optional[int]


def launched(prof, cuda: bool) -> List[Launched]:
    """The device events of a stopped torch.profiler ``prof``, each with
    the host time of the call that queued it. On the CPU (the tests) the
    operators run where they are called: each is queued at its start."""
    from torch.autograd import DeviceType
    events = list(prof.profiler.kineto_results.events())
    if not cuda:
        out = [Launched(e.name(), e.start_ns(),
                        e.start_ns() + e.duration_ns(), e.start_ns())
               for e in events if e.device_type() == DeviceType.CPU]
    else:
        calls: Dict[int, int] = {}
        for e in events:
            c = e.correlation_id()
            if e.device_type() == DeviceType.CPU and c:
                calls[c] = min(calls.get(c, e.start_ns()), e.start_ns())
        out = [Launched(e.name(), e.start_ns(),
                        e.start_ns() + e.duration_ns(),
                        calls.get(e.correlation_id()))
               for e in events if e.device_type() == DeviceType.CUDA]
    out.sort(key=lambda e: e.start_ns)
    return out


def host_offset_ns(events: List[Launched],
                   marker_host: Optional[float]) -> Optional[float]:
    """Trace ns less host ``perf_counter`` ns: the marker kernel's queueing
    call against the host time taken just before it."""
    for e in events if marker_host is not None else ():
        if _MARKER in e.name and e.launch_ns is not None:
            return e.launch_ns - marker_host * 1e9
    return None


@dataclasses.dataclass
class SpanStats:
    count: int = 0
    host_s: float = 0.0
    busy_s: float = 0.0
    events: int = 0
    idle_s: float = 0.0


@dataclasses.dataclass
class Program:
    spans: Dict[str, SpanStats]
    idle: Dict[str, float]
    counters: Dict[str, int]

    def table(self) -> dict:
        return {k: dataclasses.asdict(v)
                for k, v in sorted(self.spans.items())}


class _Busy:
    """Busy device time inside any interval, from the sorted busy union."""

    def __init__(self, busy: List[Tuple[float, float]]):
        self.starts = [a for a, _ in busy]
        self.busy = busy
        self.before = [0.0]
        for a, b in busy:
            self.before.append(self.before[-1] + (b - a))

    def upto(self, t: float) -> float:
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0.0
        a, b = self.busy[i - 1]
        return self.before[i - 1] + (min(t, b) - a)

    def inside(self, a: float, b: float) -> float:
        return self.upto(b) - self.upto(a) if b > a else 0.0


def _open_chains(marks, times) -> List[List[str]]:
    """For each of the sorted ``times``, the names of the spans open then,
    innermost last. ``marks`` are (open, close, name) by open; the
    recorder's spans nest (one host thread, ``with`` blocks), so the spans
    open at any time form one chain."""
    stack: List[tuple] = []
    out, i = [], 0
    for t in times:
        while i < len(marks) and marks[i][0] <= t:
            while stack and stack[-1][1] < marks[i][0]:
                stack.pop()
            stack.append(marks[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append([m[2] for m in stack])
    return out


def summarize(rec, events: List[Launched], t0: float, t1: float,
              offset_ns: float) -> Program:
    """The recording ``rec`` (``tracing.collect()``) over the window [t0,
    t1] (host ``perf_counter`` s) of the device events ``events``
    (:func:`launched`); ``offset_ns`` is trace ns less host ns."""
    lo, hi = t0 * 1e9 + offset_ns, t1 * 1e9 + offset_ns
    inside = [e for e in events if e.end_ns > lo and e.start_ns < hi
              and _MARKER not in e.name]
    busy = busy_intervals(inside, lo, hi)
    within = _Busy(busy)
    spans = [s for s in rec.spans
             if s.host_close >= t0 and s.host_open <= t1]
    stats: Dict[str, SpanStats] = {}
    for s in spans:
        if not t0 <= s.host_open <= t1:
            continue
        st = stats.setdefault(s.name, SpanStats())
        st.count += 1
        a, b = max(s.host_open, t0), min(s.host_close, t1)
        st.host_s += b - a
        a, b = a * 1e9 + offset_ns, b * 1e9 + offset_ns
        st.idle_s += ((b - a) - within.inside(a, b)) / 1e9
    # outer spans first where two open together
    marks = sorted(((s.host_open * 1e9 + offset_ns,
                     s.host_close * 1e9 + offset_ns, s.name) for s in spans),
                   key=lambda m: (m[0], -m[1]))
    queued = sorted((e for e in inside if e.launch_ns is not None),
                    key=lambda e: e.launch_ns)
    owned: Dict[str, list] = {}
    for e, chain in zip(queued, _open_chains(
            marks, [e.launch_ns for e in queued])):
        for name in set(chain):
            owned.setdefault(name, []).append(e)
    for name, evs in owned.items():
        if name in stats:
            evs.sort(key=lambda e: e.start_ns)
            stats[name].busy_s += sum(
                b - a for a, b in busy_intervals(evs, lo, hi)) / 1e9
            stats[name].events += len(evs)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    idle: Dict[str, float] = {}
    for (a, b), chain in zip(gaps, _open_chains(
            marks, [(a + b) / 2 for a, b in gaps])):
        name = chain[-1] if chain else "other"
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e9
    return Program(stats, idle, dict(rec.counters))


# --- the per-layer numbers; ``ctx.program`` is a :class:`Program` ---------

def _stat(ctx, name: str) -> Optional[SpanStats]:
    prog = getattr(ctx, "program", None)
    st = None if prog is None else prog.spans.get(name)
    return st if st is not None and st.count else None


def _per_update(ctx, name: str) -> Optional[float]:
    st = _stat(ctx, name)
    if st is None or not ctx.updates:
        return None
    return 1e3 * st.busy_s / ctx.updates


def stack_ms_per_update(ctx):
    """Device ms of the work ``server.stack`` queued, per update."""
    return _per_update(ctx, "server.stack")


def flatten_ms_per_update(ctx):
    """Device ms of the work ``server.flatten`` queued, per update."""
    return _per_update(ctx, "server.flatten")


def copy_mb_per_update(ctx):
    """``server.copy_bytes`` in MB (1e6 bytes), per update."""
    prog = getattr(ctx, "program", None)
    if prog is None or "server.copy_bytes" not in prog.counters \
            or not ctx.updates:
        return None
    return prog.counters["server.copy_bytes"] / 1e6 / ctx.updates


def schedule_idle_ms_per_drain(ctx):
    """Device-idle ms inside ``server.schedule`` host spans, per drain
    (``server.drain`` span)."""
    st, drains = _stat(ctx, "server.schedule"), _stat(ctx, "server.drain")
    if st is None or drains is None:
        return None
    return 1e3 * st.idle_s / drains.count


def _per_step(ctx, field: str, scale: float = 1e3):
    st = _stat(ctx, "client.step")
    return None if st is None else scale * getattr(st, field) / st.count


def step_device_ms(ctx):
    """Device ms of the work ``client.step`` queued, per step span."""
    return _per_step(ctx, "busy_s")


def step_host_ms(ctx):
    """Host ms of ``client.step``, per step span."""
    return _per_step(ctx, "host_s")


def kernels_per_step(ctx):
    """Device events (kernels, copies, fills) ``client.step`` queued, per
    step span."""
    return _per_step(ctx, "events", 1.0)


def step_idle_ms(ctx):
    """Device-idle ms inside ``client.step`` host spans, per step span."""
    return _per_step(ctx, "idle_s")


#: metric name -> (unit, reader, the runner whose cells it reads)
METRICS = {
    "stack_ms_per_update.agg": ("ms", stack_ms_per_update, "server_uploads"),
    "flatten_ms_per_update.agg": ("ms", flatten_ms_per_update,
                                  "server_uploads"),
    "copy_mb_per_update.agg": ("MB", copy_mb_per_update, "server_uploads"),
    "schedule_idle_ms_per_drain.agg": ("ms", schedule_idle_ms_per_drain,
                                       "server_uploads"),
    "step_device_ms.train": ("ms", step_device_ms, "fedtrain"),
    "step_host_ms.train": ("ms", step_host_ms, "fedtrain"),
    "kernels_per_step.train": ("kernels", kernels_per_step, "fedtrain"),
    "step_idle_ms.train": ("ms", step_idle_ms, "fedtrain"),
}
