"""The benchmark's own spans, and the device's trace from torch.profiler.

Spans are recorded around the calls into the program's layers, on the
host's clock. In a traced run each span closes with a device sync, so it
covers the device work it queued; in the timed run nothing waits but what
the program waits for itself. The device trace holds the device's kernel
and copy events of the traced window (CUPTI through torch.profiler); a
marker kernel launched right after a sync at the window's start ties the
device's clock to the host's, so idle gaps can be charged to what the host
was doing.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch


class Spans:
    """Named host spans, ``(start, end)`` in ``time.perf_counter`` s."""

    def __init__(self, device: torch.device, sync: bool):
        self.by_name: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        self.sync = sync and device.type == "cuda"
        self.recording = False

    def wrap(self, name: str, fn):
        def wrapped(*a, **kw):
            if not self.recording:
                return fn(*a, **kw)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if self.sync:
                torch.cuda.synchronize()
            self.by_name[name].append((t0, time.perf_counter()))
            return out
        return wrapped

    def total(self, name: str, lo: float, hi: float) -> float:
        """Seconds of ``name``'s spans inside [lo, hi]."""
        return sum(max(0.0, min(b, hi) - max(a, lo))
                   for a, b in self.by_name.get(name, ()))


@dataclasses.dataclass
class DeviceEvent:
    name: str
    start_ns: int
    end_ns: int


_MARKER = "spin_kernel"


class DeviceTrace:
    """torch.profiler over the device only, started and stopped by hand.
    On the CPU (the tests) it traces the CPU's operators instead."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile
        self.cuda = device.type == "cuda"
        self.prof = profile(activities=[ProfilerActivity.CUDA if self.cuda
                                        else ProfilerActivity.CPU])
        self.marker_host: Optional[float] = None

    def start(self) -> None:
        self.prof.start()
        if self.cuda:
            torch.cuda.synchronize()
            self.marker_host = time.perf_counter()
            torch.cuda._sleep(100)

    def stop(self) -> List[DeviceEvent]:
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()
        from torch.autograd import DeviceType
        kind = DeviceType.CUDA if self.cuda else DeviceType.CPU
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == kind:
                out.append(DeviceEvent(e.name(), e.start_ns(),
                                       e.start_ns() + e.duration_ns()))
        out.sort(key=lambda e: e.start_ns)
        return out

    def host_offset_ns(self, events: List[DeviceEvent]) -> Optional[float]:
        """device ns - host perf_counter ns, from the marker kernel."""
        for e in events if self.marker_host is not None else ():
            if _MARKER in e.name:
                return e.start_ns - self.marker_host * 1e9
        return None


def busy_intervals(events: List[DeviceEvent], lo_ns: float, hi_ns: float
                   ) -> List[Tuple[float, float]]:
    """The union of the events' intervals, clipped to [lo, hi]."""
    out: List[List[float]] = []
    for e in events:
        a, b = max(e.start_ns, lo_ns), min(e.end_ns, hi_ns)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def by_name(events: List[DeviceEvent]) -> Dict[str, Tuple[int, float]]:
    """name -> (event count, device seconds)."""
    acc: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for e in events:
        acc[e.name][0] += 1
        acc[e.name][1] += (e.end_ns - e.start_ns) / 1e9
    return {k: (int(c), s) for k, (c, s) in acc.items()}


def idle_by_host(busy: List[Tuple[float, float]], lo_ns: float, hi_ns: float,
                 offset_ns: float, spans: Spans) -> Dict[str, float]:
    """Idle device seconds in [lo, hi], charged to the host span open at
    each gap's middle (``other`` outside every span)."""
    marks = []
    for name, ss in spans.by_name.items():
        marks += [(a * 1e9 + offset_ns, b * 1e9 + offset_ns, name)
                  for a, b in ss]
    marks.sort()
    starts = [m[0] for m in marks]
    out: Dict[str, float] = defaultdict(float)
    edges = [lo_ns] + [x for ab in busy for x in ab] + [hi_ns]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        name = marks[i][2] if i >= 0 and marks[i][1] >= mid else "other"
        out[name] += (b - a) / 1e9
    return dict(out)


@dataclasses.dataclass
class Window:
    """The traced window's device summary, for the per-layer readers."""
    window_s: float
    busy_s: float
    ops: Dict[str, Tuple[int, float]]
    idle: Dict[str, float]

    def device_s(self, match) -> float:
        return sum(s for k, (_, s) in self.ops.items() if match(k))

    def count(self, match) -> int:
        return sum(c for k, (c, _) in self.ops.items() if match(k))

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:10]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:120], s] for k, (_, s) in top],
                "idle_gaps": [[k, s] for k, s in gaps]}


def summarize(trace: DeviceTrace, events: List[DeviceEvent], t0: float,
              t1: float, spans: Spans) -> Window:
    """The window [t0, t1] (host perf_counter s) of a stopped trace."""
    off = trace.host_offset_ns(events)
    if off is None:                     # no marker: trust the two clocks'
        off = (events[0].start_ns - t0 * 1e9) if events else 0.0  # origin
    lo, hi = t0 * 1e9 + off, t1 * 1e9 + off
    inside = [e for e in events if e.end_ns > lo and e.start_ns < hi
              and _MARKER not in e.name]
    busy = busy_intervals(inside, lo, hi)
    return Window(t1 - t0, sum(b - a for a, b in busy) / 1e9, by_name(inside),
                  idle_by_host(busy, lo, hi, off, spans))


def launch_notes(window: Window, launches: dict) -> List[str]:
    """Lines for the kernels whose profiler events disagree with their
    wrappers' launch counters (the profiler can drop events). Each
    ``ssd_scan`` launch is four device kernels; each batched norms launch
    two."""
    notes = []
    ssd = 4 * launches.get("ssd_scan", 0)
    fed = (launches["fedagg_norms"] + launches["fedagg_axpy"]
           + 2 * launches["fedagg_norms_batched"]
           + launches["fedagg_apply_batched"])
    for name, want, tag in (("ssd_scan", ssd, "ssd::"),
                            ("fedagg", fed, "fedagg::")):
        got = window.count(lambda k, tag=tag: tag in k)
        if got != want:
            notes.append(f"note: {name}: {got} profiler events, the "
                         f"wrappers' counters say {want}")
    return notes
