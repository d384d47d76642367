"""The program's spans on the device trace's clock
(``perfbench/program_trace.py``) and ``perfbench/program_run.py``, on the
CPU: synthetic device events attributed to the spans that queued them,
and their queueing calls found by correlation id; the per-layer numbers
read from a synthetic summary; and a tiny cell of each runner run with
the recorder on, whose counters agree with the harness and the judge."""
import re
import time
import types

import pytest
import torch

from perfbench import program_run, program_trace
from perfbench.tests import tiny
from repro_torch.kernels.fedagg import fedagg
from repro_torch.utils import tracing

OFF = 5e9          # trace ns less host ns


def _span(name, sid, parent, a, b, **attrs):
    return tracing.Span(name, sid, parent, attrs, a, b)


def _ev(name, a, b, launch):
    """A device event at host seconds [a, b], queued at host ``launch``."""
    return program_trace.Launched(
        name, int(OFF + a * 1e9), int(OFF + b * 1e9),
        None if launch is None else int(OFF + launch * 1e9))


def _recording():
    # host: a drain over [0.1, 0.7] holding a stack [0.1, 0.3] and a
    # schedule [0.4, 0.5]; a step [0.8, 0.92]; a step after the window
    spans = [_span("server.drain", 0, None, 0.1, 0.7, updates=2),
             _span("server.stack", 1, 0, 0.1, 0.3),
             _span("server.schedule", 2, 0, 0.4, 0.5),
             _span("client.step", 3, None, 0.8, 0.92),
             _span("client.step", 4, None, 1.2, 1.4)]
    return tracing.Recording(spans, {"server.copy_bytes": 3_000_000})


EVENTS = [_ev("spin_kernel", 0.0, 0.00001, 0.0),
          _ev("Memcpy DtoD", 0.15, 0.30, 0.12),    # queued in the stack
          _ev("fedagg::norms", 0.32, 0.36, 0.31),  # in the drain alone
          _ev("gemm", 0.81, 0.90, 0.805),          # in the step
          _ev("add", 0.91, 0.95, 0.85),            # runs after the step
          _ev("Memset", 0.96, 0.97, None),         # no queueing call
          _ev("gemm", 1.25, 1.30, 1.25)]           # after the window


def test_device_work_goes_to_the_spans_that_queued_it():
    assert program_trace.host_offset_ns(EVENTS, 0.0) == OFF
    prog = program_trace.summarize(_recording(), EVENTS, 0.0, 1.0, OFF)
    st = prog.spans
    assert set(st) == {"server.drain", "server.stack", "server.schedule",
                       "client.step"}
    assert st["client.step"].count == 1        # the second opens after
    stack = st["server.stack"]
    assert stack.count == 1 and stack.host_s == pytest.approx(0.2)
    assert stack.busy_s == pytest.approx(0.15) and stack.events == 1
    assert stack.idle_s == pytest.approx(0.05)  # host [0.1, 0.3]
    drain = st["server.drain"]                  # its stack's work and more
    assert drain.busy_s == pytest.approx(0.19) and drain.events == 2
    assert drain.idle_s == pytest.approx(0.41)
    sched = st["server.schedule"]
    assert sched.busy_s == 0 == sched.events
    assert sched.idle_s == pytest.approx(0.1)
    step = st["client.step"]                    # the add ran after it closed
    assert step.busy_s == pytest.approx(0.13) and step.events == 2
    assert step.idle_s == pytest.approx(0.02)
    # the window's gaps, each charged by its middle: [0, 0.15] (0.075,
    # before the drain opens), [0.95, 0.96], [0.97, 1] to "other";
    # [0.30, 0.32] (the stack has closed) and [0.36, 0.81] to the drain;
    # [0.90, 0.91] to the step
    assert prog.idle == pytest.approx({"other": 0.15 + 0.01 + 0.03,
                                       "server.drain": 0.02 + 0.45,
                                       "client.step": 0.01})
    assert prog.counters == {"server.copy_bytes": 3_000_000}
    assert program_trace.host_offset_ns(EVENTS[1:], 0.0) is None
    assert program_trace.host_offset_ns(EVENTS, None) is None


class _Event:
    def __init__(self, kind, name, start, dur, corr):
        self.kind, self.n, self.s = kind, name, start
        self.d, self.c = dur, corr

    def device_type(self):
        from torch.autograd import DeviceType
        return getattr(DeviceType, self.kind)

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def correlation_id(self):
        return self.c


def test_each_device_event_takes_the_time_of_its_queueing_call():
    evs = [_Event("CUDA", "gemm", 300, 40, 7),
           _Event("CPU", "cuLaunchKernel", 100, 5, 7),
           _Event("CPU", "Lazy Function Loading", 150, 5, 7),
           _Event("CUDA", "Memset (Device)", 200, 10, 9),
           _Event("CPU", "cudaMalloc", 50, 5, 0)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))
    assert program_trace.launched(prof, cuda=True) == [
        program_trace.Launched("Memset (Device)", 200, 210, None),
        program_trace.Launched("gemm", 300, 340, 100)]
    cpu = program_trace.launched(prof, cuda=False)
    assert [(e.name, e.launch_ns) for e in cpu] == [
        ("cudaMalloc", 50), ("cuLaunchKernel", 100),
        ("Lazy Function Loading", 150)]


def _stats(**kw):
    return program_trace.SpanStats(**kw)


def test_the_eight_numbers_on_a_synthetic_summary():
    prog = program_trace.Program(
        {"server.drain": _stats(count=4, host_s=0.2),
         "server.stack": _stats(count=4, busy_s=0.01),
         "server.flatten": _stats(count=4, busy_s=0.03),
         "server.schedule": _stats(count=4, idle_s=0.002),
         "client.step": _stats(count=10, host_s=0.5, busy_s=0.9, events=5000,
                                idle_s=0.02)},
        {}, {"server.copy_bytes": 33_000_000})
    ctx = types.SimpleNamespace(program=prog, updates=10)
    read = {k: fn(ctx) for k, (_, fn, _) in program_trace.METRICS.items()}
    assert read == pytest.approx({
        "stack_ms_per_update.agg": 1.0, "flatten_ms_per_update.agg": 3.0,
        "copy_mb_per_update.agg": 3.3, "schedule_idle_ms_per_drain.agg": 0.5,
        "step_device_ms.train": 90.0, "step_host_ms.train": 50.0,
        "kernels_per_step.train": 500.0, "step_idle_ms.train": 2.0})
    assert all(fn(types.SimpleNamespace(updates=10)) is None
               for _, fn, _ in program_trace.METRICS.values())
    empty = types.SimpleNamespace(
        program=program_trace.Program({}, {}, {}), updates=0)
    assert all(fn(empty) is None
               for _, fn, _ in program_trace.METRICS.values())


@pytest.fixture(scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEED = 2 ** 31 + 7


def _note(notes, pattern):
    m = re.search(pattern, "\n".join(notes))
    assert m is not None, (pattern, notes)
    return [int(g) for g in m.groups()]


def test_server_cell_with_the_recorder_on(_one_thread):
    cell = tiny.agg_cell()
    res, notes = program_run.run(cell, SEED, 0.3, True, "cpu", time.time())
    assert res["correct"] and list(res)[-1] == "checks"
    mb = res["metrics"]["copy_mb_per_update.agg"]["value"]
    sizes = [int(s) for s in re.search(
        r"(\d+) updates in (\d+) drains", "\n".join(notes)).groups()]
    spans = res["program"]["spans"]
    assert spans["server.drain"]["count"] == sizes[1]
    # the program's bytes against the arithmetic of the window's drains
    from perfbench.weights import draw
    n = draw(cell.config, SEED, torch.device("cpu"))[0].numel()
    n_pad = n + (-n) % fedagg.BLOCK
    batched = spans["server.stack"]["count"]
    singles = sizes[1] - batched
    want = (4 * (sizes[0] - singles) * (n + 3 * n_pad)
            + 4 * singles * (n + n_pad))
    assert round(mb * 1e6 * sizes[0]) == want
    clamps, lookups, judged = _note(
        notes, r"gmis.clamps (\d+) of gmis.lookups (\d+), the judge's ring "
               r"clamps (\d+)")
    assert clamps == judged > 0 and lookups == res["attempted"]
    assert not tracing.active()


def test_training_cell_with_the_recorder_on(_one_thread):
    res, notes = program_run.run(tiny.fedtrain_cell(), SEED, 0.3, True,
                                 "cpu", time.time())
    assert res["correct"]
    steps, harness = _note(notes, r"client.steps (\d+), the harness's "
                                  r"window steps (\d+)")
    assert steps == harness > 0
    assert res["program"]["spans"]["client.step"]["count"] >= 1
    assert "step_host_ms.train" in res["metrics"]
    assert "copy_mb_per_update.agg" not in res["metrics"]
    assert not tracing.active()
