#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each kernel against its plain PyTorch version on the card, times both, runs
the port's AsyncFedED simulation (``backend="pallas"``, the flat-state
server) on the paper's three tasks, checks that every aggregation went
through both kernels, and profiles two of the runs. The line of its
standard output before the last is the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
them, the last line is ``{"ok": true, "device": {...}}``, and every other
line is one JSON object. Any failed check ends the script with a non-zero
exit before the last line. It imports nothing of JAX and nothing of the
JAX package.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM data sheet: device memory rate and f32 rate outside the
#: tensor cores (both at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

#: flat lengths on the main path (the paper tasks' padded n) and one large
#: length for the bandwidth figure (the flat state of a ~270M-param model)
SIZES = (("synthetic-1-1", 65536), ("femnist", 262144),
         ("shakespeare", 131072), ("2^28", 1 << 28))
#: relative tolerance of the norms kernel against the plain version: the
#: two sum in different orders, and the error grows with the length
NORMS_RTOL = {65536: 1e-5, 262144: 1e-5, 131072: 1e-5, 1 << 28: 1e-4}
#: per-task simulation length: (virtual seconds, update cap)
SIM = {"synthetic-1-1": (10.0, 40), "femnist": (10.0, 30),
       "shakespeare": (10.0, 20)}
#: updates of an unmeasured run of each task before its measured one, so
#: that first-use loading of PyTorch's kernels stays out of the timings
WARMUP_UPDATES = 3
#: bytes the rotated timing cycles its inputs through: more than the
#: H100's 50 MB L2, so each call reads its inputs from device memory
ROTATE_BYTES = 128 << 20
#: eval accuracy agreement, CUDA vs CPU run of synthetic-1-1 (its eval set
#: holds ~300 rows, so 0.01 is three rows)
ACC_ATOL = 0.01


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def call_ms(fn, reps: int = 20, trials: int = 7) -> float:
    """Per-call time of ``reps`` back-to-back calls from Python between two
    CUDA events (median of ``trials``): what a caller pays, the wrapper's
    host work included."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / reps)
    return statistics.median(out)


def device_ms(fn, reps: int = 20, trials: int = 7) -> float:
    """Per-call time on the card: ``reps`` calls captured in one CUDA graph
    and replayed between two CUDA events (median of ``trials``), so the
    host's launch work is out of the measurement. Inputs that ``fn`` reuses
    stay resident: at the paper lengths (<= 3.2 MB moved) they are served
    from the 50 MB L2, as they are when the server calls the sweeps back to
    back, and the device-memory bound does not hold for them."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / reps)
    del graph
    return statistics.median(out)


def timings(fn, reps: int) -> dict:
    return {"device": device_ms(fn, reps), "call": call_ms(fn, reps)}


def rotated_ms(torch, kernel, n: int, g, with_stale: bool) -> float:
    """Device ms per call of ``kernel`` with its inputs cycled through
    ``ROTATE_BYTES`` of distinct copies, one copy per captured call, so
    that each call reads from device memory and the bytes-over-3.35 TB/s
    bound applies (the outputs may still be written back from L2)."""
    sets = -(-ROTATE_BYTES // (12 * n))
    x = torch.randn(sets, n, device="cuda", generator=g)
    xs = x + 0.01 * torch.randn(sets, n, device="cuda", generator=g)
    d = 0.05 * torch.randn(sets, n, device="cuda", generator=g)
    eta = torch.full((), 0.37, device="cuda")
    it = itertools.cycle(range(sets))

    def call():
        i = next(it)
        return (kernel(x[i], xs[i], d[i]) if with_stale
                else kernel(x[i], d[i], eta))
    return device_ms(call, reps=sets)


def phase_env(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "gpu": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    return smi


def phase_build(fedagg, build) -> None:
    t0 = time.time()
    fedagg.load_library()
    ptxas = [l.strip() for l in build.build_log(fedagg.SOURCE).splitlines()
             if "registers" in l or "spill" in l]
    emit({"phase": "build", "seconds": time.time() - t0,
          "sources": [str(fedagg.SOURCE.relative_to(ROOT))],
          "ptxas": ptxas})


def phase_kernels(torch, fedagg) -> dict:
    """Each kernel against its plain version at every length; returns the
    rows at the synthetic-1-1 length (the main path's)."""
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)
    main = {}
    for label, n in SIZES:
        x = torch.randn(n, device=dev, generator=g)
        xs = x + 0.01 * torch.randn(n, device=dev, generator=g)
        d = 0.05 * torch.randn(n, device=dev, generator=g)
        eta = torch.full((), 0.37, device=dev)
        nbytes = 12 * n

        out = fedagg.fedagg_norms(x, xs, d)
        ref = fedagg.norms_plain(x, xs, d)
        err = (out - ref).abs()
        rel = float((err / ref.abs()).max())
        repeat = all(torch.equal(out, fedagg.fedagg_norms(x, xs, d))
                     for _ in range(5))
        check(rel <= NORMS_RTOL[n], f"norms n={n} rel err {rel}")
        check(repeat, f"norms n={n} not bitwise reproducible")
        # a bf16 delta is upcast on load; checked at the paper lengths
        if n < (1 << 28):
            db = d.to(torch.bfloat16)
            rel_b = float(((fedagg.fedagg_norms(x, xs, db)
                            - fedagg.norms_plain(x, xs, db)).abs()
                           / fedagg.norms_plain(x, xs, db).abs()).max())
            check(rel_b <= NORMS_RTOL[n], f"norms bf16 n={n} rel {rel_b}")
        reps = 5 if n >= (1 << 28) else 20
        k = timings(lambda: fedagg.fedagg_norms(x, xs, d), reps)
        plain = timings(lambda: fedagg.norms_plain(x, xs, d), reps)
        bound = max(nbytes / HBM_BYTES_PER_S, 5 * n / F32_FLOPS_PER_S) * 1e3
        rot = (rotated_ms(torch, fedagg.fedagg_norms, n, g, True)
               if n < (1 << 28) else k["device"])
        row = {"phase": "kernel", "name": "fedagg_norms", "size": label,
               "n": n, "max_abs_err": float(err.max()), "max_rel_err": rel,
               "rtol": NORMS_RTOL[n], "bitwise_repeat": repeat,
               "ms": k["device"], "ms_rotated": rot,
               "plain_ms": plain["device"],
               "bound_ms": bound, "bound_by": "bytes",
               "gb_per_s": nbytes / k["device"] / 1e6,
               "gb_per_s_rotated": nbytes / rot / 1e6, "library_ms": None,
               "call_ms": k["call"], "plain_call_ms": plain["call"]}
        emit(row)
        if n == SIZES[0][1]:
            main["fedagg_norms"] = row

        out = fedagg.fedagg_axpy(x, d, eta)
        ref = fedagg.axpy_plain(x, d, eta)
        ulp = torch.nextafter(ref.abs(), torch.full_like(ref, float("inf"))
                              ) - ref.abs()
        err = (out - ref).abs()
        ulps = float((err / ulp).max())
        check(ulps <= 1.0, f"axpy n={n} off by {ulps} ulp")
        if n < (1 << 28):
            db = d.to(torch.bfloat16)
            ub = float((fedagg.fedagg_axpy(x, db, eta)
                        - fedagg.axpy_plain(x, db, eta)).abs().max())
            check(ub == 0.0, f"axpy bf16 n={n} max abs err {ub}")
        eta_f = float(eta)
        k = timings(lambda: fedagg.fedagg_axpy(x, d, eta), reps)
        plain = timings(lambda: fedagg.axpy_plain(x, d, eta), reps)
        lib = timings(lambda: torch.add(x, d, alpha=eta_f), reps)
        bound = max(nbytes / HBM_BYTES_PER_S, 2 * n / F32_FLOPS_PER_S) * 1e3
        rot = (rotated_ms(torch, fedagg.fedagg_axpy, n, g, False)
               if n < (1 << 28) else k["device"])
        row = {"phase": "kernel", "name": "fedagg_axpy", "size": label,
               "n": n, "max_abs_err": float(err.max()), "max_ulp": ulps,
               "ms": k["device"], "ms_rotated": rot,
               "plain_ms": plain["device"],
               "bound_ms": bound, "bound_by": "bytes",
               "gb_per_s": nbytes / k["device"] / 1e6,
               "gb_per_s_rotated": nbytes / rot / 1e6,
               "library_ms": lib["device"], "call_ms": k["call"],
               "plain_call_ms": plain["call"],
               "library_call_ms": lib["call"]}
        emit(row)
        if n == SIZES[0][1]:
            main["fedagg_axpy"] = row
        del x, xs, d, out, ref, err, ulp
        torch.cuda.empty_cache()
    return main


def _time_calls(obj, attr: str, acc: list) -> None:
    """Wrap ``obj.attr`` so each call's host seconds land in ``acc``."""
    inner = getattr(obj, attr)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = inner(*args, **kw)
        acc.append(time.perf_counter() - t0)
        return out

    setattr(obj, attr, timed)


def phase_sims(torch, fedagg, launches: dict) -> None:
    """The port's main path on the card: FederatedSimulation with the
    flat-state server on each paper task. Every launch count is set to 0
    just before a run and read just after it; ``launches`` sums them.

    Each row splits the run's host time into client training, server
    aggregation (which ends in the server's one wait on the device per
    arrival, so it covers the device work) and evaluation. An unmeasured
    run of ``WARMUP_UPDATES`` updates of the same task comes first, so the
    timings are of a process that has used every kernel before."""
    from repro_torch import configs
    from repro_torch.core.simulator import FederatedSimulation
    from repro_torch.utils import pytree as pt

    for name, (max_time, max_updates) in SIM.items():
        task = configs.PAPER_TASKS[name]
        fed = dataclasses.replace(task.fed, backend="pallas")
        FederatedSimulation(task, fed, "asyncfeded", seed=1,
                            device="cuda").run(
            max_time=max_time, eval_every=5, max_updates=WARMUP_UPDATES)
        torch.cuda.synchronize()
        sim = FederatedSimulation(task, fed, "asyncfeded", seed=0,
                                  device="cuda")
        init = pt.tree_map(lambda t: t.cpu(), sim.server.params)
        server_s, client_s, eval_s = [], [], []
        _time_calls(sim.server, "on_update", server_s)
        _time_calls(sim, "_eval_point", eval_s)
        for c in sim.clients:
            _time_calls(c, "run_local", client_s)
        fedagg.reset_launches()
        t0 = time.perf_counter()
        res = sim.run(max_time=max_time, eval_every=5,
                      max_updates=max_updates)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k.__name__: k.launches for k in fedagg.KERNELS}
        aggs = len(res.history)
        row = {"phase": "sim", "task": name, "updates": res.total_updates,
               "aggregations": aggs, "client_rounds": len(client_s),
               "max_accuracy": res.max_accuracy(),
               "final_accuracy": res.points[-1].accuracy, "wall_s": wall,
               "client_s": sum(client_s), "server_s": sum(server_s),
               "eval_s": sum(eval_s),
               "server_ms_per_aggregation":
                   1e3 * sum(server_s) / max(len(server_s), 1),
               "server_ms_median": 1e3 * statistics.median(server_s or [0]),
               "launches": counts}
        check(aggs > 0, f"{name}: no aggregation happened")
        check(all(v == aggs for v in counts.values()),
              f"{name}: launches {counts} != aggregations {aggs}")
        vec = sim.server._flat.vec
        check(bool(torch.isfinite(vec).all()), f"{name}: non-finite model")
        if name == "synthetic-1-1":
            cpu = FederatedSimulation(task, fed, "asyncfeded", seed=0,
                                      device="cpu", init_params=init)
            ref = cpu.run(max_time=max_time, eval_every=5,
                          max_updates=max_updates)
            key = lambda h: [(r.iteration, r.client_id, r.lag, r.k_next)
                             for r in h]
            same = key(res.history) == key(ref.history)
            acc_gap = abs(res.points[-1].accuracy - ref.points[-1].accuracy)
            row.update(cpu_history_identical=same, cpu_acc_gap=acc_gap,
                       acc_atol=ACC_ATOL)
            check(same, "synthetic-1-1: CUDA and CPU event histories differ")
            check(acc_gap <= ACC_ATOL,
                  f"synthetic-1-1: CUDA vs CPU accuracy gap {acc_gap}")
        emit(row)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v


def phase_profile(torch) -> None:
    """synthetic-1-1 and femnist once more under torch.profiler: device
    busy time (the sum of the device-side events), the idle share of the
    wall time, and the kernels that take the most. The profiler's own host
    work lengthens the wall time, so the idle share is an upper bound.
    Shakespeare is left out: its LSTM launches some 10^5 small kernels per
    client round, and reading back that many events takes minutes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.core.simulator import FederatedSimulation

    for name in ("synthetic-1-1", "femnist"):
        max_time, max_updates = SIM[name]
        task = configs.PAPER_TASKS[name]
        fed = dataclasses.replace(task.fed, backend="pallas")
        sim = FederatedSimulation(task, fed, "asyncfeded", seed=0,
                                  device="cuda")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sim.run(max_time=max_time, eval_every=5, max_updates=max_updates)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device-side events (kernels, copies) with their own time ranges
        per_name: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                calls, us = per_name.get(e.name, (0, 0.0))
                per_name[e.name] = (calls + 1, us + e.time_range.elapsed_us())
        busy = sum(us for _, us in per_name.values()) / 1e6
        top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:10]
        emit({"phase": "profile", "task": name, "updates": max_updates,
              "wall_s": wall, "device_busy_s": busy,
              "device_idle_share": 1.0 - busy / wall if busy else None,
              "top": [{"name": k[:80], "calls": c, "device_ms": us / 1e3}
                      for k, (c, us) in top]})


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import build
        from repro_torch.kernels.fedagg import fedagg
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2

    smi = phase_env(torch)
    phase_build(fedagg, build)
    main_rows = phase_kernels(torch, fedagg)
    launches: dict = {}
    phase_sims(torch, fedagg, launches)
    phase_profile(torch)

    src = "src/repro_torch/kernels/fedagg/csrc/fedagg.cu"
    replaces = {"fedagg_norms": "src/repro/kernels/fedagg/fedagg.py:101",
                "fedagg_axpy": "src/repro/kernels/fedagg/fedagg.py:128"}
    rows = []
    for k in fedagg.KERNELS:
        r = main_rows[k.__name__]
        rows.append({"name": k.__name__, "route": "cuda", "source": src,
                     "replaces": replaces[k.__name__],
                     "launches": launches[k.__name__], "n": r["n"],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "check": "ok"})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
