#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout (two
files, one ``nvcc`` each, started together), holds each kernel against its
plain PyTorch version on the card, times both, runs the port's AsyncFedED
simulation (``backend="pallas"``, the flat-state server) on the paper's
three tasks, on the burst-drain scenario synthetic-burst (f32 and bf16
deltas) and with int8 deltas (synthetic-1-1, femnist), checks that every
aggregation went through the kernels of its path and that the CUDA event
traces equal the CPU runs', and profiles two of the runs. The line of its
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
#: batched-kernel rows: bursts B at the paper lengths, f32 and bf16 deltas,
#: and one bandwidth row (B = 8 at 2^26: 17 x 256 MiB of inputs)
BATCHED = [(b, n) for n in (65536, 262144) for b in (2, 8, 15)]
BATCHED_BIG = (8, 1 << 26)
#: norms tolerances for the batched kernel, relative; a cross or Gram term
#: relative to the product of its two vectors' norms (Cauchy-Schwarz)
BATCHED_RTOL = {65536: 1e-5, 262144: 1e-5, 1 << 26: 1e-4}
#: per-task simulation length: (virtual seconds, update cap)
SIM = {"synthetic-1-1": (10.0, 40), "femnist": (10.0, 30),
       "shakespeare": (10.0, 20)}
#: runs of the burst and int8 paths: (label, scenario or task, FedConfig
#: changes, virtual seconds, update cap, compare with a CPU run). The
#: synthetic-burst runs use the loop engine (the cohort engine is not
#: ported). Its first burst (of 24) comes after 39 single arrivals, so the
#: bf16 run takes 40 updates, the fewest that reach it. The long run (all
#: 10 virtual seconds, 21 bursts) times the drain and checks the launches
#: but is not compared with a CPU run: at its 51st drain one client's local
#: training turns a 1e-7 difference in its starting model into a 3.5e-3
#: difference in its delta (measured on the card, PERF.md), and the two
#: traces part at update 411.
PATHS = [("synthetic-burst", "synthetic-burst", dict(client_engine="loop"),
          10.0, 60, True),
         ("synthetic-burst-bf16", "synthetic-burst",
          dict(client_engine="loop", delta_compression="bf16"), 10.0, 40,
          True),
         ("synthetic-burst-long", "synthetic-burst",
          dict(client_engine="loop"), 10.0, 1000, False),
         ("synthetic-1-1-int8", "synthetic-1-1",
          dict(backend="pallas", delta_compression="int8"), 10.0, 40, True),
         ("femnist-int8", "femnist",
          dict(backend="pallas", delta_compression="int8"), 10.0, 30, False)]
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


def rotated_ms(fn, make, set_bytes: int) -> float:
    """Device ms per call of ``fn(*make())`` with its inputs cycled through
    ``ROTATE_BYTES`` of distinct copies, one copy per captured call, so
    that each call reads from device memory and the bytes-over-3.35 TB/s
    bound applies (the outputs may still be written back from L2)."""
    sets = [make() for _ in range(-(-ROTATE_BYTES // set_bytes))]
    it = itertools.cycle(sets)
    return device_ms(lambda: fn(*next(it)), reps=len(sets))


def bound_ms(nbytes: float, flops: float):
    """The least time the card could take: the larger of bytes over the HBM
    rate and f32 flops over the f32 rate; and which one it is."""
    b, f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(b, f) * 1e3, ("bytes" if b >= f else "operations")


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
    fedagg.load_libraries()
    ptxas = [l.strip() for src in fedagg.SOURCES
             for l in build.build_log(src).splitlines()
             if "registers" in l or "spill" in l]
    emit({"phase": "build", "seconds": time.time() - t0,
          "sources": [str(src.relative_to(ROOT)) for src in fedagg.SOURCES],
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
        mk = lambda: (torch.randn(n, device=dev, generator=g),
                      torch.randn(n, device=dev, generator=g),
                      torch.randn(n, device=dev, generator=g))
        rot = (rotated_ms(fedagg.fedagg_norms, mk, 12 * n)
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
        rot = (rotated_ms(fedagg.fedagg_axpy,
                          lambda: (*mk()[:2], eta), 12 * n)
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


def phase_q_kernels(torch, fedagg, compression) -> dict:
    """The int8 sweeps against their plain versions at every length of
    ``SIZES``; returns the rows at the synthetic-1-1 length. Bytes: x_t,
    x_stale or the output (8), one byte of q and a scale per 1024
    elements."""
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(1)
    main = {}
    for label, n in SIZES:
        def make():
            x = torch.randn(n, device=dev, generator=g)
            d = 0.05 * torch.randn(n, device=dev, generator=g)
            d[:fedagg.QBLOCK] = 0.0                 # an all-zero block
            cd = compression.quantize_vec(d, "int8", n)
            return x, x + 0.01 * torch.randn(n, device=dev, generator=g), \
                cd.q, cd.scales
        x, xs, q, sc = make()
        eta = torch.full((), 0.37, device=dev)
        nbytes = 9 * n + 4 * (n // fedagg.QBLOCK)
        reps = 5 if n >= (1 << 28) else 20
        big = n >= (1 << 28)

        out = fedagg.fedagg_norms_q(x, xs, q, sc)
        ref = fedagg.norms_q_plain(x, xs, q, sc)
        err = (out - ref).abs()
        rel = float((err / ref.abs()).max())
        repeat = all(torch.equal(out, fedagg.fedagg_norms_q(x, xs, q, sc))
                     for _ in range(5))
        check(rel <= NORMS_RTOL[n], f"norms_q n={n} rel err {rel}")
        check(repeat, f"norms_q n={n} not bitwise reproducible")
        k = timings(lambda: fedagg.fedagg_norms_q(x, xs, q, sc), reps)
        plain = timings(lambda: fedagg.norms_q_plain(x, xs, q, sc), reps)
        rot = (k["device"] if big else
               rotated_ms(fedagg.fedagg_norms_q, make, nbytes))
        bms, by = bound_ms(nbytes, 6 * n)
        row = {"phase": "kernel", "name": "fedagg_norms_q", "size": label,
               "n": n, "max_abs_err": float(err.max()), "max_rel_err": rel,
               "rtol": NORMS_RTOL[n], "bitwise_repeat": repeat,
               "ms": k["device"], "ms_rotated": rot,
               "plain_ms": plain["device"], "bound_ms": bms, "bound_by": by,
               "gb_per_s_rotated": nbytes / rot / 1e6, "library_ms": None,
               "call_ms": k["call"], "plain_call_ms": plain["call"]}
        emit(row)
        if n == SIZES[0][1]:
            main["fedagg_norms_q"] = row

        out = fedagg.fedagg_axpy_q(x, q, sc, eta)
        diff = float((out - fedagg.axpy_q_plain(x, q, sc, eta)).abs().max())
        check(diff == 0.0, f"axpy_q n={n} max abs err {diff}")
        k = timings(lambda: fedagg.fedagg_axpy_q(x, q, sc, eta), reps)
        plain = timings(lambda: fedagg.axpy_q_plain(x, q, sc, eta), reps)
        rot = (k["device"] if big else rotated_ms(
            lambda a, b_, c, e: fedagg.fedagg_axpy_q(a, c, e, eta), make,
            nbytes))
        bms, by = bound_ms(nbytes, 3 * n)
        row = {"phase": "kernel", "name": "fedagg_axpy_q", "size": label,
               "n": n, "max_abs_err": diff, "ms": k["device"],
               "ms_rotated": rot, "plain_ms": plain["device"],
               "bound_ms": bms, "bound_by": by,
               "gb_per_s_rotated": nbytes / rot / 1e6, "library_ms": None,
               "call_ms": k["call"], "plain_call_ms": plain["call"]}
        emit(row)
        if n == SIZES[0][1]:
            main["fedagg_axpy_q"] = row
        del x, xs, q, sc, out, ref, err
        torch.cuda.empty_cache()
    return main


def batched_rows(torch, fedagg, b: int, n: int, dtype, seed: int = 0):
    """fedagg_norms_batched and fedagg_apply_batched at (B, n) with a
    ``dtype`` delta, each against its plain version, timed; returns the two
    rows. Work counted: the norms read x_t, B stales and B deltas and do
    3B^2 + 4B flops per element (B drifts, B squared drifts, B^2 cross
    terms, the B(B+1)/2 Gram terms of one triangle, a multiply and an add
    each); the apply reads x_t and B deltas, writes one vector, and does 2B
    flops per element."""
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(seed)
    dbytes = 4 if dtype == torch.float32 else 2

    def make():
        x = torch.randn(n, device=dev, generator=g)
        xs = x + 0.01 * torch.randn(b, n, device=dev, generator=g)
        return x, xs, (0.05 * torch.randn(b, n, device=dev,
                                          generator=g)).to(dtype)
    x, xs, d = make()
    etas = torch.linspace(0.1, 0.9, b, device=dev)
    big = n > (1 << 20)
    reps = 5 if big else 20
    tag = {"B": b, "n": n, "delta": str(dtype).replace("torch.", "")}

    got = fedagg.fedagg_norms_batched(x, xs, d)
    d0, dn, cross, gram = fedagg.norms_batched_plain(x, xs, d)
    rtol = BATCHED_RTOL[n]
    rel = max(float(((got[0] - d0).abs() / d0).max()),
              float(((got[1] - dn).abs() / dn).max()))
    scaled = max(
        float(((got[2] - cross).abs() / (d0[:, None] * dn[None]).sqrt()
               ).max()),
        float(((got[3] - gram).abs() / (dn[:, None] * dn[None]).sqrt()
               ).max()))
    abs_err = max(float((a - w).abs().max())
                  for a, w in zip(got, (d0, dn, cross, gram)))
    again = fedagg.fedagg_norms_batched(x, xs, d)
    repeat = all(torch.equal(a, c) for a, c in zip(got, again))
    check(rel <= rtol and scaled <= rtol,
          f"norms_batched {tag}: rel {rel}, scaled {scaled} > {rtol}")
    check(repeat, f"norms_batched {tag} not bitwise reproducible")
    nbytes = 4 * n * (1 + b) + dbytes * b * n
    k = timings(lambda: fedagg.fedagg_norms_batched(x, xs, d), reps)
    plain = timings(lambda: fedagg.norms_batched_plain(x, xs, d), reps)
    rot = k["device"] if big else rotated_ms(fedagg.fedagg_norms_batched,
                                             make, nbytes)
    bms, by = bound_ms(nbytes, (3 * b * b + 4 * b) * n)
    norms = {"phase": "kernel", "name": "fedagg_norms_batched", **tag,
             "max_abs_err": abs_err, "max_rel_err": rel,
             "max_scaled_err": scaled, "rtol": rtol,
             "bitwise_repeat": repeat, "ms": k["device"], "ms_rotated": rot,
             "plain_ms": plain["device"], "bound_ms": bms, "bound_by": by,
             "gb_per_s_rotated": nbytes / rot / 1e6, "library_ms": None,
             "call_ms": k["call"], "plain_call_ms": plain["call"]}

    out = fedagg.fedagg_apply_batched(x, d, etas)
    diff = float((out - fedagg.apply_batched_plain(x, d, etas)).abs().max())
    check(diff == 0.0, f"apply_batched {tag}: max abs err {diff}")
    nbytes = 8 * n + dbytes * b * n
    k = timings(lambda: fedagg.fedagg_apply_batched(x, d, etas), reps)
    plain = timings(lambda: fedagg.apply_batched_plain(x, d, etas), reps)
    lib = (timings(lambda: torch.addmv(x, d.t(), etas), reps)
           if dtype == torch.float32 else None)
    rot = k["device"] if big else rotated_ms(
        lambda a, b_, c: fedagg.fedagg_apply_batched(a, c, etas), make,
        nbytes)
    bms, by = bound_ms(nbytes, 2 * b * n)
    apply = {"phase": "kernel", "name": "fedagg_apply_batched", **tag,
             "max_abs_err": diff, "ms": k["device"], "ms_rotated": rot,
             "plain_ms": plain["device"], "bound_ms": bms, "bound_by": by,
             "gb_per_s_rotated": nbytes / rot / 1e6,
             "library_ms": lib["device"] if lib else None,
             "call_ms": k["call"], "plain_call_ms": plain["call"],
             "library_call_ms": lib["call"] if lib else None}
    del x, xs, d, got, again, out
    torch.cuda.empty_cache()
    return norms, apply


def phase_batched_kernels(torch, fedagg) -> None:
    """The batched pair at every (B, n) of ``BATCHED`` with f32 and bf16
    deltas, and at ``BATCHED_BIG`` with f32."""
    shapes = [(b, n, dt) for b, n in BATCHED
              for dt in (torch.float32, torch.bfloat16)]
    for b, n, dt in shapes + [(*BATCHED_BIG, torch.float32)]:
        for row in batched_rows(torch, fedagg, b, n, dt):
            emit(row)


def _time_calls(obj, attr: str, acc: list) -> None:
    """Wrap ``obj.attr`` so each call's host seconds land in ``acc``."""
    inner = getattr(obj, attr)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = inner(*args, **kw)
        acc.append(time.perf_counter() - t0)
        return out

    setattr(obj, attr, timed)


def _key(history):
    return [(r.iteration, r.client_id, r.lag, r.k_next) for r in history]


def run_sim(torch, fedagg, task, fed, max_time: float, max_updates: int,
            timed: str, compare_cpu: bool):
    """One measured FederatedSimulation of ``task`` on the card, after an
    unmeasured run of ``WARMUP_UPDATES`` updates of the same task (so the
    timings are of a process that has used every kernel before). Every
    launch count is set to 0 just before the measured run and read just
    after it. Returns (row, result, drain sizes, launch counts).

    The row splits the run's host time into client training, server work
    (``timed``: ``on_update`` per aggregation or ``on_update_batch`` per
    drain; either ends in a wait on the device, so it covers the device
    work) and evaluation. With ``compare_cpu`` the same run on the CPU from
    the same initial params must give the same event trace."""
    from repro_torch.core.simulator import FederatedSimulation
    from repro_torch.utils import pytree as pt

    FederatedSimulation(task, fed, "asyncfeded", seed=1, device="cuda").run(
        max_time=max_time, eval_every=5, max_updates=WARMUP_UPDATES)
    torch.cuda.synchronize()
    sim = FederatedSimulation(task, fed, "asyncfeded", seed=0, device="cuda")
    init = pt.tree_map(lambda t: t.cpu(), sim.server.params)
    sizes, server_s, client_s, eval_s = [], [], [], []
    drain = sim.server.on_update_batch
    sim.server.on_update_batch = lambda ups: sizes.append(len(ups)) or drain(
        ups)
    _time_calls(sim.server, timed, server_s)
    _time_calls(sim, "_eval_point", eval_s)
    for c in sim.clients:
        _time_calls(c, "run_local", client_s)
    fedagg.reset_launches()
    t0 = time.perf_counter()
    res = sim.run(max_time=max_time, eval_every=5, max_updates=max_updates)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in fedagg.KERNELS}
    row = {"updates": res.total_updates, "aggregations": len(res.history),
           "drains": res.total_drains, "client_rounds": len(client_s),
           "max_accuracy": res.max_accuracy(),
           "final_accuracy": res.points[-1].accuracy, "wall_s": wall,
           "client_s": sum(client_s), "server_s": sum(server_s),
           "eval_s": sum(eval_s),
           f"server_ms_per_{'aggregation' if timed == 'on_update' else 'drain'}":
               1e3 * sum(server_s) / max(len(server_s), 1),
           "server_ms_median": 1e3 * statistics.median(server_s or [0]),
           "launches": counts}
    check(len(res.history) > 0, f"{task.name}: no aggregation happened")
    check(bool(torch.isfinite(sim.server._flat.vec).all()),
          f"{task.name}: non-finite model")
    if compare_cpu:
        cpu = FederatedSimulation(task, fed, "asyncfeded", seed=0,
                                  device="cpu", init_params=init)
        ref = cpu.run(max_time=max_time, eval_every=5,
                      max_updates=max_updates)
        same = _key(res.history) == _key(ref.history)
        if not same:
            first = next(i for i, (a, b) in enumerate(
                zip(_key(res.history), _key(ref.history))) if a != b)
            row["first_difference"] = {
                "index": first, "cuda": _key(res.history)[first],
                "cpu": _key(ref.history)[first],
                "gamma_cuda": res.history[first].gamma,
                "gamma_cpu": ref.history[first].gamma}
        acc_gap = abs(res.points[-1].accuracy - ref.points[-1].accuracy)
        row.update(cpu_history_identical=same, cpu_acc_gap=acc_gap,
                   acc_atol=ACC_ATOL)
        if not same:
            emit(row)
        check(same, f"{task.name}: CUDA and CPU event histories differ")
        check(acc_gap <= ACC_ATOL,
              f"{task.name}: CUDA vs CPU accuracy gap {acc_gap}")
    return row, res, sizes, counts, sim


def _add(launches: dict, counts: dict) -> None:
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v


def phase_sims(torch, fedagg, launches: dict) -> None:
    """The port's main path on the card: FederatedSimulation with the
    flat-state server on each paper task, window 0, f32 deltas: every
    aggregation launches the single-arrival sweeps once and nothing else.
    ``launches`` sums the counts of every run."""
    from repro_torch import configs

    for name, (max_time, max_updates) in SIM.items():
        task = configs.PAPER_TASKS[name]
        fed = dataclasses.replace(task.fed, backend="pallas")
        row, res, _, counts, _ = run_sim(
            torch, fedagg, task, fed, max_time, max_updates, "on_update",
            compare_cpu=name == "synthetic-1-1")
        aggs = len(res.history)
        single = ("fedagg_norms", "fedagg_axpy")
        check(all(counts[k] == (aggs if k in single else 0) for k in counts),
              f"{name}: launches {counts} != aggregations {aggs}")
        emit({"phase": "sim", "task": name, **row})
        _add(launches, counts)


def phase_paths(torch, fedagg, compression, launches: dict) -> int:
    """The burst drain and compressed transport on the card (``PATHS``).
    In a burst run the batched launches must equal the drains of two or
    more arrivals and the single-arrival launches the drains of one; the
    bf16 run's batched launches must all take bf16 deltas; an int8 run's
    int8 launches must equal its aggregations, and one delta must quantize
    to the same bytes on the card and on the CPU. Returns the median size
    of the long f32 burst run's multi-arrival drains."""
    from repro_torch import configs
    from repro_torch.utils import pytree as pt

    median_b = None
    for label, base, change, max_time, max_updates, compare in PATHS:
        task = (configs.SCENARIOS[base] if base in configs.SCENARIOS.names()
                else configs.PAPER_TASKS[base])
        fed = dataclasses.replace(task.fed, **change)
        dtypes = []
        packed = fedagg.norms_batched_packed

        def record(x_t, x_stales, deltas):
            if x_t.is_cuda:                   # not the CPU comparison run
                dtypes.append(str(deltas.dtype))
            return packed(x_t, x_stales, deltas)
        fedagg.norms_batched_packed = record
        try:
            row, res, sizes, counts, sim = run_sim(
                torch, fedagg, task, fed, max_time, max_updates,
                "on_update_batch", compare)
        finally:
            fedagg.norms_batched_packed = packed
        multi = [b for b in sizes if b > 1]
        hist = {str(b): sizes.count(b) for b in sorted(set(sizes))}
        row.update(phase="path", run=label, burst_sizes=hist,
                   batched_delta_dtypes=sorted(set(dtypes)))
        mode = fed.delta_compression
        if mode == "int8":
            aggs = len(res.history)
            check(not multi, f"{label}: an int8 run drained a burst")
            check(counts["fedagg_norms_q"] == counts["fedagg_axpy_q"] == aggs
                  and all(v == 0 for k, v in counts.items()
                          if not k.endswith("_q")),
                  f"{label}: launches {counts} != aggregations {aggs}")
            upd, _ = sim.clients[0].run_local(sim.server.params, 5,
                                              sim.server.t)
            vec = pt.FlatSpec(upd.delta, block=fedagg.BLOCK).flatten(
                upd.delta)
            gpu = compression.quantize_vec(vec, "int8", vec.numel())
            cpu = compression.quantize_vec(vec.cpu(), "int8", vec.numel())
            same_q = (torch.equal(gpu.q.cpu(), cpu.q) and
                      gpu.scales.cpu().numpy().tobytes()
                      == cpu.scales.numpy().tobytes())
            row["quantizer_bytes_equal_cpu"] = same_q
            check(same_q, f"{label}: int8 bytes differ on CUDA and CPU")
        else:
            check(len(multi) > 0, f"{label}: no drain of two or more")
            check(counts["fedagg_norms_batched"]
                  == counts["fedagg_apply_batched"] == len(multi),
                  f"{label}: batched launches {counts} != drains with "
                  f"B >= 2 ({len(multi)})")
            check(counts["fedagg_norms"] == counts["fedagg_axpy"]
                  == len(sizes) - len(multi),
                  f"{label}: single launches {counts} != drains with B = 1")
            want = "torch.bfloat16" if mode == "bf16" else "torch.float32"
            check(dtypes == [want] * len(multi),
                  f"{label}: batched deltas {sorted(set(dtypes))}, "
                  f"expected {want}")
            if label == "synthetic-burst-long":
                median_b = int(statistics.median_low(multi))
        emit(row)
        _add(launches, counts)
    return median_b


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
        from repro_torch.core import compression
        from repro_torch.kernels import build
        from repro_torch.kernels.fedagg import fedagg
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the batched plain version needs f32")

    smi = phase_env(torch)
    phase_build(fedagg, build)
    main_rows = phase_kernels(torch, fedagg)
    main_rows.update(phase_q_kernels(torch, fedagg, compression))
    phase_batched_kernels(torch, fedagg)
    launches: dict = {}
    phase_sims(torch, fedagg, launches)
    median_b = phase_paths(torch, fedagg, compression, launches)
    # the batched pair once more at the burst run's median B, n = 65536
    norms, apply = batched_rows(torch, fedagg, median_b, 65536,
                                torch.float32, seed=2)
    for row in (norms, apply):
        row["main_path"] = True
        emit(row)
        main_rows[row["name"]] = row
    phase_profile(torch)

    csrc = "src/repro_torch/kernels/fedagg/csrc/"
    ref = "src/repro/kernels/fedagg/fedagg.py:"
    where = {"fedagg_norms": ("fedagg.cu", 101),
             "fedagg_axpy": ("fedagg.cu", 128),
             "fedagg_norms_batched": ("fedagg_batched.cu", 178),
             "fedagg_apply_batched": ("fedagg_batched.cu", 232),
             "fedagg_norms_q": ("fedagg.cu", 342),
             "fedagg_axpy_q": ("fedagg.cu", 379)}
    rows = []
    for k in fedagg.KERNELS:
        name = k.__name__
        r = main_rows[name]
        check(launches[name] > 0, f"{name} was not launched on a path")
        rows.append({"name": name, "route": "cuda",
                     "source": csrc + where[name][0],
                     "replaces": ref + str(where[name][1]),
                     "launches": launches[name], "n": r["n"],
                     "B": r.get("B"), "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "check": "ok"})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
