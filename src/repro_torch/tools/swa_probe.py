"""Where the bf16 decode kernel's time goes, against what it could take.

    PYTHONPATH=src python -m repro_torch.tools.swa_probe \\
        [--previous build/previous/swa_attn.cu] [--turns 4]

At each shape (B, S, H, KV, D) of ``SHAPES`` (bf16, every slot valid: the
step programs' decode_32k and long_500k shapes and the batch-4 serve
shape) it times, in turns that alternate their order, each as device ms
per call of a CUDA graph of calls: ``swa_decode_attention``; the same
kernel at other split counts; a loads-only copy of the kernel (its warps
skip all arithmetic and only stream K and V through the ring: the ceiling
of its copy pipeline); ``F.scaled_dot_product_attention`` on the same
inputs; and, with ``--previous FILE``, the design a commit's source holds
(``swa_decode_bf16`` of e.g. ``git show
ea92453:src/repro_torch/kernels/swa_attn/csrc/swa_attn.cu``). One JSON
object per shape: the medians over the turns, each beside the bound (K and
V read once over 3.35 TB/s), and the kernel's largest error against its
plain version. It needs a CUDA card; the first line is the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.swa_attn import swa_attn as SA

SHAPES = [(128, 2048, 10, 1, 256), (128, 4096, 32, 8, 80),
          (128, 32768, 48, 1, 128), (1, 4096, 32, 8, 80),
          (4, 2048, 10, 1, 256)]
HBM_BYTES_PER_S = 3.35e12
#: the most bytes (K and V repeated to H heads in f32) that one SDPA call
#: of the yardstick may stand for; larger batches go in slices
SLICE_BYTES = 8 << 30
#: the line of ``swa_tc`` at which a warp with no slots of a tile skips it;
#: the loads-only copy makes every warp skip every tile
_SKIP = "    if (!live || kSlots * ls >= tv) continue;\n"
_VP, _INT, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def device_ms(fn, reps: int = 10, trials: int = 3) -> float:
    """Median device ms per call of ``reps`` calls captured in one CUDA
    graph and replayed between two events."""
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
    out = []
    for _ in range(trials):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / reps)
    return statistics.median(out)


def _bind_tc(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.swa_decode_tc.argtypes = [_VP] * 4 + [_INT] * 7 + [_F] * 2 + [_VP] * 3
    lib.swa_decode_tc.restype = _INT
    lib.swa_tc_scratch_floats.argtypes = [_INT] * 4
    lib.swa_tc_scratch_floats.restype = ctypes.c_int64
    if lib.swa_init():
        raise RuntimeError("swa_init failed")
    return lib


def loads_only_library() -> ctypes.CDLL:
    """The kernel's source with every warp skipping every tile, built under
    ``build/repro_torch/probe/``."""
    text = SA.SOURCE.read_text()
    if text.count(_SKIP) != 1:
        raise RuntimeError("swa_tc's skip line moved: update _SKIP")
    path = build.BUILD_DIR / "probe" / "swa_loads_only.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text.replace(_SKIP, "    continue;\n"))
    return _bind_tc(build.load(path))


def tc_call(lib, q, k, v, vl, splits: int, chunk: int):
    """A call of ``lib``'s bf16 kernel at (splits, chunk) on fixed
    buffers."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    scratch = torch.empty(max(1, lib.swa_tc_scratch_floats(b, h, d, splits)),
                          dtype=torch.float32, device=q.device)

    def fn():
        err = lib.swa_decode_tc(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                vl.data_ptr(), b, h, s, kv, d, chunk, splits,
                                d ** -0.5, 0.0, scratch.data_ptr(),
                                out.data_ptr(), build.stream(q.device))
        if err:
            raise RuntimeError(f"swa_decode_tc failed: {err}")
        return out
    return fn


def previous_call(lib, q, k, v, vl, sms: int):
    """A call of a previous source's ``swa_decode_bf16`` (the pieces design
    in bf16) at ``piece_slots``' shape."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    split = SA.piece_slots(s, b * kv, sms)
    out = torch.empty_like(q)
    scratch = torch.empty(lib.swa_scratch_floats(b, h, s, d, split),
                          dtype=torch.float32, device=q.device)

    def fn():
        err = lib.swa_decode_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  vl.data_ptr(), b, h, s, kv, d, split,
                                  d ** -0.5, 0.0, scratch.data_ptr(),
                                  out.data_ptr(), build.stream(q.device))
        if err:
            raise RuntimeError(f"previous swa_decode_bf16 failed: {err}")
        return out
    return fn


def split_plans(s: int, counts=(1, 2, 16, 32)):
    """(splits, chunk) for each wanted split count, as tc_plan cuts."""
    grains = -(-s // SA.TC_GRAIN)
    plans = set()
    for n in counts:
        per = -(-grains // min(n, grains))
        plans.add((-(-grains // per), per * SA.TC_GRAIN))
    return sorted(plans)


def probe(shape, libs: dict, turns: int, seed: int = 12) -> dict:
    b, s, h, kv, d = shape
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    q = torch.empty(b, h, d, dtype=bf, device=dev).normal_(generator=g)
    k = torch.empty(b, s, kv, d, dtype=bf, device=dev).normal_(generator=g)
    v = torch.empty(b, s, kv, d, dtype=bf, device=dev).normal_(generator=g)
    vl = torch.full((b,), s, dtype=torch.int32, device=dev)
    sms = build.sm_count(dev)
    plan = SA.launch_plan(bf, b, kv, s, sms)
    out = SA.swa_decode_attention(q, k, v, vl)
    err = max(float((out[i:i + 1].float() - SA.swa_decode_plain(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], vl[i:i + 1]).float())
        .abs().max()) for i in range(b))
    fns = {"kernel": lambda: SA.swa_decode_attention(q, k, v, vl),
           "loads_only": tc_call(libs["loads_only"], q, k, v, vl,
                                 *plan[1:])}
    for n, c in split_plans(s):
        if (n, c) != tuple(plan[1:]):
            fns[f"kernel_{n}x{c}"] = tc_call(libs["kernel"], q, k, v, vl, n,
                                             c)
    # SDPA over batch slices, as chip_smoke.py's library_ms takes it
    qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    step = max(1, min(b, SLICE_BYTES // (8 * s * h * d + 8 * h * s)))
    sl = [slice(i, min(i + step, b)) for i in range(0, b, step)]
    fns["sdpa"] = lambda: torch.cat([F.scaled_dot_product_attention(
        qs[i], ks[i], vs[i], enable_gqa=h != kv) for i in sl])
    if "previous" in libs:
        fns["previous"] = previous_call(libs["previous"], q, k, v, vl, sms)
    times = {name: [] for name in fns}
    order = list(fns)
    for turn in range(turns):
        for name in (order if turn % 2 == 0 else order[::-1]):
            times[name].append(device_ms(fns[name]))
    bound = 4 * (b * h * d + b * s * kv * d) / HBM_BYTES_PER_S * 1e3
    ms = {name: statistics.median(t) for name, t in times.items()}
    return {"shape": list(shape), "plan": list(plan), "bound_ms": bound,
            "max_abs_err": err, "ms": ms,
            "share_of_bound": {n: bound / t for n, t in ms.items()},
            "spread": {n: (max(t) - min(t)) / statistics.median(t)
                       for n, t in times.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--previous", type=Path, default=None, metavar="FILE",
                    help="a previous swa_attn.cu whose swa_decode_bf16 to "
                         "time in turns with the kernel")
    ap.add_argument("--turns", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("swa_probe needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = {"kernel": _bind_tc(SA.load_library()),
            "loads_only": loads_only_library()}
    if args.previous is not None:
        prev = build.load(args.previous.resolve())
        prev.swa_decode_bf16.argtypes = ([_VP] * 4 + [_INT] * 6 + [_F] * 2
                                         + [_VP] * 3)
        prev.swa_decode_bf16.restype = _INT
        prev.swa_scratch_floats.argtypes = [_INT] * 5
        prev.swa_scratch_floats.restype = ctypes.c_int64
        if prev.swa_init():
            raise RuntimeError("the previous swa_init failed")
        libs["previous"] = prev
    for shape in SHAPES:
        print(json.dumps(probe(shape, libs, args.turns)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
