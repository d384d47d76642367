"""Runner ``server_uploads``: the AsyncFedED server alone, under the uploads
of a fleet of clients (:mod:`perfbench.uploads`).

The port's server, ``make_server("asyncfeded", params, fed,
backend="pallas")`` with the ring GMIS, starts from the benchmark's weights
and drains the uploads through ``on_update_batch``, in the form the port's
clients upload them: a delta tree of the model's shape, here one of a pool
of vectors made on the device from the seed, each of the norm that the
traffic's ``delta_ratio`` gives against the initial model. No client
trains, so the server's path does all the work: the GMIS lookups, the
snapshot and delta stacks, the batched sweeps, the schedule and Eq. 8.

Set-up runs until the ring holds ``gmis_depth`` versions (and at least
``warmup_drains`` drains); the window opens at the start of the next drain
and closes at the end of the first drain that ends ``--seconds`` later.
Every drain ends in a device sync: the reply's model then exists.
``updates_per_s`` is the updates drained in the window over its length;
``agg_ms_p95`` the 95th percentile, over every update of the window, of
the time of the call that drained it.

``correct``: the reference follows every update of the run exactly
(:mod:`perfbench.reference.pooled`) and the judge compares each update's
gamma, eta and trace, each reply, and the final model.
"""
from __future__ import annotations

import gc
import time
import types

import torch

from perfbench import bench, judge, stats, trace, uploads, weights
from perfbench.runners.fedtrain import device_info


def _pool_deltas(cfg: dict, pool: torch.Tensor, wire: str):
    """The pool as uploads: trees of views (f32), or the port's bf16 wire
    form of the same vectors (the control)."""
    if wire == "f32":
        return [weights.carve(cfg, row) for row in pool]
    from repro_torch.core import compression
    n = pool.shape[1]
    pad = (-n) % compression.BLOCK
    return [compression.quantize_vec(torch.nn.functional.pad(row, (0, pad)),
                                     "bf16", n) for row in pool]


def run(cell: bench.Cell, seed: int, seconds: float, traced: bool,
        device: str, t_process: float, hook=None,
        wire: str = "f32") -> bench.Outcome:
    """One run of a ``server_uploads`` cell. ``hook(server)`` is called once
    the server is built (the tests plant faults through it); ``wire="bf16"``
    sends the pool in the port's bf16 wire form (the control)."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.server import ClientUpdate, make_server
    from repro_torch.kernels.fedagg import fedagg
    from repro_torch.utils.device import resolve_device

    cfg, tr = cell.config, cell.traffic
    dev = resolve_device(device)
    fed = FedConfig(**tr["fed"])
    if dev.type == "cuda":
        fedagg.load_libraries()
    flat, tree = weights.draw(cfg, seed, dev)
    n = flat.numel()
    x1_norm = float(torch.linalg.vector_norm(flat, dtype=torch.float64))
    server = make_server("asyncfeded", tree, fed, backend="pallas")
    del flat, tree
    pool = weights.draw_pool(seed, tr["pool"], n, tr["delta_ratio"] * x1_norm,
                             dev)
    deltas = _pool_deltas(cfg, pool, wire)
    if hook is not None:
        hook(server)
    traffic = uploads.Uploads(tr, seed)
    for c in range(tr["clients"]):
        reply = server.on_connect(c)
        traffic.send(c, 0.0, reply.k_next, reply.iteration)
    limit = server.batch_limit() or tr["clients"]
    sync = (torch.cuda.synchronize if dev.type == "cuda" else lambda: None)
    spans = trace.Spans(dev, sync=False)
    drains = []            # per drain: [(upload, reply iteration, reply K)]

    def one_drain():
        now, ups = traffic.next_drain(limit)
        upds = [ClientUpdate(u.client, u.snapshot, u.k, deltas[u.delta])
                for u in ups]
        ta = time.perf_counter()
        replies = server.on_update_batch(upds)
        sync()
        tb = time.perf_counter()
        for u, r in zip(ups, replies):
            traffic.send(u.client, now, r.k_next, r.iteration)
        drains.append([(u, r.iteration, r.k_next)
                       for u, r in zip(ups, replies)])
        return ta, tb

    for _ in range(max(tr["warmup_drains"], fed.gmis_depth)):
        one_drain()
    first = len(drains)
    dtrace = trace.DeviceTrace(dev) if traced else None
    if traced:
        dtrace.start()
        for k in fedagg.KERNELS:
            k.launches = 0
    setup_end = time.time()
    t0 = time.perf_counter()
    latency = []
    while True:
        ta, tb = one_drain()
        spans.by_name["server"].append((ta, tb))
        latency += [tb - ta] * len(drains[-1])
        if tb - t0 >= seconds:
            break
    t1 = tb
    info = device_info(dev)
    launches = {k.__name__: k.launches for k in fedagg.KERNELS}
    window, notes = None, []
    if traced:
        events = dtrace.stop()
        window = trace.summarize(dtrace, events, t0, t1, spans)
        info.update(busy_s=window.busy_s, window_s=window.window_s)
        notes += trace.launch_notes(window, launches)
    win = drains[first:]
    ctx = types.SimpleNamespace(
        window=window, window_s=t1 - t0, updates=len(latency),
        sizes=[len(d) for d in win],
        stales=[len({u.snapshot for u, _, _ in d}) for d in win],
        n=n, n_padded=n + (-n) % fedagg.BLOCK)
    history = list(server.history)
    final = weights.leaves(server.params)
    del server, pool, deltas, traffic
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed, clamps = judge.server_uploads(
        cfg, tr, seed, dev, drains, history, final, cell.limits)
    del final
    notes.append(f"info: window {ctx.window_s:.3f} s, {ctx.updates} updates "
                 f"in {len(win)} drains (mean {ctx.updates / len(win):.2f}), "
                 f"{len(drains)} drains in all, "
                 f"max lag {max(h.lag for h in history)}, "
                 f"ring clamps {clamps}")
    return bench.Outcome(
        attempted=len(history), failed=failed,
        end_to_end={"updates_per_s": ctx.updates / ctx.window_s,
                    "agg_ms_p95": 1e3 * stats.p95(latency),
                    "setup_s": setup_end - t_process},
        checks=checks, device=info, ctx=ctx if traced else None,
        breakdown=None if window is None else window.breakdown(),
        notes=notes)
