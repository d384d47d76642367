"""Runner ``fedtrain``: federated training of a model with AsyncFedED.

The port's own path runs: ``FederatedSimulation(task, fed, "asyncfeded")``
with the task, the federation and the engine that the traffic file states,
from the benchmark's weights (``init_params``), with the benchmark's token
streams in the clients' place and its evaluation batch in the simulation's.
The harness wraps three methods of the instance: ``_run_locals`` (the
client layer), ``server.on_update_batch`` (the server) and
``_eval_point`` (evaluation).

Set-up runs from the process's start through the initial evaluation, the
seeding fan-out and the drains up to the one in which the last client's
``setup_rounds``-th round is drained: so set-up holds rounds of every kind
the window runs (a round from a reply's model, with the momentum the
client carried, at Eq. 8's K, alone in its cohort call). The window opens
at the start of the next drain and closes at the end of the first drain
that ends ``--seconds`` after it opened. ``train_tokens_per_s`` is the
tokens of every local step run inside the window over its length.

``correct``: the reference follows the set-up's stage from the same inputs
(the evaluation at the initial model, every round drained in set-up and
its drains) and the judge compares the numbers of
:func:`perfbench.judge.fedtrain`; the integers of every update of the run,
the window's too, are checked against Eq. 8 and the replies. A model that
routes tokens to experts has its expert choices recorded through set-up
(:mod:`perfbench.tap`), which the reference follows and judges
(:mod:`perfbench.reference.route`); the window runs without the tap.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
import types
import typing

import torch

from perfbench import bench, feed, judge, tap, trace, weights
from perfbench.reference import federation, route
from perfbench.reference.ops import exact_matmul


def port_config(cfg: dict):
    """The port's ModelConfig of a configuration file: the registered
    architecture with every key of the file that names one of its fields.
    A sub-configuration (``ssm``, ``moe``) replaces its keys in the
    architecture's, or is built from its dataclass where the architecture
    has none; a list is a tuple. Keys that name no field are ignored."""
    from repro_torch.configs import get_arch
    base = get_arch(cfg["port_arch"])
    hints = typing.get_type_hints(type(base))
    fields = {f.name: _port_value(getattr(base, f.name), hints[f.name],
                                  cfg[f.name])
              for f in dataclasses.fields(base) if f.name in cfg}
    return dataclasses.replace(base, **fields)


def _tuples(value):
    return tuple(value) if isinstance(value, list) else value


def _port_value(current, hint, value):
    if not isinstance(value, dict):
        return _tuples(value)
    value = {k: _tuples(v) for k, v in value.items()}
    if current is not None:
        return dataclasses.replace(current, **value)
    cls = [t for t in typing.get_args(hint) if dataclasses.is_dataclass(t)]
    return cls[0](**value)


def has_ssd(cfg: dict) -> bool:
    """Whether the configuration has SSD layers (an ``ssm`` section)."""
    return "ssm" in cfg


def port_task(cfg: dict, traffic: dict):
    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.shapes import TRAIN_4K
    from repro_torch.core.tasks import ArchTask
    fed = FedConfig(**traffic["fed"])
    shape = dataclasses.replace(TRAIN_4K, seq_len=traffic["seq_len"],
                                global_batch=traffic["rows"])
    return ArchTask(cfg=port_config(cfg), shape=shape,
                    q_chunk=traffic["q_chunk"], kv_chunk=traffic["kv_chunk"],
                    fed_cfg=fed), fed


def load_kernels(cfg: dict) -> None:
    """Build (first run in a checkout) or load the kernels the cell runs."""
    from repro_torch.kernels.fedagg import fedagg
    fedagg.load_libraries()
    if has_ssd(cfg):
        from repro_torch.kernels.ssd import ssd
        ssd.load_library()


class _Run:
    """State of one run: the window, the spans, and what set-up captures
    for the judge."""

    def __init__(self, sim, cfg, traffic, seed, seconds, traced, device):
        self.sim, self.cfg = sim, cfg
        self.seed, self.seconds, self.device = seed, seconds, device
        self.spans = trace.Spans(device, sync=traced)
        self.dtrace = trace.DeviceTrace(device) if traced else None
        self.setup_rounds = traffic["setup_rounds"]
        self.num_clients = traffic["fed"]["num_clients"]
        self.drains = []                  # [(client, snapshot, k_used)] each
        self.drained = {}                 # client -> rounds drained
        self.trained = {}                 # client -> rounds trained
        self.setup_drains = None
        self.window_drains = 0
        self.updates = 0
        self.steps = 0
        self.evals = 0
        self.t0 = self.t1 = None
        self.closed = False
        #: per-leaf norms: "delta" per (client, round), "grad1" per client
        #: (first rounds), "change" over the set-up's drains
        self.captured = {"eval_loss": None, "delta": {}, "grad1": {},
                         "change": None, "lr": traffic["fed"]["local_lr"]}
        self.ssd_shapes = []
        self.evals_run = 0
        #: a routed model's expert choices, recorded through set-up
        self.tap = None
        if route.routes(cfg):
            self.tap = tap.Tap(lambda: sim.cohort_plan.width)
            self.tap.recording = True
            self.tap.install()
            self.captured["routes"] = self.tap.records
        self._wrap()

    @property
    def open(self) -> bool:
        return self.t0 is not None and not self.closed

    def _wrap(self) -> None:
        sim = self.sim
        run_locals = self.spans.wrap("client", sim._run_locals)
        drain = self.spans.wrap("server", sim.server.on_update_batch)
        evaluate = self.spans.wrap("eval", sim._eval_point)

        def locals_(jobs):
            if self.closed:             # after the window: nothing to train
                return [_placeholder(c, r) for c, r in jobs]
            if self.open:
                self.steps += sum(r.k_next for _, r in jobs)
            taps = self.tap is not None and self.tap.recording
            if taps:
                self.tap.fanout([(c.client_id, self.trained.get(c.client_id,
                                                                0), r.k_next)
                                 for c, r in jobs])
            out = run_locals(jobs)
            if taps:
                self.tap.done()
            if self.t0 is None:
                self._capture_rounds(jobs, out)
            return out

        def on_batch(upds):
            if self.t0 is None and self.setup_drains is not None:
                self._open()
            self.drains.append([(u.client_id, u.snapshot_iter, u.k_used)
                                for u in upds])
            replies = drain(upds)
            if self.open:
                self.updates += len(upds)
                self.window_drains += 1
                if time.perf_counter() - self.t0 >= self.seconds:
                    self._close()
            elif self.t0 is None:
                for u in upds:
                    self.drained[u.client_id] = (
                        self.drained.get(u.client_id, 0) + 1)
                if (len(self.drained) == self.num_clients
                        and min(self.drained.values()) >= self.setup_rounds):
                    self.setup_drains = len(self.drains)
                    self._capture_change()
            return replies

        def eval_point(now):
            if self.closed:
                return types.SimpleNamespace(time=now, iteration=0,
                                             accuracy=float("nan"),
                                             loss=float("nan"))
            if self.open:
                self.evals += 1
            taps = self.tap is not None and self.tap.recording
            if taps:
                self.tap.evaluation(self.evals_run)
            self.evals_run += 1
            p = evaluate(now)
            if taps:
                self.tap.done()
            if self.captured["eval_loss"] is None:
                self.captured["eval_loss"] = p.loss
            return p

        sim._run_locals = locals_
        sim.server.on_update_batch = on_batch
        sim._eval_point = eval_point

    def _open(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        if self.tap is not None:
            self.tap.recording = False
            self.tap.remove()
        if self.dtrace is not None:
            self._count_ssd_launches()
            self.dtrace.start()
            _reset_launches()
        self.spans.recording = True
        self.t0 = time.perf_counter()
        self.setup_end = time.time()

    def _close(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.closed = True
        self.spans.recording = False
        self.sim._max_updates = 0       # the drain loop stops after this drain

    def _count_ssd_launches(self) -> None:
        """Record each SSD kernel launch's shape (traced runs)."""
        if not has_ssd(self.cfg):
            return
        from repro_torch.kernels.ssd import ssd
        launch = ssd.launch

        def counted(x, dt, a_rows, b, c, *, chunk, h0=None):
            if self.open:
                self.ssd_shapes.append((*x.shape, b.shape[2], b.shape[3],
                                        chunk, h0 is not None))
            return launch(x, dt, a_rows, b, c, chunk=chunk, h0=h0)
        ssd.launch = counted

    def _capture_rounds(self, jobs, updates) -> None:
        """Per-leaf norms of each set-up round's delta, and of each first
        round's first gradient (``federation.first_gradient``: a round of
        K = 2 from no momentum)."""
        lr = self.captured["lr"]
        for (c, _), u in zip(jobs, updates):
            cid = c.client_id
            n = self.trained.get(cid, 0)
            self.trained[cid] = n + 1
            d = weights.leaves(u.delta)
            self.captured["delta"][(cid, n)] = federation.leaf_norms(d)
            if n == 0:
                self.captured["grad1"][cid] = federation.leaf_norms(
                    federation.first_gradient(d, weights.leaves(c._mu), lr))

    def _capture_change(self) -> None:
        """Per-leaf norms of the global model's change over the set-up's
        drains."""
        _, x1 = weights.draw(self.cfg, self.seed, self.device)
        x1 = weights.leaves(x1)
        x = weights.leaves(self.sim.server.params)
        self.captured["change"] = federation.leaf_norms(
            {k: x[k] - x1[k] for k in x1})
        del x1


def _placeholder(client, reply):
    from repro_torch.core.server import ClientUpdate
    return ClientUpdate(client.client_id, reply.iteration, reply.k_next, None)


def _kernels():
    from repro_torch.kernels.fedagg import fedagg
    out = {k.__name__: k for k in fedagg.KERNELS}
    try:
        from repro_torch.kernels.ssd import ssd
        out["ssd_scan"] = ssd.ssd_scan
    except ImportError:
        pass
    return out


def _reset_launches() -> None:
    for k in _kernels().values():
        k.launches = 0


def device_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": torch.cuda.max_memory_allocated()}


def execute(cell: bench.Cell, seed: int, seconds: float, traced: bool,
            device: str, hook=None) -> types.SimpleNamespace:
    """Run the program: set-up, the window, and the program's state freed.
    ``hook(sim)``, if given, is called once the simulation is built (the
    tests plant faults through it). Returns what the judge and the readers
    need."""
    from repro_torch.core.simulator import FederatedSimulation
    from repro_torch.utils.device import resolve_device

    cfg, tr = cell.config, cell.traffic
    route.require_checks(cfg, cell.limits)
    dev = resolve_device(device)
    exact_matmul()
    if tr["fed"]["local_lr_decay"] != 1.0 or tr["fed"]["k_initial"] != 2:
        raise ValueError("the judge reads the first gradient from a round "
                         "of two steps at a constant learning rate")
    if tr["setup_rounds"] < 2:
        raise ValueError("set-up drains a round from a reply of each client")
    task, fed = port_task(cfg, tr)
    if dev.type == "cuda":
        load_kernels(cfg)
    _, tree = weights.draw(cfg, seed, dev)
    sim = FederatedSimulation(task, fed, "asyncfeded", seed=seed, device=dev,
                              init_params=tree)
    del tree
    for c in sim.clients:
        c.batcher = feed.client_stream(seed, c.client_id, cfg, tr)
    sim.eval_batch = task.to_device(feed.eval_stream(seed, cfg, tr).next(),
                                    dev)
    if hook is not None:
        hook(sim)
    ssd_launch = _ssd_launch()
    r = _Run(sim, cfg, tr, seed, seconds, traced, dev)
    try:
        sim.run(max_time=tr["max_virtual_time"], eval_every=tr["eval_every"])
    finally:
        _restore_ssd_launch(ssd_launch)
        if r.tap is not None:
            r.tap.remove()
    if not r.closed:
        raise RuntimeError("the drain loop ended before the window closed")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    info = device_info(dev)
    launches = {k: f.launches for k, f in _kernels().items()}
    window, notes = None, []
    if traced:
        events = r.dtrace.stop()
        window = trace.summarize(r.dtrace, events, r.t0, r.t1, r.spans)
        info.update(busy_s=window.busy_s, window_s=window.window_s)
        notes += trace.launch_notes(window, launches)
    rows, seq = tr["rows"], tr["seq_len"]
    out = types.SimpleNamespace(
        device=dev, info=info, notes=notes, window=window,
        setup_end=r.setup_end, drains=r.drains, captured=r.captured,
        setup_drains=r.setup_drains,
        history=list(sim.server.history),
        ctx=types.SimpleNamespace(
            cfg=cfg, traffic=tr, window=window, spans=r.spans, t0=r.t0,
            t1=r.t1, window_s=r.t1 - r.t0, updates=r.updates,
            drains=r.window_drains, steps=r.steps,
            tokens=r.steps * rows * seq, evals=r.evals,
            ssd_shapes=r.ssd_shapes))
    # the program's state goes before the reference runs
    del r, sim, task
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def run(cell: bench.Cell, seed: int, seconds: float, traced: bool,
        device: str, t_process: float, hook=None) -> bench.Outcome:
    """One run of a ``fedtrain`` cell."""
    p = execute(cell, seed, seconds, traced, device, hook)
    cfg, tr, ctx = cell.config, cell.traffic, p.ctx
    checks, failed = judge.fedtrain(cfg, tr, seed, p.device, p.drains,
                                    p.setup_drains, p.history, p.captured,
                                    cell.limits, notes=p.notes)
    ratio = _delta_ratio(p.history, cfg, seed, p.device)
    bad = sum(not (math.isfinite(h.gamma) and math.isfinite(h.delta_norm))
              for h in p.history)
    p.notes.append(f"info: set-up {p.setup_drains} drains, window "
                   f"{ctx.window_s:.3f} s, {ctx.updates} "
                   f"updates in {ctx.drains} drains, {ctx.steps} local "
                   f"steps, {ctx.evals} evals, median delta/x {ratio:.6g}, "
                   f"{bad} of {len(p.history)} updates not finite")
    return bench.Outcome(
        attempted=ctx.updates, failed=failed,
        end_to_end={"train_tokens_per_s": ctx.tokens / ctx.window_s,
                    "setup_s": p.setup_end - t_process},
        checks=checks, device=p.info, ctx=ctx if traced else None,
        breakdown=None if p.window is None else p.window.breakdown(),
        notes=p.notes)


def _ssd_launch():
    try:
        from repro_torch.kernels.ssd import ssd
    except ImportError:
        return None
    return ssd.launch


def _restore_ssd_launch(launch) -> None:
    if launch is not None:
        from repro_torch.kernels.ssd import ssd
        ssd.launch = launch


def _delta_ratio(history, cfg: dict, seed: int, device) -> float:
    """Median ||delta|| over ||x_1|| of the run's updates: what the server
    cell's traffic scales its deltas to."""
    flat, _ = weights.draw(cfg, seed, device)
    x1 = float(torch.linalg.vector_norm(flat, dtype=torch.float64))
    del flat
    dn = sorted(h.delta_norm for h in history if math.isfinite(h.delta_norm))
    return dn[len(dn) // 2] / x1 if dn else float("nan")
