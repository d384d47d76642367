"""The harness on the CPU: the format of ``BENCHMARK.json``, every cell's
files found by name, the traffic generators deterministic from the seed,
and the metric arithmetic on synthetic spans and device events."""
import json
import re
import types

import numpy as np
import pytest

from perfbench import bench, stats, trace, uploads
from perfbench.work import fedagg, flops, peaks, ssd

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"head|expand|d_model|d_ff|experts_per")


def _benchmark():
    with open(bench.ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_benchmark_file_keeps_its_format():
    b = _benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    assert b["paths"] == ["perfbench"]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"]: w for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for c in m.get("workloads", cells):
            reported = {n for n, e in e2e.items()
                        if c in e.get("workloads", cells)}
            assert m["moves"] in reported, (m["name"], c)
    for c in b["configs"]:
        assert c["file"].startswith("perfbench/")
        assert not any(WIDTH.search(k) for k in c["reduced"])
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(b["workloads"])
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(
        1, len(b["workloads"]) // 4)
    for w in b["workloads"]:
        assert len(w["why"]) <= 200
        reported = [n for n, e in e2e.items()
                    if w["name"] in e.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w["name"] in m.get("workloads", cells)
                   for m in b["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  _benchmark()["workloads"]])
def test_every_cell_is_found_by_name(cell):
    c = bench.load_cell(cell)
    bench.runner(c.traffic["runner"])
    assert c.config["name"] == _benchmark()["workloads"][[
        w["name"] for w in _benchmark()["workloads"]].index(cell)]["config"]
    assert c.per_layer and c.end_to_end
    for m in c.per_layer:
        assert callable(bench.reader(m["name"]))
    assert set(c.limits) >= {"rule_gap", "trace_errors"}


def test_token_streams_repeat_from_the_seed():
    from perfbench import feed
    from perfbench.tests import tiny
    cfg, tr = tiny.MAMBA2, tiny.fedtrain_cell().traffic
    a = feed.eval_stream(2 ** 33 + 1, cfg, tr).next()[0]["tokens"]
    b = feed.eval_stream(2 ** 33 + 1, cfg, tr).next()[0]["tokens"]
    c = feed.eval_stream(2 ** 33 + 2, cfg, tr).next()[0]["tokens"]
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < cfg["vocab_size"]


def _replay(seed, limit=15, drains=200):
    with open(bench.ROOT / "perfbench" / "traffic" /
              "uploads-burst32.json") as f:
        tr = json.load(f)
    t = uploads.Uploads(tr, seed)
    for c in range(tr["clients"]):
        t.send(c, 0.0, 2, 1)
    out, it = [], 1
    for _ in range(drains):
        now, ups = t.next_drain(limit)
        out.append([(u.client, u.snapshot, u.k, u.delta) for u in ups])
        it += len(ups)
        for u in ups:                     # a fixed reply: K from the client
            t.send(u.client, now, 1 + u.client % 3, it)
        assert len({u.epoch for u in ups}) == 1 and len(ups) <= limit
    return out


def test_upload_traffic_repeats_from_the_seed():
    a, b, c = _replay(2 ** 31 + 9), _replay(2 ** 31 + 9), _replay(7)
    assert a == b and a != c
    sizes = [len(d) for d in a]
    assert max(sizes) == 15 and min(sizes) >= 1


def test_p95_over_every_sample():
    assert stats.p95(list(range(1, 101))) == 95
    assert stats.p95([5.0] * 19 + [100.0]) == 5.0
    assert stats.p95([5.0] * 18 + [100.0] * 2) == 100.0
    assert stats.percentile([3, 1, 2], 50) == 2


def _ev(name, a, b):
    return trace.DeviceEvent(name, int(a * 1e9), int(b * 1e9))


def test_busy_and_idle_by_host():
    events = [_ev("k1", 0.1, 0.3), _ev("k2", 0.2, 0.4), _ev("k3", 0.6, 0.7)]
    busy = trace.busy_intervals(events, 0.0, 1e9)
    assert busy == [(1e8, 4e8), (6e8, 7e8)]
    spans = trace.Spans(types.SimpleNamespace(type="cpu"), sync=False)
    spans.by_name["client"].append((0.0, 0.5))
    idle = trace.idle_by_host(busy, 0.0, 1e9, 0.0, spans)
    assert idle["client"] == pytest.approx(0.1 + 0.2)
    assert idle["other"] == pytest.approx(0.3)
    assert spans.total("client", 0.25, 1.0) == pytest.approx(0.25)


def _window(ops, window_s=2.0, busy_s=1.5):
    return trace.Window(window_s, busy_s, ops, {})


def test_training_metrics_on_synthetic_spans():
    cfg = json.load(open(bench.ROOT / "perfbench/configs/mamba2-1.3b.json"))
    tr = bench.load_cell("mamba2-fedtrain").traffic
    spans = trace.Spans(types.SimpleNamespace(type="cpu"), sync=False)
    spans.by_name["client"] += [(0.0, 1.0), (1.2, 1.8)]
    spans.by_name["server"] += [(1.0, 1.1)]
    shape = (16, 512, 64, 64, 1, 128, 256, False)
    ssd_s = peaks.bound_s(*ssd.ssd_work(*shape)) * 10 / 0.4
    ctx = types.SimpleNamespace(
        cfg=cfg, traffic=tr, spans=spans, t0=0.0, t1=2.0, window_s=2.0,
        updates=4, steps=8, evals=1, ssd_shapes=[shape] * 10,
        window=_window({"void ssd::(anonymous namespace)::chunk_pass<4>(x)":
                        (40, ssd_s), "gemm": (7, 1.0)}))
    read = lambda m: bench.reader(m)(ctx)
    assert read("client_ms_per_update.train") == pytest.approx(400.0)
    assert read("server_ms_per_update.train") == pytest.approx(25.0)
    assert read("loop_other_share.train") == pytest.approx(15.0)
    assert read("ssd_scan_roofline") == pytest.approx(40.0)
    assert read("device_idle.train") == pytest.approx(25.0)
    want = (8 * flops.train_step_flops(cfg, 4, 512)
            + flops.forward_flops(cfg, 4, 512)) / (2.0 * peaks.F32_FLOPS)
    assert read("mfu.train") == pytest.approx(100 * want)
    ctx.ssd_shapes = []
    assert read("ssd_scan_roofline") is None


def test_server_metrics_on_synthetic_events():
    n, npad = 1000, 65536
    sweeps = peaks.bound_s(fedagg.drain_sweep_bytes(15, npad)
                           + fedagg.drain_sweep_bytes(1, npad))
    ctx = types.SimpleNamespace(
        window_s=0.5, updates=16, sizes=[15, 1], stales=[3, 1], n=n,
        n_padded=npad,
        window=_window({"void fedagg::(anonymous namespace)::apply": (
            3, 2 * sweeps), "Memcpy DtoD (Device -> Device)": (4, 0.016),
            "void at::native::CatArrayBatchedCopy<x>": (2, 0.016),
            "gemm": (1, 0.5)}, window_s=0.5, busy_s=0.4))
    read = lambda m: bench.reader(m)(ctx)
    assert read("fedagg_roofline.agg") == pytest.approx(50.0)
    assert read("copy_ms_per_update.agg") == pytest.approx(2.0)
    assert read("device_idle.agg") == pytest.approx(20.0)
    need = fedagg.rule_bytes(15, 3, n) + fedagg.rule_bytes(1, 1, n)
    assert read("mfu.agg") == pytest.approx(100 * need / peaks.HBM_BYTES
                                            / 0.5)


def test_result_line_puts_the_checks_last():
    cell = bench.load_cell("mamba2-agg-burst")
    out = bench.Outcome(
        attempted=10, failed=0,
        end_to_end={"updates_per_s": 1.0, "agg_ms_p95": 2.0, "setup_s": 3.0},
        checks={"rule_gap": (1e-7, 1e-5), "trace_errors": (0.0, 0)},
        device={"platform": "gpu"})
    res = bench.result(cell, out, trace=False)
    assert res["correct"] and list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"updates_per_s", "agg_ms_p95", "setup_s"}
    out.checks["trace_errors"] = (1.0, 0)
    assert not bench.result(cell, out, trace=False)["correct"]
    out.checks["trace_errors"] = (float("nan"), 0)
    assert not bench.result(cell, out, trace=False)["correct"]
