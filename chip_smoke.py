#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py [--previous DIR]

It builds the port's CUDA kernels from the sources in the checkout (five
files, one ``nvcc`` each, started together), holds each kernel against its
plain PyTorch version on the card, times both, runs the port's AsyncFedED
simulation (``backend="pallas"``, the flat-state server) on the paper's
three tasks, on the burst-drain scenario synthetic-burst (f32, bf16 and
int8 deltas) and with int8 deltas (synthetic-1-1, femnist), checks that
every aggregation went through the kernels of its path and that the CUDA
event traces equal the CPU runs', profiles two of the runs, serves
recurrentgemma-2b at full width and depth (every RG-LRU prefill through the
scan kernel, every attention decode step through the decode kernel) and
mamba2-1.3b at full width and depth (every SSD prefill through the SSD scan
kernel), and holds the card's logits against the CPU port's at full width
for both. Then it runs the baselines on synthetic-1-1 (``comparison``:
the quickstart's asyncfeded, fedavg and fedasync+constant, then
fedasync+poly and +hinge, fedbuff, fedprox, asyncfeded-perleaf and
-displacement; only the flat-state run may launch fedagg kernels) and two
attacked runs (``attack``: sign-flip with norm screening through the burst
drain, gaussian noise on int8 deltas), each against its CPU run from the
same init. Then the cohort engine (``cohort``: synthetic-burst as
configured, synthetic-256 with 256 clients per fan-out, femnist-64's CNN
under vmap; each CUDA cohort trace against the CUDA loop engine's and the
CPU cohort engine's, every burst drained through the batched kernels), the
memory planner (``budget``: femnist-64 under budgets that land its seeding
fan-out on each lower rung, each plan's estimate beside the device memory
the fan-out took, every trace equal to the unconstrained run's), the
population engine (``population``: the lazy table against the materialized
reference at 256 clients, synthetic-1m built lazily and run, and the wall
of a 10,000-client copy at the same arrival rate) and checkpoints
(``checkpoint``: the burst run's flat server saved and restored into a
fresh server bitwise, and re-padded). Last it trains the architectures
(``arch_train``): the gradients of ``SSDScan`` and ``RGLRUScan`` (the
kernels forward, the plain versions' VJPs backward) against autograd
through the plain versions, alone and vmapped over clients; mamba2-1.3b at
every published width with its depth cut to 4 layers, federated on the
cohort engine and on the loop engine (equal traces, a falling eval loss),
with a client step's forward and backward, the SSD VJP's share and the
fedagg kernels at the model's flat length timed; model sharding and the
pod engine (``sharded``: the card counted S times by the mesh's device
hook, ``launch.mesh.repeat_devices``): the six sharded fedagg entry points
at the mamba2-1.3b flat length on 1, 2 and 4 shards against f64 sums and,
to the bit, the unsharded AXPY and apply at the same etas, S launches per
sweep and no host wait on a single arrival; the sharded flat server on
synthetic-1-1 (sequential, burst, int8 burst, displacement) against its
S = 1 run; the pod engine on synthetic-burst with int8 and bf16 wire forms
against the cohort engine and the CPU; a checkpoint saved on 4 shards
restored on 1; and mamba2-1.3b at full width on 2 pods and 2 model shards
against the cohort run; and the three registered
arch scenarios on the card against the CPU port. The last architecture
slice's seven configurations are served at full width in f32 beside the
first two: qwen2-moe-a2.7b (gshard mixture of experts, 14.32 B params) and
musicgen-large (audio, four codebooks a step) at full depth, qwen3-moe-
30b-a3b, granite-34b (MQA: 48 query heads on one kv head through the
decode kernel's head groups), qwen2-vl-72b, phi3-medium-14b and
moonshot-v1-16b-a3b at a cut depth (``SERVE_DEPTH``); each is held against
the CPU port at full width and two or three layers (for the MoE models
also the share of router choices the devices share and the smallest
top-k gaps; for qwen2-vl-72b a forward with patch embeddings), and one
reduced model of each new family trains federated on the loop and cohort
engines through the flat server on the card and on the CPU
(``family_train``). ``fedagg_fused``, which no path of
either package calls, is held to the bit against ``fedagg_axpy`` and
``fedagg_norms``. The line of its
standard output before the last is the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
them, the last line is ``{"ok": true, "device": {...}}``, and every other
line is one JSON object. Any failed check ends the script with a non-zero
exit before the last line. It imports nothing of JAX and nothing of the
JAX package.

``--previous DIR`` also times, in turns, each kernel whose previous design
DIR holds against that design, after the path runs: the SSD and RG-LRU
scans from ``DIR/ssd.cu`` and ``DIR/rglru.cu`` as commit 2b85a6a holds them
(``git show 2b85a6a:src/repro_torch/kernels/ssd/csrc/ssd.cu > DIR/ssd.cu``,
likewise ``rglru/csrc/rglru.cu``); the batched applies from
``DIR/fedagg_batched.cu`` as commit 6468138 holds it, with that commit's
``fedagg_common.cuh`` beside it (``git show
6468138:src/repro_torch/kernels/fedagg/csrc/fedagg_batched.cu >
DIR/fedagg_batched.cu``, likewise the header and ``fedagg.cu``), and from
the same files the batched and single norms sweeps, which that commit
holds as they are now: those rows are a control of the turns' spread. Put
DIR under the git-ignored ``build/``.
"""
from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import math
import re
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
#: the int8 burst pair's rows: up to the int8 knee of 24 arrivals
BATCHED_Q = [(b, n) for n in (65536, 262144) for b in (2, 8, 15, 24)]
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
         # with int8 deltas, from the port's seeded init, the first burst
         # (24 arrivals) follows 39 single ones, as with f32 deltas
         ("synthetic-burst-int8", "synthetic-burst",
          dict(client_engine="loop", delta_compression="int8"), 10.0, 63,
          True),
         ("synthetic-1-1-int8", "synthetic-1-1",
          dict(backend="pallas", delta_compression="int8"), 10.0, 40, True),
         ("femnist-int8", "femnist",
          dict(backend="pallas", delta_compression="int8"), 10.0, 30, False)]
#: the comparison phase on synthetic-1-1, window 0: the quickstart's three
#: algorithms (Fig. 2 in miniature), then the other baselines and AsyncFedED
#: variants: (algorithm, backend or None for the task's, update or round
#: cap). Only the flat-state run launches fedagg kernels.
COMPARISON = [("asyncfeded", "pallas", 40), ("fedavg", None, 40),
              ("fedasync+constant", None, 40), ("fedasync+poly", None, 20),
              ("fedasync+hinge", None, 20), ("fedbuff", None, 20),
              ("fedprox", None, 20), ("asyncfeded-perleaf", None, 20),
              ("asyncfeded-displacement", None, 20)]
#: the attack phase: (label, scenario or task, FedConfig changes, virtual
#: seconds, update cap). The burst run's sign-flipped deltas reach the
#: batched drain's screen; the int8 run's noisy wire deltas the int8 sweeps.
ATTACK_RUNS = [("synthetic-burst-sign-flip", "synthetic-burst",
                dict(client_engine="loop", attack="sign-flip",
                     attack_frac=0.2, screen="reject"), 10.0, 80),
               ("synthetic-1-1-int8-gaussian-noise", "synthetic-1-1",
                dict(backend="pallas", delta_compression="int8",
                     attack="gaussian-noise", attack_frac=0.2), 10.0, 40)]
#: the cohort phase: the scaled scenarios as the repo ships them (cohort
#: engine; synthetic-burst with its auto window, synthetic-256 with 256
#: clients per fan-out and a 0.05 s window, femnist-64's CNN under vmap on
#: the tree backend), each at an update cap, on the card with the cohort
#: and the loop engine and on the CPU with the cohort engine
COHORT_RUNS = [("synthetic-burst", 60), ("synthetic-256", 300),
               ("femnist-64", 20)]
#: the budget phase: femnist-64 under budgets that land its seeding fan-out
#: (64 clients x 10 steps) on each lower rung of the planner's ladder: the
#: footprint of (clients, steps), less one byte for the loop
BUDGET_RUNGS = [("vmap width clamped to 16", 16, 10),
                ("K-scan split into 2-step microbatches", 2, 2),
                ("falling back to the per-client loop", 2, 1)]
BUDGET_CAP = 10
#: the cohort run profiled once more (device busy time and idle share)
PROFILED_COHORT = "synthetic-256"
#: arch_train (a): mamba2-1.3b (arXiv:2405.21060) at every published width
#: (d_model 2048, d_state 128, SSD head_dim 64, expand 2, ngroups 1, conv
#: 4, chunk 256, vocab 50,280), f32, depth cut from 48 to 4 layers; 512
#: tokens (two chunks: the state crosses one in the forward and the
#: backward) x batch 4; 4 clients, K 2, the arch baseline otherwise; the
#: cohort engine, the flat-state server, the auto window, 12 updates; then
#: the loop engine on the same seed, whose trace must be equal and whose
#: gamma, eta and eval losses must agree to rtol / atol. The two engines'
#: products sum in other orders (batched against single cuBLAS calls: the
#: row's ``step_grad_gap``, 1.1e-7 of the largest gradient element), and
#: from a random init at loss ~730 (a tied 2048-wide head) twelve updates
#: of lr 3e-3 with momentum 0.9 carry that to 5.2e-4 of the last eval loss
#: and 2.4e-4 of a gamma (NVIDIA H100 80GB HBM3, 700.00 W): rtol 2e-3, not
#: the 1e-4 the reduced runs hold
ARCH_TRAIN = dict(arch="mamba2-1.3b", num_layers=4, seq_len=512,
                  global_batch=4, clients=4, k=2, updates=12,
                  params=206_372_608, rtol=2e-3, atol=1e-5)
#: the sharded phase: the mamba2-1.3b flat length (3,149 blocks, odd, so
#: S = 2 and 4 pad), the shard counts and burst sizes of its op rows, and
#: their tolerances against f64: gamma, eta and the norms relative, cross
#: and Gram terms over their Cauchy-Schwarz bound
SHARDED_N = 206_372_864
SHARDED_SHARDS = (1, 2, 4)
SHARDED_BURSTS = (2, 23)
SHARDED_RTOL = 1e-6
SHARDED_CS_TOL = 1e-5
#: the sharded server on synthetic-1-1 (label, S, window, delta, algorithm),
#: each against its S = 1 run on the card, cut to this many updates
SHARDED_SERVER_RUNS = [("seq-S2", 2, 0.0, "off", "asyncfeded"),
                       ("seq-S8", 8, 0.0, "off", "asyncfeded"),
                       ("burst-S4", 4, 0.05, "off", "asyncfeded"),
                       ("int8-burst-S4", 4, 0.05, "int8", "asyncfeded"),
                       ("disp-S2", 2, 0.0, "off",
                        "asyncfeded-displacement")]
SHARDED_SERVER_CAP = 40
#: the pod engine on synthetic-burst: pods under the hook, update cap (the
#: first burst comes after 34-39 single arrivals)
SHARDED_PODS = 4
SHARDED_POD_CAP = 64
#: the cohort run cut to this many updates under torch.profiler (device
#: busy time and idle share; every kernel event is read back)
ARCH_TRAIN_PROFILED = 4
#: arch_train (b): the registered arch scenarios as configured, cut to an
#: update count, on the card and on the CPU from the same init; traces
#: equal, gamma to rtol 1e-3
ARCH_SCENARIO_RUNS = [("arch-danube-smoke", 8), ("arch-mamba2-smoke", 8),
                      ("arch-danube-budgeted", 8)]
ARCH_SCENARIO_RTOL = 1e-3
#: arch_train (c): the gradient checks of SSDScan (B, S, H, P, G, N, chunk)
#: and RGLRUScan (B, S, W) against autograd through their plain versions,
#: alone and vmapped over this many clients with their own inputs
SSD_GRAD_SHAPE = (4, 512, 64, 64, 1, 128, 256)
RGLRU_GRAD_SHAPE = (4, 2064, 2560)
GRAD_CLIENTS = 4
#: the population phase: table against materialized at N = 256 (a
#: synthetic-1-1 clone at 40 check-ins per virtual second, flat server,
#: cohort engine), then synthetic-1m and a 10,000-client copy at the same
#: arrival rate, for the virtual seconds given
POP_N, POP_TIME = 256, 1.5
POP_1M_TIME = 5.0
#: updates of an unmeasured run of each task before its measured one, so
#: that first-use loading of PyTorch's kernels stays out of the timings
WARMUP_UPDATES = 3
#: bytes the rotated timing cycles its inputs through: more than the
#: H100's 50 MB L2, so each call reads its inputs from device memory
ROTATE_BYTES = 128 << 20
#: eval accuracy agreement, CUDA vs CPU run of synthetic-1-1 (its eval set
#: holds ~300 rows, so 0.01 is three rows)
ACC_ATOL = 0.01
#: the serving slice's kernel rows: rglru_scan at (B, S, W) and
#: swa_decode_attention at (B, S, H, KV, D, softcap, valid lengths); the
#: first of each is the recurrentgemma-2b serve shape (prompt 2064 + 16 new
#: tokens: a full 2048-slot ring), the others a ragged edge and, for the
#: decode, the short serve run's 48-slot cache, a GQA map with a softcap,
#: and the short serve runs' caches of granite-34b (MQA: 48 query heads on
#: one kv head, three head groups over each piece) and qwen3-moe-30b-a3b
#: (32 heads on 4)
RGLRU_SHAPES = [(4, 2064, 2560), (1, 100, 96)]
SWA_SHAPES = [(4, 2048, 10, 1, 256, 0.0, (2048,) * 4),
              (4, 48, 10, 1, 256, 0.0, (33, 40, 47, 30)),
              (2, 256, 8, 2, 64, 30.0, (200, 256)),
              (4, 48, 48, 1, 128, 0.0, (33, 40, 47, 30)),
              (4, 48, 32, 4, 128, 0.0, (33, 40, 47, 30))]
#: their tolerances against the plain versions, absolute: the scan's carry
#: across chunks and the decode's merge of pieces sum in other orders
RGLRU_ATOL = 1e-5
SWA_ATOL = 1e-5
#: turns of a kernel and its library call, alternating which goes first, in
#: the rows that hold the AXPY against torch.add
TURN_PAIRS = 10
#: the AXPY's extra row: the flat state of a ~67M-param model
AXPY_BIG = 1 << 26
#: fedagg_fused's lengths: the synthetic-1-1 flat state and the flat states
#: of a ~67M- and a ~270M-param model
FUSED_SIZES = (65536, 1 << 26, 1 << 28)
#: ssd_scan at (B, S, H, P, G, N, chunk, with a starting state): the
#: mamba2-1.3b serve prefills (eight 256-step chunks, from zero and from a
#: state; one ragged chunk of 32), a ragged chunk of 40 and G = 4 groups of
#: two heads
SSD_SHAPES = [(4, 2048, 64, 64, 1, 128, 256, False),
              (4, 2048, 64, 64, 1, 128, 256, True),
              (4, 32, 64, 64, 1, 128, 256, False),
              (2, 40, 8, 64, 1, 128, 256, True),
              (2, 512, 8, 64, 4, 128, 256, True)]
#: its tolerance against the plain version and the model twin, relative to
#: the largest |y| (and |state|): the products sum up to L * N = 32,768
#: terms in other orders
SSD_TOL = 1e-4
#: turns of each kernel and the design it replaced under ``--previous``
PREVIOUS_TURNS = 5
#: the single norms sweep's lengths under ``--previous``
PREVIOUS_NORMS_SIZES = (65536, 1 << 28)
#: the serve runs (batch, prompt, new tokens) at full width and depth:
#: recurrentgemma-2b's first wraps the 2048-slot ring, its second leaves
#: slots masked (S = 48); mamba2-1.3b's first scans eight 256-step chunks,
#: its second one chunk cut to 32
SERVES = {"recurrentgemma-2b": [(4, 2064, 16), (4, 32, 16)],
          "mamba2-1.3b": [(4, 2048, 16), (4, 32, 16)],
          "qwen2-moe-a2.7b": [(4, 512, 16), (4, 32, 16)],
          "musicgen-large": [(4, 32, 16)],
          "qwen3-moe-30b-a3b": [(4, 32, 16)],
          "granite-34b": [(4, 32, 16)],
          "qwen2-vl-72b": [(4, 32, 16)],
          "phi3-medium-14b": [(4, 32, 16)],
          "moonshot-v1-16b-a3b": [(4, 32, 16)]}
#: the last architecture slice's serve runs, all at full width in f32:
#: qwen2-moe-a2.7b (24 layers, 14.32 B params, 57.3 GB; gshard MoE, its
#: prompt of 512 a 2048-token dispatch) and musicgen-large (48 layers) at
#: full depth, the others with their depth cut to these layers so that the
#: weights fit the card and the phase its time: qwen3-moe-30b-a3b 4 of 48,
#: granite-34b 2 of 88 (MQA through the decode kernel's head groups),
#: qwen2-vl-72b 2 of 80, phi3-medium-14b 2 of 40, moonshot-v1-16b-a3b 2 of
#: 48
SERVE_DEPTH = {"qwen3-moe-30b-a3b": 4, "granite-34b": 2, "qwen2-vl-72b": 2,
               "phi3-medium-14b": 2, "moonshot-v1-16b-a3b": 2}
#: CUDA against the CPU port: full width, 3 layers, batch 1, 8 tokens; the
#: CPU is fed the card's tokens. recurrentgemma-2b: one (rglru, rglru, attn)
#: group, prompt 64; mamba2-1.3b: prompt 512, two chunks, so the state
#: crosses a chunk. Logits agree to 1e-4 of the step's largest |logit| (f32
#: dense products of depth 2048-8192 summed in other orders by cuBLAS and
#: the CPU)
PARITY = {"recurrentgemma-2b": dict(num_layers=3, batch=1, prompt=64, gen=8,
                                    rtol=1e-4),
          "mamba2-1.3b": dict(num_layers=3, batch=1, prompt=512, gen=8,
                              rtol=1e-4)}
#: the last architecture slice's seven at full width, batch 1, prompt 64, 8
#: tokens: three layers of the MoE and audio models, two of the dense and
#: vlm ones (their layers are the widest). The MoE models run gshard, so
#: the prompt's 64 tokens overflow some experts' capacity (qwen2-moe-a2.7b:
#: 5 slots per expert for 256 pairs over 60 experts) and drop pairs on
#: both devices. qwen2-vl-72b also runs one forward with 16 patch
#: embeddings over the 64 positions.
for _arch, _layers in (("qwen2-moe-a2.7b", 3), ("qwen3-moe-30b-a3b", 3),
                       ("moonshot-v1-16b-a3b", 3), ("musicgen-large", 3),
                       ("granite-34b", 2), ("phi3-medium-14b", 2),
                       ("qwen2-vl-72b", 2)):
    PARITY[_arch] = dict(num_layers=_layers, batch=1, prompt=64, gen=8,
                         rtol=1e-4)
#: qwen2-vl-72b's patches in the parity forward
VLM_PATCHES = 16
#: federated training of one reduced arch of each new family on the card,
#: loop and cohort engines, the flat server (the fedagg kernels), against
#: the same runs on the CPU: (arch, updates)
FAMILY_TRAIN = [("qwen2-moe-a2.7b", 8), ("musicgen-large", 8),
                ("qwen2-vl-72b", 8)]


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


def turns(fn, lib, reps: int, pairs: int = TURN_PAIRS):
    """Device ms of a kernel and of the library call it is held against,
    taken in ``pairs`` turns of the two, alternating which goes first: the
    median of each side, the median of the per-turn ratios kernel/library,
    and the spread of the library's times (max - min over median), so that
    a drift of the card's clock favours neither and the reader sees how far
    one number may be off. Host ms per call once each."""
    ks, ls = [], []
    for i in range(pairs):
        order = ((fn, ks), (lib, ls)) if i % 2 == 0 else ((lib, ls), (fn, ks))
        for f, out in order:
            out.append(device_ms(f, reps))
    med = statistics.median
    k = {"device": med(ks), "call": call_ms(fn, reps),
         "ratio": med(a / b for a, b in zip(ks, ls))}
    lt = {"device": med(ls), "call": call_ms(lib, reps),
          "spread": (max(ls) - min(ls)) / med(ls)}
    return k, lt


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


def ptxas_lines(log: str) -> list:
    """``nvcc -Xptxas -v``'s register, shared-memory and spill lines, one
    string per kernel, led by the kernel's name (unmangled where the name
    follows the anonymous namespace of its source)."""
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            m = re.search(r"_cu_[0-9a-f]{8}(\d+)", name)
            if m:
                name = name[m.end():m.end() + int(m.group(1))]
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}; {spill}")
    return out


def phase_build(build, libs) -> None:
    """Every CUDA source of the port, one ``nvcc`` each, started together,
    then loaded and bound. ``libs``: (sources, loader) per module."""
    t0 = time.time()
    sources = [src for srcs, _ in libs for src in srcs]
    build.build_all(sources)
    for _, load in libs:
        load()
    emit({"phase": "build", "seconds": time.time() - t0,
          "sources": [str(src.relative_to(ROOT)) for src in sources],
          "ptxas": {src.name: ptxas_lines(build.build_log(src))
                    for src in sources}})


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
        nbytes, flops = fedagg.norms_work(n)

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
        bms, by = bound_ms(nbytes, flops)
        mk = lambda: (torch.randn(n, device=dev, generator=g),
                      torch.randn(n, device=dev, generator=g),
                      torch.randn(n, device=dev, generator=g))
        rot = (rotated_ms(fedagg.fedagg_norms, mk, nbytes)
               if n < (1 << 28) else k["device"])
        row = {"phase": "kernel", "name": "fedagg_norms", "size": label,
               "n": n, "max_abs_err": float(err.max()), "max_rel_err": rel,
               "rtol": NORMS_RTOL[n], "bitwise_repeat": repeat,
               "ms": k["device"], "ms_rotated": rot,
               "plain_ms": plain["device"],
               "bound_ms": bms, "bound_by": by,
               "gb_per_s": nbytes / k["device"] / 1e6,
               "gb_per_s_rotated": nbytes / rot / 1e6, "library_ms": None,
               "call_ms": k["call"], "plain_call_ms": plain["call"]}
        emit(row)
        if n == SIZES[0][1]:
            main["fedagg_norms"] = row

        big = n >= (1 << 28)
        row = axpy_row(torch, fedagg, label, x, d, eta,
                       None if big else lambda: (*mk()[:2], eta), reps)
        if n == SIZES[0][1]:
            main["fedagg_axpy"] = row
        del x, xs, d
        torch.cuda.empty_cache()
    x = torch.randn(AXPY_BIG, device=dev, generator=g)
    d = 0.05 * torch.randn(AXPY_BIG, device=dev, generator=g)
    axpy_row(torch, fedagg, "2^26", x, d, eta, None, 5)
    del x, d
    torch.cuda.empty_cache()
    return main


def axpy_row(torch, fedagg, label, x, d, eta, make, reps) -> dict:
    """fedagg_axpy against its plain version (to the ulp; a bf16 delta to
    the bit below 2^28) and against ``torch.add`` in :func:`turns`; the
    rotated time through ``make`` where the inputs would fit in L2, else
    the resident one. Emits and returns the ``kernel`` row."""
    n = x.shape[0]
    nbytes = 12 * n
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
    k, lib = turns(lambda: fedagg.fedagg_axpy(x, d, eta),
                   lambda: torch.add(x, d, alpha=eta_f), reps)
    plain = timings(lambda: fedagg.axpy_plain(x, d, eta), reps)
    bound = max(nbytes / HBM_BYTES_PER_S, 2 * n / F32_FLOPS_PER_S) * 1e3
    rot = (rotated_ms(fedagg.fedagg_axpy, make, 12 * n)
           if make is not None else k["device"])
    row = {"phase": "kernel", "name": "fedagg_axpy", "size": label,
           "n": n, "max_abs_err": float(err.max()), "max_ulp": ulps,
           "ms": k["device"], "ms_rotated": rot,
           "plain_ms": plain["device"],
           "bound_ms": bound, "bound_by": "bytes",
           "gb_per_s": nbytes / k["device"] / 1e6,
           "gb_per_s_rotated": nbytes / rot / 1e6,
           "library_ms": lib["device"], "library_ratio": k["ratio"],
           "library_spread": lib["spread"], "turns": TURN_PAIRS,
           "call_ms": k["call"], "plain_call_ms": plain["call"],
           "library_call_ms": lib["call"]}
    emit(row)
    return row


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
        nbytes, flops = fedagg.norms_work(n, 1)
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
        bms, by = bound_ms(nbytes, flops)
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


def batched_errors(got, want):
    """Errors of batched norms ``got`` against ``want`` (both as
    (dist0_sq, dn_sq, cross, gram)): the largest relative error of dist0_sq
    and dn_sq, the largest error of a cross or Gram term over the product of
    its two vectors' norms (its Cauchy-Schwarz bound), and the largest
    absolute error."""
    d0, dn, cross, gram = want
    rel = max(float(((got[0] - d0).abs() / d0).max()),
              float(((got[1] - dn).abs() / dn).max()))
    scaled = max(
        float(((got[2] - cross).abs() / (d0[:, None] * dn[None]).sqrt()
               ).max()),
        float(((got[3] - gram).abs() / (dn[:, None] * dn[None]).sqrt()
               ).max()))
    abs_err = max(float((a - w).abs().max()) for a, w in zip(got, want))
    return rel, scaled, abs_err


def batched_rows(torch, fedagg, b: int, n: int, dtype, seed: int = 0):
    """fedagg_norms_batched and fedagg_apply_batched at (B, n) with a
    ``dtype`` delta, each against its plain version, timed; returns the two
    rows. Work counted by ``fedagg.norms_batched_work`` (x_t, B stales and
    B deltas read; 3B^2 + 4B flops per element) and
    ``fedagg.apply_batched_work`` (x_t and B deltas read, one vector
    written; 2B flops per element)."""
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
    rtol = BATCHED_RTOL[n]
    rel, scaled, abs_err = batched_errors(
        got, fedagg.norms_batched_plain(x, xs, d))
    again = fedagg.fedagg_norms_batched(x, xs, d)
    repeat = all(torch.equal(a, c) for a, c in zip(got, again))
    check(rel <= rtol and scaled <= rtol,
          f"norms_batched {tag}: rel {rel}, scaled {scaled} > {rtol}")
    check(repeat, f"norms_batched {tag} not bitwise reproducible")
    nbytes, flops = fedagg.norms_batched_work(b, n, dbytes)
    k = timings(lambda: fedagg.fedagg_norms_batched(x, xs, d), reps)
    plain = timings(lambda: fedagg.norms_batched_plain(x, xs, d), reps)
    rot = k["device"] if big else rotated_ms(fedagg.fedagg_norms_batched,
                                             make, nbytes)
    bms, by = bound_ms(nbytes, flops)
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
    nbytes, flops = fedagg.apply_batched_work(b, n, dbytes)
    k = timings(lambda: fedagg.fedagg_apply_batched(x, d, etas), reps)
    plain = timings(lambda: fedagg.apply_batched_plain(x, d, etas), reps)
    lib = (timings(lambda: torch.addmv(x, d.t(), etas), reps)
           if dtype == torch.float32 else None)
    rot = k["device"] if big else rotated_ms(
        lambda a, b_, c: fedagg.fedagg_apply_batched(a, c, etas), make,
        nbytes)
    bms, by = bound_ms(nbytes, flops)
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


def batched_q_rows(torch, fedagg, compression, b: int, n: int,
                   seed: int = 0):
    """fedagg_norms_batched_q and fedagg_apply_batched_q at (B, n), each
    against its plain version, timed; returns the two rows. Work counted as
    in :func:`batched_rows`, with one byte of q per delta element, a scale
    per 1024 and one more flop per delta (the dequantizing multiply)."""
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(seed)

    def make():
        x = torch.randn(n, device=dev, generator=g)
        xs = x + 0.01 * torch.randn(b, n, device=dev, generator=g)
        d = 0.05 * torch.randn(b, n, device=dev, generator=g)
        d[:, :fedagg.QBLOCK] = 0.0                  # an all-zero block
        wires = [compression.quantize_vec(row, "int8", n) for row in d]
        return (x, xs, torch.stack([w.q for w in wires]),
                torch.stack([w.scales for w in wires]))
    x, xs, qs, sc = make()
    etas = torch.linspace(0.1, 0.9, b, device=dev)
    big = n > (1 << 20)
    reps = 5 if big else 20
    tag = {"B": b, "n": n, "delta": "int8"}

    got = fedagg.fedagg_norms_batched_q(x, xs, qs, sc)
    rtol = BATCHED_RTOL[n]
    rel, scaled, abs_err = batched_errors(
        got, fedagg.norms_batched_q_plain(x, xs, qs, sc))
    repeat = all(torch.equal(a, c) for a, c in zip(
        got, fedagg.fedagg_norms_batched_q(x, xs, qs, sc)))
    check(rel <= rtol and scaled <= rtol,
          f"norms_batched_q {tag}: rel {rel}, scaled {scaled} > {rtol}")
    check(repeat, f"norms_batched_q {tag} not bitwise reproducible")
    nbytes, flops = fedagg.norms_batched_work(b, n, 1)
    k = timings(lambda: fedagg.fedagg_norms_batched_q(x, xs, qs, sc), reps)
    plain = timings(lambda: fedagg.norms_batched_q_plain(x, xs, qs, sc),
                    reps)
    rot = k["device"] if big else rotated_ms(fedagg.fedagg_norms_batched_q,
                                             make, nbytes)
    bms, by = bound_ms(nbytes, flops)
    norms = {"phase": "kernel", "name": "fedagg_norms_batched_q", **tag,
             "max_abs_err": abs_err, "max_rel_err": rel,
             "max_scaled_err": scaled, "rtol": rtol,
             "bitwise_repeat": repeat, "ms": k["device"], "ms_rotated": rot,
             "plain_ms": plain["device"], "bound_ms": bms, "bound_by": by,
             "gb_per_s_rotated": nbytes / rot / 1e6, "library_ms": None,
             "call_ms": k["call"], "plain_call_ms": plain["call"]}

    out = fedagg.fedagg_apply_batched_q(x, qs, sc, etas)
    diff = float((out - fedagg.apply_batched_q_plain(x, qs, sc, etas)
                  ).abs().max())
    check(diff == 0.0, f"apply_batched_q {tag}: max abs err {diff}")
    nbytes, flops = fedagg.apply_batched_work(b, n, 1)
    k = timings(lambda: fedagg.fedagg_apply_batched_q(x, qs, sc, etas), reps)
    plain = timings(lambda: fedagg.apply_batched_q_plain(x, qs, sc, etas),
                    reps)
    rot = k["device"] if big else rotated_ms(
        lambda a, b_, c, e: fedagg.fedagg_apply_batched_q(a, c, e, etas),
        make, nbytes)
    bms, by = bound_ms(nbytes, flops)
    apply = {"phase": "kernel", "name": "fedagg_apply_batched_q", **tag,
             "max_abs_err": diff, "ms": k["device"], "ms_rotated": rot,
             "plain_ms": plain["device"], "bound_ms": bms, "bound_by": by,
             "gb_per_s_rotated": nbytes / rot / 1e6, "library_ms": None,
             "call_ms": k["call"], "plain_call_ms": plain["call"]}
    del x, xs, qs, sc, got, out
    torch.cuda.empty_cache()
    return norms, apply


def batched_passes(torch, fedagg, b: int, n: int, bound: float) -> dict:
    """The ``kernel_passes`` row of fedagg_norms_batched at (B, n) with f32
    deltas: device ms per call of its split-K pass and of its fold, from
    torch.profiler, beside the kernel row's bound."""
    g = torch.Generator(device="cuda:0").manual_seed(11)
    x = torch.randn(n, device="cuda:0", generator=g)
    xs = x + 0.01 * torch.randn(b, n, device="cuda:0", generator=g)
    d = 0.05 * torch.randn(b, n, device="cuda:0", generator=g)
    passes = pass_ms(torch, lambda: fedagg.fedagg_norms_batched(x, xs, d),
                     ("norms_batched_tiles", "norms_batched_fold"))
    del x, xs, d
    return {"phase": "kernel_passes", "name": "fedagg_norms_batched",
            "B": b, "n": n, "delta": "float32", "device_ms": passes,
            "bound_ms": bound}


def phase_batched_kernels(torch, fedagg, compression) -> None:
    """The batched pair at every (B, n) of ``BATCHED`` with f32 and bf16
    deltas and at ``BATCHED_BIG`` with f32; its int8 twins at every (B, n)
    of ``BATCHED_Q`` and at ``BATCHED_BIG``."""
    shapes = [(b, n, dt) for b, n in BATCHED
              for dt in (torch.float32, torch.bfloat16)]
    for b, n, dt in shapes + [(*BATCHED_BIG, torch.float32)]:
        for row in batched_rows(torch, fedagg, b, n, dt):
            emit(row)
    for b, n in BATCHED_Q + [BATCHED_BIG]:
        for row in batched_q_rows(torch, fedagg, compression, b, n):
            emit(row)


def rglru_inputs(torch, g, b: int, s: int, w: int):
    """(log_at, xi, h0) for rglru_scan at (B, S, W) on the card, drawn from
    the generator ``g``: log a_t in [-0.8, 0], the range of the model's
    gates (8 r log sigmoid(Lambda), a in [0.9, 0.999])."""
    dev = g.device
    return (-0.8 * torch.rand(b, s, w, device=dev, generator=g),
            torch.randn(b, s, w, device=dev, generator=g),
            torch.randn(b, w, device=dev, generator=g))


def rglru_row(torch, rglru, b: int, s: int, w: int, seed: int = 3) -> dict:
    """rglru_scan at (B, S, W) from a starting state (``rglru_inputs``),
    against its plain version, timed. Work: log_at and xi read,
    h written, h0 read and the last step written; 9 flops per element."""
    g = torch.Generator(device="cuda:0").manual_seed(seed)
    make = lambda: rglru_inputs(torch, g, b, s, w)
    la, xi, h0 = make()
    out, last = rglru.rglru_scan(la, xi, h0)
    ref, rlast = rglru.rglru_scan_plain(la, xi, h0)
    err = max(float((out - ref).abs().max()), float((last - rlast).abs().max()))
    check(err <= RGLRU_ATOL, f"rglru_scan {(b, s, w)}: max abs err {err}")
    again, _ = rglru.rglru_scan(la, xi, h0)
    check(torch.equal(out, again), f"rglru_scan {(b, s, w)} not repeatable")
    nbytes = 12 * b * s * w + 8 * b * w
    big = nbytes > ROTATE_BYTES // 2
    k = timings(lambda: rglru.rglru_scan(la, xi, h0), 5 if big else 20)
    plain = device_ms(lambda: rglru.rglru_scan_plain(la, xi, h0), reps=1,
                      trials=3)
    rot = k["device"] if big else rotated_ms(rglru.rglru_scan, make, nbytes)
    bms, by = bound_ms(nbytes, 9 * b * s * w)
    return {"phase": "kernel", "name": "rglru_scan", "shape": [b, s, w],
            "max_abs_err": err, "atol": RGLRU_ATOL, "ms": rot,
            "ms_l2": k["device"], "plain_ms": plain, "bound_ms": bms,
            "bound_by": by, "gb_per_s": nbytes / rot / 1e6,
            "library_ms": None, "call_ms": k["call"]}


def swa_row(torch, swa_attn, b: int, s: int, h: int, kv: int, d: int,
            cap: float, lens, seed: int = 4) -> dict:
    """swa_decode_attention at (B, S, H, KV, D) with ``lens`` valid slots,
    against its plain version, timed on inputs cycled through more than the
    L2 (in a decode step each layer's cache is read once, after the weights
    have passed through the cache) and on L2-resident ones. Work: q read,
    the valid slots of K and V read, the output written; 4 flops per valid
    slot, head and dim, 5 per valid slot and head for the softmax.
    ``library_ms``: F.scaled_dot_product_attention on the same inputs (its
    GQA map, a boolean mask for the lengths), where there is no softcap."""
    import torch.nn.functional as F
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(seed)
    vl = torch.tensor(lens, dtype=torch.int32, device=dev)

    def make():
        return (torch.randn(b, h, d, device=dev, generator=g),
                torch.randn(b, s, kv, d, device=dev, generator=g),
                torch.randn(b, s, kv, d, device=dev, generator=g), vl)
    q, k, v, _ = make()
    out = swa_attn.swa_decode_attention(q, k, v, vl, cap)
    ref = swa_attn.swa_decode_plain(q, k, v, vl, cap)
    err = float((out - ref).abs().max())
    tag = {"shape": [b, s, h, kv, d], "softcap": cap, "valid_len": list(lens)}
    check(err <= SWA_ATOL, f"swa_decode_attention {tag}: max abs err {err}")
    check(torch.equal(out, swa_attn.swa_decode_attention(q, k, v, vl, cap)),
          f"swa_decode_attention {tag} not repeatable")
    valid = sum(min(n, s) for n in lens)
    nbytes = 8 * b * h * d + 8 * valid * kv * d
    fn = lambda q_, k_, v_, l_: swa_attn.swa_decode_attention(q_, k_, v_, l_,
                                                              cap)
    kt = timings(lambda: fn(q, k, v, vl), 20)
    rot = rotated_ms(fn, make, 4 * b * h * d + 8 * b * s * kv * d)
    plain = device_ms(lambda: swa_attn.swa_decode_plain(q, k, v, vl, cap))
    lib = lib_err = None
    if not cap:
        qs, ks, vs = q[:, :, None], k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        mask = (None if min(lens) >= s else
                (torch.arange(s, device=dev)[None] < vl[:, None])[:, None,
                                                                  None])
        sdpa = lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=h != kv)
        lib_err = float((sdpa()[:, :, 0] - ref).abs().max())
        lib = device_ms(sdpa)
    bms, by = bound_ms(nbytes, valid * h * (4 * d + 5))
    return {"phase": "kernel", "name": "swa_decode_attention", **tag,
            "max_abs_err": err, "atol": SWA_ATOL, "ms": rot,
            "ms_l2": kt["device"], "plain_ms": plain, "bound_ms": bms,
            "bound_by": by, "gb_per_s": nbytes / rot / 1e6,
            "library_ms": lib, "library_max_abs_err": lib_err,
            "call_ms": kt["call"]}


def phase_arch_kernels(torch, rglru, swa_attn) -> dict:
    """The serving slice's two kernels at ``RGLRU_SHAPES`` and
    ``SWA_SHAPES``, and the RG-LRU kernel's pass at the serve shape under
    torch.profiler (device ms over 5 calls, beside the kernel row's bound);
    returns the rows at the serve shapes (the first of each)."""
    main = {}
    for shape in RGLRU_SHAPES:
        row = rglru_row(torch, rglru, *shape)
        emit(row)
        main.setdefault("rglru_scan", row)
    shape = RGLRU_SHAPES[0]
    la, xi, h0 = rglru_inputs(
        torch, torch.Generator(device="cuda:0").manual_seed(8), *shape)
    emit({"phase": "kernel_passes", "name": "rglru_scan", "shape": list(shape),
          "device_ms": pass_ms(torch, lambda: rglru.rglru_scan(la, xi, h0),
                               ("scan_stream",)),
          "bound_ms": main["rglru_scan"]["bound_ms"]})
    del la, xi, h0
    for shape in SWA_SHAPES:
        row = swa_row(torch, swa_attn, *shape)
        emit(row)
        main.setdefault("swa_decode_attention", row)
    torch.cuda.empty_cache()
    return main


def phase_fused(torch, fedagg) -> dict:
    """fedagg_fused at ``FUSED_SIZES``: its output must equal fedagg_axpy's
    and its norms fedagg_norms', to the bit, on the same inputs; against
    its plain version, timed. Work: x_t, x_stale and delta read and the
    output written, 16 bytes and 7 flops per element. No single PyTorch
    call computes both outputs. Returns the row at the synthetic-1-1
    length."""
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(5)
    eta = torch.full((), 0.37, device=dev)
    rows = {}
    for n in FUSED_SIZES:
        def make():
            x = torch.randn(n, device=dev, generator=g)
            return (x, x + 0.01 * torch.randn(n, device=dev, generator=g),
                    0.05 * torch.randn(n, device=dev, generator=g))
        x, xs, d = make()
        out, part = fedagg.fedagg_fused(x, xs, d, eta)
        same_axpy = torch.equal(out, fedagg.fedagg_axpy(x, d, eta))
        same_norms = torch.equal(part, fedagg.fedagg_norms(x, xs, d))
        check(same_axpy and same_norms,
              f"fedagg_fused n={n}: output equal to fedagg_axpy's "
              f"{same_axpy}, norms equal to fedagg_norms' {same_norms}")
        pout, ppart = fedagg.fused_plain(x, xs, d, eta)
        err = float((out - pout).abs().max())
        rel = float(((part - ppart).abs() / ppart.abs()).max())
        check(err == 0.0 and rel <= NORMS_RTOL.get(n, 1e-4),
              f"fedagg_fused n={n}: output err {err}, norms rel {rel}")
        again = fedagg.fedagg_fused(x, xs, d, eta)
        repeat = torch.equal(out, again[0]) and torch.equal(part, again[1])
        check(repeat, f"fedagg_fused n={n} not bitwise reproducible")
        big = 16 * n > ROTATE_BYTES // 2
        reps = 5 if big else 20
        k = timings(lambda: fedagg.fedagg_fused(x, xs, d, eta), reps)
        plain = timings(lambda: fedagg.fused_plain(x, xs, d, eta), reps)
        rot = k["device"] if big else rotated_ms(
            lambda a, b, c: fedagg.fedagg_fused(a, b, c, eta), make, 16 * n)
        bms, by = bound_ms(16 * n, 7 * n)
        row = {"phase": "kernel", "name": "fedagg_fused", "n": n,
               "equal_to_axpy": same_axpy, "equal_to_norms": same_norms,
               "max_abs_err": err, "norms_max_rel_err": rel,
               "bitwise_repeat": repeat, "ms": k["device"],
               "ms_rotated": rot, "plain_ms": plain["device"],
               "bound_ms": bms, "bound_by": by,
               "gb_per_s_rotated": 16 * n / rot / 1e6, "library_ms": None,
               "call_ms": k["call"], "plain_call_ms": plain["call"],
               "path_launches": "none: no path of either package calls it"}
        emit(row)
        rows[n] = row
        del x, xs, d, out, part, pout, again
        torch.cuda.empty_cache()
    return rows[FUSED_SIZES[0]]


def pass_ms(torch, fn, names, calls: int = 5) -> dict:
    """Device ms of each CUDA kernel in ``names``, which ``fn`` launches once
    a call: the mean duration of its kernel events in torch.profiler's
    trace of ``calls`` calls. The mean is over the events the trace holds: a
    long process's trace can drop some. A kernel launched as a programmatic
    dependent starts before the kernel it waits for ends, and its duration
    counts that wait."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us: dict = {}
    for e in prof.events():
        m = re.search(r"::(\w+)(<[^>]*>)?\(", e.name)
        if e.device_type == DeviceType.CUDA and m and m.group(1) in names:
            us.setdefault(m.group(1), []).append(e.time_range.elapsed_us())
    return {k: statistics.mean(v) / 1e3 for k, v in us.items()}


def ssd_row(torch, ssd_ops, SSM, bs, s, h, p, g, n, chunk, with_h0,
            seed=6) -> dict:
    """ssd_scan on the model's layout at (B, S, H, P, G, N, chunk), held
    against its plain version and against the model twin
    ``models/ssm.py::ssd_chunked``, errors scaled by the largest |y| (or
    |state|); bitwise repeatable; timed. ``ms`` is the time on inputs
    cycled through more than the L2 (each layer finds its inputs cold),
    ``ms_l2`` on resident ones."""
    import torch.nn.functional as F
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def make():
        rnd = lambda *shape: torch.randn(*shape, device=dev, generator=gen)
        return (rnd(bs, s, h, p), F.softplus(rnd(bs, s, h)),
                -torch.exp(0.3 * rnd(h)), 0.3 * rnd(bs, s, g, n),
                0.3 * rnd(bs, s, g, n),
                rnd(bs, h, p, n) if with_h0 else None)
    x, dt, a, b, c, h0 = make()
    L = min(chunk, s)
    y, st = ssd_ops.ssd_chunked(x, dt, a, b, c, chunk, h0)
    ry, rst = ssd_ops.ssd_chunked_plain(x, dt, a, b, c, chunk, h0)
    my, mst = SSM.ssd_chunked(x, dt, a, b, c, L, initial_state=h0)
    scaled = lambda u, v: float((u - v).abs().max() / v.abs().max())
    errs = {"y_scaled_err": scaled(y, ry), "state_scaled_err": scaled(st, rst),
            "y_scaled_err_model": scaled(y, my),
            "state_scaled_err_model": scaled(st, mst)}
    tag = {"shape": [bs, s, h, p, g, n, L], "h0": with_h0}
    check(max(errs.values()) <= SSD_TOL, f"ssd_scan {tag}: errors {errs}")
    y2, st2 = ssd_ops.ssd_chunked(x, dt, a, b, c, chunk, h0)
    repeat = torch.equal(y, y2) and torch.equal(st, st2)
    check(repeat, f"ssd_scan {tag} not bitwise reproducible")
    err = float((y - ry).abs().max())
    del y2, st2, my, mst
    nbytes, flops = ssd_ops.ssd.ssd_work(bs, s, h, p, g, n, chunk, with_h0)
    big = nbytes > ROTATE_BYTES // 2
    fn = lambda *args: ssd_ops.ssd_chunked(*args[:5], chunk, args[5])
    k = timings(lambda: fn(x, dt, a, b, c, h0), 5 if big else 20)
    plain = device_ms(lambda: ssd_ops.ssd_chunked_plain(x, dt, a, b, c,
                                                        chunk, h0),
                      reps=1, trials=3)
    rot = k["device"] if big else rotated_ms(fn, make, nbytes)
    bms, by = bound_ms(nbytes, flops)
    row = {"phase": "kernel", "name": "ssd_scan", **tag,
           "max_abs_err": err, "max_abs_y": float(ry.abs().max()), **errs,
           "tol": SSD_TOL, "bitwise_repeat": repeat, "ms": rot,
           "ms_l2": k["device"], "plain_ms": plain, "bound_ms": bms,
           "bound_by": by, "gflop": flops / 1e9,
           "tflop_per_s": flops / rot / 1e9, "library_ms": None,
           "call_ms": k["call"]}
    del x, dt, a, b, c, h0, y, st, ry, rst
    torch.cuda.empty_cache()
    return row


def phase_ssd_kernels(torch, ssd_ops, SSM) -> dict:
    """ssd_scan at every shape of ``SSD_SHAPES``, then the first shape's
    four passes under torch.profiler (device ms each, over 5 calls);
    returns the row at the first (the serve prefill of 2048)."""
    rows = [ssd_row(torch, ssd_ops, SSM, *shape) for shape in SSD_SHAPES]
    for row in rows:
        emit(row)
    bs, s, h, p, g, n, chunk, _ = SSD_SHAPES[0]
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(7)
    args = [torch.randn(*shape, device=dev, generator=gen)
            for shape in ((bs, s, h, p), (bs, s, h), (h,), (bs, s, g, n),
                          (bs, s, g, n))]
    args[1], args[2] = args[1].abs(), -args[2].abs()
    passes = pass_ms(torch, lambda: ssd_ops.ssd_chunked(*args, chunk),
                     ("cb_pass", "chunk_pass", "fold_pass", "output_pass"))
    emit({"phase": "kernel_passes", "name": "ssd_scan",
          "shape": [bs, s, h, p, g, n, chunk], "device_ms": passes})
    del args
    torch.cuda.empty_cache()
    return rows[0]


def previous_ssd(torch, build, mods, ssd_lib, rows, burst) -> None:
    """ssd_scan against the design it replaced (``DIR/ssd.cu``, commit
    2b85a6a's) at the serve shape: outputs within ``SSD_TOL``, times in
    ``PREVIOUS_TURNS`` turns."""
    import ctypes
    import torch.nn.functional as F
    vp, i = ctypes.c_void_p, ctypes.c_int
    ssd = mods["ssd"]
    ssd_lib.ssd_scan_f32.argtypes = [vp] * 6 + [i] * 7 + [vp] * 4
    ssd_lib.ssd_scratch_floats.argtypes = [i] * 6
    ssd_lib.ssd_scratch_floats.restype = ctypes.c_int64
    check(ssd_lib.ssd_init() == 0, "the previous ssd_scan did not load")
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(8)
    rnd = lambda *shape: torch.randn(*shape, device=dev, generator=gen)

    bs, s, h, p, g, n, chunk, _ = SSD_SHAPES[0]
    x, dt, a = rnd(bs, s, h, p), F.softplus(rnd(bs, s, h)), -torch.exp(
        0.3 * rnd(h))
    b, c = 0.3 * rnd(bs, s, g, n), 0.3 * rnd(bs, s, g, n)
    a_rows = a.repeat(bs)

    def ssd_old():
        scratch = torch.empty(
            ssd_lib.ssd_scratch_floats(bs, s, h, p, n, chunk), device=dev)
        y_old = torch.empty_like(x)
        st_old = torch.empty(bs, h, p, n, device=dev)
        err = ssd_lib.ssd_scan_f32(
            x.data_ptr(), dt.data_ptr(), a_rows.data_ptr(), b.data_ptr(),
            c.data_ptr(), None, bs, s, h, g, p, n, chunk, scratch.data_ptr(),
            y_old.data_ptr(), st_old.data_ptr(), build.stream(dev))
        check(err == 0, f"the previous ssd_scan failed: {err}")
        return y_old, st_old
    ssd_new = lambda: ssd.launch(x, dt, a_rows, b, c, chunk=chunk)
    (y, st), (y_old, st_old) = ssd_new(), ssd_old()
    scaled = lambda u, v: float((u - v).abs().max() / v.abs().max())
    diff = max(scaled(y, y_old), scaled(st, st_old))
    check(diff <= SSD_TOL, f"ssd_scan against its previous design: {diff}")
    del y, st, y_old, st_old
    k, prev_t = turns(ssd_new, ssd_old, 5, PREVIOUS_TURNS)
    check(min(k["device"], prev_t["device"]) >= rows["ssd_scan"]["bound_ms"],
          f"ssd_scan timed below its bound: {k}, previous {prev_t}")
    emit({"phase": "previous_design", "name": "ssd_scan",
          "shape": [bs, s, h, p, g, n, chunk], "ms": k["device"],
          "previous_ms": prev_t["device"], "ratio": k["ratio"],
          "previous_spread": prev_t["spread"], "turns": PREVIOUS_TURNS,
          "max_scaled_diff": diff})
    del x, dt, b, c
    torch.cuda.empty_cache()


def previous_rglru(torch, build, mods, rg_lib, rows, burst) -> None:
    """rglru_scan against the design it replaced (``DIR/rglru.cu``, commit
    2b85a6a's) at the serve shape: outputs within ``RGLRU_ATOL``, times in
    ``PREVIOUS_TURNS`` turns."""
    import ctypes
    vp, i = ctypes.c_void_p, ctypes.c_int
    rglru = mods["rglru"]
    rg_lib.rglru_scan_f32.argtypes = [vp, vp, vp, i, i, i, i, vp, vp, vp, vp]
    rg_lib.rglru_scratch_floats.argtypes = [i] * 4
    rg_lib.rglru_scratch_floats.restype = ctypes.c_int64
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(8)
    bs, s, w = RGLRU_SHAPES[0]
    la, xi, h0 = rglru_inputs(torch, gen, bs, s, w)

    def rg_old():
        scratch = torch.empty(rg_lib.rglru_scratch_floats(bs, s, w, 64),
                              device=dev)
        out_old = torch.empty_like(xi)
        last_old = torch.empty(bs, w, device=dev)
        err = rg_lib.rglru_scan_f32(
            la.data_ptr(), xi.data_ptr(), h0.data_ptr(), bs, s, w, 64,
            scratch.data_ptr(), out_old.data_ptr(), last_old.data_ptr(),
            build.stream(dev))
        check(err == 0, f"the previous rglru_scan failed: {err}")
        return out_old, last_old
    rg_new = lambda: rglru.rglru_scan(la, xi, h0)
    (out, last), (out_old, last_old) = rg_new(), rg_old()
    diff = max(float((out - out_old).abs().max()),
               float((last - last_old).abs().max()))
    check(diff <= RGLRU_ATOL,
          f"rglru_scan against its previous design: {diff}")
    equal = torch.equal(out, out_old) and torch.equal(last, last_old)
    del out, last, out_old, last_old
    k, prev_t = turns(rg_new, rg_old, 10, PREVIOUS_TURNS)
    check(min(k["device"], prev_t["device"]) >= rows["rglru_scan"]["bound_ms"],
          f"rglru_scan timed below its bound: {k}, previous {prev_t}")
    emit({"phase": "previous_design", "name": "rglru_scan",
          "shape": [bs, s, w], "ms": k["device"],
          "previous_ms": prev_t["device"], "ratio": k["ratio"],
          "previous_spread": prev_t["spread"], "turns": PREVIOUS_TURNS,
          "max_abs_diff": diff, "bitwise_equal_previous": equal})
    del la, xi, h0
    torch.cuda.empty_cache()


def previous_norms(torch, build, mods, lib, rows, burst) -> None:
    """The single norms sweeps against the one-launch design in
    ``DIR/fedagg.cu`` (commit 6468138's, which this source still holds: the
    rows are a control of the turns' spread) at ``PREVIOUS_NORMS_SIZES``:
    fedagg_norms (f32 and bf16 deltas), fedagg_norms_q and fedagg_fused's
    norms must equal it to the bit; fedagg_norms with f32 deltas is timed
    against it in ``PREVIOUS_TURNS`` turns."""
    import ctypes
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    fedagg, compression = mods["fedagg"], mods["compression"]
    for name in ("fedagg_norms_f32", "fedagg_norms_bf16"):
        getattr(lib, name).argtypes = [vp] * 6 + [i64, vp]
    lib.fedagg_norms_int8.argtypes = [vp] * 7 + [i64, vp]
    lib.fedagg_fused_f32.argtypes = [vp] * 8 + [i64, vp]
    lib.fedagg_norms_blocks.argtypes = [i64]
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(9)
    eta = torch.full((), 0.37, device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    for n in PREVIOUS_NORMS_SIZES:
        x = torch.randn(n, device=dev, generator=g)
        xs = x + 0.01 * torch.randn(n, device=dev, generator=g)
        d = 0.05 * torch.randn(n, device=dev, generator=g)
        db = d.bfloat16()
        cd = compression.quantize_vec(d, "int8", n)

        def old(fn, *ptrs):
            buf = torch.empty(2 + 2 * lib.fedagg_norms_blocks(n), device=dev)
            err = fn(*ptrs, buf.data_ptr() + 8, ticket.data_ptr(),
                     buf.data_ptr(), n, build.stream(dev))
            check(err == 0, f"the previous norms sweep failed: {err}")
            return buf[:2]
        ptrs = (x.data_ptr(), xs.data_ptr())
        old_f32 = lambda: old(lib.fedagg_norms_f32, *ptrs, d.data_ptr())
        new_f32 = lambda: fedagg.fedagg_norms(x, xs, d)
        fused_out = torch.empty_like(x)
        equal = {
            "f32": torch.equal(new_f32(), old_f32()),
            "bf16": torch.equal(fedagg.fedagg_norms(x, xs, db),
                                old(lib.fedagg_norms_bf16, *ptrs,
                                    db.data_ptr())),
            "int8": torch.equal(fedagg.fedagg_norms_q(x, xs, cd.q, cd.scales),
                                old(lib.fedagg_norms_int8, *ptrs,
                                    cd.q.data_ptr(), cd.scales.data_ptr())),
            "fused": torch.equal(fedagg.fedagg_fused(x, xs, d, eta)[1],
                                 old(lib.fedagg_fused_f32, *ptrs,
                                     d.data_ptr(), eta.data_ptr(),
                                     fused_out.data_ptr()))}
        check(all(equal.values()),
              f"norms n={n} not bitwise equal to the previous design: "
              f"{equal}")
        del db, cd, fused_out
        k, prev_t = turns(new_f32, old_f32, 5 if n >= (1 << 28) else 20,
                          PREVIOUS_TURNS)
        bms, by = bound_ms(*fedagg.norms_work(n))
        check(min(k["device"], prev_t["device"]) >= bms,
              f"fedagg_norms n={n} timed below its bound: {k}, previous "
              f"{prev_t}")
        emit({"phase": "previous_design", "name": "fedagg_norms", "n": n,
              "ms": k["device"], "previous_ms": prev_t["device"],
              "ratio": k["ratio"], "previous_spread": prev_t["spread"],
              "turns": PREVIOUS_TURNS, "bound_ms": bms, "bound_by": by,
              "bitwise_equal_previous": equal})
        del x, xs, d
        torch.cuda.empty_cache()


def previous_norms_batched(torch, build, mods, lib, rows, burst) -> None:
    """fedagg_norms_batched and fedagg_norms_batched_q against the design in
    ``DIR/fedagg_batched.cu`` (commit 6468138's holds the current split-K
    design: the rows are a control of the turns' spread; commit 33d513a's
    the warp-per-dot one it replaced) at the path's median burst ``burst``
    (n = 65,536, f32 deltas) and at every
    (B, n, delta) of the kernel rows (``BATCHED`` with f32 and bf16 deltas,
    ``BATCHED_Q`` with int8 ones, ``BATCHED_BIG`` with f32 and int8): both
    within ``BATCHED_RTOL`` of each other (as of the plain version), times
    in ``PREVIOUS_TURNS`` turns."""
    import ctypes
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fedagg, compression = mods["fedagg"], mods["compression"]
    for name in ("fedagg_norms_batched_f32", "fedagg_norms_batched_bf16"):
        getattr(lib, name).argtypes = [vp, vp, vp, i, i64, vp, vp, vp]
    lib.fedagg_norms_batched_int8.argtypes = [vp, vp, vp, vp, i, i64, vp, vp,
                                              vp]
    lib.fedagg_norms_batched_scratch.argtypes = [i64, i]
    lib.fedagg_norms_batched_scratch.restype = i64
    check(lib.fedagg_batched_init() == 0,
          "the previous fedagg_norms_batched did not load")
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(10)
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = ([(burst, 65536, f32), (*BATCHED_BIG, f32)]
              + [(b, n, dt) for b, n in BATCHED for dt in (f32, bf16)]
              + [(b, n, torch.int8) for b, n in BATCHED_Q + [BATCHED_BIG]])
    for b, n, dt in shapes:
        x = torch.randn(n, device=dev, generator=g)
        xs = x + 0.01 * torch.randn(b, n, device=dev, generator=g)
        d = 0.05 * torch.randn(b, n, device=dev, generator=g)
        sc = None
        if dt == torch.int8:
            d[:, :fedagg.QBLOCK] = 0.0
            wires = [compression.quantize_vec(row, "int8", n) for row in d]
            d = torch.stack([w.q for w in wires])
            sc = torch.stack([w.scales for w in wires])
            del wires
        else:
            d = d.to(dt)
        out_len = 2 * b + 2 * b * b

        def old():
            buf = torch.empty(out_len + lib.fedagg_norms_batched_scratch(n, b),
                              device=dev)
            tail = (b, n, buf.data_ptr() + 4 * out_len, buf.data_ptr(),
                    build.stream(dev))
            if sc is not None:
                err = lib.fedagg_norms_batched_int8(
                    x.data_ptr(), xs.data_ptr(), d.data_ptr(), sc.data_ptr(),
                    *tail)
            else:
                fn = (lib.fedagg_norms_batched_f32 if dt == f32
                      else lib.fedagg_norms_batched_bf16)
                err = fn(x.data_ptr(), xs.data_ptr(), d.data_ptr(), *tail)
            check(err == 0, f"the previous norms_batched failed: {err}")
            return buf[:out_len]
        new = lambda: fedagg.norms_batched_packed(x, xs, d, sc)
        rel, scaled, diff = batched_errors(fedagg.split_batched(new(), b),
                                           fedagg.split_batched(old(), b))
        rtol = BATCHED_RTOL[n]
        tag = {"B": b, "n": n, "delta": str(dt).replace("torch.", "")}
        check(rel <= rtol and scaled <= rtol,
              f"norms_batched {tag} against its previous design: rel {rel}, "
              f"scaled {scaled}")
        k, prev_t = turns(new, old, 5 if n > (1 << 20) else 20,
                          PREVIOUS_TURNS)
        dbytes = {f32: 4, bf16: 2, torch.int8: 1}[dt]
        bms, by = bound_ms(*fedagg.norms_batched_work(b, n, dbytes))
        check(min(k["device"], prev_t["device"]) >= bms,
              f"fedagg_norms_batched {tag} timed below its bound: {k}, "
              f"previous {prev_t}")
        emit({"phase": "previous_design",
              "name": ("fedagg_norms_batched_q" if sc is not None
                       else "fedagg_norms_batched"), **tag,
              "ms": k["device"], "previous_ms": prev_t["device"],
              "ratio": k["ratio"], "previous_spread": prev_t["spread"],
              "turns": PREVIOUS_TURNS, "bound_ms": bms, "bound_by": by,
              "max_rel_diff": rel, "max_scaled_diff": scaled,
              "max_abs_diff": diff})
        del x, xs, d, sc
        torch.cuda.empty_cache()


def previous_apply_batched(torch, build, mods, lib, rows, burst) -> None:
    """fedagg_apply_batched and fedagg_apply_batched_q against the design in
    ``DIR/fedagg_batched.cu`` (commit 6468138's: a grid-stride loop, one
    float4 a thread, the B rows loaded one after another) at the path's
    median bursts (n = 65,536: f32 deltas at ``burst``, int8 at the B of the
    main-path row in ``rows``) and at every (B, n, delta) of the kernel
    rows (``BATCHED`` with f32 and bf16 deltas, ``BATCHED_Q`` with int8
    ones, ``BATCHED_BIG`` with f32 and int8), with etas that hold a zero and
    negative values: the two must agree to the bit. Times in
    ``PREVIOUS_TURNS`` turns twice: on resident inputs (``ms``; at the paper
    lengths from L2, as the server calls the apply) and on inputs cycled
    through ``ROTATE_BYTES`` of copies (``ms_cold``; the same as ``ms``
    where one set outgrows half of that), which must not come out below the
    bound (``fedagg.apply_batched_work``): L2 serves resident inputs faster
    than device memory, so the bound does not hold for those."""
    import ctypes
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fedagg, compression = mods["fedagg"], mods["compression"]
    for name in ("fedagg_apply_batched_f32", "fedagg_apply_batched_bf16"):
        getattr(lib, name).argtypes = [vp, vp, vp, i, i64, vp, vp]
    lib.fedagg_apply_batched_int8.argtypes = [vp, vp, vp, vp, i, i64, vp, vp]
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(12)
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8

    def new(x, d, sc, etas):
        if sc is None:
            return fedagg.fedagg_apply_batched(x, d, etas)
        return fedagg.fedagg_apply_batched_q(x, d, sc, etas)

    def old(x, d, sc, etas):
        out = torch.empty_like(x)
        tail = (etas.data_ptr(), d.shape[0], x.shape[0], out.data_ptr(),
                build.stream(dev))
        if sc is not None:
            err = lib.fedagg_apply_batched_int8(x.data_ptr(), d.data_ptr(),
                                                sc.data_ptr(), *tail)
        else:
            fn = (lib.fedagg_apply_batched_f32 if d.dtype == f32
                  else lib.fedagg_apply_batched_bf16)
            err = fn(x.data_ptr(), d.data_ptr(), *tail)
        check(err == 0, f"the previous apply_batched failed: {err}")
        return out

    shapes = ([(burst, 65536, f32),
               (rows["fedagg_apply_batched_q"]["B"], 65536, i8)]
              + [(b, n, dt) for b, n in BATCHED for dt in (f32, bf16)]
              + [(*BATCHED_BIG, f32)]
              + [(b, n, i8) for b, n in BATCHED_Q + [BATCHED_BIG]])
    for b, n, dt in shapes:
        x = torch.randn(n, device=dev, generator=g)
        d = 0.05 * torch.randn(b, n, device=dev, generator=g)
        etas = torch.linspace(-0.5, 0.9, b, device=dev)
        etas[b // 2] = 0.0
        sc = None
        if dt == i8:
            d[:, :fedagg.QBLOCK] = 0.0
            wires = [compression.quantize_vec(row, "int8", n) for row in d]
            d = torch.stack([w.q for w in wires])
            sc = torch.stack([w.scales for w in wires])
            del wires
        else:
            d = d.to(dt)
        args = (x, d, sc, etas)
        tag = {"B": b, "n": n, "delta": str(dt).replace("torch.", "")}
        equal = torch.equal(new(*args), old(*args))
        check(equal, f"apply_batched {tag} not bitwise equal to the previous "
              "design")
        dbytes = {f32: 4, bf16: 2, i8: 1}[dt]
        nbytes, flops = fedagg.apply_batched_work(b, n, dbytes)
        reps = 5 if n > (1 << 20) else 20
        k, prev_t = turns(lambda: new(*args), lambda: old(*args), reps,
                          PREVIOUS_TURNS)
        cold, prev_cold = k, prev_t
        if nbytes <= ROTATE_BYTES // 2:
            sets = [tuple(a.clone() if a is not None else None for a in args)
                    for _ in range(-(-ROTATE_BYTES // nbytes))]
            it_new, it_old = itertools.cycle(sets), itertools.cycle(sets)
            cold, prev_cold = turns(lambda: new(*next(it_new)),
                                    lambda: old(*next(it_old)), len(sets),
                                    PREVIOUS_TURNS)
            del sets, it_new, it_old
        bms, by = bound_ms(nbytes, flops)
        check(min(cold["device"], prev_cold["device"]) >= bms,
              f"apply_batched {tag} timed below its bound: {cold}, previous "
              f"{prev_cold}")
        emit({"phase": "previous_design",
              "name": ("fedagg_apply_batched_q" if sc is not None
                       else "fedagg_apply_batched"), **tag,
              "ms": k["device"], "previous_ms": prev_t["device"],
              "ratio": k["ratio"], "previous_spread": prev_t["spread"],
              "ms_cold": cold["device"],
              "previous_ms_cold": prev_cold["device"],
              "ratio_cold": cold["ratio"],
              "previous_spread_cold": prev_cold["spread"],
              "turns": PREVIOUS_TURNS, "bound_ms": bms, "bound_by": by,
              "bitwise_equal_previous": equal})
        del x, d, sc, etas, args
        torch.cuda.empty_cache()


#: the previous designs ``--previous DIR`` can time, by source file name
PREVIOUS = {"ssd.cu": (previous_ssd,), "rglru.cu": (previous_rglru,),
            "fedagg.cu": (previous_norms,),
            "fedagg_batched.cu": (previous_norms_batched,
                                  previous_apply_batched)}


def phase_previous(torch, build, mods: dict, prev: Path, rows: dict,
                   burst: int) -> None:
    """Every kernel whose previous design ``prev`` holds (``PREVIOUS``),
    built from there (one ``nvcc`` each, with the ``.cuh`` headers beside
    them) and held against the current one on the same inputs. Each call
    launches on the current stream, which the CUDA graphs of ``device_ms``
    replace while they capture. No time may come out below the kernel's
    bound."""
    names = [name for name in PREVIOUS if (prev / name).exists()]
    check(bool(names), f"--previous {prev} holds none of {list(PREVIOUS)}")
    build.build_all([prev / name for name in names])
    for name in names:
        for compare in PREVIOUS[name]:
            compare(torch, build, mods, build.load(prev / name), rows, burst)


def expected_launches(kinds, gen_len: int) -> dict:
    """What one serve run must launch: the scan kernel once per RG-LRU and
    per SSD layer in the prefill, the decode kernel once per attention
    layer in each of the ``gen_len - 1`` decode steps."""
    return {"rglru_scan": kinds.count("rglru"),
            "swa_decode_attention": kinds.count("attn") * (gen_len - 1),
            "ssd_scan": kinds.count("ssd")}


def phase_serve(torch, arch: str, kernels: dict, launches: dict) -> None:
    """``arch`` served at full width and depth (``SERVE_DEPTH`` cuts the
    depth of some) in f32 from seeded random weights (``SERVES[arch]``,
    after an unmeasured warm-up run): the
    serving kernels (``kernels``, by name) must launch as
    :func:`expected_launches` says, the logits must be finite and the
    tokens in the vocabulary. Then a short run once more under
    torch.profiler: the device's busy time and idle share."""
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    dev = torch.device("cuda:0")
    cfg = serve.serve_config(arch, reduced=False)
    full_layers = cfg.num_layers
    if arch in SERVE_DEPTH:
        cfg = dataclasses.replace(cfg, num_layers=SERVE_DEPTH[arch])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_model(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    kinds = cfg.layer_kinds
    per_step = cfg.num_codebooks if cfg.family == "audio" else 1
    serve.generate(params, cfg, serve.make_prompt(cfg, 1, 32, 1, dev), 2)
    for batch, prompt_len, gen_len in SERVES[arch]:
        prompt = serve.make_prompt(cfg, batch, prompt_len, 0, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        for k in kernels.values():
            k.launches = 0
        gen = serve.generate(params, cfg, prompt, gen_len, keep_logits=True)
        counts = {name: k.launches for name, k in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
        label = f"serve-{arch}-{prompt_len}"
        check(counts == expected_launches(kinds, gen_len),
              f"{label}: launches {counts}")
        check(all(bool(torch.isfinite(l).all()) for l in gen.logits),
              f"{label}: non-finite logits")
        check(tuple(gen.tokens.shape) == (batch, gen_len * per_step)
              and 0 <= int(gen.tokens.min())
              and int(gen.tokens.max()) < cfg.vocab_size,
              f"{label}: tokens {gen.tokens.shape}")
        emit({"phase": "serve", "run": label, "arch": cfg.arch_id,
              "params": cfg.param_count(), "layers": cfg.num_layers,
              "full_layers": full_layers,
              "moe": cfg.moe.impl if cfg.moe is not None else None,
              "dtype": cfg.dtype, "batch": batch, "prompt": prompt_len,
              "new_tokens": gen_len,
              "ring_slots": (min(cfg.sliding_window, prompt_len + gen_len)
                             if cfg.sliding_window else None),
              "init_s": init_s, "prefill_s": gen.prefill_s,
              "decode_s": gen.decode_s,
              "decode_ms_per_step": 1e3 * gen.decode_s / (gen_len - 1),
              "decode_tok_per_s": batch * (gen_len - 1) / gen.decode_s,
              "peak_gib": peak / 2 ** 30, "init_peak_gib": init_peak / 2 ** 30,
              "resident_before_gib": resident / 2 ** 30, "launches": counts,
              "tokens_row0": gen.tokens[0].tolist()})
        _add(launches, counts)
    # the short run's prefill and three decode steps under the profiler
    from torch.profiler import ProfilerActivity, profile
    prompt = serve.make_prompt(cfg, 4, 32, 0, dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen = serve.generate(params, cfg, prompt, 4)
        wall = time.perf_counter() - t0
    emit({"phase": "profile", "run": f"serve-{arch}-32",
          "new_tokens": 4, "prefill_s": gen.prefill_s,
          "decode_s": gen.decode_s, **device_summary(prof, wall)})
    del params, gen
    torch.cuda.empty_cache()


class RouterLog:
    """Records every MoE router call while it is entered: the chosen
    experts, the gap between the k-th and the (k+1)-th largest probability
    (what decides the choice) and the smallest gap between neighbours of
    the top k (what orders it; the aux loss reads the first)."""

    def __init__(self, torch, moe):
        self.torch, self.moe, self.calls = torch, moe, []

    def __enter__(self):
        torch, inner = self.torch, self.moe._router

        def recording(p, x, m):
            w, idx, aux = inner(p, x, m)
            probs = torch.softmax(torch.einsum(
                "td,de->te", x, p["router"].to(x.dtype)).float(), dim=-1)
            top = torch.sort(probs, dim=-1, descending=True).values
            k = m.num_experts_per_tok
            self.calls.append((idx.cpu(),
                               float((top[:, k - 1] - top[:, k]).min()),
                               float((top[:, :k - 1] - top[:, 1:k]).min())))
            return w, idx, aux

        self.moe._router = recording
        self._inner = inner
        return self

    def __exit__(self, *exc):
        self.moe._router = self._inner


def phase_serve_parity(torch, arch: str) -> None:
    """The port on the card against the port on the CPU at full width and
    ``PARITY[arch]``'s depth, from the same weights: the CPU is fed the
    card's tokens, and every step's logits must agree to ``rtol`` of the
    step's largest |logit|. Prints how many of the card's tokens the CPU's
    argmax gives too; for an MoE model also the share of router choices
    the two devices share and the smallest probability gaps at the choice
    (a flip at a gap within f32 noise is a near-tie); for a vlm model one
    forward with ``VLM_PATCHES`` patch embeddings, held likewise."""
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.utils import pytree as pt

    dev = torch.device("cuda:0")
    par = PARITY[arch]
    cfg = dataclasses.replace(serve.serve_config(arch, reduced=False),
                              num_layers=par["num_layers"])
    gparams = M.init_model(torch.Generator(device=dev).manual_seed(1), cfg)
    cparams = pt.tree_map(lambda t: t.cpu(), gparams)
    prompt = serve.make_prompt(cfg, par["batch"], par["prompt"], 0, dev)
    with RouterLog(torch, moe) as glog:
        gen = serve.generate(gparams, cfg, prompt, par["gen"],
                             keep_logits=True)
    t0 = time.perf_counter()
    with RouterLog(torch, moe) as clog:
        cpu = serve.generate(cparams, cfg, prompt.cpu(), par["gen"],
                             feed=gen.tokens.cpu(), keep_logits=True)
    cpu_s = time.perf_counter() - t0
    errs = [float((a.cpu() - b).abs().max() / b.abs().max())
            for a, b in zip(gen.logits, cpu.logits)]
    agree = float((gen.tokens.cpu() == cpu.tokens).float().mean())
    row = {"phase": "serve_parity", "arch": cfg.arch_id,
           "params": cfg.param_count(), "layers": cfg.num_layers,
           "batch": par["batch"], "prompt": par["prompt"],
           "new_tokens": par["gen"], "max_scaled_err_per_step": errs,
           "rtol": par["rtol"], "token_agreement": agree, "cpu_s": cpu_s}
    if cfg.moe is not None:
        check(len(glog.calls) == len(clog.calls) > 0,
              f"{arch}: router calls {len(glog.calls)} / {len(clog.calls)}")
        same = sum(int((a[0] == b[0]).sum())
                   for a, b in zip(glog.calls, clog.calls))
        total = sum(a[0].numel() for a in glog.calls)
        row.update({"moe": cfg.moe.impl, "router_calls": len(glog.calls),
                    "router_choice_agreement": same / total,
                    "min_choice_gap": min(c[1] for c in glog.calls),
                    "min_order_gap": min(c[2] for c in glog.calls)})
    if cfg.family == "vlm":
        g = torch.Generator().manual_seed(2)
        pe = torch.randn(par["batch"], VLM_PATCHES, cfg.vision_embed_dim,
                         generator=g)
        toks = prompt.cpu()
        got, _, _ = M.forward(gparams, prompt, cfg, patch_embeds=pe.to(dev))
        want, _, _ = M.forward(cparams, toks, cfg, patch_embeds=pe)
        text, _, _ = M.forward(cparams, toks, cfg)
        row["patch_embeds_scaled_err"] = float(
            (got.cpu() - want).abs().max() / want.abs().max())
        row["patches_move_logits"] = float((want - text).abs().max())
        check(row["patch_embeds_scaled_err"] <= par["rtol"],
              f"{arch}: patch_embeds forward, scaled error "
              f"{row['patch_embeds_scaled_err']}")
        check(row["patches_move_logits"] > 0,
              f"{arch}: the patch embeddings changed no logit")
        del got, want, text
    emit(row)
    check(max(errs) <= par["rtol"],
          f"{arch}: CUDA vs CPU logits: scaled errors {errs}")
    check(agree == 1.0, f"{arch}: CUDA vs CPU tokens agree on {agree}")
    del gparams, cparams
    gc.collect()
    torch.cuda.empty_cache()


def phase_family_train(torch, fedagg, launches: dict) -> None:
    """One reduced arch of each family of the last architecture slice
    (``FAMILY_TRAIN``: MoE, audio, vlm) trained federated by
    ``launch.train.run_arch_federated`` through the flat server (its
    sweeps the fedagg kernels), on the loop and the cohort engines, on the
    card and then on the CPU from the same init: traces equal, gammas to
    ``ARCH_SCENARIO_RTOL``, and some fedagg kernel launched on the card."""
    import contextlib
    import io

    from repro_torch.launch.train import run_arch_federated

    keys = lambda out: [(h["iteration"], h["client_id"], h["lag"],
                         h["k_next"]) for h in out["history"]]
    for arch, cap in FAMILY_TRAIN:
        for engine in ("loop", "cohort"):
            out = {}
            for dev in ("cuda", "cpu"):
                for k in fedagg.KERNELS:
                    k.launches = 0
                with contextlib.redirect_stdout(io.StringIO()):
                    out[dev] = run_arch_federated(
                        arch, steps=cap, use_pallas_agg=True,
                        client_engine=engine, device=dev)
                if dev == "cuda":
                    counts = _count(fedagg)
            res, ref = out["cuda"], out["cpu"]
            _add(launches, counts)
            same = keys(res) == keys(ref)
            gap = max((abs(a["gamma"] - b["gamma"]) / max(abs(b["gamma"]),
                                                           1e-12)
                       for a, b in zip(res["history"], ref["history"])),
                      default=0.0)
            label = f"train-{arch}-{engine}"
            emit({"phase": "family_train", "run": label, "arch": arch,
                  "engine": engine, "updates": res["updates"],
                  "drains": res["drains"], "wall_s": res["wall_s"],
                  "cpu_wall_s": ref["wall_s"], "eval_loss": res["losses"],
                  "cpu_eval_loss": ref["losses"], "trace_identical": same,
                  "gamma_max_rel_gap": gap, "rtol": ARCH_SCENARIO_RTOL,
                  "fedagg_launches": counts})
            check(res["updates"] >= cap, f"{label}: {res['updates']} updates")
            check(same, f"{label}: CUDA and CPU traces differ")
            check(gap <= ARCH_SCENARIO_RTOL, f"{label}: gamma gap {gap}")
            check(sum(counts.values()) > 0, f"{label}: no fedagg launch")
            check(all(math.isfinite(x) for x in res["losses"]),
                  f"{label}: eval losses {res['losses']}")


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
            timed: str, compare_cpu: bool, algorithm: str = "asyncfeded"):
    """One measured FederatedSimulation of ``task`` with ``algorithm`` on
    the card, after an unmeasured run of ``WARMUP_UPDATES`` updates of the
    same task (so the timings are of a process that has used every kernel
    before). Every launch count is set to 0 just before the measured run
    and read just after it. Returns (row, result, drain sizes, launch
    counts, simulation).

    The row splits the run's host time into client training, server work
    (``timed``: ``on_update`` per arrival, ``on_update_batch`` per drain or
    ``round`` per synchronous round; each ends in a wait on the device, so
    it covers the device work) and evaluation. With ``compare_cpu`` the
    same run on the CPU from the same initial params must give the same
    event trace, the same screen verdicts and the same attack stats."""
    from repro_torch.core.simulator import FederatedSimulation
    from repro_torch.utils import pytree as pt

    FederatedSimulation(task, fed, algorithm, seed=1, device="cuda").run(
        max_time=max_time, eval_every=5, max_updates=WARMUP_UPDATES)
    torch.cuda.synchronize()
    sim = FederatedSimulation(task, fed, algorithm, seed=0, device="cuda")
    init = pt.tree_map(lambda t: t.cpu(), sim.server.params)
    sizes, server_s, client_s, eval_s = [], [], [], []
    if sim.server.is_async:
        drain = sim.server.on_update_batch
        sim.server.on_update_batch = (
            lambda ups: sizes.append(len(ups)) or drain(ups))
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
    per = {"on_update": "aggregation", "on_update_batch": "drain",
           "round": "round"}[timed]
    row = {"updates": res.total_updates, "aggregations": len(res.history),
           "drains": res.total_drains, "client_rounds": len(client_s),
           "max_accuracy": res.max_accuracy(),
           "final_accuracy": res.points[-1].accuracy,
           "t90": res.time_to_accuracy(0.9 * res.max_accuracy()),
           "wall_s": wall, "client_s": sum(client_s),
           "server_s": sum(server_s), "eval_s": sum(eval_s),
           f"server_ms_per_{per}":
               1e3 * sum(server_s) / max(len(server_s), 1),
           "server_ms_median": 1e3 * statistics.median(server_s or [0]),
           "launches": counts}
    if res.screen is not None:
        row["screen"] = res.screen
    if res.attack is not None:
        row["attack"] = res.attack
    label = f"{task.name} {algorithm}"
    check(len(res.history) > 0, f"{label}: no aggregation happened")
    check(all(bool(torch.isfinite(t).all())
              for t in pt.tree_leaves(sim.server.params)),
          f"{label}: non-finite model")
    if compare_cpu:
        cpu = FederatedSimulation(task, fed, algorithm, seed=0,
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
        verdicts = ([r.screen for r in res.history]
                    == [r.screen for r in ref.history])
        acc_gap = abs(res.points[-1].accuracy - ref.points[-1].accuracy)
        row.update(cpu_history_identical=same, cpu_verdicts_identical=verdicts,
                   cpu_acc_gap=acc_gap, acc_atol=ACC_ATOL)
        if not (same and verdicts):
            emit(row)
        check(same, f"{label}: CUDA and CPU event histories differ")
        check(verdicts, f"{label}: CUDA and CPU screen verdicts differ")
        check(res.attack == ref.attack,
              f"{label}: attack stats {res.attack} != CPU {ref.attack}")
        check(acc_gap <= ACC_ATOL,
              f"{label}: CUDA vs CPU accuracy gap {acc_gap}")
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


def phase_paths(torch, fedagg, compression, launches: dict) -> dict:
    """The burst drain and compressed transport on the card (``PATHS``).
    In a run the batched launches must equal the drains of two or more
    arrivals and the single-arrival launches the aggregations outside them,
    all of the run's wire form (an int8 run through the int8 twins); the
    batched launches must all take that run's delta dtype; in an int8 run
    one delta must quantize to the same bytes on the card and on the CPU.
    Returns the median burst size of the long f32 run and of the int8 burst
    run, by label."""
    from repro_torch import configs
    from repro_torch.utils import pytree as pt

    bursts = {}
    for label, base, change, max_time, max_updates, compare in PATHS:
        task = (configs.SCENARIOS[base] if base in configs.SCENARIOS.names()
                else configs.PAPER_TASKS[base])
        fed = dataclasses.replace(task.fed, **change)
        dtypes = []
        packed = fedagg.norms_batched_packed

        def record(x_t, x_stales, deltas, scales=None):
            if x_t.is_cuda:                   # not the CPU comparison run
                dtypes.append(str(deltas.dtype))
            return packed(x_t, x_stales, deltas, scales)
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
        # the kernels of this wire form: singles through the norms and AXPY
        # sweeps, drains of two or more through the batched pair
        q = "_q" if mode == "int8" else ""
        singles = len(res.history) - sum(multi)
        check(counts["fedagg_norms_batched" + q]
              == counts["fedagg_apply_batched" + q] == len(multi),
              f"{label}: batched launches {counts} != drains with B >= 2 "
              f"({len(multi)})")
        check(counts["fedagg_norms" + q] == counts["fedagg_axpy" + q]
              == singles, f"{label}: single launches {counts} != "
              f"single aggregations ({singles})")
        check(all(v == 0 for k, v in counts.items()
                  if k.endswith("_q") != (mode == "int8")),
              f"{label}: launches of another wire form: {counts}")
        want = {"int8": "torch.int8", "bf16": "torch.bfloat16"}.get(
            mode, "torch.float32")
        check(dtypes == [want] * len(multi),
              f"{label}: batched deltas {sorted(set(dtypes))}, expected "
              f"{want}")
        if mode == "int8":
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
        if base == "synthetic-burst":
            check(len(multi) > 0, f"{label}: no drain of two or more")
        if label in ("synthetic-burst-long", "synthetic-burst-int8"):
            bursts[label] = int(statistics.median_low(multi))
        emit(row)
        _add(launches, counts)
    return bursts


def phase_comparison(torch, fedagg, launches: dict) -> None:
    """``COMPARISON`` on the card, each run against its CPU run from the
    same init: the flat-state AsyncFedED run launches the single-arrival
    sweeps once per aggregation and nothing else; every baseline and tree
    run launches no fedagg kernel, so none quietly takes the kernels or
    the CPU."""
    from repro_torch import configs

    task = configs.PAPER_TASKS["synthetic-1-1"]
    for algorithm, backend, cap in COMPARISON:
        fed = (task.fed if backend is None
               else dataclasses.replace(task.fed, backend=backend))
        sync = algorithm in ("fedavg", "fedprox")
        row, res, _, counts, sim = run_sim(
            torch, fedagg, task, fed, 1e9, cap,
            "round" if sync else "on_update", compare_cpu=True,
            algorithm=algorithm)
        flat = getattr(sim.server, "backend", None) == "pallas"
        aggs = len(res.history)
        single = ("fedagg_norms", "fedagg_axpy")
        check(res.total_updates == cap,
              f"{algorithm}: {res.total_updates} updates, expected {cap}")
        check(all(v == (aggs if flat and k in single else 0)
                  for k, v in counts.items()),
              f"{algorithm}: launches {counts} (flat: {flat}, "
              f"aggregations {aggs})")
        emit({"phase": "comparison", "algorithm": algorithm,
              "backend": getattr(sim.server, "backend", None), **row})
        _add(launches, counts)


def phase_attack(torch, fedagg, launches: dict) -> None:
    """``ATTACK_RUNS`` on the card, each against its CPU run (trace,
    verdicts, attack stats). A single arrival launches the sweeps of its
    wire form unless the screen rejects it; a drain of two or more
    launches the batched pair once. The burst run must drain a burst
    through the batched pair and reject at least once."""
    from repro_torch import configs

    for label, base, change, max_time, cap in ATTACK_RUNS:
        task = (configs.SCENARIOS[base] if base in configs.SCENARIOS.names()
                else configs.PAPER_TASKS[base])
        fed = dataclasses.replace(task.fed, **change)
        row, res, sizes, counts, _ = run_sim(
            torch, fedagg, task, fed, max_time, cap, "on_update_batch",
            compare_cpu=True)
        singles = multi = i = 0
        for b in sizes:
            if b == 1:
                singles += res.history[i].screen != "reject"
            else:
                multi += 1
            i += b
        q = "_q" if fed.delta_compression == "int8" else ""
        check(counts["fedagg_norms" + q] == counts["fedagg_axpy" + q]
              == singles, f"{label}: single launches {counts} != accepted "
              f"single arrivals ({singles})")
        check(counts["fedagg_norms_batched" + q]
              == counts["fedagg_apply_batched" + q] == multi,
              f"{label}: batched launches {counts} != drains with B >= 2 "
              f"({multi})")
        check(sum(counts.values()) == 2 * (singles + multi),
              f"{label}: launches of another wire form: {counts}")
        if base == "synthetic-burst":
            check(multi > 0, f"{label}: no drain of two or more")
            check(res.screen["reject"] > 0, f"{label}: nothing rejected")
        else:
            check(singles > 0, f"{label}: no single sweep")
        row.update(phase="attack", run=label, burst_sizes={
            str(b): sizes.count(b) for b in sorted(set(sizes))})
        emit(row)
        _add(launches, counts)


def _timed_sim(torch, fedagg, task, fed, cap, device, max_time=1e9, seed=0,
               algorithm="asyncfeded"):
    """One FederatedSimulation with timers, launch counts set to 0 just
    before it runs and read just after: wall s, client s (every fan-out,
    ``_run_locals``: both engines end in a wait for the losses), server s
    (``on_update_batch`` per drain, ending in a wait for the record's
    scalars), eval s, the width of each fan-out of two or more, the drain
    sizes. Returns (row, result, drain sizes, launch counts, simulation)."""
    from repro_torch.core.simulator import FederatedSimulation

    sim = FederatedSimulation(task, fed, algorithm, seed=seed,
                              device=device)
    client_s, server_s, eval_s, widths, sizes = [], [], [], [], []
    run_locals = sim._run_locals

    def locals_(jobs):
        t0 = time.perf_counter()
        out = run_locals(jobs)
        client_s.append(time.perf_counter() - t0)
        if len(jobs) > 1:
            widths.append(len(jobs))
        return out
    sim._run_locals = locals_
    drain = sim.server.on_update_batch
    sim.server.on_update_batch = lambda ups: sizes.append(len(ups)) or drain(
        ups)
    _time_calls(sim.server, "on_update_batch", server_s)
    _time_calls(sim, "_eval_point", eval_s)
    fedagg.reset_launches()
    t0 = time.perf_counter()
    res = sim.run(max_time=max_time, eval_every=5, max_updates=cap)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in fedagg.KERNELS}
    row = {"engine": fed.client_engine, "device": device,
           "updates": res.total_updates, "drains": res.total_drains,
           "max_accuracy": res.max_accuracy(),
           "final_accuracy": res.points[-1].accuracy, "wall_s": wall,
           "client_s": sum(client_s), "server_s": sum(server_s),
           "server_ms_median": 1e3 * statistics.median(server_s or [0]),
           "eval_s": sum(eval_s), "fan_outs": len(widths),
           "mean_width": statistics.mean(widths) if widths else 0,
           "max_width": max(widths, default=0), "plan": res.plan,
           "launches": counts}
    return row, res, sizes, counts, sim


def _check_drain_launches(label, sim, res, sizes, counts) -> None:
    """On the flat ring-GMIS server every drain of two or more launches the
    batched pair once and every single arrival the single sweeps once; the
    tree backend launches no fedagg kernel."""
    multi = sum(1 for b in sizes if b > 1)
    singles = sum(1 for b in sizes if b == 1)
    if getattr(sim.server, "backend", None) == "pallas":
        want = {"fedagg_norms": singles, "fedagg_axpy": singles,
                "fedagg_norms_batched": multi, "fedagg_apply_batched": multi}
    else:
        want = {}
    check(all(v == want.get(k, 0) for k, v in counts.items()),
          f"{label}: launches {counts}, expected {want}")


def phase_cohort(torch, fedagg, launches: dict):
    """``COHORT_RUNS`` on the card: each scenario as configured (cohort
    engine) against the loop engine on the card and the cohort engine on
    the CPU, from the same seed (so the same initial params): the three
    event traces equal, accuracy within ``ACC_ATOL``, every drain through
    the kernels of its path. Returns the synthetic-burst cohort run's
    simulation (the checkpoint phase saves its server)."""
    from repro_torch import configs

    burst_sim = None
    for name, cap in COHORT_RUNS:
        task = configs.SCENARIOS[name]
        fed_c = task.fed
        fed_l = dataclasses.replace(fed_c, client_engine="loop")
        check(fed_c.client_engine == "cohort",
              f"{name}: engine {fed_c.client_engine}, expected cohort")
        for fed in (fed_c, fed_l):             # unmeasured warm-ups
            _timed_sim(torch, fedagg, task, fed, WARMUP_UPDATES, "cuda",
                       seed=1)
        row_c, res_c, sizes, counts_c, sim_c = _timed_sim(
            torch, fedagg, task, fed_c, cap, "cuda")
        _check_drain_launches(f"{name} cohort", sim_c, res_c, sizes,
                              counts_c)
        row_l, res_l, sizes_l, counts_l, sim_l = _timed_sim(
            torch, fedagg, task, fed_l, cap, "cuda")
        _check_drain_launches(f"{name} loop", sim_l, res_l, sizes_l,
                              counts_l)
        row_cpu, res_cpu, _, _, _ = _timed_sim(torch, fedagg, task, fed_c,
                                               cap, "cpu")
        same_cpu = _key(res_c.history) == _key(res_cpu.history)
        same_loop = _key(res_c.history) == _key(res_l.history)
        gap_cpu = abs(res_c.points[-1].accuracy - res_cpu.points[-1].accuracy)
        gap_loop = abs(res_c.points[-1].accuracy - res_l.points[-1].accuracy)
        emit({"phase": "cohort", "scenario": name, "cap": cap,
              "cohort": row_c, "loop": row_l,
              "cpu_cohort": {k: row_cpu[k] for k in (
                  "updates", "drains", "fan_outs", "mean_width",
                  "final_accuracy")},
              "cpu_trace_identical": same_cpu,
              "loop_trace_identical": same_loop, "cpu_acc_gap": gap_cpu,
              "loop_acc_gap": gap_loop, "acc_atol": ACC_ATOL,
              "client_s_loop_over_cohort":
                  row_l["client_s"] / max(row_c["client_s"], 1e-9),
              "burst_sizes": {str(b): sizes.count(b)
                              for b in sorted(set(sizes))}})
        check(res_c.total_updates >= cap, f"{name}: {res_c.total_updates} "
              f"updates, expected {cap}")
        check(row_c["fan_outs"] > 0 and res_c.plan["engine"] == "cohort",
              f"{name}: no cohort fan-out ({res_c.plan})")
        check(same_cpu, f"{name}: CUDA and CPU cohort traces differ")
        check(same_loop, f"{name}: CUDA cohort and loop traces differ")
        check(gap_cpu <= ACC_ATOL and gap_loop <= ACC_ATOL,
              f"{name}: accuracy gaps {gap_cpu}, {gap_loop}")
        _add(launches, counts_c)
        _add(launches, counts_l)
        if name == PROFILED_COHORT:
            phase_cohort_profile(torch, task, fed_c, cap)
        if name == "synthetic-burst":
            check(any(b > 1 for b in sizes), f"{name}: no burst drained")
            burst_sim = sim_c
    return burst_sim


def phase_cohort_profile(torch, task, fed, cap: int) -> None:
    """The cohort run once more under torch.profiler: device busy time, the
    idle share of the wall time (an upper bound: the profiler's host work
    lengthens the wall) and the kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.simulator import FederatedSimulation

    sim = FederatedSimulation(task, fed, "asyncfeded", seed=0,
                              device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(max_time=1e9, eval_every=5, max_updates=cap)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    emit({"phase": "cohort_profile", "scenario": task.name, "cap": cap,
          **device_summary(prof, wall)})


def _fanout_memory(torch, sim, fanouts: list) -> None:
    """Wrap ``sim._run_locals`` so that each fan-out of two or more
    appends its plan (reason, est_bytes) beside the device memory it took:
    the peak of ``torch.cuda.max_memory_allocated()`` over the fan-out less
    what was allocated before it."""
    inner = sim._run_locals

    def locals_(jobs):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = inner(jobs)
        torch.cuda.synchronize()
        if len(jobs) > 1:
            plan = sim.cohort_plan
            fanouts.append({
                "clients": len(jobs), "engine": plan.engine,
                "width": plan.width, "k_chunk": plan.k_chunk,
                "reason": plan.reason, "est_bytes": plan.est_bytes,
                "full_bytes": plan.full_bytes,
                "budget_bytes": plan.budget_bytes,
                "peak_bytes": torch.cuda.max_memory_allocated() - base})
        return out
    sim._run_locals = locals_


def phase_budget(torch, fedagg) -> None:
    """femnist-64 unconstrained and under the ``BUDGET_RUNGS`` budgets: the
    seeding fan-out lands on each lower rung, every run gives the
    unconstrained trace, and each fan-out's plan (reason, est_bytes) is
    printed beside the device memory it took (``_fanout_memory``); then
    synthetic-256's fan-outs, unconstrained, for the law on the MLP."""
    from repro_torch import configs
    from repro_torch.configs import shapes
    from repro_torch.core import tasks
    from repro_torch.core.simulator import FederatedSimulation

    task = configs.SCENARIOS["femnist-64"]
    fed0 = task.fed
    lt = tasks.as_task(task)
    bb, ab = lt.batch_bytes(fed0), lt.activation_bytes(fed0)
    free = None
    for rung, clients, steps in [("fits", 0, 0)] + BUDGET_RUNGS:
        budget = 0
        if clients:
            budget = shapes.cohort_footprint_bytes(
                free[1].model_bytes, bb, ab, clients, steps)
            if rung.endswith("loop"):       # just below a 2 x 1 chunk
                budget -= 1
        # half a byte over, so that int(mb * 2**20) is the budget itself
        fed = dataclasses.replace(
            fed0, memory_budget_mb=(budget + 0.5) / 2 ** 20 if budget else 0)
        fanouts = []
        sim = FederatedSimulation(task, fed, "asyncfeded", seed=0,
                                  device="cuda")
        _fanout_memory(torch, sim, fanouts)
        t0 = time.perf_counter()
        res = sim.run(max_time=1e9, eval_every=5, max_updates=BUDGET_CAP)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if free is None:
            free = (res, sim)
        same = _key(res.history) == _key(free[0].history)
        emit({"phase": "budget", "scenario": "femnist-64", "rung": rung,
              "budget_bytes": budget, "updates": res.total_updates,
              "wall_s": wall, "trace_identical_unconstrained": same,
              "fan_outs": fanouts})
        check(fanouts and rung in fanouts[0]["reason"],
              f"budget {budget}: seeding plan {fanouts[:1]}, expected "
              f"{rung!r}")
        check(same, f"budget {budget} ({rung}): trace differs from the "
              "unconstrained run's")
    # the law on the MLP: synthetic-256's fan-outs, unconstrained
    name = "synthetic-256"
    cap = dict(COHORT_RUNS)[name]
    sim = FederatedSimulation(configs.SCENARIOS[name],
                              configs.SCENARIOS[name].fed, "asyncfeded",
                              seed=0, device="cuda")
    fanouts = []
    _fanout_memory(torch, sim, fanouts)
    sim.run(max_time=1e9, eval_every=5, max_updates=cap)
    emit({"phase": "budget", "scenario": name, "rung": "fits",
          "budget_bytes": 0, "fan_outs": fanouts})


def _pop_task(configs, n: int, mode: str):
    """synthetic-1-1 at population scale ``n`` (the population tests'
    setting): diurnal check-ins at 40 per virtual second, sessions staying
    with probability 0.25, auto window, flat server, cohort engine."""
    base = configs.SYNTHETIC_1_1
    fed = dataclasses.replace(
        base.fed, num_clients=n, population=mode, arrival_rate=40.0,
        session_stay_prob=0.25, backend="pallas", client_engine="cohort",
        client_behavior="diurnal", batch_window="auto")
    return dataclasses.replace(base, num_clients=n, samples_per_client=32,
                               fed=fed)


def phase_population(torch, fedagg, launches: dict) -> None:
    """The population engine on the card: table against materialized at
    ``POP_N`` (trace, counters, per-client table); synthetic-1m built
    lazily (no roster, no 1M-wide array, nothing contacted) and run for
    ``POP_1M_TIME`` virtual seconds, contacting fewer than 10,000; and a
    10,000-client copy at the same arrival rate, whose wall is printed
    beside the 1M run's (a row, not a check)."""
    from repro_torch import configs
    from repro_torch.core.simulator import FederatedSimulation

    runs = {}
    for mode in ("table", "materialized"):
        task = _pop_task(configs, POP_N, mode)
        row, res, sizes, counts, sim = _timed_sim(
            torch, fedagg, task, task.fed, None, "cuda", max_time=POP_TIME,
            seed=3)
        _check_drain_launches(f"population {mode}", sim, res, sizes, counts)
        runs[mode] = (row, res, sim)
        _add(launches, counts)
    (row_t, res_t, sim_t), (row_m, res_m, sim_m) = (runs["table"],
                                                    runs["materialized"])

    def rows(sim):
        return {i: {k: v for k, v in r.items() if k != "slot"}
                for i, r in sim._population.table().items()
                if r["rounds"] > 0}
    counters = ("checkins", "skipped_checkins", "sessions", "max_in_flight",
                "dropped")
    same = _key(res_t.history) == _key(res_m.history)
    same_counts = all(res_t.population[k] == res_m.population[k]
                      for k in counters)
    same_rows = rows(sim_t) == rows(sim_m)
    emit({"phase": "population", "run": f"table-vs-materialized-{POP_N}",
          "table": row_t, "materialized": row_m,
          "population_table": res_t.population,
          "population_materialized": res_m.population,
          "trace_identical": same, "counters_identical": same_counts,
          "tables_identical": same_rows})
    check(res_t.total_updates >= 10, "population: fewer than 10 updates")
    check(same and same_counts and same_rows,
          "population: table and materialized runs differ")
    check(res_t.population["materialized"] == res_t.population["contacted"]
          < POP_N, f"population: {res_t.population}")

    walls = {}
    for n in (None, 1_000_000, 10_000):   # None: an unmeasured warm-up
        task = configs.SYNTHETIC_1M
        if n not in (None, 1_000_000):
            task = dataclasses.replace(
                task, num_clients=n,
                fed=dataclasses.replace(task.fed, num_clients=n))
        t0 = time.perf_counter()
        sim = FederatedSimulation(task, task.fed, "asyncfeded", seed=0,
                                  device="cuda")
        built = time.perf_counter() - t0
        pop = sim._population
        lazy = (sim.clients == [] and pop.contacted == 0
                and sim.behavior.step_time is None)
        sizes = []
        drain = sim.server.on_update_batch
        sim.server.on_update_batch = (
            lambda ups, drain=drain: sizes.append(len(ups)) or drain(ups))
        fedagg.reset_launches()
        t0 = time.perf_counter()
        res = sim.run(max_time=0.5 if n is None else POP_1M_TIME,
                      eval_every=50)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if n is None:
            continue
        counts = {k.__name__: k.launches for k in fedagg.KERNELS}
        _check_drain_launches(f"population {n}", sim, res, sizes, counts)
        _add(launches, counts)
        walls[n] = wall
        stats = res.population
        emit({"phase": "population", "run": task.name, "num_clients": n,
              "virtual_s": POP_1M_TIME, "construct_s": built,
              "wall_s": wall, "updates": res.total_updates,
              "drains": res.total_drains, "largest_burst": max(sizes),
              "lazy_construction": lazy, **stats, "launches": counts})
        check(lazy, f"{task.name}: construction was not lazy")
        check(0 < stats["contacted"] < 10_000
              and stats["capacity"] < 10_000,
              f"{task.name}: contacted {stats['contacted']}, capacity "
              f"{stats['capacity']}")
    emit({"phase": "population", "run": "wall_1m_over_10k",
          "ratio": walls[1_000_000] / walls[10_000]})


def phase_checkpoint(torch, sim) -> None:
    """After the synthetic-burst cohort run: ``save_checkpoint``, a fresh
    server from other params, ``restore_checkpoint`` gives the flat vector
    bitwise; restoring with twice the padded length keeps the ``n`` true
    elements and pads zeros. Files go to the git-ignored ``build/``."""
    import shutil

    import numpy as np

    from repro_torch import checkpoint
    from repro_torch.core.server import AsyncFedEDServer

    d = ROOT / "build" / "chip_smoke_checkpoint"
    shutil.rmtree(d, ignore_errors=True)
    server = sim.server
    t0 = time.perf_counter()
    path = server.save_checkpoint(str(d))
    saved = time.perf_counter() - t0
    fresh = AsyncFedEDServer(
        sim.task.init(torch.Generator().manual_seed(1), sim.device),
        sim.fed, backend="pallas")
    differs = not torch.equal(fresh._flat.vec, server._flat.vec)
    t0 = time.perf_counter()
    fresh.restore_checkpoint(str(d))
    restored = time.perf_counter() - t0
    bitwise = torch.equal(fresh._flat.vec, server._flat.vec)
    spec = server._flat.spec
    wide, meta = checkpoint.restore_flat(str(d), n=spec.n,
                                         n_padded=2 * spec.n_padded)
    vec = server._flat.vec.cpu().numpy()
    repad = (wide.shape == (2 * spec.n_padded,)
             and np.array_equal(wide[:spec.n], vec[:spec.n])
             and not wide[spec.n:].any())
    shutil.rmtree(d, ignore_errors=True)
    emit({"phase": "checkpoint", "scenario": "synthetic-burst",
          "file": Path(path).name, "meta": meta, "save_s": saved,
          "restore_s": restored, "restored_bitwise": bitwise,
          "repadded_keeps_n": repad})
    check(differs and bitwise, "checkpoint: restored flat vector differs")
    check(repad, "checkpoint: re-padded restore lost the true elements")


def scaled_err(got, want) -> float:
    """The largest error over a sequence of tensors, each relative to the
    largest |want| of its tensor."""
    return max(float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
               for g, w in zip(got, want))


def phase_arch_grads(torch, ssd, ssd_ops, rglru, rglru_ops) -> None:
    """arch_train (c): the gradients of a seeded random linear functional
    of each scan's outputs, through its Function (the kernel forward, the
    plain version's VJP backward), against autograd through the plain
    version: SSDScan at ``SSD_GRAD_SHAPE`` from zero and from a state,
    RGLRUScan at ``RGLRU_GRAD_SHAPE``, errors relative to the largest
    gradient within ``SSD_TOL`` and ``RGLRU_ATOL``. Then under
    ``torch.func.vmap`` over ``GRAD_CLIENTS`` clients, each with its own
    inputs (its own ``a`` for the SSD), against one call per client: one
    launch for the vmapped call, one per client for the others. Each row
    also times, by CUDA events, the forward kernel and the backward (the
    plain version's VJP, its forward recomputed)."""
    import torch.nn.functional as F
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(11)
    rnd = lambda *shape: torch.randn(*shape, device=dev, generator=g)
    bs, s, h, p, gr, n, chunk = SSD_GRAD_SHAPE
    wy, ws = rnd(bs, s, h, p), rnd(bs, h, p, n)

    def ssd_inputs(lead=()):
        return (rnd(*lead, bs, s, h, p), F.softplus(rnd(*lead, bs, s, h)),
                -torch.exp(0.3 * rnd(*lead, h)), 0.3 * rnd(*lead, bs, s, gr, n),
                0.3 * rnd(*lead, bs, s, gr, n), rnd(*lead, bs, h, p, n))

    def ssd_fn(scan, with_h0):
        def f(x, dt, a, b, c, *h0):
            y, st = scan(x, dt, a, b, c, chunk, h0[0] if with_h0 else None)
            return (y * wy).sum() + (st * ws).sum()
        return f

    for with_h0 in (False, True):
        nargs = 6 if with_h0 else 5
        args = ssd_inputs()[:nargs]
        argnums = tuple(range(nargs))
        f = ssd_fn(ssd_ops.ssd_chunked, with_h0)
        ssd.ssd_scan.launches = 0
        got = torch.func.grad(f, argnums)(*args)
        single = ssd.ssd_scan.launches
        want = torch.func.grad(ssd_fn(ssd_ops.ssd_chunked_plain, with_h0),
                               argnums)(*args)
        err = scaled_err(got, want)
        vargs = ssd_inputs((GRAD_CLIENTS,))[:nargs]
        ssd.ssd_scan.launches = 0
        vgot = torch.func.vmap(torch.func.grad(f, argnums))(*vargs)
        folded = ssd.ssd_scan.launches
        loop = [torch.func.grad(f, argnums)(*(t[i] for t in vargs))
                for i in range(GRAD_CLIENTS)]
        verr = max(scaled_err([t[i] for t in vgot], loop[i])
                   for i in range(GRAD_CLIENTS))
        tag = {"shape": list(SSD_GRAD_SHAPE), "h0": with_h0}
        a_rows = args[2].repeat(bs)
        h0 = args[5] if with_h0 else None
        fwd = lambda: ssd_ops.SSDScan.apply(*args[:2], a_rows, *args[3:5],
                                            h0, chunk)
        vjp = lambda: torch.func.vjp(
            lambda *t: ssd_ops.ssd_rows_plain(*t[:5], chunk, h0),
            *args[:2], a_rows, *args[3:5])[1]((wy, ws))
        emit({"phase": "arch_grad", "name": "SSDScan", **tag,
              "scaled_err": err, "vmap_scaled_err": verr, "tol": SSD_TOL,
              "launches": single, "vmap_launches": folded,
              "clients": GRAD_CLIENTS, "forward_kernel_ms": _events_ms(
                  torch, fwd), "backward_vjp_ms": _events_ms(torch, vjp)})
        check(err <= SSD_TOL, f"SSDScan grads {tag}: error {err}")
        check(verr <= SSD_TOL, f"SSDScan vmapped grads {tag}: error {verr}")
        check((single, folded) == (1, 1),
              f"SSDScan {tag}: launches {single}, vmapped {folded}")
        del args, got, want, vargs, vgot, loop
        torch.cuda.empty_cache()

    b, s, w = RGLRU_GRAD_SHAPE
    wh, wl = rnd(b, s, w), rnd(b, w)

    def rg_fn(scan):
        def f(log_at, xi, h0):
            hs, last = scan(log_at.contiguous(), xi.contiguous(),
                            h0.contiguous())
            return (hs * wh).sum() + (last * wl).sum()
        return f

    f = rg_fn(rglru_ops.RGLRUScan.apply)
    args = rglru_inputs(torch, g, b, s, w)
    rglru.rglru_scan.launches = 0
    got = torch.func.grad(f, (0, 1, 2))(*args)
    single = rglru.rglru_scan.launches
    want = torch.func.grad(rg_fn(rglru.rglru_scan_plain), (0, 1, 2))(*args)
    err = scaled_err(got, want)
    vargs = [torch.stack(t) for t in zip(*(rglru_inputs(torch, g, b, s, w)
                                           for _ in range(GRAD_CLIENTS)))]
    rglru.rglru_scan.launches = 0
    vgot = torch.func.vmap(torch.func.grad(f, (0, 1, 2)))(*vargs)
    folded = rglru.rglru_scan.launches
    verr = max(scaled_err([t[i] for t in vgot],
                          torch.func.grad(f, (0, 1, 2))(
                              *(t[i] for t in vargs)))
               for i in range(GRAD_CLIENTS))
    vjp = lambda: torch.func.vjp(rglru.rglru_scan_plain, *args)[1]((wh, wl))
    emit({"phase": "arch_grad", "name": "RGLRUScan",
          "shape": list(RGLRU_GRAD_SHAPE), "h0": True, "scaled_err": err,
          "vmap_scaled_err": verr, "tol": RGLRU_ATOL, "launches": single,
          "vmap_launches": folded, "clients": GRAD_CLIENTS,
          "forward_kernel_ms": _events_ms(
              torch, lambda: rglru_ops.RGLRUScan.apply(*args)),
          "backward_vjp_ms": _events_ms(torch, vjp, reps=3)})
    check(err <= RGLRU_ATOL, f"RGLRUScan grads: error {err}")
    check(verr <= RGLRU_ATOL, f"RGLRUScan vmapped grads: error {verr}")
    check((single, folded) == (1, 1),
          f"RGLRUScan: launches {single}, vmapped {folded}")
    del args, got, want, vargs, vgot
    torch.cuda.empty_cache()


def _arch_train_task():
    """(a)'s task: the published mamba2-1.3b config with its depth cut
    and f32 compute, over ``seq_len x global_batch`` token batches."""
    from repro_torch import configs
    from repro_torch.configs.shapes import TRAIN_4K
    from repro_torch.core.tasks import ArchTask

    cfg = dataclasses.replace(configs.get_arch(ARCH_TRAIN["arch"]),
                              num_layers=ARCH_TRAIN["num_layers"],
                              dtype="float32")
    shape = dataclasses.replace(TRAIN_4K, seq_len=ARCH_TRAIN["seq_len"],
                                global_batch=ARCH_TRAIN["global_batch"])
    return ArchTask(cfg=cfg, shape=shape)


def _events_ms(torch, fn, reps: int = 5) -> float:
    """Median CUDA-event ms of ``fn()`` over ``reps`` calls after two
    unmeasured ones, each call timed alone (host launch work included)."""
    for _ in range(2):
        fn()
    out = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return statistics.median(out)


def _client_step_ms(torch, ssd, task, params, batch) -> dict:
    """One client step of the loop engine (``client.local_sgd_step``'s
    forward and backward) timed by CUDA events, split into the loss's
    forward and ``torch.autograd.grad``; the SSD launches of one step; the
    gradient's leaves (``grads``)."""
    from repro_torch.utils import pytree as pt

    leaves0, treedef = pt.tree_flatten(params)
    fwd, bwd = [], []
    for i in range(7):
        leaves = [l.detach().requires_grad_(True) for l in leaves0]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ssd.ssd_scan.launches = 0
        ev[0].record()
        loss = task.loss(pt.tree_unflatten(treedef, leaves), batch)
        ev[1].record()
        grads = torch.autograd.grad(loss, leaves)
        ev[2].record()
        ev[2].synchronize()
        if i >= 2:
            fwd.append(ev[0].elapsed_time(ev[1]))
            bwd.append(ev[1].elapsed_time(ev[2]))
        del loss, leaves
    return {"forward_ms": statistics.median(fwd),
            "backward_ms": statistics.median(bwd),
            "ssd_launches": ssd.ssd_scan.launches, "grads": list(grads)}


def _cohort_step(torch, ssd, task, params, batches) -> dict:
    """One vmapped step of a cohort chunk (``torch.func.vmap`` over the
    clients of ``grad_and_value`` of the loss, as the cohort engine runs
    it): its ms, its SSD launches and the first client's gradient leaves
    (``grads0``)."""
    from repro_torch.utils import pytree as pt

    c = len(batches)
    p = pt.tree_map(lambda t: t.expand(c, *t.shape), params)
    bx = {"tokens": torch.stack([b[0]["tokens"] for b in batches])}
    by = torch.stack([b[1] for b in batches])
    step = torch.func.vmap(torch.func.grad_and_value(
        lambda q, x, y: task.loss(q, (x, y))))
    ssd.ssd_scan.launches = 0
    grads, _ = step(p, bx, by)
    launches = ssd.ssd_scan.launches
    grads0 = [g[0].clone() for g in pt.tree_leaves(grads)]
    del grads
    return {"ms": _events_ms(torch, lambda: step(p, bx, by), reps=3),
            "ssd_launches": launches, "clients": c, "grads0": grads0}


def _grad_gap(torch, params, got, want) -> dict:
    """How far one step's gradient from the vmapped chunk (``got``) is from
    the single client step's (``want``) on the same params and batch: the
    largest error over the largest |want|, over the whole flat gradient and
    for the leaf where it is largest relative to its own."""
    names = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            names.append("/".join(path))
    walk(params, ())
    flat = lambda ls: torch.cat([t.reshape(-1) for t in ls])
    per_leaf = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(got, want)]
    worst = max(range(len(per_leaf)), key=per_leaf.__getitem__)
    return {"flat": scaled_err([flat(got)], [flat(want)]),
            "worst_leaf": names[worst], "worst_leaf_gap": per_leaf[worst]}


def _ssd_layer_ms(torch, ssd_ops, cfg, bs: int, s: int) -> dict:
    """At one layer's scan shape: the forward kernel's ms and the ms of the
    SSDScan backward (the plain version's VJP, its forward recomputed), by
    CUDA events."""
    import torch.nn.functional as F
    from repro_torch.models import ssm as SSM
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(12)
    rnd = lambda *shape: torch.randn(*shape, device=dev, generator=g)
    _, h, p, n = SSM.ssd_dims(cfg)
    gr, chunk = cfg.ssm.ngroups, min(cfg.ssm.chunk_size, s)
    x, dt = rnd(bs, s, h, p), F.softplus(rnd(bs, s, h))
    a_rows = -torch.exp(0.3 * rnd(h)).repeat(bs)
    b, c = 0.3 * rnd(bs, s, gr, n), 0.3 * rnd(bs, s, gr, n)
    gy, gs = rnd(bs, s, h, p), rnd(bs, h, p, n)

    def vjp():
        _, fn = torch.func.vjp(
            lambda *t: ssd_ops.ssd_rows_plain(*t, chunk), x, dt, a_rows, b, c)
        return fn((gy, gs))
    return {"shape": [bs, s, h, p, gr, n, chunk],
            "forward_kernel_ms": _events_ms(
                torch, lambda: ssd_ops.SSDScan.apply(x, dt, a_rows, b, c,
                                                     None, chunk)),
            "backward_vjp_ms": _events_ms(torch, vjp)}


def _fedagg_at(torch, fedagg, n: int, b: int) -> list:
    """The fedagg kernels of the flat server at the model's padded length
    ``n`` (each input read from device memory: 826 MB a vector), timed by a
    CUDA graph against their bounds (``norms_work``,
    ``apply_batched_work``; the AXPY is the B = 1 apply), the batched pair
    at burst size ``b``. The norms are held against their plain version's
    formula evaluated in f64 (at 2e8 terms the f32 plain version's own sum
    is off by up to ~1e-4, which the row reports), the AXPY against its
    plain version to the ulp and the apply to the bit."""
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn(n, device=dev, generator=g)
    xs = x + 0.01 * torch.randn(b, n, device=dev, generator=g)
    d = 0.05 * torch.randn(b, n, device=dev, generator=g)
    eta = torch.full((), 0.37, device=dev)
    etas = torch.linspace(0.1, 0.9, b, device=dev)

    def norms_f64():
        s0, d0 = x.double() - xs[0].double(), d[0].double()
        return torch.stack([torch.sum(s0 * s0), torch.sum(d0 * d0)])

    def batched_f64():
        s0, d0 = x.double()[None] - xs.double(), d.double()
        return (torch.sum(s0 * s0, dim=1), torch.sum(d0 * d0, dim=1),
                s0 @ d0.T, d0 @ d0.T)

    rel = lambda u, v: float(((u.double() - v).abs() / v.abs()).max())
    batched_err = lambda u, v: max(batched_errors(
        [t.double() for t in u], v)[:2])
    axpy_err = lambda u, v: float((u - v).abs().max() / v.abs().max())
    cases = [
        ("fedagg_norms", lambda: fedagg.fedagg_norms(x, xs[0], d[0]),
         lambda: fedagg.norms_plain(x, xs[0], d[0]), norms_f64,
         fedagg.norms_work(n), rel, 1e-5),
        ("fedagg_axpy", lambda: fedagg.fedagg_axpy(x, d[0], eta),
         lambda: fedagg.axpy_plain(x, d[0], eta), None,
         fedagg.apply_batched_work(1, n), axpy_err, 1e-7),
        ("fedagg_norms_batched",
         lambda: fedagg.fedagg_norms_batched(x, xs, d),
         lambda: fedagg.norms_batched_plain(x, xs, d), batched_f64,
         fedagg.norms_batched_work(b, n), batched_err, 1e-5),
        ("fedagg_apply_batched",
         lambda: fedagg.fedagg_apply_batched(x, d, etas),
         lambda: fedagg.apply_batched_plain(x, d, etas), None,
         fedagg.apply_batched_work(b, n), axpy_err, 0.0)]
    rows = []
    for name, fn, plain, f64, (nbytes, flops), err_fn, tol in cases:
        want = plain() if f64 is None else f64()
        err = err_fn(fn(), want)
        plain_err = None if f64 is None else err_fn(plain(), want)
        del want
        check(err <= tol, f"{name} at n={n}: error {err} > {tol}")
        ms = device_ms(fn, reps=3, trials=5)
        plain_ms = device_ms(plain, reps=1, trials=3)
        bms, by = bound_ms(nbytes, flops)
        rows.append({"name": name, "n": n,
                     "B": b if "batched" in name else 1, "err": err,
                     "tol": tol, "reference": "f64" if f64 else "plain",
                     "plain_err_vs_f64": plain_err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                     "of_bound": bms / ms})
    del x, xs, d
    torch.cuda.empty_cache()
    return rows


def phase_arch_train(torch, fedagg, ssd, ssd_ops, launches: dict) -> dict:
    """arch_train (a): mamba2-1.3b at full width (``ARCH_TRAIN``) trained
    federated on the cohort engine, then on the loop engine, after an
    unmeasured warm-up; the traces must be equal, gamma, eta and the eval
    losses agree, and the eval loss fall from the first eval to the last. Every launch count is set to 0
    just before each run and read just after. Then: a client step's
    forward and backward, a cohort chunk's step, the SSD layer's forward
    kernel against its backward (the plain VJP), the vmapped step's
    gradient against the single step's on the same batch, the fedagg
    kernels at the model's flat length, and the cohort run cut to ``ARCH_TRAIN_PROFILED``
    updates under torch.profiler. Returns the launch counts of both
    runs."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.simulator import FederatedSimulation
    from repro_torch.utils import pytree as pt

    task = _arch_train_task()
    fed_c = dataclasses.replace(
        task.fed, num_clients=ARCH_TRAIN["clients"],
        k_initial=ARCH_TRAIN["k"], client_engine="cohort", backend="pallas",
        batch_window="auto")
    fed_l = dataclasses.replace(fed_c, client_engine="loop")
    cap = ARCH_TRAIN["updates"]
    # an unmeasured warm-up (the seeding fan-out, one update, the evals)
    _timed_sim(torch, fedagg, task, fed_c, 1, "cuda", seed=1)
    runs = {}
    for fed in (fed_c, fed_l):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ssd.ssd_scan.launches = 0
        row, res, sizes, counts, sim = _timed_sim(torch, fedagg, task, fed,
                                                  cap, "cuda")
        counts = {**counts, "ssd_scan": ssd.ssd_scan.launches}
        row["launches"] = counts
        row["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        _check_drain_launches(f"arch_train {fed.client_engine}", sim, res,
                              sizes, {k: v for k, v in counts.items()
                                      if k != "ssd_scan"})
        _add(launches, counts)
        n_params = pt.tree_size(sim.server.params)
        n_flat = sim.server._flat.spec.n_padded
        # the final model (a copy), for the step timings below; one run's
        # server, GMIS and clients (~20 GiB) are let go before the next
        params = pt.tree_map(lambda t: t.detach().clone(), sim.server.params)
        runs[fed.client_engine] = (row, res, sizes, counts)
        del sim
    (row_c, res_c, sizes_c, counts_c) = runs["cohort"]
    (row_l, res_l, _, counts_l) = runs["loop"]
    layers = task.cfg.num_layers
    same = _key(res_c.history) == _key(res_l.history)
    # per quantity, the largest |cohort - loop| over (atol + rtol |loop|):
    # at most 1 where they agree
    excess = lambda u, v: max(
        (abs(a - b) / (ARCH_TRAIN["atol"] + ARCH_TRAIN["rtol"] * abs(b))
         if math.isfinite(a) else math.inf for a, b in zip(u, v)),
        default=0.0)
    gaps = {f: excess([getattr(h, f) for h in res_c.history],
                      [getattr(h, f) for h in res_l.history])
            for f in ("gamma", "eta")}
    losses_c = [p.loss for p in res_c.points]
    losses_l = [p.loss for p in res_l.points]
    gaps["eval_loss"] = (excess(losses_c, losses_l)
                         if len(losses_c) == len(losses_l) else math.inf)
    emit({"phase": "arch_train_runs", "cohort": row_c, "loop": row_l,
          "trace_identical": same, "excess": gaps,
          "gamma_cohort": [h.gamma for h in res_c.history],
          "gamma_loop": [h.gamma for h in res_l.history],
          "eta_cohort": [h.eta for h in res_c.history],
          "eta_loop": [h.eta for h in res_l.history],
          "eval_loss_cohort": losses_c, "eval_loss_loop": losses_l})
    gc.collect()
    torch.cuda.empty_cache()

    # a client step, a cohort chunk's step, the SSD layer, at this size
    batches = [task.to_device(task.make_batcher(0, 0, seed=90 + i).next(),
                              torch.device("cuda:0"))
               for i in range(ARCH_TRAIN["clients"])]
    step = _client_step_ms(torch, ssd, task, params, batches[0])
    chunk_step = _cohort_step(torch, ssd, task, params, batches)
    grad_gap = _grad_gap(torch, params, chunk_step.pop("grads0"),
                         step.pop("grads"))
    del params, batches
    gc.collect()
    torch.cuda.empty_cache()
    layer = _ssd_layer_ms(torch, ssd_ops, task.cfg,
                          ARCH_TRAIN["global_batch"], ARCH_TRAIN["seq_len"])
    vjp_share = layers * layer["backward_vjp_ms"] / step["backward_ms"]
    torch.cuda.empty_cache()
    fed_rows = _fedagg_at(torch, fedagg, n_flat,
                          max([b for b in sizes_c if b > 1], default=2))

    # the cohort run once more, cut, under the profiler
    sim = FederatedSimulation(task, fed_c, "asyncfeded", seed=0,
                              device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(max_time=1e9, eval_every=5, max_updates=ARCH_TRAIN_PROFILED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof_row = device_summary(prof, wall)
    del sim, prof
    gc.collect()
    torch.cuda.empty_cache()

    emit({"phase": "arch_train", "model": ARCH_TRAIN["arch"],
          "params": n_params, "flat_n": n_flat, "layers": layers,
          "published_layers": 48, "seq_len": ARCH_TRAIN["seq_len"],
          "global_batch": ARCH_TRAIN["global_batch"],
          "clients": ARCH_TRAIN["clients"], "k": ARCH_TRAIN["k"],
          "cap": cap, "trace_identical": same, "excess": gaps,
          "rtol": ARCH_TRAIN["rtol"], "atol": ARCH_TRAIN["atol"],
          "wall_s": {"cohort": row_c["wall_s"], "loop": row_l["wall_s"]},
          "peak_gib": {"cohort": row_c["peak_gib"],
                       "loop": row_l["peak_gib"]},
          "first_eval_loss": losses_c[0], "last_eval_loss": losses_c[-1],
          "burst_sizes": {str(b): sizes_c.count(b)
                          for b in sorted(set(sizes_c))},
          "client_step": {**step, "total_ms": step["forward_ms"]
                          + step["backward_ms"]},
          "cohort_chunk_step": chunk_step, "ssd_layer": layer,
          "step_grad_gap": grad_gap,
          "backward_share_ssd_vjp": vjp_share,
          "ssd_launches_per_client_step": step["ssd_launches"],
          "ssd_launches_per_cohort_chunk_step": chunk_step["ssd_launches"],
          "fedagg_at_model_length": fed_rows,
          "profile": {"updates": ARCH_TRAIN_PROFILED, **prof_row}})
    check(n_params == ARCH_TRAIN["params"],
          f"arch_train: {n_params} params, expected {ARCH_TRAIN['params']}")
    check(res_c.total_updates >= cap and res_c.plan["engine"] == "cohort",
          f"arch_train: {res_c.total_updates} updates, plan {res_c.plan}")
    check(same, "arch_train: cohort and loop traces differ")
    check(max(gaps.values()) <= 1.0, f"arch_train: cohort and loop "
          f"disagree beyond atol + rtol |loop| ({gaps})")
    check(losses_c[-1] < losses_c[0], f"arch_train: eval loss did not fall "
          f"({losses_c[0]} -> {losses_c[-1]})")
    check(step["ssd_launches"] == layers
          and chunk_step["ssd_launches"] == layers,
          f"arch_train: SSD launches per step {step['ssd_launches']}, per "
          f"chunk step {chunk_step['ssd_launches']}, expected {layers}")
    check(counts_c["ssd_scan"] > 0 and counts_c["ssd_scan"] % layers == 0,
          f"arch_train: cohort run's SSD launches {counts_c['ssd_scan']}")
    return {"cohort": counts_c, "loop": counts_l,
            "cohort_run": (res_c, row_c, counts_c)}


def phase_arch_scenarios(torch, ssd, launches: dict) -> None:
    """arch_train (b): each registered arch scenario as configured (cohort
    engine, auto window, its size and budget), cut to an update count, on
    the card and then on the CPU port from the same init: traces equal,
    gamma to ``ARCH_SCENARIO_RTOL``; the budgeted scenario's plan is
    printed."""
    from repro_torch import configs
    from repro_torch.core import tasks
    from repro_torch.core.simulator import FederatedSimulation
    from repro_torch.utils import pytree as pt

    for name, cap in ARCH_SCENARIO_RUNS:
        fed = configs.SCENARIOS[name].fed
        task = tasks.as_task(name)
        init = task.init(torch.Generator().manual_seed(0), "cpu")
        out = {}
        for dev in ("cuda", "cpu"):
            ssd.ssd_scan.launches = 0
            sim = FederatedSimulation(task, fed, "asyncfeded", seed=0,
                                      device=dev, init_params=init)
            t0 = time.perf_counter()
            res = sim.run(max_time=1e9, eval_every=5, max_updates=cap)
            out[dev] = (res, time.perf_counter() - t0, ssd.ssd_scan.launches)
        (res, wall, n_ssd), (res_cpu, wall_cpu, _) = out["cuda"], out["cpu"]
        _add(launches, {"ssd_scan": n_ssd})
        same = _key(res.history) == _key(res_cpu.history)
        gam, gam_cpu = ([h.gamma for h in r.history] for r in (res, res_cpu))
        gap = max((abs(a - b) / max(abs(b), 1e-12)
                   for a, b in zip(gam, gam_cpu)), default=0.0)
        emit({"phase": "arch_scenario", "scenario": name, "cap": cap,
              "arch": task.cfg.arch_id, "params": pt.tree_size(init),
              "updates": res.total_updates, "drains": res.total_drains,
              "wall_s": wall, "cpu_wall_s": wall_cpu, "plan": res.plan,
              "eval_loss": [p.loss for p in res.points],
              "cpu_eval_loss": [p.loss for p in res_cpu.points],
              "trace_identical": same, "gamma_max_rel_gap": gap,
              "rtol": ARCH_SCENARIO_RTOL, "ssd_launches": n_ssd})
        check(res.total_updates >= cap, f"{name}: {res.total_updates} "
              "updates")
        check(same, f"{name}: CUDA and CPU traces differ")
        check(gap <= ARCH_SCENARIO_RTOL, f"{name}: gamma gap {gap}")
        check(task.cfg.arch_id != "mamba2-1.3b" or n_ssd > 0,
              f"{name}: no SSD launch")
        check(fed.memory_budget_mb == 0 or res.plan["reason"] != "fits",
              f"{name}: budgeted plan {res.plan}")


def _f64_norms(shards, chunk: int = 1 << 24):
    """[sum (a - b)^2, sum d^2] in f64 over the shards' (a, b, d) triples,
    ``d`` the delta as the sweeps read it (f32, bf16, or an int8 ``(q,
    scales)`` pair dequantized to f32 first), in chunks of the length."""
    import torch

    from repro_torch.kernels.fedagg import fedagg

    s = torch.zeros(2, dtype=torch.float64, device=shards[0][0].device)
    for a, b, d in shards:
        for lo in range(0, a.shape[0], chunk):
            hi = lo + chunk
            u = a[lo:hi].double() - b[lo:hi].double()
            if isinstance(d, tuple):
                v = fedagg.dequantize_plain(
                    d[0][lo:hi], d[1][lo // fedagg.QBLOCK:hi // fedagg.QBLOCK]
                ).double()
            else:
                v = d[lo:hi].double()
            s += torch.stack([(u * u).sum(), (v * v).sum()])
    return s


def _f64_batched(shards, chunk: int = 1 << 22):
    """The batched norms (dist0_sq, dn_sq, cross, gram) in f64 over the
    shards' (x, x_stales, deltas) triples, deltas as in :func:`_f64_norms`
    with (B, n) rows."""
    from repro_torch.kernels.fedagg import fedagg

    out = None
    for x, xs, d in shards:
        for lo in range(0, x.shape[0], chunk):
            hi = lo + chunk
            s = x[None, lo:hi].double() - xs[:, lo:hi].double()
            if isinstance(d, tuple):
                q0, q1 = lo // fedagg.QBLOCK, hi // fedagg.QBLOCK
                v = fedagg.dequantize_rows_plain(
                    d[0][:, lo:hi].contiguous(),
                    d[1][:, q0:q1].contiguous()).double()
            else:
                v = d[:, lo:hi].double()
            part = [(s * s).sum(1), (v * v).sum(1), s @ v.T, v @ v.T]
            out = part if out is None else [a + p for a, p in zip(out, part)]
    return out


def _sharded_inputs(torch, n_true: int, n: int, b=None, seed: int = 0):
    """(x_t, x_stale(s), delta(s)) on the card at padded length ``n``: the
    first ``n_true`` entries random (the same for every ``n``), the rest
    zero."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = () if b is None else (b,)
    x = torch.zeros(n, device="cuda")
    x[:n_true] = torch.randn(n_true, device="cuda", generator=g)
    xs = torch.zeros(*rows, n, device="cuda")
    xs[..., :n_true] = 0.01 * torch.randn(*rows, n_true, device="cuda",
                                          generator=g)
    xs[..., :n_true] += x[:n_true]
    d = torch.zeros(*rows, n, device="cuda")
    d[..., :n_true] = 0.05 * torch.randn(*rows, n_true, device="cuda",
                                         generator=g)
    return x, xs, d


def _rel(got, want) -> float:
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def _count(fedagg) -> dict:
    return {k.__name__: k.launches for k in fedagg.KERNELS if k.launches}


def sharded_single_rows(torch, fedagg, compression, sharded, specs, mesh):
    """The four single-arrival sharded entry points at the mamba2-1.3b flat
    length on ``SHARDED_SHARDS`` shards of the one card (the device hook):
    gamma, eta and the norms against the f64 sums, every shard's new vector
    against the unsharded AXPY at the sharded eta to the bit, S launches of
    each sweep per call, no host synchronisation in a call (CUDA's sync
    debug mode raises on one), device ms (a CUDA graph) and call ms."""
    import numpy as np

    n_true, lam, eps = SHARDED_N, 2.0, 1.0
    rows = []
    # the host's cost of S shards: at a launch-bound length (4 blocks, in
    # L2) call ms is the wrappers' host work
    x, xs, d = _sharded_inputs(torch, 4 * fedagg.BLOCK, 4 * fedagg.BLOCK)
    for s in SHARDED_SHARDS:
        with mesh.repeat_devices(s):
            m = mesh.make_fedagg_mesh(s)
            a = [specs.split_flat(v, m) for v in (x, xs, d)]
            fn = lambda: sharded.flat_aggregate(*a, lam=lam, eps=eps)
            row = {"phase": "sharded_op", "name": "flat_aggregate",
                   "S": s, "n": x.shape[0], "device_ms": device_ms(fn),
                   "call_ms": call_ms(fn)}
        emit(row)
        rows.append(row)
    del x, xs, d, a, fn
    for s in SHARDED_SHARDS:
        blk = fedagg.BLOCK * s
        n = -(-n_true // blk) * blk
        x, xs, d = _sharded_inputs(torch, n_true, n, seed=7)
        z = torch.zeros_like(x)
        cd = compression.quantize_vec(d, "int8", n_true)
        with mesh.repeat_devices(s):
            m = mesh.make_fedagg_mesh(s)
            sp = lambda v: specs.split_flat(v, m)
            sx, sxs, sd, sz = sp(x), sp(xs), sp(d), sp(z)
            sq, ss = sp(cd.q), specs.split_scales(cd.scales, m)
            cases = {
                "flat_aggregate": (
                    lambda: sharded.flat_aggregate(sx, sxs, sd, lam=lam,
                                                   eps=eps),
                    list(zip(sx, sxs, sd)),
                    lambda e: fedagg.fedagg_axpy(x, d, e), "fedagg_norms",
                    "fedagg_axpy"),
                "flat_aggregate_displacement": (
                    lambda: sharded.flat_aggregate_displacement(
                        sx, sxs, sd, sz, lam=lam, eps=eps),
                    list(zip(sxs, sz, sd)),
                    lambda e: fedagg.fedagg_axpy(x, d, e), "fedagg_norms",
                    "fedagg_axpy"),
                "flat_aggregate_q": (
                    lambda: sharded.flat_aggregate_q(sx, sxs, sq, ss,
                                                     lam=lam, eps=eps),
                    list(zip(sx, sxs, zip(sq, ss))),
                    lambda e: fedagg.fedagg_axpy_q(x, cd.q, cd.scales, e),
                    "fedagg_norms_q", "fedagg_axpy_q"),
                "flat_aggregate_displacement_q": (
                    lambda: sharded.flat_aggregate_displacement_q(
                        sx, sxs, sq, ss, sz, lam=lam, eps=eps),
                    list(zip(sxs, sz, zip(sq, ss))),
                    lambda e: fedagg.fedagg_axpy_q(x, cd.q, cd.scales, e),
                    "fedagg_norms_q", "fedagg_axpy_q")}
            for name, (fn, triples, axpy, k_norms, k_axpy) in cases.items():
                fn()                              # the ticket, first use
                torch.cuda.synchronize()
                fedagg.reset_launches()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    new, gamma, eta, dist, dnorm = fn()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                counts = _count(fedagg)
                sq64 = _f64_norms(triples).cpu().numpy()
                dist64, dn64 = np.sqrt(sq64)
                gamma64 = dist64 / dn64
                eta64 = lam / (gamma64 + eps)
                got = [float(v) for v in (gamma, eta, dist, dnorm)]
                err = _rel(got, [gamma64, eta64, dist64, dn64])
                bitwise = bool(torch.equal(specs.gather_flat(new),
                                           axpy(eta)))
                row = {"phase": "sharded_op", "name": name, "S": s,
                       "n": n, "n_true": n_true, "rel_err_f64": err,
                       "tol": SHARDED_RTOL, "bitwise_vs_unsharded": bitwise,
                       "launches": counts,
                       "shard_bytes": [int(t.numel() * t.element_size())
                                       for t in new],
                       "device_ms": device_ms(fn, reps=3, trials=5),
                       "call_ms": call_ms(fn, reps=3, trials=5)}
                emit(row)
                rows.append(row)
                check(err <= SHARDED_RTOL, f"sharded {name} S={s}: gamma, "
                      f"eta, norms {err} from f64 > {SHARDED_RTOL}")
                check(bitwise, f"sharded {name} S={s}: shards differ from "
                      "the unsharded AXPY at the same eta")
                check(counts == {k_norms: s, k_axpy: s},
                      f"sharded {name} S={s}: launches {counts}")
                check(len(new) == s and all(t.is_cuda for t in new),
                      f"sharded {name} S={s}: {len(new)} shards")
            del sx, sxs, sd, sz, sq, ss, cases
        del x, xs, d, z, cd
        torch.cuda.empty_cache()
    return rows


def sharded_burst_rows(torch, fedagg, compression, sharded, specs, mesh):
    """The two batched sharded entry points at the mamba2-1.3b flat length,
    bursts of ``SHARDED_BURSTS`` (f32 rows at B = 2, bf16 at B = 23, the
    wire form that fits the card at that size; int8 at both), S shards of
    the one card: gamma, eta and the norms against the f64 sums (the
    schedule run in f64 on them), cross and Gram against f64 over their
    Cauchy-Schwarz bound, the new vector against the unsharded apply at the
    sharded etas to the bit, S launches of each sweep per burst; the
    burst's device ms (its 2S kernels in a CUDA graph) and call ms (the
    entry point, host schedule and copies included)."""
    from repro_torch.core.aggregation import sequential_batch_schedule

    n_true, lam, eps = SHARDED_N, 2.0, 1.0
    rows = []
    for b in SHARDED_BURSTS:
        for form in ("f32" if b == 2 else "bf16", "int8"):
            for s in SHARDED_SHARDS:
                blk = fedagg.BLOCK * s
                n = -(-n_true // blk) * blk
                x, xs, d = _sharded_inputs(torch, n_true, n, b=b, seed=b)
                with mesh.repeat_devices(s):
                    m = mesh.make_fedagg_mesh(s)
                    sp = lambda v: specs.split_flat(v, m)
                    sx, sxs = sp(x), sp(xs)
                    del xs
                    if form == "int8":
                        wq = [compression.quantize_vec(r, "int8", n_true)
                              for r in d]
                        del d
                        q = torch.stack([w.q for w in wq])
                        sc = torch.stack([w.scales for w in wq])
                        del wq
                        sd = list(zip(sp(q), specs.split_scales(sc, m)))
                        fn = lambda: sharded.flat_aggregate_batched_q(
                            sx, sxs, tuple(a for a, _ in sd),
                            tuple(c for _, c in sd), lam=lam, eps=eps)
                        apply = lambda e: fedagg.fedagg_apply_batched_q(
                            x, q, sc, e)
                        kinds = ("fedagg_norms_batched_q",
                                 "fedagg_apply_batched_q")
                        sweeps = lambda e: [
                            (fedagg.norms_batched_packed(a, bb, qq, cc),
                             fedagg.fedagg_apply_batched_q(a, qq, cc, e))
                            for a, bb, (qq, cc) in zip(sx, sxs, sd)]
                    else:
                        if form == "bf16":
                            d = d.to(torch.bfloat16)
                        sd = sp(d)
                        fn = lambda: sharded.flat_aggregate_batched(
                            sx, sxs, sd, lam=lam, eps=eps)
                        apply = lambda e: fedagg.fedagg_apply_batched(x, d, e)
                        kinds = ("fedagg_norms_batched",
                                 "fedagg_apply_batched")
                        sweeps = lambda e: [
                            (fedagg.norms_batched_packed(a, bb, dd),
                             fedagg.fedagg_apply_batched(a, dd, e))
                            for a, bb, dd in zip(sx, sxs, sd)]
                    fedagg.reset_launches()
                    new, etas, gammas, dists, dnorms, _ = fn()
                    counts = _count(fedagg)
                    ref = [t.cpu().numpy() for t in _f64_batched(
                        list(zip(sx, sxs, sd)))]
                    e64, g64, di64, dn64 = sequential_batch_schedule(
                        *ref, lam=lam, eps=eps)
                    err = max(_rel(gammas, g64), _rel(etas, e64),
                              _rel(dists, di64), _rel(dnorms, dn64))
                    etas_t = torch.from_numpy(etas).cuda()
                    bitwise = bool(torch.equal(specs.gather_flat(new),
                                               apply(etas_t)))
                    del new
                    packed = sharded._psum([fedagg.norms_batched_packed(
                        a, bb, *(dd if isinstance(dd, tuple) else (dd,)))
                        for a, bb, dd in zip(sx, sxs, sd)])
                    got = [torch.as_tensor(v).double() for v in
                           fedagg.split_batched(packed.cpu().numpy(), b)]
                    _, cs_err, _ = batched_errors(
                        got, [torch.as_tensor(r) for r in ref])
                    row = {"phase": "sharded_op",
                           "name": ("flat_aggregate_batched_q"
                                    if form == "int8"
                                    else "flat_aggregate_batched"),
                           "B": b, "delta": form, "S": s, "n": n,
                           "rel_err_f64": err, "tol": SHARDED_RTOL,
                           "cross_gram_err_f64": cs_err,
                           "bitwise_vs_unsharded": bitwise,
                           "launches": counts,
                           "device_ms": device_ms(lambda: sweeps(etas_t),
                                                  reps=2, trials=3),
                           "call_ms": call_ms(fn, reps=2, trials=3)}
                    emit(row)
                    rows.append(row)
                    label = f"sharded {row['name']} B={b} {form} S={s}"
                    check(err <= SHARDED_RTOL, f"{label}: gamma, eta, "
                          f"norms {err} from f64 > {SHARDED_RTOL}")
                    check(cs_err <= SHARDED_CS_TOL,
                          f"{label}: cross/Gram {cs_err} > {SHARDED_CS_TOL}")
                    check(bitwise, f"{label}: shards differ from the "
                          "unsharded apply at the same etas")
                    check(counts == {k: s for k in kinds},
                          f"{label}: launches {counts}")
                    del sx, sxs, sd, fn, apply, sweeps, packed
                del x
                if form == "int8":
                    del q, sc
                else:
                    del d
                torch.cuda.empty_cache()
    return rows


def _sim_pair_check(label, got, want, rtol=2e-4, atol=1e-5, acc_rtol=1e-3):
    """The reference's ``assert_same_run``: traces (and screen verdicts)
    equal, gamma to rtol / atol, eval accuracies to ``acc_rtol`` (None: not
    compared). Returns the largest gamma excess over atol + rtol |want|
    (<= 1 passes)."""
    import numpy as np

    key = lambda r: [(h.iteration, h.client_id, h.lag, h.k_next, h.screen)
                     for h in r.history]
    same = key(got) == key(want)
    g1 = np.array([h.gamma for h in got.history], np.float64)
    g2 = np.array([h.gamma for h in want.history], np.float64)
    excess = (float(np.max(np.abs(g1 - g2) / (atol + rtol * np.abs(g2))))
              if same and len(g1) else float("inf"))
    a1 = np.array([p.accuracy for p in got.points])
    a2 = np.array([p.accuracy for p in want.points])
    acc_ok = acc_rtol is None or (a1.shape == a2.shape and bool(
        np.all(np.abs(a1 - a2) <= acc_rtol * np.abs(a2))))
    check(same, f"{label}: traces differ")
    check(excess <= 1.0, f"{label}: gamma beyond rtol {rtol} (excess "
          f"{excess})")
    check(acc_ok, f"{label}: accuracies differ beyond rtol {acc_rtol}")
    return excess


def _hooked_sim(torch, fedagg, mesh, task, fed, cap, devices, device="cuda",
                algorithm="asyncfeded"):
    """``_timed_sim`` with the mesh's device hook counting the card
    ``devices`` times."""
    with mesh.repeat_devices(devices):
        return _timed_sim(torch, fedagg, task, fed, cap, device,
                          algorithm=algorithm)


def sharded_server_runs(torch, fedagg, mesh, launches: dict):
    """The sharded flat server on the card (``SHARDED_SERVER_RUNS``), each
    against the same config at S = 1 on the card: traces equal, gamma and
    accuracy to the reference's bounds, equal drain counts, and S times the
    unsharded run's launches. Outside the hook ``model_shards`` beyond the
    card count raises the mesh's error. Returns the S = 4 burst run's
    server and its S = 1 twin's (for the checkpoint)."""
    from repro_torch import configs
    from repro_torch.core.simulator import FederatedSimulation

    task = configs.SYNTHETIC_1_1
    # unmeasured: the sharded path's first use in this process
    _hooked_sim(torch, fedagg, mesh, task, dataclasses.replace(
        task.fed, backend="pallas", model_shards=2), WARMUP_UPDATES, 2)
    base = {}
    servers = None
    for label, s, window, comp, algorithm in SHARDED_SERVER_RUNS:
        fed = dataclasses.replace(task.fed, backend="pallas",
                                  batch_window=window,
                                  delta_compression=comp)
        key = (window, comp, algorithm)
        if key not in base:
            base[key] = _timed_sim(torch, fedagg, task, fed,
                                   SHARDED_SERVER_CAP, "cuda",
                                   algorithm=algorithm)
            _add(launches, base[key][3])
        row1, res1, sizes1, counts1, sim1 = base[key]
        row, res, sizes, counts, sim = _hooked_sim(
            torch, fedagg, mesh, task,
            dataclasses.replace(fed, model_shards=s), SHARDED_SERVER_CAP,
            s, algorithm=algorithm)
        _add(launches, counts)
        per_agg = lambda r, sz: 1e3 * r["server_s"] / max(len(sz), 1)
        emit({"phase": "sharded_server", "run": label, "S": s,
              "window": window, "delta": comp, "algorithm": algorithm,
              "updates": res.total_updates, "drains": res.total_drains,
              "server_ms_per_drain": per_agg(row, sizes),
              "server_ms_per_drain_S1": per_agg(row1, sizes1),
              "server_ms_median": row["server_ms_median"],
              "server_ms_median_S1": row1["server_ms_median"],
              "wall_s": row["wall_s"], "wall_s_S1": row1["wall_s"],
              "launches": counts, "launches_S1": counts1,
              "shard_bytes": [int(t.numel() * t.element_size())
                              for t in sim.server._flat.vec]})
        _sim_pair_check(f"sharded server {label}", res, res1)
        check(res.total_drains == res1.total_drains,
              f"sharded server {label}: drains {res.total_drains} != "
              f"{res1.total_drains}")
        check(counts == {k: s * v for k, v in counts1.items()},
              f"sharded server {label}: launches {counts}, S = 1 {counts1}")
        check(len(sim.server._flat.vec) == s, f"sharded server {label}: "
              f"{len(sim.server._flat.vec)} shards")
        if label == "burst-S4":
            servers = (sim.server, sim1.server)
    over = 2 * torch.cuda.device_count()
    try:
        FederatedSimulation(task, dataclasses.replace(
            task.fed, backend="pallas", model_shards=over), device="cuda")
        raised = None
    except ValueError as e:
        raised = str(e)
    emit({"phase": "sharded_server", "run": f"model_shards={over} unhooked",
          "raised": raised})
    check(raised is not None and "devices, have" in raised,
          f"model_shards={over} on {over // 2} card(s) did not raise the "
          "mesh's error")
    return servers


def sharded_pod_runs(torch, fedagg, mesh, launches: dict) -> None:
    """The pod engine on ``SYNTHETIC_BURST`` (32 clients, auto window, flat
    server) with int8 and bf16 wire forms: one pod (the card alone) and
    ``SHARDED_PODS`` pods (the hook), each against the card's cohort run
    (trace equal, gamma and accuracy to the reference's bounds, the same
    launches) and the CPU port's pod run (trace equal); then the 2-D
    layout, int8 pods into ``model_shards=2``, against the cohort run."""
    from repro_torch import configs

    task = configs.SCENARIOS["synthetic-burst"]
    cap = SHARDED_POD_CAP
    for mode in ("int8", "bf16"):
        fed_c = dataclasses.replace(task.fed, delta_compression=mode)
        fed_p = dataclasses.replace(fed_c, client_engine="cohort_sharded")
        row_c, res_c, sizes_c, counts_c, _ = _timed_sim(
            torch, fedagg, task, fed_c, cap, "cuda")
        _add(launches, counts_c)
        out = {"phase": "sharded_pods", "scenario": "synthetic-burst",
               "delta": mode, "cap": cap, "cohort": row_c}
        for pods in (1, SHARDED_PODS):
            row, res, sizes, counts, sim = _hooked_sim(
                torch, fedagg, mesh, task, fed_p, cap, pods)
            _add(launches, counts)
            label = f"pods={pods} {mode}"
            out[f"pods_{pods}"] = row
            out[f"pods_{pods}_gamma_excess"] = _sim_pair_check(
                f"pod engine {label} vs cohort", res, res_c)
            check(counts == counts_c and sizes == sizes_c,
                  f"pod engine {label}: launches {counts} / {counts_c}")
            check(row["max_width"] >= 2, f"pod engine {label}: no fan-out")
            staged = [c._residual for c in sim.clients
                      if c._residual is not None]
            check(staged and all(
                r.is_cuda and r.storage_offset() == 0
                and r.untyped_storage().nbytes() == r.numel() * 4
                for r in staged),
                f"pod engine {label}: residual rows not owned on the card")
        _, res_cpu, _, _, _ = _hooked_sim(torch, fedagg, mesh, task, fed_p,
                                          cap, SHARDED_PODS, device="cpu")
        same_cpu = _key(res.history) == _key(res_cpu.history)
        out["cpu_trace_identical"] = same_cpu
        emit(out)
        check(same_cpu, f"pod engine {mode}: card and CPU traces differ")
    fed_c = dataclasses.replace(task.fed, delta_compression="int8")
    fed_2d = dataclasses.replace(fed_c, client_engine="cohort_sharded",
                                 model_shards=2)
    _, res_c, _, counts_c, _ = _timed_sim(torch, fedagg, task, fed_c, cap,
                                          "cuda")
    row, res, _, counts, sim = _hooked_sim(torch, fedagg, mesh, task, fed_2d,
                                           cap, 2)
    _add(launches, counts_c)
    _add(launches, counts)
    emit({"phase": "sharded_pods", "scenario": "synthetic-burst",
          "layout": "2 pods x 2 model shards", "delta": "int8",
          "run": row, "launches_cohort": counts_c,
          "gamma_excess": _sim_pair_check("pod engine 2-D vs cohort", res,
                                          res_c)})
    check(counts == {k: 2 * v for k, v in counts_c.items()},
          f"pod engine 2-D: launches {counts}, cohort {counts_c}")
    check(len(sim.server._flat.vec) == 2, "pod engine 2-D: not sharded")


def sharded_checkpoint(torch, servers) -> None:
    """Saved at S = 4, restored at S = 1: the n true elements equal bitwise
    (the S = 1 server is the burst run's unsharded twin)."""
    import shutil

    from repro_torch.sharding import specs

    s4, s1 = servers
    d = ROOT / "build" / "chip_smoke_sharded_checkpoint"
    shutil.rmtree(d, ignore_errors=True)
    s4.save_checkpoint(str(d), step=1)
    s1.restore_checkpoint(str(d), step=1)
    n = s1._flat.spec.n
    bitwise = bool(torch.equal(s1._flat.vec[:n],
                               specs.gather_flat(s4._flat.vec)[:n]))
    shutil.rmtree(d, ignore_errors=True)
    emit({"phase": "sharded_checkpoint", "saved_S": len(s4._flat.vec),
          "restored_S": 1, "n": n, "restored_bitwise": bitwise})
    check(bitwise, "sharded checkpoint: S = 4 -> S = 1 restore differs")


def sharded_arch_run(torch, fedagg, mesh, ssd, cohort_run,
                     launches: dict) -> None:
    """arch_train (a)'s mamba2-1.3b task at every published width on the
    pod engine with ``model_shards=2`` (two pods of two clients and two
    model shards, one after another on the card), against that phase's
    cohort run: traces equal, gamma and the last eval loss to
    ``ARCH_TRAIN["rtol"]``, twice its fedagg launches; per-shard flat
    bytes, peak GiB, wall s, server ms per drain."""
    task = _arch_train_task()
    res_c, row_c, counts_c = cohort_run
    fed = dataclasses.replace(
        task.fed, num_clients=ARCH_TRAIN["clients"],
        k_initial=ARCH_TRAIN["k"], client_engine="cohort_sharded",
        backend="pallas", batch_window="auto", model_shards=2)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssd.ssd_scan.launches = 0
    row, res, sizes, counts, sim = _hooked_sim(
        torch, fedagg, mesh, task, fed, ARCH_TRAIN["updates"], 2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = {**counts, "ssd_scan": ssd.ssd_scan.launches}
    _add(launches, counts)
    shard_bytes = [int(t.numel() * t.element_size())
                   for t in sim.server._flat.vec]
    del sim
    gc.collect()
    torch.cuda.empty_cache()
    rtol, atol = ARCH_TRAIN["rtol"], ARCH_TRAIN["atol"]
    loss_c, loss_s = res_c.points[-1].loss, res.points[-1].loss
    loss_gap = abs(loss_s - loss_c) / abs(loss_c)
    emit({"phase": "sharded_arch", "model": ARCH_TRAIN["arch"],
          "layout": "2 pods x 2 model shards", "updates": res.total_updates,
          "drains": res.total_drains, "shard_bytes": shard_bytes,
          "peak_gib": peak, "wall_s": row["wall_s"],
          "wall_s_cohort": row_c["wall_s"],
          "server_ms_per_drain": 1e3 * row["server_s"] / max(len(sizes), 1),
          "server_ms_per_drain_cohort":
              1e3 * row_c["server_s"] / max(res_c.total_drains, 1),
          "launches": counts, "launches_cohort": counts_c,
          "last_eval_loss": loss_s, "last_eval_loss_cohort": loss_c,
          "eval_loss_rel_gap": loss_gap,
          "gamma_excess": _sim_pair_check(
              "sharded arch run vs cohort", res, res_c, rtol=rtol,
              atol=atol, acc_rtol=None)})
    check(loss_gap <= rtol, f"sharded arch run: last eval loss {loss_s} vs "
          f"{loss_c}")
    check(all(counts[k] == 2 * v for k, v in counts_c.items()
              if k != "ssd_scan"),
          f"sharded arch run: launches {counts}, cohort {counts_c}")


def phase_sharded(torch, fedagg, compression, ssd, cohort_run,
                  launches: dict) -> None:
    """``sharded``: model sharding and the pod engine on the one card, the
    card counted S times by the mesh's device hook (S shard allocations, S
    launches per sweep): the sharded entry points at the mamba2-1.3b flat
    length, the sharded server, the pod engine, a checkpoint across
    layouts and the full-width mamba2-1.3b run on two pods and two model
    shards."""
    from repro_torch.kernels.fedagg import sharded
    from repro_torch.launch import mesh
    from repro_torch.sharding import specs

    t0 = time.perf_counter()
    sharded_single_rows(torch, fedagg, compression, sharded, specs, mesh)
    sharded_burst_rows(torch, fedagg, compression, sharded, specs, mesh)
    t1 = time.perf_counter()
    servers = sharded_server_runs(torch, fedagg, mesh, launches)
    sharded_checkpoint(torch, servers)
    del servers
    t2 = time.perf_counter()
    sharded_pod_runs(torch, fedagg, mesh, launches)
    t3 = time.perf_counter()
    sharded_arch_run(torch, fedagg, mesh, ssd, cohort_run, launches)
    emit({"phase": "sharded_seconds", "ops": t1 - t0, "server": t2 - t1,
          "pods": t3 - t2, "arch": time.perf_counter() - t3})


def phase_profile(torch) -> None:
    """synthetic-1-1 and femnist once more under torch.profiler: device
    busy time (the sum of the device-side events), the idle share of the
    wall time, and the kernels that take the most. The profiler's own host
    work lengthens the wall time, so the idle share is an upper bound.
    Shakespeare is left out: its LSTM launches some 10^5 small kernels per
    client round, and reading back that many events takes minutes."""
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
        emit({"phase": "profile", "task": name, "updates": max_updates,
              **device_summary(prof, wall)})


def device_summary(prof, wall: float) -> dict:
    """From a finished torch.profiler run of ``wall`` host seconds: the sum
    of the device-side events (kernels, copies), the idle share of the wall
    time, and the ten names that take the most device time."""
    from torch.autograd import DeviceType

    per_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            calls, us = per_name.get(e.name, (0, 0.0))
            per_name[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in per_name.values()) / 1e6
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall if busy else None,
            "top": [{"name": k[:80], "calls": c, "device_ms": us / 1e3}
                    for k, (c, us) in top]}


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Drive the PyTorch port on one "
                                 "NVIDIA GPU and check it.")
    ap.add_argument("--previous", type=Path, default=None, metavar="DIR",
                    help="time each kernel whose previous design DIR holds "
                         "(ssd.cu, rglru.cu: commit 2b85a6a's; fedagg.cu, "
                         "fedagg_batched.cu with fedagg_common.cuh: commit "
                         "6468138's) in turns with that design")
    args = ap.parse_args(argv)
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
        from repro_torch.kernels.rglru import ops as rglru_ops
        from repro_torch.kernels.rglru import rglru
        from repro_torch.kernels.ssd import ops as ssd_ops
        from repro_torch.kernels.ssd import ssd
        from repro_torch.kernels.swa_attn import swa_attn
        from repro_torch.models import ssm as SSM
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the batched plain version needs f32")

    smi = phase_env(torch)
    phase_build(build, [(fedagg.SOURCES, fedagg.load_libraries),
                        ((rglru.SOURCE,), rglru.load_library),
                        ((swa_attn.SOURCE,), swa_attn.load_library),
                        ((ssd.SOURCE,), ssd.load_library)])
    main_rows = phase_kernels(torch, fedagg)
    main_rows.update(phase_q_kernels(torch, fedagg, compression))
    phase_batched_kernels(torch, fedagg, compression)
    main_rows.update(phase_arch_kernels(torch, rglru, swa_attn))
    main_rows["fedagg_fused"] = phase_fused(torch, fedagg)
    main_rows["ssd_scan"] = phase_ssd_kernels(torch, ssd_ops, SSM)
    launches: dict = {}
    phase_sims(torch, fedagg, launches)
    bursts = phase_paths(torch, fedagg, compression, launches)
    # the batched pairs once more at their runs' median B, n = 65536
    burst = bursts["synthetic-burst-long"]
    rows = (*batched_rows(torch, fedagg, burst, 65536, torch.float32,
                          seed=2),
            *batched_q_rows(torch, fedagg, compression,
                            bursts["synthetic-burst-int8"], 65536, seed=2))
    for row in rows:
        row["main_path"] = True
        emit(row)
        main_rows[row["name"]] = row
    emit(batched_passes(torch, fedagg, burst, 65536,
                        main_rows["fedagg_norms_batched"]["bound_ms"]))
    if args.previous is not None:
        phase_previous(torch, build, {"ssd": ssd, "rglru": rglru,
                                      "fedagg": fedagg,
                                      "compression": compression},
                       args.previous.resolve(), main_rows, burst)
    phase_profile(torch)
    serve_kernels = {"rglru_scan": rglru.rglru_scan,
                     "swa_decode_attention": swa_attn.swa_decode_attention,
                     "ssd_scan": ssd.ssd_scan}
    serve_s = {}
    for arch in SERVES:
        t0 = time.perf_counter()
        phase_serve(torch, arch, serve_kernels, launches)
        phase_serve_parity(torch, arch)
        serve_s[arch] = time.perf_counter() - t0
    emit({"phase": "phase_seconds", "serve": serve_s})
    t0 = time.perf_counter()
    phase_comparison(torch, fedagg, launches)
    t1 = time.perf_counter()
    phase_attack(torch, fedagg, launches)
    t2 = time.perf_counter()
    burst_sim = phase_cohort(torch, fedagg, launches)
    t3 = time.perf_counter()
    phase_budget(torch, fedagg)
    t4 = time.perf_counter()
    phase_population(torch, fedagg, launches)
    t5 = time.perf_counter()
    phase_checkpoint(torch, burst_sim)
    t6 = time.perf_counter()
    phase_arch_grads(torch, ssd, ssd_ops, rglru, rglru_ops)
    t7 = time.perf_counter()
    arch = phase_arch_train(torch, fedagg, ssd, ssd_ops, launches)
    t8 = time.perf_counter()
    phase_sharded(torch, fedagg, compression, ssd, arch["cohort_run"],
                  launches)
    del arch
    t9 = time.perf_counter()
    phase_arch_scenarios(torch, ssd, launches)
    t10 = time.perf_counter()
    phase_family_train(torch, fedagg, launches)
    emit({"phase": "phase_seconds", "comparison": t1 - t0,
          "attack": t2 - t1, "cohort": t3 - t2, "budget": t4 - t3,
          "population": t5 - t4, "checkpoint": t6 - t5,
          "arch_grads": t7 - t6, "arch_train": t8 - t7,
          "sharded": t9 - t8, "arch_scenarios": t10 - t9,
          "family_train": time.perf_counter() - t10})

    fed_csrc = "src/repro_torch/kernels/fedagg/csrc/"
    fed_ref = "src/repro/kernels/fedagg/fedagg.py:"
    where = {"fedagg_norms": (fed_csrc + "fedagg.cu", fed_ref + "101"),
             "fedagg_axpy": (fed_csrc + "fedagg.cu", fed_ref + "128"),
             "fedagg_norms_batched": (fed_csrc + "fedagg_batched.cu",
                                      fed_ref + "178"),
             "fedagg_apply_batched": (fed_csrc + "fedagg_batched.cu",
                                      fed_ref + "232"),
             "fedagg_fused": (fed_csrc + "fedagg.cu", fed_ref + "278"),
             "fedagg_norms_q": (fed_csrc + "fedagg.cu", fed_ref + "342"),
             "fedagg_axpy_q": (fed_csrc + "fedagg.cu", fed_ref + "379"),
             "fedagg_norms_batched_q": (fed_csrc + "fedagg_batched.cu",
                                        fed_ref + "421"),
             "fedagg_apply_batched_q": (fed_csrc + "fedagg_batched.cu",
                                        fed_ref + "477"),
             "rglru_scan": ("src/repro_torch/kernels/rglru/csrc/rglru.cu",
                            "src/repro/kernels/rglru/rglru.py:49"),
             "swa_decode_attention": (
                 "src/repro_torch/kernels/swa_attn/csrc/swa_attn.cu",
                 "src/repro/kernels/swa_attn/swa_attn.py:61"),
             "ssd_scan": ("src/repro_torch/kernels/ssd/csrc/ssd.cu",
                          "src/repro/kernels/ssd/ssd.py:76")}
    #: kernels that no path of either package launches (checked above
    #: against the wrappers they equal)
    off_path = {"fedagg_fused"}
    rows = []
    for k in (*fedagg.KERNELS, *rglru.KERNELS, *swa_attn.KERNELS,
              *ssd.KERNELS):
        name = k.__name__
        r = main_rows[name]
        check(name in off_path or launches.get(name, 0) > 0,
              f"{name} was not launched on a path")
        rows.append({"name": name, "route": "cuda", "source": where[name][0],
                     "replaces": where[name][1],
                     "launches": launches.get(name, 0),
                     "on_path": name not in off_path,
                     "shape": r.get("shape", [r.get("B"), r.get("n")]),
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
    sys.exit(main(sys.argv[1:]))
