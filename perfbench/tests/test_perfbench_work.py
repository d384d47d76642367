"""The frozen yardsticks pinned to values worked by hand at the cells'
shapes, and to the port's own counts they were copied from."""
import json

import pytest

from perfbench import bench
from perfbench.weights import num_elements as param_count
from perfbench.work import fedagg, flops, peaks, ssd

N = 206_372_608                 # mamba2-1.3b at 4 layers
N_PAD = 206_372_864             # padded to 3,149 blocks of 65,536


def _config(name):
    with open(bench.ROOT / "perfbench" / "configs" / f"{name}.json") as f:
        return json.load(f)


def test_param_counts():
    # mamba2: embed 50,280 x 2,048 = 102,973,440; a layer 25,849,792 (in_proj
    # 2,048 x 8,512, conv 4 x 4,352 + 4,352, out_proj 4,096 x 2,048, the
    # norms 2,048 + 4,096, three head vectors of 64); final norm 2,048
    assert param_count(_config("mamba2-1.3b")) == N
    # danube: embed and head 2 x 81,920,000; a layer 69,473,280 (q and o
    # 2 x 6,553,600, k and v 2 x 1,638,400, SwiGLU 3 x 17,694,720, norms
    # 2 x 2,560); final norm 2,560
    assert param_count(_config("h2o-danube-1.8b")) == 441_735_680


def test_ssd_work_at_the_cells_shapes():
    # a client's launch (4, 512, 64, 64, G 1, N 128, chunk 256), no h0:
    # bytes 4 (2 x 8,388,608 + 131,072 + 2 x 262,144 + 64 + 2,097,152)
    assert ssd.ssd_work(4, 512, 64, 64, 1, 128, 256, False) == (
        78_119_168, 6_518_210_560)
    # a cohort's launch folds its four clients into the batch
    assert ssd.ssd_work(16, 512, 64, 64, 1, 128, 256, False) == (
        312_475_904, 26_072_842_240)


def test_drain_bytes():
    # one arrival: the norms sweep and the AXPY, 12 bytes an element each
    assert fedagg.drain_sweep_bytes(1, N_PAD) == 24 * N_PAD
    # 15: norms 4 (16 + 15) n, apply 4 (2 + 15) n
    assert fedagg.drain_sweep_bytes(15, N_PAD) == 4 * (31 + 17) * N_PAD
    # the rule: x_t, the distinct snapshots, the deltas, x_new
    assert fedagg.rule_bytes(1, 1, N) == 16 * N == 3_301_961_728
    assert fedagg.rule_bytes(15, 3, N) == 80 * N == 16_509_808_640


def test_model_flops_per_token():
    m, d = _config("mamba2-1.3b"), _config("h2o-danube-1.8b")
    # mamba2 per token and layer: projections 2 x 2,048 x 8,512 + 2 x 4,096
    # x 2,048, conv 2 x 4 x 4,352; the scan's count over the batch; the
    # tied head 2 x 2,048 x 50,280
    layer = 2 * 2048 * 8512 + 2 * 4096 * 2048 + 2 * 4 * 4352
    scan = ssd.ssd_work(4, 512, 64, 64, 1, 128, 256, False)[1]
    want = 4 * (layer * 2048 + scan) + 2 * 2048 * 50280 * 2048
    assert flops.forward_flops(m, 4, 512) == want == 871_191_543_808
    # danube: q, k, v, o 2 x 2,560 x (2,560 + 1,280) + 2 x 2,560 x 2,560,
    # SwiGLU 6 x 2,560 x 6,912, attention 4 x 32 x 80 over the 131,328
    # causal pairs of 512 tokens per row, the head 2 x 2,560 x 32,000
    layer = (2 * 2560 * 3840 + 2 * 2560 * 2560 + 6 * 2560 * 6912) * 2048
    attn = 4 * 32 * 80 * 131_328 * 4
    want = 4 * (layer + attn) + 2 * 2560 * 32000 * 2048
    assert flops.forward_flops(d, 4, 512) == want == 1_495_227_432_960
    assert flops.train_step_flops(m, 4, 512) == 3 * 871_191_543_808


def test_bound_takes_the_larger():
    assert peaks.bound_s(3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(0, 67e12) == pytest.approx(1.0)
    assert peaks.bound_s(3.35e12, 134e12) == pytest.approx(2.0)


def test_frozen_copies_equal_the_ports_counts():
    from repro_torch.kernels.fedagg import fedagg as port_fedagg
    from repro_torch.kernels.ssd import ssd as port_ssd
    for shape in ((4, 512, 64, 64, 1, 128, 256, False),
                  (2, 2048, 10, 32, 2, 64, 128, True)):
        assert ssd.ssd_work(*shape) == port_ssd.ssd_work(*shape)
    for b in (2, 15, 23):
        assert fedagg.norms_batched_work(b, N_PAD) == \
            port_fedagg.norms_batched_work(b, N_PAD)
        assert fedagg.apply_batched_work(b, N_PAD) == \
            port_fedagg.apply_batched_work(b, N_PAD)
    assert fedagg.norms_work(N_PAD) == port_fedagg.norms_work(N_PAD)
