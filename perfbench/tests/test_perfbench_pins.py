"""What the cells read, pinned: each configuration's weight layout, its
parameter and flop counts at the cells' shapes (4 rows of 512 tokens), and
the flat vector that one seed draws for each tiny configuration. The
layout and the counts are found through the configuration's reference
module; these values are the ones the cells were measured with."""
import hashlib
import json

import pytest

from perfbench import bench, weights
from perfbench.tests import tiny
from perfbench.work import flops

N, O, Z = "normal", "ones", "zeros"
SSD = "layers", "b0_ssd"
ATTN = "layers", "b0_attn"

#: (path, shape, init, scale) of every leaf, in sorted-key order
LAYOUT = {
    "mamba2-1.3b": [
        (("embed", "tok"), (50280, 2048), N, 1.0),
        (("final_norm", "scale"), (2048,), O, 0.02),
        (SSD + ("norm1", "scale"), (4, 2048), O, 0.02),
        (SSD + ("ssd", "a_log"), (4, 64), O, 0.02),
        (SSD + ("ssd", "conv_b"), (4, 4352), Z, 0.02),
        (SSD + ("ssd", "conv_w"), (4, 4, 4352), N, 0.02),
        (SSD + ("ssd", "d_skip"), (4, 64), O, 0.02),
        (SSD + ("ssd", "dt_bias"), (4, 64), Z, 0.02),
        (SSD + ("ssd", "in_proj"), (4, 2048, 8512), N, 0.02),
        (SSD + ("ssd", "norm_scale"), (4, 4096), O, 0.02),
        (SSD + ("ssd", "out_proj"), (4, 4096, 2048), N, 0.02),
    ],
    "h2o-danube-1.8b": [
        (("embed", "tok"), (32000, 2560), N, 1.0),
        (("final_norm", "scale"), (2560,), O, 0.02),
        (("head", "out"), (2560, 32000), N, 0.02),
        (ATTN + ("attn", "wk"), (4, 2560, 8, 80), N, 0.02),
        (ATTN + ("attn", "wo"), (4, 32, 80, 2560), N, 0.02),
        (ATTN + ("attn", "wq"), (4, 2560, 32, 80), N, 0.02),
        (ATTN + ("attn", "wv"), (4, 2560, 8, 80), N, 0.02),
        (ATTN + ("ffn", "wi_gate"), (4, 2560, 6912), N, 0.02),
        (ATTN + ("ffn", "wi_up"), (4, 2560, 6912), N, 0.02),
        (ATTN + ("ffn", "wo"), (4, 6912, 2560), N, 0.02),
        (ATTN + ("norm1", "scale"), (4, 2560), O, 0.02),
        (ATTN + ("norm2", "scale"), (4, 2560), O, 0.02),
    ],
}
#: (elements, forward_flops, train_step_flops) at 4 rows of 512 tokens
COUNTS = {
    "mamba2-1.3b": (206_372_608, 871_191_543_808, 2_613_574_631_424),
    "h2o-danube-1.8b": (441_735_680, 1_495_227_432_960,
                        4_485_682_298_880),
}
#: sha256 of the float32 flat vector drawn from seed 2**31 + 7 on the CPU
FLAT = {
    "tiny-mamba2": (17_968, "07e770134e0a4baa1ed3baaa8eed0fe7"
                            "58189d9e5da98abcec99714a09184266"),
    "tiny-danube": (21_664, "2957342ffc7ee543cef6c0a2e96bb24a"
                            "37dc06624fce1aaca5f0d6de00abf263"),
}


def _config(name):
    with open(bench.ROOT / "perfbench" / "configs" / f"{name}.json") as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(LAYOUT))
def test_layout_and_counts_are_pinned(name):
    cfg = _config(name)
    got = [(s.path, s.shape, s.init, s.scale)
           for s in weights.leaf_specs(cfg)]
    assert got == LAYOUT[name]
    elements, fwd, step = COUNTS[name]
    assert weights.num_elements(cfg) == elements
    assert flops.forward_flops(cfg, 4, 512) == fwd
    assert flops.train_step_flops(cfg, 4, 512) == step


@pytest.mark.parametrize("name", sorted(FLAT))
def test_tiny_flat_vector_is_pinned(name):
    cfg = [c for c in tiny.CONFIGS if c["name"] == name][0]
    flat, _ = weights.draw(cfg, 2 ** 31 + 7, "cpu")
    size, digest = FLAT[name]
    assert flat.numel() == size
    assert hashlib.sha256(flat.numpy().tobytes()).hexdigest() == digest
