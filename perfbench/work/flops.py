"""Model operations a training or evaluation step needs, counted from the
configuration's shapes (a configuration file of ``perfbench/configs``).

Counted: every matrix product (the projections, the MLP, the head, tied or
not), the Mamba-2 depthwise convolution and SSD scan (its chunked form, the
kernel's count in :mod:`perfbench.work.ssd`), and attention's scores and
weighted values over the causal pairs inside the window. Not counted:
norms, activations, softmax and other elementwise work. A training step is
its forward and a backward of twice the forward's operations; no recompute
is counted.
"""
from perfbench.work.ssd import ssd_work


def _ssd_dims(cfg: dict):
    s = cfg["ssm"]
    dinner = s["expand"] * cfg["d_model"]
    heads = dinner // s["head_dim"]
    return dinner, heads, s["head_dim"], s["state_dim"], s["ngroups"]


def _visible_pairs(seq: int, window: int) -> int:
    """Causal (query, key) pairs of one sequence, keys inside the window."""
    w = window or seq
    return sum(min(i + 1, w) for i in range(seq))


def forward_flops(cfg: dict, rows: int, seq: int) -> int:
    """Operations of one forward pass over ``rows`` sequences of ``seq``
    tokens."""
    d, v, layers = cfg["d_model"], cfg["vocab_size"], cfg["num_layers"]
    tokens = rows * seq
    head = 2 * d * v * tokens
    if cfg["family"] == "ssm":
        dinner, h, p, n, g = _ssd_dims(cfg)
        conv_dim = dinner + 2 * g * n
        proj = 2 * d * (2 * dinner + 2 * g * n + h) + 2 * dinner * d
        conv = 2 * cfg["ssm"]["conv_width"] * conv_dim
        scan = ssd_work(rows, seq, h, p, g, n, cfg["ssm"]["chunk_size"],
                        False)[1]
        return layers * ((proj + conv) * tokens + scan) + head
    if cfg["family"] == "dense":
        hq, kv, hd, f = (cfg["num_heads"], cfg["num_kv_heads"],
                         cfg["head_dim"], cfg["d_ff"])
        proj = 2 * d * (hq * hd + 2 * kv * hd) + 2 * hq * hd * d
        mlp = 3 * 2 * d * f
        attn = 4 * hq * hd * _visible_pairs(seq, cfg["sliding_window"]) * rows
        return layers * ((proj + mlp) * tokens + attn) + head
    raise ValueError(f"no flop count for family {cfg['family']!r}")


def train_step_flops(cfg: dict, rows: int, seq: int) -> int:
    """A local step: its forward and a backward of twice as many."""
    return 3 * forward_flops(cfg, rows, seq)
