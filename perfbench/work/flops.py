"""Model operations a training or evaluation step needs, counted from the
configuration's shapes (a configuration file of ``perfbench/configs``).

Each model's count is ``forward_flops(cfg, rows, seq)`` of
``perfbench/work/<reference>.py``, the module named by the configuration's
``reference`` key, built from the parts here: the SSD layer, attention's
projections and its visible pairs, and the head.

Counted: every matrix product (the projections, the MLP, the head, tied or
not), the Mamba-2 depthwise convolution and SSD scan (its chunked form, the
kernel's count in :mod:`perfbench.work.ssd`), and attention's scores and
weighted values over the causal pairs inside the window. Not counted:
norms, activations, softmax and other elementwise work. A training step is
its forward and a backward of twice the forward's operations; no recompute
is counted.
"""
import importlib

from perfbench.work.ssd import ssd_work


def _ssd_dims(cfg: dict):
    s = cfg["ssm"]
    dinner = s["expand"] * cfg["d_model"]
    heads = dinner // s["head_dim"]
    return dinner, heads, s["head_dim"], s["state_dim"], s["ngroups"]


def ssd_layer(cfg: dict, rows: int, seq: int) -> int:
    """One Mamba-2 layer over ``rows`` sequences of ``seq`` tokens: its
    projections and convolution per token, and the scan."""
    d = cfg["d_model"]
    dinner, h, p, n, g = _ssd_dims(cfg)
    conv_dim = dinner + 2 * g * n
    proj = 2 * d * (2 * dinner + 2 * g * n + h) + 2 * dinner * d
    conv = 2 * cfg["ssm"]["conv_width"] * conv_dim
    scan = ssd_work(rows, seq, h, p, g, n, cfg["ssm"]["chunk_size"],
                    False)[1]
    return (proj + conv) * rows * seq + scan


def attn_proj(cfg: dict) -> int:
    """Attention's q, k, v and output projections, per token."""
    d, hq, kv, hd = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
                     cfg["head_dim"])
    return 2 * d * (hq * hd + 2 * kv * hd) + 2 * hq * hd * d


def visible_pairs(seq: int, window: int) -> int:
    """Causal (query, key) pairs of one sequence, keys inside the window."""
    w = window or seq
    return sum(min(i + 1, w) for i in range(seq))


def attn_scores(cfg: dict, rows: int, seq: int) -> int:
    """Attention's scores and weighted values over the visible pairs."""
    return (4 * cfg["num_heads"] * cfg["head_dim"]
            * visible_pairs(seq, cfg["sliding_window"]) * rows)


def head(cfg: dict, tokens: int) -> int:
    return 2 * cfg["d_model"] * cfg["vocab_size"] * tokens


def forward_flops(cfg: dict, rows: int, seq: int) -> int:
    """Operations of one forward pass over ``rows`` sequences of ``seq``
    tokens."""
    mod = importlib.import_module(f"perfbench.work.{cfg['reference']}")
    return mod.forward_flops(cfg, rows, seq)


def train_step_flops(cfg: dict, rows: int, seq: int) -> int:
    """A local step: its forward and a backward of twice as many."""
    return 3 * forward_flops(cfg, rows, seq)
