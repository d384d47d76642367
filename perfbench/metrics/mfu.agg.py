"""The whole drain: the bytes the rule needs for the traced window's
drains (x_t read once, each distinct stale snapshot and each delta read
once, the new model written once; :mod:`perfbench.work.fedagg`) over the
HBM bandwidth, over the window, in %."""
from perfbench.work.fedagg import rule_bytes
from perfbench.work.peaks import HBM_BYTES


def read(ctx):
    need = sum(rule_bytes(b, s, ctx.n) for b, s in zip(ctx.sizes, ctx.stales))
    return 100.0 * need / HBM_BYTES / ctx.window_s
