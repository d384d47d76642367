"""The whole step: the model operations the traced window required (every
local step's forward and backward, every evaluation's forward; no
recompute; :mod:`perfbench.work.flops`) over the window times the f32
rate outside the tensor cores, in %. The configurations compute in f32
with TF32 off."""
from perfbench.work.flops import forward_flops, train_step_flops
from perfbench.work.peaks import F32_FLOPS


def read(ctx):
    tr = ctx.traffic
    need = (ctx.steps * train_step_flops(ctx.cfg, tr["rows"], tr["seq_len"])
            + ctx.evals * forward_flops(ctx.cfg, tr["rows"], tr["seq_len"]))
    return 100.0 * need / (ctx.window_s * F32_FLOPS)
