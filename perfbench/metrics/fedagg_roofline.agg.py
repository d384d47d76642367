"""Kernel layer (``kernels/fedagg``): the least time the chip could take
for the window's sweeps (frozen work counts at each drain's B and the
padded flat length; all bound by bytes) over the device time of the fedagg
kernels' events, in %."""
from perfbench.work.fedagg import drain_sweep_bytes
from perfbench.work.peaks import bound_s


def read(ctx):
    if ctx.window is None:
        return None
    spent = ctx.window.device_s(lambda name: "fedagg::" in name)
    if spent <= 0:
        return None
    need = sum(bound_s(drain_sweep_bytes(b, ctx.n_padded)) for b in ctx.sizes)
    return 100.0 * need / spent
