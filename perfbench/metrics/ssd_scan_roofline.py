"""Kernel layer (``kernels/ssd``): the least time the chip could take for
the window's ``ssd_scan`` launches (frozen ``ssd_work`` at each launch's
shape: bytes over the HBM bandwidth or f32 operations over the f32 rate,
the larger) over the device time of the kernel's events, in %."""
from perfbench.work.peaks import bound_s
from perfbench.work.ssd import ssd_work


def read(ctx):
    if ctx.window is None or not ctx.ssd_shapes:
        return None
    spent = ctx.window.device_s(lambda name: "ssd::" in name)
    if spent <= 0:
        return None
    need = sum(bound_s(*ssd_work(*shape)) for shape in ctx.ssd_shapes)
    return 100.0 * need / spent
