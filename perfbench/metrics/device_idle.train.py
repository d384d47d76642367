"""Device: the share of the traced window, in %, in which no kernel or
copy ran (torch.profiler's device events)."""


def read(ctx):
    if ctx.window is None:
        return None
    return 100.0 * (1.0 - ctx.window.busy_s / ctx.window.window_s)
