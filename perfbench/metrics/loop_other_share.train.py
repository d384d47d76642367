"""Simulator layer (``core/simulator.py``, ``events.py``, ``behavior.py``),
evaluation included: the share of the traced window, in %, outside the
client and server spans."""


def read(ctx):
    inside = (ctx.spans.total("client", ctx.t0, ctx.t1)
              + ctx.spans.total("server", ctx.t0, ctx.t1))
    return 100.0 * (1.0 - inside / ctx.window_s)
