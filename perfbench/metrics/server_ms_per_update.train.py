"""Server layer (``core/server.py``, ``gmis.py``, ``aggregation.py``,
``kernels/fedagg/ops.py``): the harness's spans over
``server.on_update_batch`` in the traced window, closed by a device sync,
in ms per update aggregated."""


def read(ctx):
    if not ctx.updates:
        return None
    return 1e3 * ctx.spans.total("server", ctx.t0, ctx.t1) / ctx.updates
