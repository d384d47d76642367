"""Client layer (``core/cohort.py``, ``core/client.py``, ``core/tasks.py``,
``models/``): the harness's spans over ``_run_locals`` in the traced
window, closed by a device sync, in ms per update aggregated."""


def read(ctx):
    if not ctx.updates:
        return None
    return 1e3 * ctx.spans.total("client", ctx.t0, ctx.t1) / ctx.updates
