"""Server layer's copies (the snapshot and delta stacks, the deltas'
flattening and padding): device time of copy, concatenation, padding and
fill kernels (the padding's zeros) and of memory copies in the traced
window, in ms per update."""
import re

_COPY = re.compile(r"memcpy|copy|CatArray|cat_|pad|stack|fill", re.IGNORECASE)


def read(ctx):
    if ctx.window is None or not ctx.updates:
        return None
    spent = ctx.window.device_s(lambda name: "fedagg::" not in name
                                and bool(_COPY.search(name)))
    return 1e3 * spent / ctx.updates
