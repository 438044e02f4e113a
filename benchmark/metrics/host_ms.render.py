"""host_ms.render: the host's time in each ``render()`` call of the window,
from the call to its return (before the wait for the image), mean per
frame; the benchmark's own span around the call (dispatch layer)."""


def read(ctx):
    if ctx.kind != "orbit":
        return None
    each = ctx.stats["host_s_each"]
    return 1e3 * sum(each) / len(each)
