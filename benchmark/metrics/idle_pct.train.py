"""idle_pct.train: 100 x (1 - the union of the device's operations over
the traced fit, from its first graph launch to the end of its last graph
kernel), from the CUPTI trace (device layer)."""


def read(ctx):
    if ctx.kind != "train":
        return None
    lo, hi = ctx.window
    busy = sum(b - a for a, b in ctx.trace.busy(lo, hi))
    return 100.0 * (1.0 - busy / (hi - lo))
