"""walk_roofline_pct: the least time of the tree walks (``csrc/bvh4.cu``'s
``bvh_kernel`` and ``bvh_bounce_kernel``) over their CUPTI time, on the
first frames of the traced segment.  The least time counts only what any
walk must do for the frame's rays (``rtbench/walk.py``: each live ray read
and its record written, each hit's triangle read and tested once, each
shadow ray set up and its bit written), no node visit; the rays come from
the plain reference's hits on a grid of every ``stride``-th pixel, times
stride squared (kernels layer)."""

from rtbench import walk

FRAMES = 2


def read(ctx):
    if ctx.kind != "orbit":
        return None
    run = ctx.run
    lights = len(run.config.get("point_lights", []))
    least = spent = 0.0
    for lo, hi, i in ctx.frames()[:FRAMES]:
        kernels = [b - a for a, b, n in ctx.kernels(lo, hi) if walk.is_walk(n)]
        if not kernels:
            return None
        stride, per_offset = run.frame_hits(i)
        for _, levels in per_offset:
            least += walk.frame_bound_s(levels, lights, stride)
        spent += sum(kernels)
    return 100.0 * least / spent if spent else None
