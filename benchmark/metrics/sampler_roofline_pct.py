"""sampler_roofline_pct: the least time of the soft-shadow samplers
(``csrc/soft.cu``'s ``soft_kernel``) over their CUPTI time, on the first
frames of the traced segment.  The least time counts only what any sampler
must do for the frame's shading points (``rtbench/yard.py::sampler_work``:
Philox4x32-10 and Box-Muller per point and sample, each sample ray's
set-up, each point read and each fraction written once), no tree visit
and no triangle test.  The shading points are each level's hits, which the
plain reference counts on a grid of every ``stride``-th pixel (kernels
layer)."""

from rtbench import yard

FRAMES = 2
NAME = "soft_kernel"


def read(ctx):
    if ctx.kind != "orbit" or not ctx.run.config.get("spherical_lights"):
        return None
    run = ctx.run
    samples = int(run.config["soft_shadow_samples"])
    lights = len(run.config["spherical_lights"])
    least = spent = 0.0
    for lo, hi, i in ctx.frames()[:FRAMES]:
        kernels = [b - a for a, b, n in ctx.kernels(lo, hi) if NAME in n]
        if not kernels:
            return None
        stride, per_offset = run.frame_hits(i)
        for _, levels in per_offset:
            for prim, _ in levels:
                points = int((prim >= 0).sum()) * stride * stride * lights
                flops, ints, byts = yard.sampler_work(points, samples)
                least += yard.bound_s(flops, byts, ints)[0]
        spent += sum(kernels)
    return 100.0 * least / spent if spent else None
