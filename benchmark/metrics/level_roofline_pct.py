"""level_roofline_pct: the least time of the bounce-level kernels
(``csrc/level.cu``'s ``level_kernel``) over their CUPTI time, on the first
frames of the traced segment.  The least time is ``rtbench/yard.py::
level_work``'s bytes and operations on each level's hits, which the plain
reference finds for every pixel of those frames (kernels layer)."""

from rtbench import yard

FRAMES = 4
NAME = "level_kernel"


def read(ctx):
    if ctx.kind != "orbit":
        return None
    run = ctx.run
    tris = sum(len(m["triangles"]) for m in run.meshes)
    num_pl = len(run.config.get("point_lights", []))
    num_sl = len(run.config.get("spherical_lights", []))
    least = spent = 0.0
    for lo, hi, i in ctx.frames()[:FRAMES]:
        kernels = [b - a for a, b, n in ctx.kernels(lo, hi) if NAME in n]
        if not kernels:
            return None
        stride, per_offset = run.frame_hits(i)
        if stride != 1:
            return None  # the count needs every pixel's hits
        scene = run.reference_scene()
        for _, levels in per_offset:
            for level, (prim, _) in enumerate(levels):
                flops, byts = yard.level_work(tris, scene.triangles, scene.tri_material, num_pl,
                                              num_sl, prim, "level", True, level > 0,
                                              level + 1 == len(levels))
                least += yard.bound_s(flops, byts)[0]
        spent += sum(kernels)
    return 100.0 * least / spent if spent else None
