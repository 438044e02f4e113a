"""walk_ns_per_ray: the tree walks' CUPTI time (``csrc/bvh4.cu``'s
``bvh_kernel`` and ``bvh_bounce_kernel``) per frame of the traced segment,
over the rays a frame's replay hands them: the program's count of the rows
each walk's wrapper is handed, live or not, which a CUDA graph stores per
replay (``cg_raytracer_tpu_torch/utils/graphs.py::replay_rays``, kept after
the graphs are released).  None where the program keeps no such count
(kernels layer)."""

from rtbench import walk


def read(ctx):
    if ctx.kind != "orbit":
        return None
    try:
        from cg_raytracer_tpu_torch.utils import graphs
    except ImportError:
        return None
    replay_rays = getattr(graphs, "replay_rays", None)
    frames = ctx.frames()
    if replay_rays is None or not frames:
        return None
    rays = sum(n for by_width in replay_rays().values() for n in by_width.values())
    spent = sum(b - a for a, b, n in ctx.kernels() if walk.is_walk(n))
    if not rays or not spent:
        return None
    return 1e9 * spent / len(frames) / rays
