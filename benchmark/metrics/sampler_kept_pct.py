"""sampler_kept_pct: the share of triangle tests that the brute soft-shadow
sampler's per-point culling keeps (``csrc/soft.cu``: a point's sample rays
test only the triangles that may lie between it and the light), over the
tests sweeps of every triangle would make: 100 x kept / swept, from the
program's cumulative tally (``cg_raytracer_tpu_torch/ops/soft.py::
cull_counts``: every launch of the run's process, its graphs' replays
included).  None where the program keeps no such tally, or its brute sampler
never ran (kernels layer)."""


def read(ctx):
    if ctx.kind != "orbit" or not ctx.run.config.get("spherical_lights"):
        return None
    try:
        from cg_raytracer_tpu_torch.ops import soft
    except ImportError:
        return None
    cull_counts = getattr(soft, "cull_counts", None)
    if cull_counts is None:
        return None
    kept, swept = cull_counts()
    return 100.0 * kept / swept if swept else None
