"""tree_sampler_tests_per_sample: the triangles the tree soft-shadow
samplers' any-hit walks test (``csrc/soft.cu``'s ``soft_kernel<*, W>``,
W > 0) per live sample ray, from the program's cumulative tally
(``cg_raytracer_tpu_torch/ops/soft.py::tree_sampler_counts``: every launch
of the run's process, its graphs' replays included).  None where the program
keeps no such tally, or no tree sampler ran (kernels layer)."""


def read(ctx):
    if ctx.kind != "orbit" or not ctx.run.config.get("spherical_lights"):
        return None
    try:
        from cg_raytracer_tpu_torch.ops import soft
    except ImportError:
        return None
    counts = getattr(soft, "tree_sampler_counts", None)
    if counts is None:
        return None
    c = counts()
    return c["tests"] / c["samples"] if c["samples"] else None
