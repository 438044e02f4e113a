"""plan_hit_pct: the share of the run's graphed ``render()`` calls that
replayed the frame plan of the call before (the same scene, config and
tree, unchanged: no resolution, no cache key, only the changed inputs
copied), 100 x hits / calls, from the program's cumulative counts
(``cg_raytracer_tpu_torch/models/whitted.py::plan_counts``: every call of the
run's process, set-up included; kept after the graphs are released).  None
where the program keeps no such count, or made no graphed call (dispatch
layer)."""


def read(ctx):
    if ctx.kind != "orbit":
        return None
    try:
        from cg_raytracer_tpu_torch.models import whitted
    except ImportError:
        return None
    plan_counts = getattr(whitted, "plan_counts", None)
    if plan_counts is None:
        return None
    counts = plan_counts()
    return 100.0 * counts["hits"] / counts["calls"] if counts["calls"] else None
