"""The port's training benchmark: prints ONE JSON line with the keys of the
repository's ``bench.py``.

    python -m cg_raytracer_tpu_torch.bench

Primary rays/s, forward + backward, on the stand-in mirror box
(``scene/standins.py``: 32 triangles, one point light, depth 2; it stands in
for ``cornell_box``, whose OBJ is not in the repository) at 1024x1024, under
the full-gradient contract (materials + lights + vertices); the
materials-only contract rides along as ``materials_only_*``.  ``vs_baseline``
divides by the reference's forward-only 3.8e6 rays/s on a CPU.  Needs a CUDA
device; without one it raises.
"""
import json
import sys


def main() -> int:
    import torch

    from .scene import standins
    from .scene.types import PointLights, make_scene
    from .utils.bench import run_bench

    box = make_scene(standins.mirror_box_meshes(),
                     point_lights=PointLights.of(*standins.MIRROR_BOX_LIGHTS),
                     device=torch.device("cuda"))
    name = "stand-in mirror box"
    full = run_bench(box, width=1024, height=1024, include_bwd=True, iters=10,
                     include_vertex_params=True, scene_name=name)
    mat = run_bench(box, width=1024, height=1024, include_bwd=True, iters=10, scene_name=name)
    print(json.dumps({
        "metric": full["metric"] + " [full-gradient contract]",
        "value": full["value"],
        "unit": full["unit"],
        "vs_baseline": full["vs_baseline"],
        "materials_only_value": mat["value"],
        "materials_only_vs_baseline": mat["vs_baseline"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
