"""The port's training benchmark: prints ONE JSON line with the keys of the
repository's ``bench.py``.

    python -m cg_raytracer_tpu_torch.bench [--scene teacup]

Primary rays/s, forward + backward, at 1024x1024, under the full-gradient
contract (materials + lights + vertices); the materials-only contract rides
along as ``materials_only_*``.  The default scene is the stand-in mirror box
(``scene/standins.py``: 32 triangles, one point light, depth 2; it stands in
for ``cornell_box``, whose OBJ is not in the repository); ``--scene`` takes a
preset instead (``teacup``: 48,000 triangles through the 4-wide BVH
kernels).  ``vs_baseline`` divides by the reference's forward-only 3.8e6
rays/s on a CPU.  Needs a CUDA device; without one it raises.
"""
import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scene", default=None,
                        help="preset name (default: the stand-in mirror box)")
    args = parser.parse_args(argv)
    import torch

    from .scene import standins
    from .scene.types import PointLights, make_scene
    from .utils.bench import run_bench

    if args.scene is None:
        scene = make_scene(standins.mirror_box_meshes(),
                           point_lights=PointLights.of(*standins.MIRROR_BOX_LIGHTS),
                           device=torch.device("cuda"))
        name = "stand-in mirror box"
    else:
        scene, name = args.scene, None
    full = run_bench(scene, width=1024, height=1024, include_bwd=True, iters=10,
                     include_vertex_params=True, scene_name=name)
    mat = run_bench(scene, width=1024, height=1024, include_bwd=True, iters=10,
                    scene_name=name)
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
