"""The port's training benchmark: prints ONE JSON line with the keys of the
repository's ``bench.py``.

    python -m cg_raytracer_tpu_torch.bench [--scene teacup | dragon | donut | spherical_box
                                            | spherical_teacup]

Primary rays/s, forward + backward, at 1024x1024, under the full-gradient
contract (materials + lights + vertices); the materials-only contract rides
along as ``materials_only_*``.  The default scene is the stand-in mirror box
(``scene/standins.py``: 32 triangles, one point light, depth 2; it stands in
for ``cornell_box``, whose OBJ is not in the repository); ``--scene`` takes a
preset the port can load (``teacup``: 48,000 triangles, ``dragon``: 87,780,
``donut``: 320,000, past the JAX package's on-chip tier; all through the
4-wide BVH kernels) or a stand-in of ``scene/presets.py::STANDIN_NAMES``
instead: ``spherical_box``
(the box lit by ``cornell_box_spherical_light``'s spherical light, through
the brute soft-shadow sampler) or ``spherical_teacup`` (the teacup lit by
``monkey_spherical_light``'s, through the cone sampler), both at the
reference's 200 samples.  ``vs_baseline`` divides by the reference's
forward-only 3.8e6 rays/s on a CPU; ``pct_of_roofline``, printed for the
brute-force scenes, is the share of the H100's least time for the
closed-form work of the step (``utils/roofline.py::headline_roofline``).
Each step is one replay of its CUDA graph, as ``optimize()`` runs it.  Needs
a CUDA device; without one it raises.
"""
import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scene", default="mirror_box",
                        help="teacup, dragon, donut or a stand-in (default: the stand-in "
                             "mirror box)")
    args = parser.parse_args(argv)
    from .utils.bench import run_bench

    scene, name = args.scene, None
    full = run_bench(scene, width=1024, height=1024, include_bwd=True, iters=10,
                     include_vertex_params=True, scene_name=name)
    mat = run_bench(scene, width=1024, height=1024, include_bwd=True, iters=10,
                    scene_name=name)
    line = {
        "metric": full["metric"] + " [full-gradient contract]",
        "value": full["value"],
        "unit": full["unit"],
        "vs_baseline": full["vs_baseline"],
        "materials_only_value": mat["value"],
        "materials_only_vs_baseline": mat["vs_baseline"],
    }
    if "pct_of_roofline" in full:
        line["pct_of_roofline"] = round(full["pct_of_roofline"], 2)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
