"""PyTorch port: the tree sampler of the benchmark's ``teacup_spherical``
configuration against the benchmark's plain reference, on the CPU.

A coarse lathed cup from the ``teacup`` configuration's own surface
(``benchmark/configs/teacup.py::cup``, 40 x 41 vertices: 3,200 triangles,
past ``pallas_brute_max_tris`` so that the tree route resolves) under seeded
random materials and the configuration's spherical light, rendered at 32²
with ``backend="cuda"`` on CPU tensors and the sampler kernels on
(``soft_shadow_kernel="on"``): ``ops/bvh4.py``'s plain twins walk the
width-4 collapse, ``ops/soft.py``'s plain twin of the cone tree sampler
draws each level's 200 sample rays from the frame's seeded key, and
``ops/level.py`` runs each level after its query, the route the card takes.
Each pixel is held to ``benchmark/reference/render.py`` (a brute-force
search, its soft shadows from the same Philox stream) under the cell's
tolerance, 1e-4 + 1e-4 x the reference's brightest channel.  The
configuration's scene is the port's ``teacup`` preset after one session of
the light editor (``scene/lights.py``), its geometry bit for bit the
``teacup`` configuration's.  This file imports no JAX.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu_torch.models import whitted
from cg_raytracer_tpu_torch.ops import bvh4
from cg_raytracer_tpu_torch.scene import lights
from cg_raytracer_tpu_torch.scene.presets import load_scene
from cg_raytracer_tpu_torch.scene.types import SphericalLights, make_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)  # the benchmark's ``reference`` and ``rtbench``, last

from reference import philox  # noqa: E402
from reference import render as R  # noqa: E402
from rtbench import orbit, spec  # noqa: E402

SIZE = 32
CELL = spec.cell("teacup_spherical.orbit")
CUP = spec.module(os.path.join(BENCH, "configs", "teacup.py"), "bench_geometry_teacup_sph_test")


def _light():
    ((pos, radius, color),) = CELL.config["spherical_lights"]
    return tuple(pos), float(radius), tuple(color)


def _meshes(seed: int):
    """The coarse cup's meshes with seeded random materials."""
    g = np.random.default_rng(seed)
    meshes = CUP.cup(40, 41)
    meshes[0]["material"] = {"kd": tuple(g.uniform(0.2, 0.9, 3)),
                             "ks": tuple(g.uniform(0.05, 0.6, 3)),
                             "shininess": float(g.uniform(2.0, 64.0)), "transparency": 1.0}
    return meshes


@pytest.mark.parametrize("seed, key_seed", [(0, 7), (2 ** 31 + 23, 2 ** 40 + 5)])
def test_tree_sampler_matches_the_plain_reference(seed, key_seed):
    meshes = _meshes(seed)
    assert sum(len(m["triangles"]) for m in meshes) == 3200
    light = _light()
    scene = make_scene(meshes, spherical_lights=SphericalLights.of(light), device="cpu")
    cam = CELL.config["camera"]
    samples = int(CELL.config["soft_shadow_samples"])
    cfg = trt.RenderConfig(width=SIZE, height=SIZE, max_depth=int(CELL.config["max_depth"]),
                           soft_shadow_samples=samples, backend="cuda",
                           soft_shadow_kernel="on")
    tree = whitted.build_accel(scene, cfg)
    assert isinstance(tree, bvh4.BVH4) and tree.width == 4  # the tree route resolved
    assert whitted.make_backend(scene, cfg, accel=tree).soft_vis is not None  # the tree sampler
    camera = trt.Camera.default(look_at=tuple(cam["look_at"]), euler_deg=tuple(cam["euler_deg"]),
                                dist=float(cam["dist"]), fovy_deg=float(cam["fovy_deg"]),
                                aspect=1.0, device="cpu")
    img = trt.render(scene, camera, cfg, generator=torch.Generator().manual_seed(key_seed))

    ref_scene = R.make_scene(meshes, (), (light,), device="cpu")
    ref_cam = R.camera_dict(cam["look_at"], R.radians32(cam["euler_deg"]), cam["dist"],
                            R.radians32(cam["fovy_deg"]), 1.0, "cpu")
    key = philox.draw_key(torch.Generator().manual_seed(key_seed))
    want = R.render_frame(ref_scene, ref_cam, R.Frame(SIZE, SIZE, 2, samples=samples), key)
    assert float(want.amax()) > 0.05  # the cup is in the frame and lit
    shade = want.amax(dim=-1)
    assert bool(((shade > 0) & (shade < 0.5 * float(shade.amax()))).any())  # and shadowed
    assert orbit.off_share(img, want) == 0.0


def test_configuration_is_an_editor_session_on_the_teacup_preset():
    """The teacup preset with its point light removed and a spherical light
    of the editor's radius added at (-1, 1, -1), as the configuration says."""
    teacup = load_scene("teacup", device="cpu")
    edited = lights.remove_light(teacup, 0)
    edited = lights.add_spherical_light(edited, position=(-1.0, 1.0, -1.0))
    assert lights.DEFAULT_RADIUS == 0.1 and lights.DEFAULT_COLOR == (1.0, 1.0, 1.0)
    assert edited.point_lights.position.shape[0] == len(CELL.config["point_lights"]) == 0
    ((pos, radius, color),) = CELL.config["spherical_lights"]
    sl = edited.spherical_lights
    np.testing.assert_array_equal(sl.position.numpy(), np.float32([pos]))
    np.testing.assert_array_equal(sl.radius.numpy(), np.float32([radius]))
    np.testing.assert_array_equal(sl.color.numpy(), np.float32([color]))
    # The geometry and materials the editor leaves as they were.
    (m,) = CELL.geometry()()
    np.testing.assert_array_equal(edited.vertices.numpy(), m["vertices"])
    np.testing.assert_array_equal(edited.triangles.numpy(), m["triangles"])
    np.testing.assert_array_equal(edited.materials.kd.numpy()[0], np.float32(m["material"]["kd"]))
    np.testing.assert_array_equal(edited.materials.ks.numpy()[0], np.float32(m["material"]["ks"]))
    assert CELL.config["reduced"] == [] and CELL.chips == 1


def test_geometry_is_the_teacup_configuration():
    mine = CELL.geometry()()
    theirs = spec.cell("teacup.orbit").geometry()()
    assert len(mine) == len(theirs) == 1
    for key in ("vertices", "normals", "triangles"):
        assert mine[0][key].dtype == theirs[0][key].dtype
        np.testing.assert_array_equal(mine[0][key], theirs[0][key])
    assert mine[0]["material"] == theirs[0]["material"]
    with open(os.path.join(BENCH, "configs", "teacup.json")) as f:
        teacup = json.load(f)
    for key in ("triangles", "width", "height", "max_depth", "soft_shadow_samples", "camera"):
        assert CELL.config[key] == teacup[key], key
    assert CELL.config["spherical_lights"][0][0] == teacup["point_lights"][0][0]
