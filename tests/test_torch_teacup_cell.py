"""PyTorch port: the tree route of the benchmark's ``teacup`` configuration
against the benchmark's plain reference, on the CPU.

A coarse lathed cup from the configuration's own surface
(``benchmark/configs/teacup.py::cup``, 40 x 41 vertices: 3,200 triangles,
past ``pallas_brute_max_tris`` so the tree route resolves) under seeded
random materials and a point light drawn from the seed, rendered at 32²
with ``backend="cuda"`` on CPU tensors: ``ops/bvh4.py``'s plain twins walk
the width-4 collapse and ``ops/level.py`` runs each level after its query,
the route the card takes.  Each pixel is held to
``benchmark/reference/render.py`` (brute force over every triangle) under
the cell's tolerance, 1e-4 + 1e-4 x the reference's brightest channel.
The configuration's 48,000-triangle geometry is the port's ``teacup``
preset, bit for bit.  This file imports no JAX.
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
from cg_raytracer_tpu_torch.scene.presets import load_scene
from cg_raytracer_tpu_torch.scene.types import PointLights, make_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)  # the benchmark's ``reference`` and ``rtbench``, last

from reference import render as R  # noqa: E402
from rtbench import orbit, spec  # noqa: E402

SIZE = 32
CELL = spec.cell("teacup.orbit")
CUP = spec.module(os.path.join(BENCH, "configs", "teacup.py"), "bench_geometry_teacup_test")


def _scene_parts(seed: int):
    """The coarse cup's meshes with seeded random materials, and a point
    light (position, colour) drawn from the seed."""
    g = np.random.default_rng(seed)
    meshes = CUP.cup(40, 41)
    meshes[0]["material"] = {"kd": tuple(g.uniform(0.2, 0.9, 3)),
                             "ks": tuple(g.uniform(0.05, 0.6, 3)),
                             "shininess": float(g.uniform(2.0, 64.0)), "transparency": 1.0}
    direction = g.normal(size=3)
    position = tuple(float(x) for x in 1.5 * direction / np.linalg.norm(direction))
    return meshes, (position, (1.0, 1.0, 1.0))


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7])
def test_tree_route_matches_the_plain_reference(seed):
    meshes, light = _scene_parts(seed)
    assert sum(len(m["triangles"]) for m in meshes) == 3200
    scene = make_scene(meshes, point_lights=PointLights.of(light), device="cpu")
    cam = CELL.config["camera"]
    cfg = trt.RenderConfig(width=SIZE, height=SIZE, max_depth=2, backend="cuda")
    tree = whitted.build_accel(scene, cfg)
    assert isinstance(tree, bvh4.BVH4) and tree.width == 4  # the tree route resolved
    camera = trt.Camera.default(look_at=tuple(cam["look_at"]), euler_deg=tuple(cam["euler_deg"]),
                                dist=float(cam["dist"]), fovy_deg=float(cam["fovy_deg"]),
                                aspect=1.0, device="cpu")
    img = trt.render(scene, camera, cfg)

    ref_scene = R.make_scene(meshes, (light,), (), device="cpu")
    ref_cam = R.camera_dict(cam["look_at"], R.radians32(cam["euler_deg"]), cam["dist"],
                            R.radians32(cam["fovy_deg"]), 1.0, "cpu")
    want = R.render_frame(ref_scene, ref_cam, R.Frame(SIZE, SIZE, 2))
    assert float(want.amax()) > 0.05  # the cup is in the frame and lit
    assert orbit.off_share(img, want) == 0.0


def test_configuration_geometry_is_the_teacup_preset():
    meshes = CELL.geometry()()
    scene = load_scene("teacup", device="cpu")
    (m,) = meshes
    assert len(m["triangles"]) == CELL.config["triangles"] == 48000
    np.testing.assert_array_equal(scene.vertices.numpy(), m["vertices"])
    np.testing.assert_array_equal(scene.normals.numpy(), m["normals"])
    np.testing.assert_array_equal(scene.triangles.numpy(), m["triangles"])
    mat = scene.materials
    np.testing.assert_array_equal(mat.kd.numpy()[0], np.float32(m["material"]["kd"]))
    np.testing.assert_array_equal(mat.ks.numpy()[0], np.float32(m["material"]["ks"]))
    assert float(mat.shininess[0]) == m["material"]["shininess"]
    with open(os.path.join(BENCH, "configs", "teacup.json")) as f:
        config = json.load(f)
    ((pos, color),) = config["point_lights"]
    np.testing.assert_array_equal(scene.point_lights.position.numpy()[0], np.float32(pos))
    np.testing.assert_array_equal(scene.point_lights.color.numpy()[0], np.float32(color))
    assert config["reduced"] == [] and not config["spherical_lights"]
    assert torch.equal(scene.tri_material, torch.zeros(48000, dtype=scene.tri_material.dtype))
