"""PyTorch port against the committed golden renders (``tests/golden/
images.npz``, written by the JAX package on the CPU: ``tests/golden_cases.py``).

The procedural meshes need no OBJ: the teacup, the dragon and the donut at
48x48 through the CPU traversal (``backend='bvh'``), the spheres preset at
64x64 by brute force, and the teacup also through the card's route on CPU
tensors (``backend='cuda'``: the wide BVH kernels' plain twins) at node
widths 2, 4 and 8, one binary tree collapsed three ways.  Tolerance:
``assert_images_close`` (0.5% of pixels may differ: coincident-t ties), on
each pixel scaled by its largest channel where that exceeds 1.  The
spheres' light has color 15 and their pixels reach 12: the port's sphere
hits equal JAX's to one ulp of t, which the shading carries past an
absolute 1e-4 on 22 of their 4,096 pixels (0.54%).
"""
import dataclasses
import os

import numpy as np
import pytest

import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu_torch.models import whitted as tw
from cg_raytracer_tpu_torch.ops import bvh4 as tb4
from tests.conftest import assert_images_close

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "images.npz")


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as data:
        return {k: data[k] for k in ("teacup", "dragon", "donut", "spheres")}


@pytest.fixture(scope="module")
def teacup():
    return trt.load_scene("teacup", device="cpu")


def render(scene, cfg, accel=None):
    return trt.render(scene, trt.Camera.default(device="cpu"), cfg, accel=accel).numpy()


def assert_matches_golden(img, want, msg):
    scale = np.maximum(1.0, np.abs(want).max(axis=-1, keepdims=True))
    assert img.shape == want.shape
    assert_images_close(img / scale, want / scale, msg=msg)


@pytest.mark.parametrize("name", ["dragon", "donut", "spheres"])
def test_cpu_render_matches_golden(name, golden):
    scene = trt.load_scene(name, device="cpu")
    size, backend = (64, "brute") if name == "spheres" else (48, "bvh")
    img = render(scene, trt.RenderConfig(width=size, height=size, backend=backend))
    assert_matches_golden(img, golden[name], name)
    assert (img.max(axis=-1) > 0.02).mean() > 0.05


@pytest.mark.parametrize("route", ["bvh", "cuda:2", "cuda:4", "cuda:8"])
def test_teacup_matches_golden_at_every_width(route, golden, teacup):
    cfg = trt.RenderConfig(width=48, height=48, backend=route.split(":")[0])
    accel = None
    if route != "bvh":
        cfg = dataclasses.replace(cfg, bvh_wide=route.split(":")[1])
        accel = tw.build_accel(teacup, cfg)  # one binary build, memoized, per width a collapse
        assert isinstance(accel, tb4.BVH4) and accel.width == int(cfg.bvh_wide)
    img = render(teacup, cfg, accel)
    assert_matches_golden(img, golden["teacup"], route)
    assert (img.max(axis=-1) > 0.02).mean() > 0.1
