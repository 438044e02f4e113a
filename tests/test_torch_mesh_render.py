"""PyTorch port, the mesh slice as a whole, forward: ``render`` of a mesh
scene past 256 triangles against the JAX package's 4-wide BVH path, on the
default route (the bounce over the tree, then reconstruct + Phong per level)
and the forward-only route (the two-phase records and the pregathered
shade).

Scene: the reflective lathed cup of ``test_torch_mesh.py`` at 40x40, two
point lights.  JAX renders with ``backend='pallas'`` (its BVH4 kernels and
pregathered shade in interpret mode); the port with ``backend='cuda'``,
whose wrappers run their plain twins on CPU tensors.  Tolerance:
``assert_images_close`` (0.5% of pixels may differ: coincident-t ties).
"""
import dataclasses

import numpy as np
import pytest

import cg_raytracer_tpu as jrt
import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu.utils.config import RenderConfig as JConfig
from cg_raytracer_tpu_torch.models import whitted as tw
from tests.conftest import assert_images_close
from tests.test_torch_bvh import cup_pair
from tests.test_torch_mesh import TWO_LIGHTS

SIZE = 40


@pytest.mark.parametrize("route", ["default", "forward_only"])
def test_mesh_render_matches_jax(route):
    # default: the bounce over the 4-wide tree, then reconstruct + Phong per
    # level; forward_only: the two-phase records and the pregathered shade
    # (fwd_shade_kernel 'on', which the card resolves from 'auto').
    j, t = cup_pair(ks=0.3, lights=TWO_LIGHTS)
    switches = dict(width=SIZE, height=SIZE)
    if route == "forward_only":
        switches.update(forward_only=True, fwd_shade_kernel="on", shade_kernel="on")
    j_img = np.asarray(jrt.render(j, jrt.Camera.default(), JConfig(backend="pallas", **switches)))
    cfg = trt.RenderConfig(backend="cuda", **switches)
    backend = tw.make_backend(t, cfg)
    assert backend.bounce is not None and backend.record_trace is None
    calls = []
    if route == "forward_only":
        shade = backend.shade
        backend = backend._replace(shade=lambda *a: calls.append(1) or shade(*a))
    t_img = tw.render_image(t, trt.Camera.default(device="cpu"), cfg, backend=backend)
    assert len(calls) == (2 if route == "forward_only" else 0)
    assert_images_close(t_img.numpy(), j_img, msg=route)
    assert_images_close(trt.render(t, trt.Camera.default(device="cpu"), cfg).numpy(), j_img, msg="render()")
    lit = j_img.max(axis=-1) > 0.02
    assert lit.mean() > 0.2
    # Depth 2 is live: the cup's reflections add light.
    one = trt.render(t, trt.Camera.default(device="cpu"), dataclasses.replace(cfg, max_depth=1)).numpy()
    assert (np.abs(t_img.numpy() - one).max(axis=-1) > 1e-3).mean() > 0.01
