"""PyTorch port, scenes past the JAX package's ``HBM_MAX_TRIS`` (2,752,512
triangles), where the JAX package leaves its kernels for its XLA traversal
(``backend='bvh'``) and the card keeps walking the same 4-wide kernels, up
to ``ops/bvh4.py::MAX_TRIS``, the limit of their int32 indexing.

- The limit: ``MAX_TRIS`` is the largest T whose pregathered shade payload
  rows (19 floats per triangle) stay inside int32, and every other index
  product of the kernels (node records at W = 8, leaf entries, triangle
  rows) fits there too; the entry points raise just past it, before any
  build (stride-0 triangle tables: no memory), and run just below it.
- The torus of ``tests/test_geometry_sharding.py::_big_torus_scene`` past
  ``HBM_MAX_TRIS`` (2,775,368 triangles), built in-process: the port's auto
  tree (median, leaf 4, width 4) walked by the 4-wide plain twin gives the
  closest hits of JAX's ``backend='bvh'`` oracle on the 256 rays of a 16^2
  frame (prim ids equal and t within 1e-5 on all but ties <= 0.5%; u and v
  within 1e-3: the triangles' edges are ~7.5e-3 long, and the two packages'
  Moller-Trumbore forms (the port's on precomputed edges) round u and v
  apart by up to 2.4e-4 here),
  and the port's CPU render at 16^2 is within ``assert_images_close``
  (atol 1e-4) of JAX's.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cg_raytracer_tpu as jrt
import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu.models import whitted as jw
from cg_raytracer_tpu.ops.pallas_bvh import HBM_MAX_TRIS as J_HBM_MAX_TRIS
from cg_raytracer_tpu_torch.interop import scene_from_numpy
from cg_raytracer_tpu_torch.models import whitted as tw
from cg_raytracer_tpu_torch.ops import bvh4 as tb4
from cg_raytracer_tpu_torch.scene import standins
from tests.conftest import assert_images_close
from tests.test_geometry_sharding import _big_torus_scene
from tests.test_torch_geometry import TIES, _agree
from tests.test_torch_scene import jax_leaves

SIZE = 16
CARD = trt.RenderConfig(width=SIZE, height=SIZE, backend="cuda")


def test_max_tris_is_the_limit_of_the_int32_indexing():
    limit = tb4.MAX_TRIS
    assert limit == 113_025_455 and tb4.INT32_MAX == 2**31 - 1
    assert 19 * limit <= tb4.INT32_MAX < 19 * (limit + 1)  # shade payload rows bind
    assert 16 * limit < 2**31 and 8 * limit < 2**31 and 3 * limit < 2**31  # bvh4.cuh
    assert limit > tb4.HBM_MAX_TRIS == J_HBM_MAX_TRIS
    tb4.check_max_tris(limit)
    with pytest.raises(NotImplementedError, match=f"MAX_TRIS = {limit}"):
        tb4.check_max_tris(limit + 1)


def _stubbed(scene, n):
    """``scene`` with ``n`` triangles in stride-0 tables (no memory)."""
    return dataclasses.replace(
        scene, triangles=torch.zeros((1, 3), dtype=torch.int32).expand(n, 3),
        tri_material=torch.zeros((1,), dtype=torch.int32).expand(n))


def test_entry_points_raise_past_the_limit_and_not_below():
    box = trt.make_scene(standins.mirror_box_meshes(),
                         point_lights=trt.PointLights.of(*standins.MIRROR_BOX_LIGHTS),
                         device="cpu")
    at, past = _stubbed(box, tb4.MAX_TRIS), _stubbed(box, tb4.MAX_TRIS + 1)
    assert tb4.supports_bvh4(at) and tb4.supports_fused_bounce_bvh4(at)
    assert tb4.supports_bvh4(_stubbed(box, tb4.HBM_MAX_TRIS + 1))
    assert not tb4.supports_bvh4(past) and not tb4.supports_fused_bounce_bvh4(past)
    for cfg in (CARD, dataclasses.replace(CARD, forward_only=True)):
        with pytest.raises(NotImplementedError, match="MAX_TRIS"):
            tw.build_accel(past, cfg)
        with pytest.raises(NotImplementedError, match="MAX_TRIS"):
            tw.make_backend(past, cfg)
    # A tree past the limit is refused by the wrappers too.
    n = tb4.MAX_TRIS + 1
    tree = tb4.BVH4(torch.zeros((1, 24)), torch.zeros((1, 8), dtype=torch.int32),
                    torch.ones((1,), dtype=torch.int32), torch.zeros((1, 9)).expand(n, 9),
                    torch.zeros((1,), dtype=torch.int32).expand(n), torch.zeros((1, 32)),
                    torch.zeros((1, 12)).expand(n, 12), depth=1, width=4)
    with pytest.raises(NotImplementedError, match="MAX_TRIS"):
        tb4._tree_args("cgrt_bvh4_closest", tree, torch.device("cpu"))


@pytest.fixture(scope="module")
def torus():
    """(JAX torus, port torus, JAX's BVH, the port's auto tree)."""
    nu = int(np.ceil(np.sqrt(J_HBM_MAX_TRIS / 2))) + 4
    j = _big_torus_scene(nu, nu)
    t = scene_from_numpy(jax_leaves(j))
    assert t.num_triangles == j.num_triangles > J_HBM_MAX_TRIS
    jbvh = jw.build_accel(j, jrt.RenderConfig(backend="bvh"))
    tree = tw.build_accel(t, CARD)
    return j, t, jbvh, tree


def test_past_the_old_cap_the_4_wide_twin_walks_like_jax(torus):
    j, t, jbvh, tree = torus
    assert isinstance(tree, tb4.BVH4) and tree.num_tris == t.num_triangles and tree.width == 4
    o, d = (np.asarray(x) for x in jrt.generate_rays(jrt.Camera.default(), SIZE, SIZE))
    got = tb4.intersect_bvh4_plain(t, tree, torch.from_numpy(o.copy()), torch.from_numpy(d.copy()))
    want = jw.make_backend(j, jrt.RenderConfig(backend="bvh"), bvh=jbvh).closest(
        jnp.asarray(o), jnp.asarray(d))
    assert _agree(got, want, uv_atol=1e-3) >= 1 - TIES
    assert 0.1 < (got.prim_id >= 0).float().mean().item() < 0.9


def test_past_the_old_cap_the_render_matches_jax(torus):
    j, t, jbvh, tree = torus
    img = trt.render(t, trt.Camera.default(device="cpu"), CARD, accel=tree)
    j_img = np.asarray(jrt.render(j, jrt.Camera.default(), jrt.RenderConfig(
        width=SIZE, height=SIZE, backend="bvh")))
    assert_images_close(img.numpy(), j_img, msg="torus past HBM_MAX_TRIS")
    assert (j_img.max(axis=-1) > 0.02).mean() > 0.1
