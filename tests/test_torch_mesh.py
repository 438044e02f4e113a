"""PyTorch port, the mesh slice: the pregathered shade against the JAX
package's ``shade_fused_pallas`` on its pregathered branch, the shade gate
and the forward-only routing past 256 triangles, and the tree's build and
memo (``build_accel``).  The slice's renders and training steps against the
JAX package are in ``test_torch_mesh_render.py`` and
``test_torch_mesh_train.py``.

Scene: the lathed cup of ``test_torch_bvh.py`` (1,154 triangles: past 256,
so the port takes its BVH kernels and pregathered shade, and past
``SHADE_SELECT_MAX_TRIS`` = 64, so the JAX shade takes its pregathered
branch), reflective (ks 0.3) so depth 2 runs, two point lights.  JAX runs
``backend='pallas'``, Pallas in interpret mode; the port ``backend='cuda'``,
whose wrappers run their plain twins on CPU tensors.

Tolerances: the shade's as ``test_torch_shade.py`` (gradients rtol 2e-4,
atol 1e-5, vertices atol 2e-5; sphere hits atol 1e-3, and rtol 2e-3, atol
1e-4 with their cotangent), but the forward at atol 2e-5 (rtol 1e-5): the
cup's triangles are ~0.05 across, so Moller-Trumbore's determinant is
~1e-4 and the recomputed barycentrics, hence the interpolated normals, carry
~1e-5 of float32 error that XLA and PyTorch round differently (atol 1e-6 is
met on the box's unit-size triangles).
"""
import dataclasses

import numpy as np
import pytest
import torch

import cg_raytracer_tpu as jrt
import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu.ops import pallas_shade as jshade
from cg_raytracer_tpu_torch.interop import scene_from_numpy
from cg_raytracer_tpu_torch.models import whitted as tw
from cg_raytracer_tpu_torch.ops import bvh4 as tb4
from cg_raytracer_tpu_torch.ops import intersect as tint
from cg_raytracer_tpu_torch.ops import shade as tshade
from tests.test_torch_bvh import cup_meshes, cup_pair
from tests.test_torch_scene import jax_leaves
from tests.test_torch_shade import (GRAD, cotangents, fused_outputs, jax_shade_vjp,
                                    port_shade_grads, records, scene_params)

TWO_LIGHTS = (((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0)), ((1.0, 2.0, 0.5), (0.5, 0.5, 0.5)))
FWD_MESH = dict(rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("spheres", [False, True])
def test_pregathered_shade_matches_jax_kernel(spheres):
    j, t = cup_pair(ks=0.3, spheres=spheres, lights=TWO_LIGHTS)
    assert t.num_triangles > tshade.SHADE_MAX_TRIS > jshade.SHADE_SELECT_MAX_TRIS
    o, d, jhit, bits = records(j, 32, seed=71)
    thit = tint.Hit(*(torch.from_numpy(np.array(x)) for x in jhit))
    loose = (thit.prim_id >= t.num_triangles).numpy()  # sphere hits
    cts = cotangents(o.shape[0], seed=81)
    strict = [np.where(loose[:, None], 0.0, c).astype(np.float32) for c in cts]
    params = scene_params(j)
    j_outs, j_grads, j_all = jax_shade_vjp(j, params, o, d, jhit, bits, strict, cts)
    t_outs, t_grads, t_all = port_shade_grads(t, params, o, d, thit, bits, fused_outputs,
                                              strict, cts)
    for what, a, b in zip(("direct", "ks", "normal", "position"), t_outs, j_outs):
        np.testing.assert_allclose(a[~loose], b[~loose], **FWD_MESH, err_msg=what)
        np.testing.assert_allclose(a[loose], b[loose], rtol=0, atol=1e-3, err_msg=what)
    assert set(t_grads) == set(j_grads)
    for k, g in j_grads.items():
        tol = dict(GRAD, atol=2e-5) if k == "vertices" else GRAD
        np.testing.assert_allclose(t_grads[k], g, **tol, err_msg=f"d/d{k}")
        np.testing.assert_allclose(t_all[k], j_all[k], rtol=2e-3, atol=1e-4,
                                   err_msg=f"d/d{k}, sphere hits included")
    assert (thit.prim_id >= 0).float().mean() > 0.2
    for k in ("kd", "ks", "shininess", "light_color", "light_position", "vertices", "normals",
              "o", "d"):
        assert np.abs(t_grads[k]).sum() > 0, k
    if spheres:
        assert loose.any() and np.abs(t_all["center"]).sum() > 0


def test_pregathered_twin_reads_the_payload_and_material_table():
    # The twin on the scene's tables equals the select twin on the same hits
    # (a face normal recomputed from the vertices picks the same flip), and
    # material ids outside the table take material 0, as the Pallas select.
    _, t = cup_pair(ks=0.3, lights=TWO_LIGHTS)
    o, d = (torch.from_numpy(np.array(x)) for x in jrt.generate_rays(jrt.Camera.default(),
                                                                       24, 24))
    prim = tint.intersect_brute(t, o, d).prim_id
    bits = torch.zeros_like(prim)
    payload, mats, lights, spheres, num_tris = tshade._pre_tables(t)
    tri, aux, *_ = tshade._shade_tables(t)
    pre = tshade.shade_plain_pre(payload, mats, lights, spheres, o, d, prim, bits)
    sel = tshade.shade_plain(tri, aux, lights, spheres, o, d, prim, bits, num_tris=num_tris)
    for a, b in zip(pre, sel):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    wrong = payload.detach().clone()
    wrong[:, 18] = torch.where(wrong[:, 18] == 1, 7.0, wrong[:, 18])  # the floor's id -> 7
    mats0 = mats.detach()[:1].expand_as(mats).contiguous()
    ks_wrong = tshade.shade_plain_pre(wrong, mats.detach(), lights, spheres, o, d, prim, bits)[1]
    ks_mat0 = tshade.shade_plain_pre(payload.detach(), mats0, lights, spheres, o, d, prim, bits)[1]
    torch.testing.assert_close(ks_wrong, ks_mat0)


@pytest.mark.parametrize("kind,want", [("16 materials", True), ("17 materials", False),
                                       ("17 point lights", False)])
def test_supports_shade_kernel_past_256_triangles_matches_jax_gate(kind, want):
    meshes, lights = cup_meshes(), TWO_LIGHTS
    if kind == "17 materials":
        meshes = meshes + [dict(meshes[1], material={"kd": (0.1 * k, 0.5, 0.5)})
                           for k in range(15)]
    elif kind == "16 materials":
        meshes = meshes + [dict(meshes[1], material={"kd": (0.1 * k, 0.5, 0.5)})
                           for k in range(14)]
    else:
        lights = tuple(((0.1 * k, 1.0, 0.0), (0.1, 0.1, 0.1)) for k in range(17))
    j = jrt.make_scene(meshes, point_lights=jrt.PointLights.of(*lights))
    t = scene_from_numpy(jax_leaves(j))
    assert t.num_triangles > 256
    assert tshade.supports_shade_kernel(t) == jshade.supports_shade_kernel(j) == want, kind


def test_fwd_shade_kernel_resolves_like_jax():
    _, t = cup_pair(ks=0.3, lights=TWO_LIGHTS)
    _, matte = cup_pair(ks=0.0, lights=TWO_LIGHTS)
    fo = trt.RenderConfig(forward_only=True)
    assert tw.resolve_fwd_shade_kernel(t, fo).fwd_shade_kernel == "off"  # CPU: shade auto off
    on = dataclasses.replace(fo, shade_kernel="on")
    assert tw.resolve_fwd_shade_kernel(t, on).fwd_shade_kernel == "on"
    assert tw.resolve_fwd_shade_kernel(t, dataclasses.replace(on, max_depth=1)).fwd_shade_kernel \
        == "off"
    # The matte cup's only reflective triangles are the floor's 2 of 1,154.
    assert tw.resolve_fwd_shade_kernel(matte, on).fwd_shade_kernel == "off"
    assert tw.resolve_fwd_shade_kernel(t, trt.RenderConfig(shade_kernel="on")) \
        .fwd_shade_kernel == "auto"  # not forward-only: untouched
    with pytest.raises(ValueError, match="fwd_shade_kernel"):
        tw.resolve_fwd_shade_kernel(t, dataclasses.replace(on, fwd_shade_kernel="yes"))


def test_accel_is_built_once_and_checked():
    _, t = cup_pair()
    cfg = trt.RenderConfig(backend="cuda")
    assert tw.needs_bvh(cfg, t.num_triangles, t.device)
    assert cfg.resolve_bvh_builder(t.num_triangles, t.device) == "sah"
    assert cfg.resolve_bvh_max_leaf() == 4
    accel = tw.build_accel(t, cfg)
    assert isinstance(accel, tb4.BVH4) and tw.build_accel(t, cfg) is accel
    moved = dataclasses.replace(t, vertices=t.vertices.clone())
    assert tw.build_accel(moved, cfg) is not accel  # keyed on the vertex tensor
    wide = tw.build_accel(t, dataclasses.replace(cfg, bvh_max_leaf=56))
    assert wide.num_nodes < accel.num_nodes
    with pytest.raises(TypeError, match="BVH4"):
        tw.make_backend(t, cfg, accel=tw.build_accel(t, trt.RenderConfig(backend="bvh")))
    small = tw.build_accel(cup_pair(spheres=True)[1], cfg)  # spheres share the tree
    assert small.num_tris == accel.num_tris
    with pytest.raises(ValueError, match="bvh_max_leaf"):
        trt.RenderConfig(bvh_max_leaf=-1).resolve_bvh_max_leaf()
    with pytest.raises(ValueError, match="bvh_builder"):
        trt.RenderConfig(bvh_builder="lbvh").resolve_bvh_builder(10, t.device)
