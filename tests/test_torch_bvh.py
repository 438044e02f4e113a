"""PyTorch port: the BVH build (``ops/bvh.py``) against the JAX package's
numpy builders, and the CPU traversal (``backend='bvh'``) against the JAX
package's traversal on the same tree and against brute force.

Scene: a lathed cup (the teacup preset's profile on a 24 x 25 grid, 1,152
triangles) standing on a two-triangle floor, one point light; built for
both packages in-process.  Tolerances (the backend contract): t within atol
1e-4, rtol 1e-5 on >= 99.8% of rays, prim ids and any-hit bits on >= 99.5%
(coincident-t ties on shared edges may resolve to another triangle).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cg_raytracer_tpu as jrt
import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu.ops import bvh as jbvh
from cg_raytracer_tpu.scene import presets as jpresets
from cg_raytracer_tpu.scene.loader import center_and_scale_to_unit
from cg_raytracer_tpu_torch.interop import BVH_LEAVES, bvh_from_numpy, scene_from_numpy
from cg_raytracer_tpu_torch.models import whitted as tw
from cg_raytracer_tpu_torch.ops import bvh as tbvh
from cg_raytracer_tpu_torch.ops import intersect as tint
from tests.conftest import assert_images_close
from tests.test_torch_scene import jax_leaves

CUP_LIGHTS = (((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0)),)


def cup_meshes(ks=0.1, nu=24, nv=25):
    """The teacup preset's lathe profile at a small grid, and a floor."""
    def surface(uu, vv):
        th = 2 * np.pi * uu
        r = 0.25 + 0.55 * np.sqrt(np.clip(vv, 0.0, 1.0)) + 0.05 * np.sin(6 * np.pi * vv)
        return r * np.cos(th), 1.4 * vv - 0.7, r * np.sin(th)

    cup = jpresets._grid_mesh(surface, nu, nv, wrap_u=True, wrap_v=False,
                              material={"kd": (0.85, 0.85, 0.9), "ks": (ks, ks, ks),
                                        "shininess": 16.0})
    center_and_scale_to_unit([cup])
    floor = {"vertices": np.asarray([[-2, -0.6, -2], [2, -0.6, -2], [2, -0.6, 2], [-2, -0.6, 2]],
                                    np.float32),
             "normals": np.tile(np.asarray([[0.0, 1.0, 0.0]], np.float32), (4, 1)),
             "triangles": np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
             "material": {"kd": (0.6, 0.35, 0.3), "ks": (0.2, 0.2, 0.2), "shininess": 8.0}}
    return [cup, floor]


CUP_SPHERES = {"center": np.asarray([[0.55, -0.35, -0.45], [-0.6, 0.45, 0.3]], np.float32),
               "radius": np.asarray([0.2, 0.15], np.float32),
               "kd": np.asarray([[0.9, 0.2, 0.2], [0.2, 0.3, 0.9]], np.float32),
               "ks": np.asarray([[0.3, 0.3, 0.3], [0.0, 0.0, 0.0]], np.float32),
               "shininess": np.asarray([20.0, 1.0], np.float32)}


def cup_pair(ks=0.1, spheres=False, lights=CUP_LIGHTS):
    """(JAX scene, port scene) of the cup, the port's built from the JAX leaves."""
    sp = (jrt.Spheres(**{k: jnp.asarray(v) for k, v in CUP_SPHERES.items()}) if spheres
          else None)
    j = jrt.make_scene(cup_meshes(ks), spheres=sp, point_lights=jrt.PointLights.of(*lights))
    return j, scene_from_numpy(jax_leaves(j))


def mesh_rays(n_random=512, size=40, seed=0):
    """Camera rays plus random rays with a random t_max (tests/test_bvh4.py:24-43)."""
    o, d = (np.asarray(x) for x in jrt.generate_rays(jrt.Camera.default(), size, size))
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-2, 2, (n_random, 3)).astype(np.float32)
    rd = rng.normal(size=(n_random, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    tm = rng.uniform(0.5, 5.0, (n_random,)).astype(np.float32)
    return np.concatenate([o, ro]), np.concatenate([d, rd]), ro, rd, tm


def assert_hits_agree(got, want, what):
    big = lambda t: np.where(np.isinf(t), 1e9, t)  # noqa: E731
    t_ok = np.isclose(big(np.asarray(got.t)), big(np.asarray(want.t)), atol=1e-4, rtol=1e-5)
    assert t_ok.mean() >= 0.998, f"{what}: t agrees on {t_ok.mean():.4%}"
    same = np.asarray(got.prim_id) == np.asarray(want.prim_id)
    assert same.mean() >= 0.995, f"{what}: prim ids agree on {same.mean():.4%}"


@pytest.mark.parametrize("builder,leaf", [("median", 4), ("sah", 4), ("median", 14),
                                          ("sah", 56)])
def test_build_bvh_matches_jax(builder, leaf):
    j, t = cup_pair()
    want = jbvh.build_bvh(j, max_leaf=leaf, use_native=False, builder=builder)
    got = tbvh.build_bvh(t, max_leaf=leaf, builder=builder, use_native=False)
    for name in BVH_LEAVES:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.max_leaf == want.max_leaf
    assert tbvh.bvh_num_levels(got) == jbvh.bvh_num_levels(want)
    # The interop path carries the JAX tree over unchanged.
    carried = bvh_from_numpy([np.asarray(getattr(want, n)) for n in BVH_LEAVES], want.max_leaf)
    for name in BVH_LEAVES:
        assert torch.equal(getattr(carried, name), getattr(got, name)), name


def test_build_bvh_rejects_bad_input():
    _, t = cup_pair()
    with pytest.raises(ValueError, match="builder"):
        tbvh.build_bvh(t, builder="lbvh")
    empty = dataclasses.replace(t, triangles=torch.zeros((0, 3), dtype=torch.int32),
                                tri_material=torch.zeros((0,), dtype=torch.int32))
    with pytest.raises(ValueError, match="empty"):
        tbvh.build_bvh(empty)


@pytest.mark.parametrize("spheres", [False, True])
def test_cpu_traversal_matches_jax_and_brute(spheres):
    j, t = cup_pair(spheres=spheres)
    jt = jbvh.build_bvh(j, use_native=False, builder="median")
    tree = bvh_from_numpy([np.asarray(getattr(jt, n)) for n in BVH_LEAVES], jt.max_leaf)
    o, d, ro, rd, tm = mesh_rays()
    got = tbvh.intersect_bvh(t, tree, torch.from_numpy(o), torch.from_numpy(d))
    want = jbvh.intersect_bvh(j, jt, jnp.asarray(o), jnp.asarray(d))
    assert_hits_agree(got, want, "closest vs JAX")
    assert_hits_agree(got, tint.intersect_brute(t, torch.from_numpy(o), torch.from_numpy(d)),
                      "closest vs brute force")
    hit = np.asarray(got.prim_id) >= 0
    assert 0.2 < hit.mean() < 0.9
    np.testing.assert_allclose(got.u.numpy()[hit], np.asarray(want.u)[hit], atol=1e-4)
    occ = tbvh.occluded_bvh(t, tree, torch.from_numpy(ro), torch.from_numpy(rd),
                            torch.from_numpy(tm)).numpy()
    j_occ = np.asarray(jbvh.occluded_bvh(j, jt, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tm)))
    b_occ = tint.occluded_brute(t, torch.from_numpy(ro), torch.from_numpy(rd),
                                torch.from_numpy(tm)).numpy()
    assert (occ == j_occ).mean() >= 0.995 and (occ == b_occ).mean() >= 0.995
    assert 0.05 < occ.mean() < 0.95


def test_oversized_leaves_are_swept_in_chunks():
    # A depth cap of 3 leaves ~144 triangles per leaf: the traversal re-pushes
    # a leaf with an advanced cursor until every triangle is tested.
    j, t = cup_pair()
    tree = tbvh.build_bvh(t, max_depth=3, max_leaf=4)
    assert int(tree.count.max()) > 4
    o, d, *_ = mesh_rays(n_random=0)
    got = tbvh.intersect_bvh(t, tree, torch.from_numpy(o), torch.from_numpy(d))
    assert_hits_agree(got, tint.intersect_brute(t, torch.from_numpy(o), torch.from_numpy(d)),
                      "depth-capped tree vs brute force")


def test_axis_aligned_rays_match_jax():
    # Direction components of exactly 0: (lo - o) * inf is +-inf, or NaN where
    # the origin lies on a slab plane.  NaN-propagating min/max cull that box
    # in both packages, so both give the same hits.
    j, t = cup_pair()
    jt = jbvh.build_bvh(j, use_native=False)
    tree = tbvh.build_bvh(t, use_native=False)
    lo = np.asarray(jt.node_lo)
    o = np.asarray([[0.0, 0.0, -3.0], [0.1, -0.3, -3.0], [lo[1, 0], 0.1, -3.0], [0.2, 0.2, 3.0],
                    [-3.0, 0.0, 0.0], [0.0, 3.0, 0.1], [lo[0, 0], lo[0, 1], -3.0]], np.float32)
    d = np.asarray([[0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0], [0, 0, 1]],
                   np.float32)
    got = tbvh.intersect_bvh(t, tree, torch.from_numpy(o), torch.from_numpy(d))
    want = jbvh.intersect_bvh(j, jt, jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(got.prim_id.numpy(), np.asarray(want.prim_id))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-6)
    assert (got.prim_id.numpy() >= 0).sum() >= 4


def test_cpu_auto_backend_is_the_bvh_past_the_brute_cap():
    j, t = cup_pair()
    cfg = trt.RenderConfig(width=32, height=32, brute_force_max_tris=1000)
    assert cfg.resolve_backend(t.num_triangles, torch.device("cpu")) == "bvh"
    assert cfg.resolve_bvh_builder(t.num_triangles, torch.device("cpu")) == "median"
    assert tw.needs_bvh(cfg, t.num_triangles, torch.device("cpu"))
    accel = tw.build_accel(t, cfg)
    assert isinstance(accel, tbvh.BVH) and tw.build_accel(t, cfg) is accel  # memoized
    img = trt.render(t, trt.Camera.default(device="cpu"), cfg)
    brute = trt.render(t, trt.Camera.default(device="cpu"), dataclasses.replace(cfg, backend="brute"))
    assert_images_close(img.numpy(), brute.numpy(), msg="bvh vs brute")
    jimg = jrt.render(j, jrt.Camera.default(),
                      jrt.RenderConfig(width=32, height=32, backend="bvh"))
    assert_images_close(img.numpy(), np.asarray(jimg), msg="bvh vs the JAX bvh backend")
    assert (img.numpy().max(axis=-1) > 0.02).mean() > 0.15
    with pytest.raises(ValueError, match="CPU path"):
        trt.RenderConfig(backend="bvh").resolve_backend(10, torch.device("cuda"))
