"""PyTorch port, geometry sharding (``parallel/geometry.py``): the triangles
split over the ranks of a 'prims' mesh axis, each rank walking its own
shard's tree, the hits merged across ranks.

A gloo world of 4 ranks on the CPU is spawned once for this file
(``multihost.spawn``, ``tests/torch_parallel_worker.py``): a ('rays',
'prims') 2 x 2 mesh and a 4-shard 'prims' mesh.  What is held, and to what:

- the partition equals JAX's ``build_geometry_shards`` (``tris``,
  ``tri_mat``, ``perm``) bit for bit, for S = 2 and 8, on the 1,154-triangle
  cup;
- ``geometry_sharded_intersect`` over 2 shards of the cup (the brute sweep
  per shard, and ``backend='cuda'``: the 4-wide tree's twin per shard)
  against JAX's on 2 devices (``backend='bvh'``) and against the port's
  replicated oracle: global prim id, t, u and v agree (atol 1e-5) on all
  but ties, <= 0.5% of the 32^2 rays; every rank holds the same merged
  hits; sphere hits come back as T + s on the triangles + spheres scene;
- ``geometry_sharded_render`` (the cup over 2 x 2 with the rows split too
  and over 4 shards, the mirror box whose reflections cross shards, the
  spherical box through the scan, the box with AA + bloom) against the
  port's replicated ``render()``: ``assert_images_close``;
- shards built for another shard count raise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import cg_raytracer_tpu as jrt
import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu.parallel import geometry as jgeo
from cg_raytracer_tpu_torch.models import whitted as tw
from cg_raytracer_tpu_torch.ops import bvh4 as tb4
from cg_raytracer_tpu_torch.ops.camera import generate_rays
from cg_raytracer_tpu_torch.parallel import geometry, multihost, sharding
from cg_raytracer_tpu_torch.scene import standins
from tests import torch_parallel_worker as worker
from tests.conftest import assert_images_close
from tests.test_torch_bvh import cup_pair
from tests.test_torch_scene import scene_pair

CAM = trt.Camera.default(device="cpu")
TIES = 0.005


def _box():
    return trt.make_scene(standins.mirror_box_meshes(),
                          point_lights=trt.PointLights.of(*standins.MIRROR_BOX_LIGHTS),
                          device="cpu")


def _spherical_box():
    return trt.make_scene(standins.mirror_box_meshes(),
                          spherical_lights=trt.SphericalLights.of(
                              *standins.SPHERICAL_BOX_LIGHTS), device="cpu")


@pytest.fixture(scope="module")
def cup():
    return cup_pair()


@pytest.fixture(scope="module")
def world(cup, tmp_path_factory):
    """What rank 0 of the spawned 4-rank world returned."""
    d = tmp_path_factory.mktemp("geometry")
    torch.save((cup[1], _box(), _spherical_box(), scene_pair("mixed")[1]), d / "scenes.pt")
    multihost.spawn(worker.geometry_cases, 4, args=(str(d / "scenes.pt"), str(d / "out.pt")))
    return torch.load(d / "out.pt", weights_only=False)


@pytest.mark.parametrize("n_shards", [2, 8])
def test_partition_equals_jax(cup, n_shards):
    j, t = cup
    want = jgeo.build_geometry_shards(j, n_shards, jrt.RenderConfig(backend="brute"))
    got = geometry.build_geometry_shards(t, n_shards, trt.RenderConfig())
    assert (got.n_shards, got.shard_size) == (want.n_shards, want.shard_size)
    for name in ("tris", "tri_mat", "perm"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b), name
    assert got.accel is None and got.shard is None
    # A rank builds its own shard's tree only: the card's 4-wide tree past
    # 256 triangles, nothing for the brute kernels.
    mine = geometry.build_geometry_shards(t, n_shards, trt.RenderConfig(backend="cuda"), shard=1)
    if got.shard_size > 256:
        assert isinstance(mine.accel, tb4.BVH4) and mine.accel.num_tris == got.shard_size
    else:
        assert mine.accel is None


def _agree(got, want, uv_atol=1e-5):
    """Share of rays whose prim id, t (to 1e-5), u and v (to ``uv_atol``)
    agree."""
    g = [np.asarray(x) for x in got]
    w = [np.asarray(x) for x in want]
    big = lambda t: np.where(np.isinf(t), 1e9, t)  # noqa: E731
    same = g[1] == w[1]
    same &= np.isclose(big(g[0]), big(w[0]), atol=1e-5, rtol=0)
    for a, b in zip(g[2:], w[2:]):
        same &= np.isclose(a, b, atol=uv_atol, rtol=0) | (w[1] < 0)
    return same.mean()


@pytest.mark.parametrize("label", ["auto", "cuda"])
def test_sharded_intersect_matches_jax_and_the_replicated_oracle(cup, world, label):
    j, t = cup
    got = world[f"cup hits {label}"]
    jcfg = jrt.RenderConfig(width=32, height=32, backend="bvh")
    o, d = jrt.generate_rays(jrt.Camera.default(), 32, 32)
    jmesh = JMesh(np.asarray(jax.devices()[:2]), (jgeo.PRIM_AXIS,))
    want = jgeo.geometry_sharded_intersect(j, jcfg, jmesh, jgeo.build_geometry_shards(j, 2, jcfg),
                                           jnp.asarray(o), jnp.asarray(d))
    assert _agree(got, want) >= 1 - TIES
    cfg = trt.RenderConfig(backend=label) if label == "cuda" else trt.RenderConfig()
    to, td = generate_rays(CAM, 32, 32)
    assert _agree(got, tw.make_backend(t, cfg).closest(to, td)) >= 1 - TIES
    hit = got.prim_id >= 0
    assert 0.1 < hit.float().mean().item() < 0.9 and int(got.prim_id.max()) < t.num_triangles
    # Every rank of the 4 holds the same merged hits.
    ts = world["every rank's t"]
    assert all(torch.equal(ts[r], ts[0]) for r in range(4)) and torch.equal(ts[0], got.t)


def test_sharded_intersect_reports_sphere_ids(world):
    mixed = scene_pair("mixed")[1]
    got = world["mixed hits"]
    want = tw.make_backend(mixed, trt.RenderConfig()).closest(*generate_rays(CAM, 32, 32))
    assert _agree(got, want) >= 1 - TIES
    spheres = got.prim_id >= mixed.num_triangles
    assert spheres.any() and int(got.prim_id.max()) < mixed.num_triangles + 2


@pytest.mark.parametrize("case", ["cup 2x2 auto", "cup 2x2 cuda", "cup 4", "box 4",
                                  "spherical 4", "box 4 aa+bloom"])
def test_sharded_render_matches_replicated(cup, world, case):
    scene = {"cup": cup[1], "box": _box(), "spherical": _spherical_box()}[case.split()[0]]
    cfg = worker.SPH_GEO_CFG if case.startswith("spherical") else worker.BOX_CFG
    if case.endswith("cuda"):
        cfg = dataclasses.replace(cfg, backend="cuda")
    if case.endswith("aa+bloom"):
        cfg = worker.EFFECT_CFGS["aa+bloom"]
    got = world[case]
    want = trt.render(scene, CAM, cfg)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert_images_close(got.numpy(), want.numpy(), msg=case)
    assert (want.amax(dim=-1) > 0.02).float().mean() > 0.05


def test_shard_count_mismatch_raises(cup):
    _, t = cup
    mesh = sharding.make_mesh(device="cpu", axis=geometry.PRIM_AXIS)
    shards = geometry.build_geometry_shards(t, 2, trt.RenderConfig())
    with pytest.raises(ValueError, match="mesh axis"):
        geometry.geometry_sharded_render(t, CAM, trt.RenderConfig(width=8, height=8), mesh,
                                         shards=shards)
    # One shard on a world of one rank is the replicated render.
    cfg = trt.RenderConfig(width=16, height=16)
    assert torch.equal(geometry.geometry_sharded_render(t, CAM, cfg, mesh),
                       trt.render(t, CAM, cfg))
