"""PyTorch port: Moller-Trumbore, the brute-force oracles and reconstruct_hit
against the JAX package, and reconstruct_hit's grad-safety on miss lanes.

Tolerances (the backend contract): prim ids equal on >= 99.5% of rays
(coincident-edge tie-breaks); where they match, t/u/v within atol 1e-5,
rtol 1e-5.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cg_raytracer_tpu as jrt
import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu.ops import intersect as jint
from cg_raytracer_tpu_torch.ops import intersect as tint
from tests.test_torch_scene import scene_pair


def rays(seed, n=2048, camera=True):
    """Camera rays at 32x32 (when ``camera``) plus random rays through the scene."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if camera:
        co, cd = jrt.generate_rays(jrt.Camera.default(), 32, 32)
        o = np.concatenate([np.asarray(co), o])
        d = np.concatenate([np.asarray(cd), d])
    return o, d


def assert_hits_close(th, jh, min_match=0.995):
    tp, jp = th.prim_id.numpy(), np.asarray(jh.prim_id)
    assert th.prim_id.dtype == torch.int32
    same = tp == jp
    assert same.mean() >= min_match, f"prim ids agree on {same.mean():.4%}"
    for a, b in ((th.t, jh.t), (th.u, jh.u), (th.v, jh.v)):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same], rtol=1e-5, atol=1e-5)
    assert np.isinf(th.t.numpy()[tp < 0]).all()
    return same.mean()


def test_moller_trumbore_matches_jax():
    rng = np.random.default_rng(1)
    v = rng.uniform(-1, 1, (3, 512, 3)).astype(np.float32)
    o = rng.uniform(-2, 2, (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    # Aim half of the rays at their triangle's centroid so many hit.
    d[:256] = v[:, :256].mean(axis=0) - o[:256]
    j = jint.moller_trumbore(o, d, v[0], v[1], v[2])
    t = tint.moller_trumbore(*(torch.from_numpy(x.copy()) for x in (o, d, v[0], v[1], v[2])))
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))
    aimed = t[3].numpy()[:256]
    assert aimed.mean() > 0.9
    # Values on the aimed hits (random rays include near-parallel ones whose
    # t is ill-conditioned in the last bits).
    for a, b in zip(t[:3], j[:3]):
        np.testing.assert_allclose(a.numpy()[:256][aimed], np.asarray(b)[:256][aimed],
                                   rtol=1e-5, atol=1e-5)
    # Parallel ray: det below eps gives an invalid, finite result (det_safe).
    par = tint.moller_trumbore(torch.zeros(1, 3), torch.tensor([[1.0, 0, 0]]),
                               torch.tensor([[0.0, 1, 0]]), torch.tensor([[1.0, 1, 0]]),
                               torch.tensor([[0.0, 1, 1]]))
    assert not bool(par[3][0]) and all(bool(torch.isfinite(x).all()) for x in par[:3])


@pytest.mark.parametrize("name", ["mirror_box", "mixed", "spheres"])
def test_intersect_brute_matches_jax(name):
    j_scene, t_scene = scene_pair(name)
    o, d = rays(2)
    jh = jint.intersect_brute(j_scene, jnp.asarray(o), jnp.asarray(d), tri_chunk=8)
    th = tint.intersect_brute(t_scene, torch.from_numpy(o), torch.from_numpy(d), tri_chunk=8)
    assert_hits_close(th, jh)
    assert (th.prim_id.numpy() >= 0).mean() > 0.05
    # With a t_max bound.
    tm = np.full((o.shape[0],), 1.5, np.float32)
    jh = jint.intersect_brute(j_scene, jnp.asarray(o), jnp.asarray(d), t_max=jnp.asarray(tm))
    th = tint.intersect_brute(t_scene, torch.from_numpy(o), torch.from_numpy(d),
                              t_max=torch.from_numpy(tm))
    assert_hits_close(th, jh)


@pytest.mark.parametrize("name", ["mirror_box", "mixed"])
def test_occluded_brute_matches_jax(name):
    j_scene, t_scene = scene_pair(name)
    o, d = rays(3)
    tm = np.random.default_rng(4).uniform(0.0, 2.0, o.shape[0]).astype(np.float32)
    jb = np.asarray(jint.occluded_brute(j_scene, jnp.asarray(o), jnp.asarray(d),
                                        jnp.asarray(tm), tri_chunk=8))
    tb = tint.occluded_brute(t_scene, torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(tm), tri_chunk=8).numpy()
    assert tb.dtype == np.bool_
    assert (tb == jb).mean() >= 0.995
    assert 0.02 < tb.mean() < 0.98


@pytest.mark.parametrize("name", ["mirror_box", "mixed", "spheres"])
def test_reconstruct_hit_matches_jax(name):
    j_scene, t_scene = scene_pair(name)
    o, d = rays(5)
    jh = jint.intersect_brute(j_scene, jnp.asarray(o), jnp.asarray(d))
    # Both reconstruct from the same (JAX) hit ids.
    th = tint.Hit(*(torch.from_numpy(np.array(x)) for x in jh))
    js = jint.reconstruct_hit(j_scene, jnp.asarray(o), jnp.asarray(d), jh)
    ts = tint.reconstruct_hit(t_scene, torch.from_numpy(o), torch.from_numpy(d), th)
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    for field in ("position", "normal", "kd", "ks", "shininess"):
        np.testing.assert_allclose(getattr(ts, field).numpy(), np.asarray(getattr(js, field)),
                                   rtol=1e-5, atol=1e-5, err_msg=field)
    assert ts.valid.numpy().mean() > 0.05



def _level_vertex_grad(t_scene, o, d, hit, w):
    """Vertex gradient of one level's reconstruct + Phong, weighted per ray
    by ``w`` [N] and summed over every output."""
    from cg_raytracer_tpu_torch.ops import shading

    verts = t_scene.vertices.detach().clone().requires_grad_(True)
    scene = dataclasses.replace(t_scene, vertices=verts)
    surf = tint.reconstruct_hit(scene, o, d, hit)
    direct = shading.direct_point_lights(scene, d, surf, None,
                                         shadow_bits=torch.zeros_like(hit.prim_id))
    loss = ((direct + surf.position + surf.normal + surf.ks) * w[:, None]).sum()
    return torch.autograd.grad(loss, verts)[0]


def test_reconstruct_hit_vertex_grads_are_finite_and_miss_lanes_add_zero():
    # Miss rays fall through to triangle 0, where their barycentrics reach
    # ~1e7 and the interpolated normal can cancel to zero: before the inputs
    # were gated, its norm's derivative turned their zero cotangent into NaN
    # on triangle 0's vertices.
    _, t_scene = scene_pair("mirror_box")
    o, d = (torch.from_numpy(np.array(x)) for x in jrt.generate_rays(jrt.Camera.default(), 24, 24))
    hit = tint.intersect_brute(t_scene, o, d)
    w = torch.linspace(0.5, 1.5, o.shape[0])
    g_all = _level_vertex_grad(t_scene, o, d, hit, w)
    hits = hit.prim_id >= 0
    assert (~hits).sum() > 100 and (hit.prim_id == 0).any()
    assert bool(torch.isfinite(g_all).all()) and g_all[:3].abs().sum() > 0
    g_hits = _level_vertex_grad(t_scene, o[hits], d[hits], tint.Hit(*(x[hits] for x in hit)),
                                w[hits])
    torch.testing.assert_close(g_all, g_hits, rtol=1e-6, atol=1e-7)


def test_render_vertex_grads_are_finite_on_the_stand_in_box():
    _, t_scene = scene_pair("mirror_box")
    verts = t_scene.vertices.detach().clone().requires_grad_(True)
    scene = dataclasses.replace(t_scene, vertices=verts)
    img = trt.render(scene, trt.Camera.default(device="cpu"), trt.RenderConfig(width=24, height=24))
    img.mean().backward()
    assert bool(torch.isfinite(verts.grad).all()) and verts.grad.abs().sum() > 0


def test_plane_intersector_matches_jax():
    # tests/test_intersect.py:136-144: a hit from above at t = 1 (the plane
    # y = 1), a ray pointing away (rejected), the origin on the plane (t =
    # 0), a parallel ray off the plane (rejected); then random rays.
    n = np.asarray([0.0, 1.0, 0.0], np.float32)
    o = np.asarray([[0, 2, 0], [0, 2, 0], [0, 1, 0], [0, 2, 0]], np.float32)
    d = np.asarray([[0, -1, 0], [0, 1, 0], [1, 0, 0], [1, 0, 0]], np.float32)
    ro, rd = rays(5, n=256, camera=False)
    o, d = np.concatenate([o, ro]), np.concatenate([d, rd])
    t, ok = tint.intersect_plane(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(n),
                                 torch.tensor(1.0))
    jt, jok = jint.intersect_plane(jnp.asarray(o), jnp.asarray(d), jnp.asarray(n),
                                   jnp.float32(1.0))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-6)
    assert ok[:4].tolist() == [True, False, True, False]
    assert float(t[0]) == 1.0 and float(t[2]) == 0.0 and np.isinf(float(t[1]))
    assert 0.2 < ok.float().mean().item() < 0.8


def test_aabb_slab_matches_jax():
    # tests/test_intersect.py:69-96: in front (t = 2), origin inside, behind,
    # and a parallel ray outside the slab (IEEE infinities); then random rays
    # against random boxes.
    lo, hi = np.zeros(3, np.float32), np.ones(3, np.float32)
    o = np.asarray([[0.5, 0.5, -2], [0.5, 0.5, 0.5], [0.5, 0.5, 2], [2, 0.5, -2]], np.float32)
    with np.errstate(divide="ignore"):
        inv = np.broadcast_to(1.0 / np.asarray([0, 0, 1], np.float32), o.shape).copy()
    t, hit = tint.intersect_aabb(*(torch.from_numpy(x) for x in (o, inv, lo, hi)))
    jt, jhit = jint.intersect_aabb(*(jnp.asarray(x) for x in (o, inv, lo, hi)))
    assert hit.tolist() == np.asarray(jhit).tolist() == [True, True, False, False]
    assert float(t[0]) == 2.0
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    ro, rd = rays(6, n=512, camera=False)
    rinv = (1.0 / rd).astype(np.float32)
    blo = np.random.default_rng(6).uniform(-1, 0, (512, 3)).astype(np.float32)
    bhi = blo + np.random.default_rng(7).uniform(0.1, 1, (512, 3)).astype(np.float32)
    t, hit = tint.intersect_aabb(*(torch.from_numpy(x) for x in (ro, rinv, blo, bhi)))
    jt, jhit = jint.intersect_aabb(*(jnp.asarray(x) for x in (ro, rinv, blo, bhi)))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    assert 0.1 < hit.float().mean().item() < 0.9
