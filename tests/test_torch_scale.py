"""PyTorch port, the scale slice: scenes past the JAX package's on-chip tier
(200,000 triangles) through the 4-wide BVH kernels, on the donut (320,000
triangles, one point light, ks 0).

The port's 4-wide twins walk its auto tree (median, leaf 4); JAX's
streaming kernels ``intersect_pallas_bvh4_hbm`` / ``occluded_pallas_bvh4_hbm``
/ ``bounce_pallas_bvh4_hbm`` (B8, interpret mode) walk its own
``build_hbm_bvh4`` tree (median, 28 triangles per leaf) on the same rays: a
16^2 frame plus 256 random rays with a random t_max.  Tolerances
(``tests/test_bvh4.py:195``'s tie allowance): prim ids equal on >= 99.8% of
rays and t within atol 1e-4 where they are; any-hit and shadow bits equal
on >= 99.8%.  The render (depth 1) against JAX's ``backend='pallas'`` render
as ``assert_images_close``; one two-phase step's gradients (materials,
light and vertices, 'exact') against JAX's on its streaming tree at
``test_torch_mesh_train.py``'s tolerances (rtol 2e-4, atol 1e-5; vertices
atol 2e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cg_raytracer_tpu as jrt
import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu.models import whitted as jw
from cg_raytracer_tpu.ops import pallas_bvh4 as jb4
from cg_raytracer_tpu.optim import inverse as jinv
from cg_raytracer_tpu.utils.config import RenderConfig as JConfig
from cg_raytracer_tpu_torch.interop import params_from_numpy, scene_from_numpy
from cg_raytracer_tpu_torch.models import whitted as tw
from cg_raytracer_tpu_torch.ops import bvh4 as tb4
from cg_raytracer_tpu_torch.ops import soft
from cg_raytracer_tpu_torch.optim import inverse as tinv
from tests.conftest import assert_images_close
from tests.test_torch_bvh import mesh_rays
from tests.test_torch_scene import jax_leaves
from tests.test_torch_train import GRAD, _apply

SIZE = 16
MATCH = 0.998


@pytest.fixture(scope="module")
def donut():
    """(JAX donut, port donut, JAX's streaming tree, the port's auto tree)."""
    j = jrt.load_scene("donut")
    t = scene_from_numpy(jax_leaves(j))
    _, h4 = jb4.build_hbm_bvh4(j)
    tree = tw.build_accel(t, trt.RenderConfig(backend="cuda"))
    return j, t, h4, tree


def _hits_agree(got, want, what):
    same = got.prim_id.numpy() == np.asarray(want.prim_id)
    assert same.mean() >= MATCH, f"{what}: prim ids agree on {same.mean():.4%}"
    hit = same & np.isfinite(np.asarray(want.t))
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], atol=1e-4, rtol=0,
                               err_msg=what)


def test_donut_kernels_match_jax_streaming_kernels(donut):
    j, t, h4, tree = donut
    assert t.num_triangles == 320_000 > tb4.VMEM_MAX_TRIS
    assert isinstance(tree, tb4.BVH4) and tree.num_tris == t.num_triangles
    o, d, ro, rd, tm = mesh_rays(n_random=256, size=SIZE)
    got = tb4.intersect_bvh4_cuda(t, tree, torch.from_numpy(o), torch.from_numpy(d))
    want = jb4.intersect_pallas_bvh4_hbm(j, h4, jnp.asarray(o), jnp.asarray(d), interpret=True)
    _hits_agree(got, want, "closest")
    assert 0.1 < (got.prim_id >= 0).float().mean().item() < 0.9
    occ = tb4.occluded_bvh4_cuda(t, tree, torch.from_numpy(ro), torch.from_numpy(rd),
                                 torch.from_numpy(tm)).numpy()
    j_occ = np.asarray(jb4.occluded_pallas_bvh4_hbm(j, h4, jnp.asarray(ro), jnp.asarray(rd),
                                                    jnp.asarray(tm), interpret=True))
    assert (occ == j_occ).mean() >= MATCH and 0.02 < occ.mean() < 0.98
    live = np.arange(o.shape[0]) % 5 != 0
    hit, bits = tb4.bounce_bvh4_cuda(t, tree, torch.from_numpy(o), torch.from_numpy(d),
                                     live=torch.from_numpy(live))
    j_hit, j_bits = jb4.bounce_pallas_bvh4_hbm(j, h4, jnp.asarray(o), jnp.asarray(d),
                                               live=jnp.asarray(live), interpret=True)
    _hits_agree(hit, j_hit, "bounce")
    assert (bits.numpy() == np.asarray(j_bits)).mean() >= MATCH
    assert (bits.numpy() > 0).any() and (hit.prim_id.numpy()[~live] == -1).all()


def test_routing_past_the_on_chip_tier(donut):
    _, t, _, tree = donut
    cfg = trt.RenderConfig(backend="cuda")
    assert cfg.resolve_bvh_builder(t.num_triangles, t.device) == "median"
    assert cfg.resolve_bvh_builder(tb4.VMEM_MAX_TRIS, t.device) == "sah"
    assert tb4.supports_bvh4(t) and tb4.supports_fused_bounce_bvh4(t)
    backend = tw.make_backend(t, cfg, accel=tree)
    assert backend.bounce is not None and backend.soft_vis is None
    # A spherical light past the tier: no sampler kernel (JAX's streaming
    # tier has none), the scan over the any-hit kernel instead.
    sph = dataclasses.replace(t, spherical_lights=trt.SphericalLights.of(((-1, 1, -1), 0.1,
                                                                         (1, 1, 1))))
    assert not soft.supports_soft_shadow_kernel_bvh(sph)
    on = dataclasses.replace(cfg, width=8, height=8, soft_shadow_kernel="on",
                             soft_shadow_samples=4)
    accel = tw.build_accel(sph, on)
    assert isinstance(accel, tb4.BVH4) and accel is tw.build_accel(sph, on)
    assert tw.make_backend(sph, on, accel=accel).soft_vis is None
    img = trt.render(sph, trt.Camera.default(device="cpu"), on, accel=accel)
    off = trt.render(sph, trt.Camera.default(device="cpu"), dataclasses.replace(on, soft_shadow_kernel="off"),
                     accel=accel)
    assert torch.equal(img, off) and bool(torch.isfinite(img).all()) and img.amax() > 0.02
    # Past the limit of the kernels' int32 indexing the card raises, before
    # any build (a stubbed count: stride-0 tables).
    n = tb4.MAX_TRIS + 1
    big = dataclasses.replace(t, triangles=torch.zeros((1, 3), dtype=torch.int32).expand(n, 3),
                              tri_material=torch.zeros((1,), dtype=torch.int32).expand(n))
    assert not tb4.supports_bvh4(big)
    with pytest.raises(NotImplementedError, match="int32 indexing"):
        tw.build_accel(big, cfg)
    with pytest.raises(NotImplementedError, match="MAX_TRIS"):
        tw.make_backend(big, cfg, accel=tree)


def test_donut_render_and_step_match_jax(donut):
    j, t, h4, tree = donut
    cfg = dict(width=SIZE, height=SIZE)
    j_img = np.asarray(jrt.render(j, jrt.Camera.default(), JConfig(backend="pallas", **cfg)))
    t_img = trt.render(t, trt.Camera.default(device="cpu"), trt.RenderConfig(backend="cuda", **cfg),
                       accel=tree).numpy()
    assert_images_close(t_img, j_img, msg="donut render")
    assert (j_img.max(axis=-1) > 0.02).mean() > 0.1

    params = {k: np.asarray(v) for k, v in jinv.material_params(j).items()}
    params["vertices"] = np.asarray(j.vertices)
    switches = dict(cfg, grad_two_phase="on", shade_kernel="on", two_phase_rays="exact")
    jcfg = JConfig(backend="pallas", **switches)

    def f(p):
        s = _apply(j, p, jinv)
        return jw.render_image(s, jrt.Camera.default(), jcfg,
                               backend=jw.make_backend(s, jcfg, bvh=h4),
                               key=jax.random.PRNGKey(0))

    j_img, vjp = jax.vjp(f, {k: jnp.asarray(v) for k, v in params.items()})
    j_img = np.asarray(j_img)
    leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(params).items()}
    scn, tcfg = _apply(t, leaves, tinv), trt.RenderConfig(backend="cuda", **switches)
    t_img = tw.render_image(scn, trt.Camera.default(device="cpu"), tcfg,
                            backend=tw.make_backend(scn, tcfg, accel=tree))
    assert_images_close(t_img.detach().numpy(), j_img, msg="donut two-phase")
    mask = (np.abs(t_img.detach().numpy() - j_img).max(axis=-1) <= 1e-4).astype(np.float32)
    ct = np.repeat(mask[..., None], 3, axis=-1) / mask.size / 3
    (t_img * torch.from_numpy(ct)).sum().backward()
    j_grads = {k: np.asarray(v) for k, v in vjp(jnp.asarray(ct))[0].items()}
    for k, g in j_grads.items():
        tol = dict(GRAD, atol=2e-5) if k == "vertices" else GRAD
        np.testing.assert_allclose(leaves[k].grad.numpy(), g, **tol, err_msg=f"d/d{k}")
    for k in ("kd", "light_color", "light_position", "vertices"):  # ks 0: no specular term
        assert np.abs(j_grads[k]).sum() > 0, k
