"""PyTorch port, the soft-shadow slice: spherical lights against the JAX
package, on the CPU.

- The cone sampler's table twin (``ops/soft.py``, B10) against the JAX
  Pallas table kernel in interpret mode, on the same numpy Gaussians, on
  the 1,154-triangle cup lit by ``monkey_spherical_light``'s light, over
  JAX's soft tree (median, leaf 14) and over the port's (SAH, leaf 4); the
  brute sampler (B9) is ``test_torch_soft_box.py``'s.  Counts
  equal on >= 99.5% of hit points and within 1 elsewhere (a sample ray
  through a shared edge may resolve either way: the tie allowance of
  ``assert_images_close``).
- ``spherical_fracs``' scan with JAX's own draws (redrawn here under the
  same ``fold_in`` keys) against JAX's scan: the same rule.
- The slice as a whole on the cup (``check_slice``; the box's is in
  ``test_torch_soft_box.py``): JAX ``render_image`` with its sampler
  replaced by the table kernel on numpy Gaussians against the port's render
  with the table twin on the same Gaussians, one phase and two phase
  (``assert_images_close``); and the two-phase gradients (materials,
  vertices, the spherical light's position and color) through JAX's shade
  kernel (interpret) and the port's shade twin: rtol 2e-4, atol 1e-5
  (vertices atol 2e-5), as ``test_torch_train.py``.
- The sample stream: Philox4x32-10 against its published known answers, the
  Gaussians' moments, the PRNG twin against the table twin in distribution,
  and a render's independence of ``ray_chunk``.
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
from cg_raytracer_tpu.ops import bvh as jbvh_mod
from cg_raytracer_tpu.ops import pallas_bvh4 as jb4
from cg_raytracer_tpu.ops import shading as jshading
from cg_raytracer_tpu.ops.intersect import intersect_brute as j_intersect_brute
from cg_raytracer_tpu.ops.intersect import occluded_brute as j_occluded_brute
from cg_raytracer_tpu.ops.pallas_kernels import soft_shadow_counts_pallas
from cg_raytracer_tpu.optim import inverse as jinv
from cg_raytracer_tpu.utils.config import RenderConfig as JConfig
from cg_raytracer_tpu_torch.interop import params_from_numpy, scene_from_numpy
from cg_raytracer_tpu_torch.models import whitted as tw
from cg_raytracer_tpu_torch.ops import bvh4 as b4
from cg_raytracer_tpu_torch.ops import intersect as tint
from cg_raytracer_tpu_torch.ops import shading, soft
from cg_raytracer_tpu_torch.optim import inverse as tinv
from cg_raytracer_tpu_torch.scene import standins
from tests.conftest import assert_images_close
from tests.test_torch_bvh import cup_meshes
from tests.test_torch_scene import jax_leaves
from tests.test_torch_train import GRAD

S = 16
SIZE = 20


def spherical_pair(name):
    """(JAX scene, port scene) of a spherical stand-in: the box, or the cup
    of ``test_torch_bvh.py`` (ks 0.3, so depth 2 is live)."""
    if name == "box":
        meshes, lights = standins.mirror_box_meshes(), standins.SPHERICAL_BOX_LIGHTS
    else:
        meshes, lights = cup_meshes(ks=0.3), standins.SPHERICAL_CUP_LIGHTS
    j = jrt.make_scene(meshes, spherical_lights=jrt.SphericalLights.of(*lights))
    return j, scene_from_numpy(jax_leaves(j))


def hit_points(j, size):
    """Level-0 hit positions [N, 3] (zero on a miss) and the hit mask, numpy."""
    o, d = jrt.generate_rays(jrt.Camera.default(), size, size)
    hit = j_intersect_brute(j, o, d)
    valid = np.asarray(hit.prim_id) >= 0
    t = np.where(valid, np.asarray(hit.t), 0.0)
    pos = np.where(valid[:, None], np.asarray(o) + np.asarray(d) * t[:, None], 0.0)
    return pos.astype(np.float32), valid


def gaussians(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def assert_counts_agree(got, want, valid, what):
    got, want = np.asarray(got)[valid], np.asarray(want)[valid]
    same = (got == want).mean()
    assert same >= 0.995, f"{what}: counts equal on {same:.4%} of hit points"
    assert np.abs(got - want).max() <= 1, f"{what}: {np.abs(got - want).max()}"


@pytest.mark.parametrize("tree", ["jax soft tree", "port tree"])
def test_cone_table_twin_matches_jax_kernel(tree):
    j, t = spherical_pair("cup")
    pos, valid = hit_points(j, 24)
    g = gaussians((S, pos.shape[0], 3), seed=1)
    lpos, lrad = j.spherical_lights.position[0], j.spherical_lights.radius[0]
    _, packed = jb4.build_packed_bvh4(j, max_leaf=14, builder="median")
    want = jb4.soft_shadow_counts_pallas_bvh4_cone(j, packed, jnp.asarray(pos), lpos, lrad, None,
                                                   S, interpret=True, gauss=jnp.asarray(g))
    leaf, builder = (14, "median") if tree == "jax soft tree" else (4, "sah")
    _, t_tree = b4.build_bvh4(t, max_leaf=leaf, builder=builder)
    got = soft.soft4_table_cuda(t, t_tree, torch.from_numpy(pos), t.spherical_lights.position[0],
                                t.spherical_lights.radius[0], torch.from_numpy(g),
                                valid=torch.from_numpy(valid))
    assert_counts_agree(got, want, valid, f"cone table over the {tree}")
    frac = np.asarray(want)[valid] / S
    assert ((frac > 0) & (frac < 1)).any() and (frac == 1).any()


def test_spherical_fracs_scan_matches_jax_with_its_draws():
    # 30 samples in chunks of 20: both count out of 40.
    j, t = spherical_pair("box")
    pos, valid = hit_points(j, 24)
    n, num, chunk = pos.shape[0], 30, 20
    key = jax.random.PRNGKey(7)
    want = jshading.spherical_fracs(
        j, jnp.asarray(pos), lambda o, d, tm: j_occluded_brute(j, o, d, tm), key,
        num_samples=num, sample_chunk=chunk)
    draws = np.concatenate([np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.fold_in(key, 0), ci), (chunk, n, 3), dtype=jnp.float32))
        for ci in range(2)])
    got = shading.spherical_fracs(
        t, torch.from_numpy(pos), lambda o, d, tm: tint.occluded_brute(t, o, d, tm), None,
        num_samples=num, sample_chunk=chunk, gauss=torch.from_numpy(draws))
    assert got.shape == (1, n)
    assert_counts_agree(np.asarray(got[0]) * 40, np.asarray(want[0]) * 40,
                        np.ones(n, bool), "spherical_fracs scan")
    # The hit mask only skips work: the fractions of hit points are unchanged.
    masked = shading.spherical_fracs(
        t, torch.from_numpy(pos), lambda o, d, tm: tint.occluded_brute(t, o, d, tm), None,
        num_samples=num, sample_chunk=chunk, gauss=torch.from_numpy(draws),
        valid=torch.from_numpy(valid))
    torch.testing.assert_close(masked[0][torch.from_numpy(valid)], got[0][torch.from_numpy(valid)])
    assert not masked[0][~torch.from_numpy(valid)].any()


def _jax_table_backend(j, jcfg, g, packed=None, jbvh=None):
    """JAX's backend with its sampler replaced by the table kernel on ``g``
    (``jbvh``: its BVH, built before ``jax.vjp`` traces the vertices)."""
    backend = jw.make_backend(j, jcfg, bvh=jbvh)
    num = g.shape[0]
    if packed is None:
        vis = lambda lpos, lrad, pos, k: soft_shadow_counts_pallas(  # noqa: E731
            j, pos, lpos, lrad, k, num, interpret=True, gauss=jnp.asarray(g))
    else:
        vis = lambda lpos, lrad, pos, k: jb4.soft_shadow_counts_pallas_bvh4_cone(  # noqa: E731
            j, packed, pos, lpos, lrad, k, num, interpret=True, gauss=jnp.asarray(g))
    return backend._replace(soft_vis=vis)


def _port_table_backend(t, cfg, g, tree=None):
    backend = tw.make_backend(t, cfg, accel=tree)
    gt = torch.from_numpy(g)
    if tree is None:
        vis = lambda lpos, lrad, pos, key, valid=None: soft.soft_table_cuda(  # noqa: E731
            t, pos, lpos, lrad, gt, valid=valid)
    else:
        vis = lambda lpos, lrad, pos, key, valid=None: soft.soft4_table_cuda(  # noqa: E731
            t, tree, pos, lpos, lrad, gt, valid=valid)
    return backend._replace(soft_vis=vis)


SPH_PARAMS = ("sph_position", "sph_color")


def _apply(scene, params, inv):
    scene = inv.apply_material_params(scene, {k: v for k, v in params.items()
                                              if k not in SPH_PARAMS})
    if "vertices" in params:
        scene = inv.apply_vertex_params(scene, params)
    return dataclasses.replace(scene, spherical_lights=dataclasses.replace(
        scene.spherical_lights, position=params["sph_position"], color=params["sph_color"]))


def test_slice_renders_and_grads_match_jax():
    check_slice("cup", S)


def check_slice(name, num):
    """The slice as a whole on a spherical stand-in, ``num`` samples."""
    j, t = spherical_pair(name)
    g = gaussians((num, SIZE * SIZE, 3), seed=2)
    packed = tree = jbvh = None
    jbackend, tbackend = ("brute", "cuda") if name == "box" else ("bvh", "cuda")
    if name == "cup":
        _, packed = jb4.build_packed_bvh4(j, max_leaf=14, builder="median")
        jbvh = jbvh_mod.build_bvh(j, builder="median")
        tree = tw.build_accel(t, trt.RenderConfig(backend="cuda"))
    cam_j, cam_t = jrt.Camera.default(), trt.Camera.default(device="cpu")

    # One phase, forward.
    jcfg = JConfig(width=SIZE, height=SIZE, backend=jbackend, soft_shadow_samples=num)
    cfg = trt.RenderConfig(width=SIZE, height=SIZE, backend=tbackend, soft_shadow_samples=num)
    j_img = np.asarray(jw.render_image(j, cam_j, jcfg,
                                       backend=_jax_table_backend(j, jcfg, g, packed, jbvh),
                                       key=jax.random.PRNGKey(0)))
    t_img = tw.render_image(t, cam_t, cfg, backend=_port_table_backend(t, cfg, g, tree))
    assert_images_close(t_img.numpy(), j_img, msg=f"{name} one phase")
    assert (j_img.max(axis=-1) > 0.02).mean() > 0.15

    # Two phase through the shade kernels: image and gradients.
    params = {k: np.asarray(v) for k, v in jinv.material_params(j).items()}
    params["vertices"] = np.asarray(j.vertices)
    params["sph_position"] = np.asarray(j.spherical_lights.position)
    params["sph_color"] = np.asarray(j.spherical_lights.color)
    switches = dict(width=SIZE, height=SIZE, grad_two_phase="on", shade_kernel="on",
                    soft_shadow_samples=num)
    jcfg = JConfig(backend=jbackend, **switches)
    cfg = trt.RenderConfig(backend=tbackend, **switches)

    def f(p):
        s = _apply(j, p, jinv)
        return jw.render_image(s, cam_j, jcfg,
                               backend=_jax_table_backend(s, jcfg, g, packed, jbvh),
                               key=jax.random.PRNGKey(0))

    j_img2, vjp = jax.vjp(f, {k: jnp.asarray(v) for k, v in params.items()})
    j_img2 = np.asarray(j_img2)
    leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(params).items()}
    scene = _apply(t, leaves, tinv)
    calls = []
    backend = _port_table_backend(scene, cfg, g, tree)
    shade = backend.shade
    backend = backend._replace(shade=lambda *a: calls.append(a[-1]) or shade(*a))
    t_img2 = tw.render_image(scene, cam_t, cfg, backend=backend)
    assert len(calls) == 2 and all(c is not None and c.shape == (1, SIZE * SIZE) for c in calls)
    assert_images_close(t_img2.detach().numpy(), j_img2, msg=f"{name} two phase")
    assert_images_close(t_img2.detach().numpy(), t_img.numpy(), msg=f"{name} two vs one phase")

    mask = (np.abs(t_img2.detach().numpy() - j_img2).max(axis=-1) <= 1e-4).astype(np.float32)
    ct = np.repeat(mask[..., None], 3, axis=-1) / mask.size / 3
    (t_img2 * torch.from_numpy(ct)).sum().backward()
    j_grads = {k: np.asarray(v) for k, v in vjp(jnp.asarray(ct))[0].items()}
    assert set(j_grads) == set(leaves)
    for k, want in j_grads.items():
        tol = dict(GRAD, atol=2e-5) if k == "vertices" else GRAD
        np.testing.assert_allclose(leaves[k].grad.numpy(), want, **tol, err_msg=f"{name} d/d{k}")
        if k in ("kd", "vertices") + SPH_PARAMS:
            assert np.abs(want).sum() > 0, k


# Philox4x32-10 known answers (Salmon et al., SC'11; Random123's kat_vectors).
KAT = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
       ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
       ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
        (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    assert soft.philox_host(ctr, key) == want
    got = soft.philox(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
    assert tuple(int(x) for x in got) == want


def test_gaussians_have_unit_moments():
    g = soft.philox_gauss(soft.SampleKey(5, 6), torch.arange(1000), torch.arange(334))
    x = g.reshape(-1).double()
    n = x.numel()
    assert n > 1_000_000 and bool(torch.isfinite(x).all())
    assert abs(x.mean().item()) < 5 / n ** 0.5
    assert abs(x.var().item() - 1.0) < 5 * (2 / n) ** 0.5
    # The three components are independent: no correlation past 5 sigma.
    c = torch.corrcoef(g.reshape(-1, 3).double().T)
    assert (c - torch.eye(3, dtype=torch.float64)).abs().max().item() < 5 * 3 / n ** 0.5


def test_prng_counts_agree_with_the_table_in_distribution():
    j, t = spherical_pair("box")
    pos, valid = hit_points(j, 48)
    pos_t, valid_t = torch.from_numpy(pos), torch.from_numpy(valid)
    lpos, lrad = t.spherical_lights.position[0], t.spherical_lights.radius[0]
    num = 64
    prng = soft.soft_prng_cuda(t, pos_t, lpos, lrad, soft.SampleKey(9, 10), num, valid=valid_t)
    table = soft.soft_table_cuda(t, pos_t, lpos, lrad,
                                 torch.from_numpy(gaussians((num, pos.shape[0], 3), seed=3)),
                                 valid=valid_t)
    a, b = prng[valid_t].double() / num, table[valid_t].double() / num
    assert not prng[~valid_t].any()
    # The mean fraction of two independent draws: within 5 sigma of the
    # binomial spread, summed over the points.
    var = (a * (1 - a) + b * (1 - b)).sum() / num
    assert abs((a - b).sum().item()) < 5 * var.sqrt().item() + 1e-9
    # Point by point: fully lit and fully shadowed points agree.
    assert ((a == 1) == (b == 1)).double().mean().item() > 0.95


def test_render_stream_is_seeded_and_chunk_independent():
    _, t = spherical_pair("box")
    cam = trt.Camera.default(device="cpu")
    cfg = trt.RenderConfig(width=16, height=16, backend="cuda", soft_shadow_kernel="on",
                           soft_shadow_samples=S)
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    a = trt.render(t, cam, cfg, generator=gen(1))
    assert torch.equal(a, trt.render(t, cam, cfg, generator=gen(1)))
    assert not torch.equal(a, trt.render(t, cam, cfg, generator=gen(2)))
    assert torch.equal(trt.render(t, cam, cfg), trt.render(t, cam, cfg, generator=gen(0)))
    assert torch.equal(a, trt.render(t, cam, dataclasses.replace(cfg, ray_chunk=100),
                                     generator=gen(1)))
    # The scan over the any-hit oracle draws the same samples (S is one chunk).
    scan = trt.render(t, cam, dataclasses.replace(cfg, soft_shadow_kernel="off"), generator=gen(1))
    assert_images_close(scan.numpy(), a.numpy(), msg="scan vs sampler twin")
    assert (a.amax(dim=-1) > 0.02).float().mean().item() > 0.2


def test_soft_config_errors_match_jax():
    for field, bad in (("soft_shadow_kernel", "yes"), ("soft_shadow_tile", "rows")):
        j_err = t_err = None
        jcfg, tcfg = JConfig(**{field: bad}), trt.RenderConfig(**{field: bad})
        resolve = {"soft_shadow_kernel": ("resolve_soft_shadow_kernel", ("cpu",)),
                   "soft_shadow_tile": ("resolve_soft_shadow_tile", ())}[field]
        with pytest.raises(ValueError) as j_err:
            getattr(jcfg, resolve[0])(*resolve[1])
        with pytest.raises(ValueError) as t_err:
            args = (torch.device("cpu"),) if field == "soft_shadow_kernel" else ()
            getattr(tcfg, resolve[0])(*args)
        assert str(t_err.value) == str(j_err.value), field
    assert (trt.RenderConfig(soft_shadow_tile="sample").resolve_soft_shadow_tile()
            == JConfig(soft_shadow_tile="sample").resolve_soft_shadow_tile() == "sample")
    cfg = trt.RenderConfig()
    assert cfg.soft_shadow_samples == JConfig().soft_shadow_samples == 200
    assert cfg.soft_shadow_chunk == JConfig().soft_shadow_chunk == 20
    assert cfg.resolve_soft_shadow_tile() == "cone"
    assert cfg.resolve_soft_shadow_kernel(torch.device("cuda"))
    assert not cfg.resolve_soft_shadow_kernel(torch.device("cpu"))
    assert trt.RenderConfig(soft_shadow_kernel="on").resolve_soft_shadow_kernel("cpu")


@pytest.mark.parametrize("tile,wide", [("sample", "4"), ("cone", "2"), ("cone", "8")])
def test_sampler_routes_to_its_tree(tile, wide, monkeypatch):
    # Both routes walk the scene's one tree: 'sample' makes it binary
    # whatever bvh_wide says (whitted.py:977-984 of the JAX package); 'cone'
    # keeps bvh_wide.
    _, t = spherical_pair("cup")
    cfg = trt.RenderConfig(backend="cuda", soft_shadow_kernel="on", soft_shadow_tile=tile,
                           bvh_wide=wide)
    accel = tw.build_accel(t, cfg)
    width = 2 if tile == "sample" else int(wide)
    assert tw.tree_width(t, cfg) == width
    assert isinstance(accel, b4.BVH4) and accel.width == width
    seen = []
    monkeypatch.setattr(soft, "soft4_prng_plain", lambda scene, tree, *a, **k: seen.append(tree))
    backend = tw.make_backend(t, cfg, plain=True, accel=accel)
    backend.soft_vis(t.spherical_lights.position[0], t.spherical_lights.radius[0],
                     torch.zeros((4, 3)), soft.SampleKey(1, 2))
    assert len(seen) == 1 and seen[0] is accel
    # A tree of another width than the config's is refused.
    other = b4.build_bvh4(t, max_leaf=4, builder="sah", width=4 if width != 4 else 8)[1]
    with pytest.raises(ValueError, match="width"):
        tw.make_backend(t, cfg, accel=other)
