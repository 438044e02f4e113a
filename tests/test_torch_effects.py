"""PyTorch port: the effects (``ops/effects.py``) and their composition in
``render_image`` and ``render_rows`` against the JAX package.

- The effect functions on the same numpy images (from a seed): supersampling,
  the clean bloom, the quirk blur, the AA + bloom quirk and motion blur in
  both modes, at rtol 1e-5, atol 1e-6 (the box blur and the quirk blur sum
  their windows in another order than XLA's convolution and scan); the
  quirk blur also against the reference's loop, transcribed in numpy
  (``tests/test_effects.py::_bloom_quirk_numpy``), at atol 1e-5.
- The composition: JAX's ``render_image`` with its sub-renders
  (``_render_flat``) taken from the port, against the port's, for every
  combination of the four flags, at rtol 1e-5, atol 1e-6.  This holds the
  order of the effects, the offsets, the jittered cameras and the divisors
  on identical sub-renders; ``test_torch_effects_render.py`` holds the
  renders themselves.
- ``render_rows``: tiles equal to the full frame, bit for bit, for point
  and spherical lights (the card's route, as the kernels' twins); for point
  lights also against JAX's tiles (``assert_images_close``).
- The spherical lights' key: one draw per ``render_image``, whatever the
  effects, and AA exactly the mean of four renders with that key.
- One gradient of the mean image through AA + clean bloom against
  ``jax.grad`` at 16x16 (rtol 2e-4, atol 1e-5, as the training tests).
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cg_raytracer_tpu as jrt
import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu.models import whitted as jw
from cg_raytracer_tpu.ops import effects as je
from cg_raytracer_tpu.optim import inverse as jinv
from cg_raytracer_tpu_torch.interop import camera_from_numpy, params_from_numpy
from cg_raytracer_tpu_torch.models import whitted as tw
from cg_raytracer_tpu_torch.ops import effects as te
from cg_raytracer_tpu_torch.ops import soft
from cg_raytracer_tpu_torch.optim import inverse as tinv
from tests.conftest import assert_images_close
from tests.test_effects import _bloom_quirk_numpy
from tests.test_torch_scene import jax_leaves, scene_pair

FN = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=2e-4, atol=1e-5)
FLAGS = ("anti_aliasing", "bloom", "motion_blur", "reference_quirks")
COMBOS = [dict(zip(FLAGS, bits)) for bits in itertools.product((False, True), repeat=4)]


def combo_id(flags):
    return "-".join(k for k, v in flags.items() if v) or "plain"


def images(seed, n, h=24, w=26):
    """``n`` images [h, w, 3] in [0, 0.8) with a few pixels past the bloom
    threshold."""
    rng = np.random.default_rng(seed)
    out = rng.uniform(0.0, 0.8, (n, h, w, 3)).astype(np.float32)
    for img in out:
        for _ in range(4):
            img[rng.integers(h), rng.integers(w)] = rng.uniform(0.5, 2.0, 3)
    return out


def cfgs(**flags):
    return jrt.RenderConfig(**flags), trt.RenderConfig(**flags)


@pytest.mark.parametrize("quirks", [False, True])
def test_supersample_and_bloom_match_jax(quirks):
    subs = images(1, 4)
    offs = dict(zip(te.AA_OFFSETS, subs))
    jcfg, tcfg = cfgs(reference_quirks=quirks)
    np.testing.assert_allclose(
        te.supersample_render(lambda off: torch.from_numpy(offs[off]), tcfg).numpy(),
        np.asarray(je.supersample_render(lambda off: jnp.asarray(offs[off]), jcfg)), **FN)
    img = subs[0]
    want = (je._bloom_quirk(jnp.asarray(img)) if quirks
            else je.bloom(jnp.asarray(img), jcfg))
    got = te.bloom(torch.from_numpy(img), tcfg).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **FN)
    assert (got - img).max() > 1e-3  # bright pixels were blurred back in
    if quirks:
        np.testing.assert_allclose(got, _bloom_quirk_numpy(img), atol=1e-5)
    else:
        # The blur alone: the JAX package's two 1-D passes.
        np.testing.assert_allclose(
            te._box_blur(torch.from_numpy(img)).numpy(),
            np.asarray(je._box_blur_1d(je._box_blur_1d(jnp.asarray(img), 10, 0), 10, 1)), **FN)


def test_bloom_quirk_aa_matches_jax():
    subs = images(2, 4, 28, 24)
    offs = dict(zip(te.AA_OFFSETS, subs))
    jcfg, tcfg = cfgs(reference_quirks=True, anti_aliasing=True, bloom=True)
    got = te.bloom_quirk_aa(lambda off: torch.from_numpy(offs[off]), tcfg).numpy()
    want = np.asarray(je.bloom_quirk_aa(lambda off: jnp.asarray(offs[off]), jcfg))
    np.testing.assert_allclose(got, want, **FN)
    assert np.abs(got - subs[0]).max() > 1e-3


def test_quirk_blur_wavefronts_cover_the_frame_in_raster_dependence_order():
    # Every pixel once; within a wavefront no two pixels in each other's
    # window; 11 (H-1) + W wavefronts (9,589 at 800^2).
    centers, _, _, bounds = te._wavefronts(30, 25, 10)
    assert len(bounds) - 1 == 11 * 29 + 25 and len(np.unique(centers)) == centers.size == 30 * 25
    assert len(te._wavefronts(800, 800, 10)[3]) - 1 == 9589
    wp = 25 + 20
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        ys, xs = np.divmod(centers[b0:b1], wp)
        for i in range(len(ys)):
            near = (np.abs(ys - ys[i]) <= 10) & (np.abs(xs - xs[i]) <= 10)
            assert near.sum() == 1


@pytest.mark.parametrize("quirks", [False, True])
def test_motion_blur_matches_jax(quirks):
    base, grad = images(3, 2)
    jcam = jrt.Camera.default(look_at=(0.3, -0.1, 0.2))
    tcam = camera_from_numpy(jax_leaves(jcam))
    jcfg, tcfg = cfgs(motion_blur=True, reference_quirks=quirks)

    def j_render(cam, key):  # an image that depends on the look_at
        return jnp.asarray(base) + cam.look_at[0] * jnp.asarray(grad) + cam.look_at[1]

    def t_render(cam):
        return torch.from_numpy(base) + cam.look_at[0] * torch.from_numpy(grad) + cam.look_at[1]

    want = np.asarray(je.motion_blur(j_render, jcam, jcfg, jax.random.PRNGKey(0)))
    got = te.motion_blur(t_render, tcam, tcfg).numpy()
    np.testing.assert_allclose(got, want, **FN)


@pytest.mark.parametrize("flags", COMBOS, ids=combo_id)
def test_render_image_composition_matches_jax(flags, monkeypatch):
    """JAX's ``render_image`` around the port's sub-renders: JAX traces
    motion blur through ``lax.map``, so it runs under ``disable_jit`` to hand
    the port concrete cameras."""
    j, t = scene_pair("mirror_box")
    jcam = jrt.Camera.default()
    tcam = camera_from_numpy(jax_leaves(jcam))
    size = dict(width=24, height=24)
    tcfg = trt.RenderConfig(backend="brute", **size, **flags)
    backend = tw.make_backend(t, tcfg)

    def port_flat(scene, camera, cfg, backend_, key, offset=(0.0, 0.0), sample_constrain=None):
        cam = camera_from_numpy(jax_leaves(camera))
        return jnp.asarray(tw._render_flat(t, cam, tcfg, backend, None, offset).numpy())

    monkeypatch.setattr(jw, "_render_flat", port_flat)
    with jax.disable_jit():
        want = np.asarray(jw.render_image(j, jcam, jrt.RenderConfig(**size, **flags),
                                          backend=object()))
    got = tw.render_image(t, tcam, tcfg, backend=backend).numpy()
    np.testing.assert_allclose(got, want, **FN)
    assert (got.max(axis=-1) > 0.02).mean() > 0.2


def spherical_box():
    _, t = scene_pair("mirror_box")
    return dataclasses.replace(t, spherical_lights=trt.SphericalLights.of(
        ((0.0, 0.4, 0.0), 0.1, (1.0, 1.0, 1.0))))


# The card's route on the CPU: the sampler kernels' plain twins.
SPHERICAL = dict(backend="cuda", soft_shadow_kernel="on", soft_shadow_samples=4)


@pytest.mark.parametrize("flags", [dict(anti_aliasing=True), dict(motion_blur=True),
                                   dict(anti_aliasing=True, bloom=True, reference_quirks=True)],
                         ids=combo_id)
def test_spherical_key_is_drawn_once_per_frame(flags):
    t = spherical_box()
    cam = trt.Camera.default(device="cpu")
    cfg = trt.RenderConfig(width=24, height=24, **SPHERICAL, **flags)
    gen = torch.Generator().manual_seed(5)
    img = tw.render_image(t, cam, cfg, generator=gen)
    once = torch.Generator().manual_seed(5)
    key = soft.draw_key(once)
    assert torch.equal(gen.get_state(), once.get_state())
    backend = tw.make_backend(t, cfg)
    if flags == dict(anti_aliasing=True):
        subs = [tw._render_flat(t, cam, cfg, backend, key, off) for off in te.AA_OFFSETS]
        assert torch.equal(img, (subs[0] + subs[1] + subs[2] + subs[3]) / 4.0)
        # The samples differ from another key's.
        other = tw._render_flat(t, cam, cfg, backend, soft.SampleKey(1, 2), (0.0, 0.0))
        assert not torch.equal(other, subs[0])
    # The key as the generator gives the same frame.
    assert torch.equal(tw.render_image(t, cam, cfg, generator=key), img)


ROWS = (slice(0, 7), slice(7, 18), slice(18, 24))


@pytest.mark.parametrize("flags", [dict(), dict(anti_aliasing=True, motion_blur=True),
                                   dict(reference_quirks=True, anti_aliasing=True)],
                         ids=combo_id)
def test_render_rows_tiles_are_the_frame(flags):
    _, t = scene_pair("mirror_box")
    cam = trt.Camera.default(device="cpu")
    for scene, cfg in ((t, trt.RenderConfig(backend="cuda", **flags)),
                       (spherical_box(), trt.RenderConfig(**SPHERICAL, **flags))):
        cfg = dataclasses.replace(cfg, width=24, height=24, ray_chunk=100)
        full = tw.render_image(scene, cam, cfg, generator=torch.Generator().manual_seed(3))
        tiles = [tw.render_rows(scene, cam, cfg, rows,
                                generator=torch.Generator().manual_seed(3)) for rows in ROWS]
        assert torch.equal(torch.cat(tiles), full)


def test_render_rows_matches_jax():
    j, t = scene_pair("mirror_box")
    jcam = jrt.Camera.default()
    tcam = camera_from_numpy(jax_leaves(jcam))
    jcfg = jrt.RenderConfig(width=24, height=24, backend="brute")
    cfg = trt.RenderConfig(width=24, height=24, backend="brute")
    got, want = [], []
    for rows in ROWS:
        want.append(np.asarray(jw.render_rows(j, jcam, jcfg, rows)))
        got.append(tw.render_rows(t, tcam, cfg, rows).numpy())
        assert got[-1].shape == want[-1].shape == (rows.stop - rows.start, 24, 3)
    # The allowance is a frame's: the tiles put together.
    assert_images_close(np.concatenate(got), np.concatenate(want), msg="tiles")


def test_render_rows_refuses_bloom_and_strided_slices():
    _, t = scene_pair("mirror_box")
    cam = trt.Camera.default(device="cpu")
    with pytest.raises(ValueError, match="bloom"):
        tw.render_rows(t, cam, trt.RenderConfig(width=8, height=8, bloom=True), slice(0, 4))
    with pytest.raises(ValueError, match="contiguous"):
        tw.render_rows(t, cam, trt.RenderConfig(width=8, height=8), slice(0, 8, 2))


def test_grad_through_aa_and_bloom_matches_jax():
    j, t = scene_pair("mixed_tris")
    flags = dict(width=16, height=16, backend="brute", anti_aliasing=True, bloom=True)
    jcfg, cfg = jrt.RenderConfig(**flags), trt.RenderConfig(**flags)
    params = {k: np.asarray(v) for k, v in jinv.material_params(j).items()}

    def j_loss(p):
        s = jinv.apply_material_params(j, p)
        return jw.render_image(s, jrt.Camera.default(), jcfg, backend=jw.make_backend(s, jcfg),
                               key=jax.random.PRNGKey(0)).mean()

    j_grads = jax.jit(jax.grad(j_loss))({k: jnp.asarray(v) for k, v in params.items()})
    leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(params).items()}
    img = tw.render_image(tinv.apply_material_params(t, leaves), trt.Camera.default(device="cpu"),
                          cfg)
    np.testing.assert_allclose(img.mean().item(), float(j_loss(params)), rtol=1e-5)
    img.mean().backward()
    assert set(j_grads) == set(leaves)
    for k, g in j_grads.items():
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(g), **GRAD,
                                   err_msg=f"d/d{k}")
        assert np.abs(np.asarray(g)).sum() > 0, k
