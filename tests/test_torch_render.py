"""PyTorch port, the whole forward slice: ``render`` against the JAX package.

The 32-triangle stand-in mirror box is held to JAX ``backend='brute'`` (the
JAX package's own tests pin that path to its Pallas kernels; running them in
interpret mode on 32 triangles would take close to a minute per config).  The
``spheres`` preset and a triangles + spheres scene (12 triangles, two spheres,
one glossy) are held to JAX ``backend='pallas'``, whose kernels run in
interpret mode.  The port renders
through ``backend='brute'`` and through ``backend='cuda'``, whose kernels run
as their plain twins on CPU tensors, with ``forward_only`` on (trace kernel)
and off (bounce kernel + shading).  Images: ``assert_images_close``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import cg_raytracer_tpu as jrt
import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu_torch.interop import camera_from_numpy
from cg_raytracer_tpu_torch.models import whitted as tw
from tests.conftest import assert_images_close
from tests.test_torch_scene import jax_leaves, scene_pair

SIZE = 32


def cameras():
    jc = jrt.Camera.default()
    return jc, camera_from_numpy(jax_leaves(jc))


def port_renders(scene, cam, **cfg):
    """The port's image through each route: brute, and cuda with and without
    the forward-only trace kernel."""
    out = {}
    for backend, fo in (("brute", False), ("cuda", False), ("cuda", True)):
        c = trt.RenderConfig(width=SIZE, height=SIZE, backend=backend, forward_only=fo, **cfg)
        out[(backend, fo)] = trt.render(scene, cam, c)
    return out


@pytest.mark.parametrize("quirks", [False, True])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("name", ["mirror_box", "mixed", "spheres"])
def test_scene_matches_jax_brute(name, depth, quirks):
    j, t = scene_pair(name)
    jc, tc = cameras()
    ref = np.asarray(jrt.render(j, jc, jrt.RenderConfig(width=SIZE, height=SIZE, backend="brute",
                                                        max_depth=depth,
                                                        reference_quirks=quirks)))
    for route, img in port_renders(t, tc, max_depth=depth, reference_quirks=quirks).items():
        assert img.shape == (SIZE, SIZE, 3) and img.dtype == torch.float32
        assert_images_close(img.numpy(), ref, msg=f"{name} {route} depth={depth}")
    assert (ref.max(axis=-1) > 0.02).mean() > 0.05


def test_mirror_box_depth_and_quirks_change_the_image():
    _, t = scene_pair("mirror_box")
    _, tc = cameras()
    imgs = {(d, q): trt.render(t, tc, trt.RenderConfig(width=SIZE, height=SIZE, max_depth=d,
                                                       reference_quirks=q)).numpy()
            for d in (1, 2) for q in (False, True)}
    # The mirror adds light at depth 2; the red wall's ks.x is only reflective
    # without the ks.z quirk.
    assert np.abs(imgs[(2, False)] - imgs[(1, False)]).max() > 0.01
    assert np.abs(imgs[(2, False)] - imgs[(2, True)]).max() > 1e-3
    np.testing.assert_array_equal(imgs[(1, False)], imgs[(1, True)])


@pytest.mark.parametrize("forward_only", [True, False])
def test_spheres_matches_jax_pallas(forward_only):
    j, t = scene_pair("spheres")
    jc, tc = cameras()
    cfg = dict(width=SIZE, height=SIZE, forward_only=forward_only)
    ref = np.asarray(jrt.render(j, jc, jrt.RenderConfig(backend="pallas", **cfg)))
    img = trt.render(t, tc, trt.RenderConfig(backend="cuda", **cfg))
    assert_images_close(img.numpy(), ref, msg=f"spheres forward_only={forward_only}")
    assert (ref.max(axis=-1) > 0.02).mean() > 0.05


@pytest.mark.parametrize("forward_only", [True, False])
def test_mixed_scene_matches_jax_pallas(forward_only):
    # forward_only: the trace kernel; otherwise the closest-hit and any-hit
    # kernels (a scene with spheres has no fused bounce).  Depth 2 is live.
    j, t = scene_pair("mixed")
    jc, tc = cameras()
    cfg = dict(width=SIZE, height=SIZE, forward_only=forward_only)
    ref = np.asarray(jrt.render(j, jc, jrt.RenderConfig(backend="pallas", **cfg)))
    for backend in ("cuda", "brute"):
        img = trt.render(t, tc, trt.RenderConfig(backend=backend, **cfg))
        assert_images_close(img.numpy(), ref, msg=f"mixed {backend} forward_only={forward_only}")
    assert (ref.max(axis=-1) > 0.02).mean() > 0.15


def test_effective_max_depth_matches_jax():
    for name in ("mirror_box", "mixed", "spheres"):
        j, t = scene_pair(name)
        for q in (False, True):
            assert tw.effective_max_depth(t, trt.RenderConfig(reference_quirks=q)) == \
                jrt.models.whitted.effective_max_depth(j, jrt.RenderConfig(reference_quirks=q))


def test_make_backend_routes():
    _, box = scene_pair("mirror_box")
    _, mixed = scene_pair("mixed")
    brute = tw.make_backend(box, trt.RenderConfig())
    assert brute.bounce is None and brute.trace is None
    cuda = tw.make_backend(box, trt.RenderConfig(backend="cuda", forward_only=True))
    assert cuda.bounce is not None and cuda.trace is not None
    assert tw.make_backend(box, trt.RenderConfig(backend="cuda")).trace is None
    assert tw.make_backend(mixed, trt.RenderConfig(backend="cuda")).bounce is None
    cfg = trt.RenderConfig()
    assert cfg.resolve_backend(32, torch.device("cpu")) == "brute"
    assert cfg.resolve_backend(32, torch.device("cuda")) == "cuda"
    with pytest.raises(ValueError, match="brute"):
        trt.RenderConfig(backend="brute").resolve_backend(32, torch.device("cuda"))
    with pytest.raises(ValueError):
        trt.RenderConfig(backend="pallas").resolve_backend(32, torch.device("cpu"))


def test_ray_chunk_gives_the_same_image():
    _, t = scene_pair("mirror_box")
    _, tc = cameras()
    cfg = trt.RenderConfig(width=SIZE, height=SIZE, backend="cuda")
    whole = trt.render(t, tc, cfg)
    chunked = trt.render(t, tc, dataclasses.replace(cfg, ray_chunk=300))
    assert torch.equal(whole, chunked)


def test_unported_features_raise():
    _, t = scene_pair("mirror_box")
    _, tc = cameras()
    small = dict(width=8, height=8)
    for flag in ("anti_aliasing", "bloom", "motion_blur"):
        with pytest.raises(NotImplementedError, match="A9"):
            trt.render(t, tc, trt.RenderConfig(**small, **{flag: True}))
    # The two-phase structure is ported (it renders the one-phase image).
    torch.testing.assert_close(trt.render(t, tc, trt.RenderConfig(**small, grad_two_phase="on")),
                               trt.render(t, tc, trt.RenderConfig(**small)))
    sph = dataclasses.replace(t, spherical_lights=trt.SphericalLights.of(((0, 0.4, 0), 0.1,
                                                                         (1, 1, 1))))
    for two_phase in ("off", "on"):
        with pytest.raises(NotImplementedError, match="A8"):
            trt.render(sph, tc, trt.RenderConfig(**small, grad_two_phase=two_phase))
    teacup = trt.load_scene("teacup")
    with pytest.raises(NotImplementedError, match="B5"):
        tw.make_backend(teacup, trt.RenderConfig(backend="cuda"))
    with pytest.raises(NotImplementedError, match="A6"):
        tw.make_backend(teacup, trt.RenderConfig())


def test_forward_only_render_cannot_be_differentiated():
    _, t = scene_pair("mirror_box")
    _, tc = cameras()
    t.materials.kd.requires_grad_(True)
    img = trt.render(t, tc, trt.RenderConfig(width=8, height=8, backend="cuda",
                                             forward_only=True))
    with pytest.raises(NotImplementedError, match="forward_only"):
        img.mean().backward()
    # The default path differentiates through reconstruct + shade.
    img = trt.render(t, tc, trt.RenderConfig(width=8, height=8, backend="cuda"))
    img.mean().backward()
    assert torch.isfinite(t.materials.kd.grad).all() and t.materials.kd.grad.abs().sum() > 0
