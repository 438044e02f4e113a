"""PyTorch port: primary-ray generation against the JAX package (atol 1e-6)."""
import numpy as np
import pytest
import torch

import cg_raytracer_tpu as jrt
from cg_raytracer_tpu.ops import camera as jcam
from cg_raytracer_tpu_torch.interop import camera_from_numpy
from cg_raytracer_tpu_torch.ops import camera as tcam
from tests.test_torch_scene import jax_leaves

CAMERAS = [
    {},
    dict(euler_deg=(0.0, 0.0, 0.0), dist=3.0, look_at=(0.5, 0.5, 0.0)),
    dict(euler_deg=(-35.0, 140.0, 12.0), dist=1.7, fovy_deg=70.0, aspect=16 / 9,
         look_at=(0.1, -0.3, 0.2)),
]


@pytest.mark.parametrize("cam_kw", CAMERAS)
@pytest.mark.parametrize("hw", [(32, 32), (17, 29)])
def test_generate_rays_matches_jax(cam_kw, hw):
    h, w = hw
    jc = jrt.Camera.default(**cam_kw)
    tc = camera_from_numpy(jax_leaves(jc))
    jo, jd = jrt.generate_rays(jc, h, w)
    to, td = tcam.generate_rays(tc, h, w)
    assert to.shape == (h * w, 3) and td.shape == (h * w, 3)
    assert to.dtype == torch.float32 and td.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


def test_pixel_ndc_and_offset_match_jax():
    jc = jrt.Camera.default()
    tc = camera_from_numpy(jax_leaves(jc))
    for offset in ((0.0, 0.0), (0.25, 0.75)):
        np.testing.assert_array_equal(tcam.pixel_ndc(9, 13, offset=offset).numpy(),
                                      np.asarray(jcam.pixel_ndc(9, 13, offset=offset)))
        np.testing.assert_allclose(tcam.generate_rays(tc, 9, 13, offset)[1].numpy(),
                                   np.asarray(jcam.generate_rays(jc, 9, 13, offset=offset)[1]),
                                   rtol=0, atol=1e-6)
    # Row 0 is the top of the image (the largest screen y); pixels sample corners.
    ndc = tcam.pixel_ndc(4, 4)
    assert ndc[0, 0, 1] > ndc[-1, 0, 1] and ndc[0, 0, 0] == -1.0


def test_quaternion_helpers_match_jax():
    rng = np.random.default_rng(0)
    euler = rng.uniform(-3, 3, (16, 3)).astype(np.float32)
    vecs = rng.normal(size=(16, 3)).astype(np.float32)
    jq = np.asarray(jcam.quat_from_euler(euler))
    tq = tcam.quat_from_euler(torch.from_numpy(euler)).numpy()
    np.testing.assert_allclose(tq, jq, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tcam.quat_rotate(torch.tensor(jq), torch.tensor(vecs)).numpy(),
                               np.asarray(jcam.quat_rotate(jq, vecs)), rtol=0, atol=1e-5)
    jc = jrt.Camera.default(euler_deg=(10, -50, 3), dist=2.0)
    np.testing.assert_allclose(tcam.camera_position(camera_from_numpy(jax_leaves(jc))).numpy(),
                               np.asarray(jcam.camera_position(jc)), rtol=0, atol=1e-6)


def test_trackball_controls_match_jax():
    # tests/test_camera.py:75-89's interactions on both packages.
    jc = jrt.Camera.default()
    tc = camera_from_numpy(jax_leaves(jc))
    for move, arg in ((tcam.orbit, (10.0, -2000.0)), (tcam.orbit, (35.0, 12.0)),
                      (tcam.pan, (100.0, 0.0)), (tcam.pan, (-7.0, 33.0)),
                      (tcam.zoom, 1000.0), (tcam.zoom, -1000.0), (tcam.zoom, 0.8)):
        want = getattr(jcam, move.__name__)(jc, arg)
        got = move(tc, arg)
        for a, b in zip((got.look_at, got.euler, got.dist, got.fovy, got.aspect),
                        jax_leaves(want)):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7)
    assert np.isclose(float(tcam.orbit(tc, (10.0, -2000.0)).euler[0]), np.pi / 2)
    assert np.isclose(float(tcam.zoom(tc, 1000.0).dist), 0.1)
    assert np.isclose(float(tcam.zoom(tc, -1000.0).dist), 100.0)
    c3 = tcam.pan(tc, (100.0, 0.0))
    assert not torch.allclose(c3.look_at, tc.look_at) and torch.equal(c3.euler, tc.euler)
