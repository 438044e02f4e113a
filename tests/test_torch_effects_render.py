"""PyTorch port: ``render_image`` with the effects against the JAX package's,
render for render (``test_torch_effects.py`` holds the composition on
identical sub-renders).

Both packages render with ``backend='brute'`` at 24x24.  Allowance: each
sub-render is held to the backend contract's tie-break allowance
(``assert_images_close``: 0.5% of pixels past 1e-4), so an average of n
sub-renders (4 under AA, 16 or 15 under motion blur, 64 or 60 with both) may
differ on n x 0.5% of its pixels, each by the tie pixel's difference over
n.  Bloom spreads a tie pixel past the threshold over its 21x21 window (the
quirk blur over every later pixel it reaches), so no pixel allowance carries
through it: the bloom combinations are held here on the triangles + spheres
scene, whose frames have no tie pixel, at the contract's allowance.
"""
import itertools

import numpy as np
import pytest

import cg_raytracer_tpu as jrt
import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu_torch.interop import camera_from_numpy
from tests.conftest import assert_images_close
from tests.test_torch_effects import combo_id
from tests.test_torch_scene import jax_leaves, scene_pair

SIZE = 24


def renders(name, flags):
    j, t = scene_pair(name)
    jcam = jrt.Camera.default()
    ref = np.asarray(jrt.render(j, jcam, jrt.RenderConfig(width=SIZE, height=SIZE,
                                                          backend="brute", **flags)))
    img = trt.render(t, camera_from_numpy(jax_leaves(jcam)),
                     trt.RenderConfig(width=SIZE, height=SIZE, backend="brute", **flags))
    assert img.shape == (SIZE, SIZE, 3)
    return img.numpy(), ref


@pytest.mark.parametrize("flags", [dict(zip(("anti_aliasing", "motion_blur", "reference_quirks"),
                                            bits))
                                   for bits in itertools.product((False, True), repeat=3)],
                         ids=combo_id)
def test_render_image_matches_jax(flags):
    img, ref = renders("mirror_box", flags)
    subs = (4 if flags["anti_aliasing"] else 1) * (16 if flags["motion_blur"] else 1)
    assert_images_close(img, ref, max_bad_fraction=0.005 * subs, msg=combo_id(flags))
    assert (ref.max(axis=-1) > 0.02).mean() > 0.2


@pytest.mark.parametrize("flags", [dict(bloom=True, anti_aliasing=aa, reference_quirks=q)
                                   for aa in (False, True) for q in (False, True)],
                         ids=combo_id)
def test_bloom_renders_match_jax(flags):
    img, ref = renders("mixed", flags)
    assert_images_close(img, ref, msg=combo_id(flags))
    _, t = scene_pair("mixed")
    plain = trt.render(t, trt.Camera.default(device="cpu"),
                       trt.RenderConfig(width=SIZE, height=SIZE, backend="brute")).numpy()
    assert (img - plain).max() > 1e-3  # the bloom added light
