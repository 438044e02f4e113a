"""PyTorch port, the tree-width slice: ``render`` under ``bvh_wide='2'``,
``'8'`` and ``bvh_wide_hbm='2'`` against the JAX package's
``backend='pallas'`` (its binary B13/B14 and 8-wide B15 kernels in interpret
mode).

Scene: the cup (two point lights, ks 0.3, depth 2) at 16x16; the port with
``backend='cuda'`` (the twins on CPU tensors).  ``bvh_wide_hbm='2'`` runs
the cup as the large tier: the port's ``VMEM_MAX_TRIS`` set below the cup's
count, and JAX honouring an explicitly built streaming tree, both walking
one binary tree (median, leaf 14).  Tolerance: ``assert_images_close``
(0.5% of pixels may differ: coincident-t ties).
"""
import jax
import numpy as np
import pytest

import cg_raytracer_tpu as jrt
import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu.models import whitted as jw
from cg_raytracer_tpu.ops import pallas_bvh as jpb
from cg_raytracer_tpu.utils.config import RenderConfig as JConfig
from cg_raytracer_tpu_torch.models import whitted as tw
from cg_raytracer_tpu_torch.ops import bvh4 as tb4
from tests.conftest import assert_images_close
from tests.test_torch_bvh import cup_pair
from tests.test_torch_bvhw import TWO_LIGHTS, carried

SIZE = 16


def _jax_render(j, jcfg, bvh=None):
    return np.asarray(jw.render_image(j, jrt.Camera.default(), jcfg,
                                      backend=jw.make_backend(j, jcfg, bvh=bvh),
                                      key=jax.random.PRNGKey(0)))


@pytest.mark.parametrize("knob", ["bvh_wide=2", "bvh_wide=8", "bvh_wide_hbm=2"])
def test_width_renders_match_jax(knob, monkeypatch):
    j, t = cup_pair(ks=0.3, lights=TWO_LIGHTS)
    field, value = knob.split("=")
    switches = dict(width=SIZE, height=SIZE, **{field: value})
    jcfg, cfg = JConfig(backend="pallas", **switches), trt.RenderConfig(backend="cuda", **switches)
    accel = None
    if field == "bvh_wide_hbm":
        # The cup as the large tier: JAX's explicit streaming tree, and the
        # port's width-2 collapse of the same binary tree.
        bvh_h, hbm = jpb.build_hbm_bvh(j, leaf_rows=1)
        j_img = _jax_render(j, jcfg, bvh=hbm)
        monkeypatch.setattr(tb4, "VMEM_MAX_TRIS", 1000)
        assert tw.tree_width(t, cfg) == 2 and cfg.resolve_bvh_wide() == "4"
        accel = tb4.collapse_bvhw(carried(bvh_h), 2)
    else:
        j_img = np.asarray(jrt.render(j, jrt.Camera.default(), jcfg))
        assert tw.tree_width(t, cfg) == int(value)
    tree = accel if accel is not None else tw.build_accel(t, cfg)
    assert isinstance(tree, tb4.BVH4) and tree.width == int(value)
    t_img = trt.render(t, trt.Camera.default(device="cpu"), cfg, accel=accel).numpy()
    assert_images_close(t_img, j_img, msg=knob)
    assert (j_img.max(axis=-1) > 0.02).mean() > 0.2
