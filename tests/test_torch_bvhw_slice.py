"""PyTorch port, the tree-width slice as a whole, on the CPU: the samplers
over the binary tree (B12 'sample', B11 'cone') against the JAX package's
table kernels in interpret mode, a training step under ``bvh_wide='2'``
against JAX's ``backend='pallas'``, and the spherical cup under every width
and tile (the renders under each width knob: ``test_torch_bvhw_render.py``).

- Samplers: the port's table twins on the binary collapse of JAX's own
  tree (median, leaf 14) against ``soft_shadow_counts_pallas_bvh(gauss=)``
  (4 samples: JAX unrolls one walk per sample) and
  ``soft_shadow_counts_pallas_bvh_cone(gauss=)`` (32 samples, one pass) on
  the same numpy Gaussians: counts exact.  The same counts from the 4- and
  8-wide collapses of that tree (an any-hit count does not depend on it).
- One two-phase step (materials, lights, vertices) under ``bvh_wide='2'``:
  gradients rtol 2e-4, atol 1e-5 (vertices atol 2e-5), as
  ``test_torch_mesh_train.py``.
- The spherical cup with the twins under ('4', 'cone'), ('2', 'sample'),
  ('2', 'cone') and ('8', 'cone'), one key: images equal within the 0.5%
  tie allowance.
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
from cg_raytracer_tpu.ops import pallas_bvh as jpb
from cg_raytracer_tpu.optim import inverse as jinv
from cg_raytracer_tpu.utils.config import RenderConfig as JConfig
from cg_raytracer_tpu_torch.interop import params_from_numpy
from cg_raytracer_tpu_torch.models import whitted as tw
from cg_raytracer_tpu_torch.ops import bvh4 as tb4
from cg_raytracer_tpu_torch.ops import soft
from cg_raytracer_tpu_torch.optim import inverse as tinv
from tests.conftest import assert_images_close
from tests.test_torch_bvh import cup_pair
from tests.test_torch_bvhw import TWO_LIGHTS, carried
from tests.test_torch_soft import gaussians, hit_points, spherical_pair
from tests.test_torch_train import GRAD, _apply

SIZE = 16


@pytest.mark.parametrize("tile,num", [("sample", 4), ("cone", 32)])
def test_binary_table_samplers_match_jax(tile, num):
    j, t = spherical_pair("cup")
    pos, valid = hit_points(j, SIZE)
    g = gaussians((num, pos.shape[0], 3), seed=5)
    lpos, lrad = j.spherical_lights.position[0], j.spherical_lights.radius[0]
    jt, packed = jpb.build_packed_bvh(j, max_leaf=14, builder="median")
    run = (jpb.soft_shadow_counts_pallas_bvh if tile == "sample"
           else jpb.soft_shadow_counts_pallas_bvh_cone)
    want = np.asarray(run(j, packed, jnp.asarray(pos), lpos, lrad, None, num, interpret=True,
                          gauss=jnp.asarray(g)))
    twin = soft.soft_bvh_table_plain if tile == "sample" else soft.soft4_table_plain
    args = (torch.from_numpy(pos), t.spherical_lights.position[0],
            t.spherical_lights.radius[0], torch.from_numpy(g))
    bvh = carried(jt)
    counts = {w: twin(t, tb4.collapse_bvhw(bvh, w), *args, valid=torch.from_numpy(valid))
              for w in tb4.WIDTHS}
    np.testing.assert_array_equal(counts[2].numpy()[valid], want[valid],
                                  err_msg=f"{tile}: counts differ from JAX's")
    for w in (4, 8):
        assert torch.equal(counts[w], counts[2]), f"{tile}: width {w} counts differ"
    frac = want[valid] / num
    assert ((frac > 0) & (frac < 1)).any() and (frac == 1).any()


def test_width2_two_phase_grads_match_jax():
    j, t = cup_pair(ks=0.3, lights=TWO_LIGHTS)
    params = {k: np.asarray(v) for k, v in jinv.material_params(j).items()}
    params["vertices"] = np.asarray(j.vertices)
    switches = dict(width=SIZE, height=SIZE, grad_two_phase="on", shade_kernel="on",
                    bvh_wide="2")
    jcfg = JConfig(backend="pallas", **switches)
    _, packed = jpb.build_packed_bvh(j, max_leaf=jcfg.resolve_pallas_bvh_max_leaf(),
                                     builder=jcfg.resolve_bvh_builder(j.num_triangles))

    def f(p):
        s = _apply(j, p, jinv)
        return jw.render_image(s, jrt.Camera.default(), jcfg,
                               backend=jw.make_backend(s, jcfg, bvh=packed),
                               key=jax.random.PRNGKey(0))

    j_img, vjp = jax.vjp(f, {k: jnp.asarray(v) for k, v in params.items()})
    j_img = np.asarray(j_img)
    leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(params).items()}
    cfg = trt.RenderConfig(backend="cuda", **switches)
    accel = tw.build_accel(t, cfg)
    assert accel.width == 2
    t_img = trt.render_image(_apply(t, leaves, tinv), trt.Camera.default(device="cpu"), cfg,
                             backend=tw.make_backend(t, cfg, accel=accel))
    assert_images_close(t_img.detach().numpy(), j_img, msg="bvh_wide='2' two phase")
    mask = (np.abs(t_img.detach().numpy() - j_img).max(axis=-1) <= 1e-4).astype(np.float32)
    ct = np.repeat(mask[..., None], 3, axis=-1) / mask.size / 3
    (t_img * torch.from_numpy(ct)).sum().backward()
    j_grads = {k: np.asarray(v) for k, v in vjp(jnp.asarray(ct))[0].items()}
    assert set(j_grads) == set(leaves)
    for k, want in j_grads.items():
        tol = dict(GRAD, atol=2e-5) if k == "vertices" else GRAD
        np.testing.assert_allclose(leaves[k].grad.numpy(), want, **tol, err_msg=f"d/d{k}")
        assert np.abs(want).sum() > 0, k


def test_spherical_cup_renders_alike_at_every_width_and_tile():
    _, t = spherical_pair("cup")
    cam = trt.Camera.default(device="cpu")
    base = trt.RenderConfig(width=SIZE, height=SIZE, backend="cuda", soft_shadow_kernel="on",
                            soft_shadow_samples=16)
    images = {}
    for wide, tile in (("4", "cone"), ("2", "sample"), ("2", "cone"), ("8", "cone")):
        cfg = dataclasses.replace(base, bvh_wide=wide, soft_shadow_tile=tile)
        images[(wide, tile)] = trt.render(t, cam, cfg, generator=torch.Generator().manual_seed(3))
    ref = images[("4", "cone")].numpy()
    assert (ref.max(axis=-1) > 0.02).mean() > 0.15
    for key, img in images.items():
        assert_images_close(img.numpy(), ref, msg=f"{key} vs ('4', 'cone')")
