"""PyTorch port, the mesh slice as a whole, training: render + masked mean +
backward of a mesh scene past 256 triangles against the JAX package, under
both two-phase contracts.

JAX renders with ``backend='pallas'``, ``grad_two_phase='on'`` and
``shade_kernel='on'``: phase 1 level by level through its 4-wide bounce
kernel, phase 2 through the pregathered shade kernel and its custom VJP,
both in interpret mode; its tree is built before ``jax.vjp`` (a traced
vertex cannot be read on the host) and passed as ``bvh``.  The port renders
with ``backend='cuda'`` and the same switches: on CPU tensors the 4-wide
bounce twin and ``shade_plain_pre``.  Scene: the reflective lathed cup at
24x24, depth 2; 'exact' differentiates materials, lights and vertices,
'recorded' materials and lights.  As ``test_torch_train.py``: the loss masks
pixels where the two images differ by more than 1e-4 (tie-break pixels);
images as ``assert_images_close``; gradients rtol 2e-4, atol 1e-5 (vertices
atol 2e-5).
"""
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
from cg_raytracer_tpu_torch.interop import params_from_numpy
from cg_raytracer_tpu_torch.optim import inverse as tinv
from tests.conftest import assert_images_close
from tests.test_torch_bvh import cup_pair
from tests.test_torch_mesh import TWO_LIGHTS
from tests.test_torch_train import GRAD, _apply

SIZE = 24


@pytest.mark.parametrize("rays", ["exact", "recorded"])
def test_mesh_two_phase_render_and_grads_match_jax(rays):
    j, t = cup_pair(ks=0.3, lights=TWO_LIGHTS)
    vertices = rays == "exact"
    params = {k: np.asarray(v) for k, v in jinv.material_params(j).items()}
    if vertices:
        params["vertices"] = np.asarray(j.vertices)
    switches = dict(width=SIZE, height=SIZE, grad_two_phase="on", shade_kernel="on",
                    two_phase_rays=rays)
    jcfg = JConfig(backend="pallas", **switches)
    _, packed = jb4.build_packed_bvh4(j, max_leaf=jcfg.resolve_pallas_bvh_max_leaf(),
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
    t_img = trt.render_image(_apply(t, leaves, tinv), trt.Camera.default(device="cpu"), cfg)
    assert_images_close(t_img.detach().numpy(), j_img, msg=f"mesh two-phase {rays}")
    assert (j_img.max(axis=-1) > 0.02).mean() > 0.2

    mask = (np.abs(t_img.detach().numpy() - j_img).max(axis=-1) <= 1e-4).astype(np.float32)
    ct = np.repeat(mask[..., None], 3, axis=-1) / mask.size / 3
    (t_img * torch.from_numpy(ct)).sum().backward()
    j_grads = {k: np.asarray(v) for k, v in vjp(jnp.asarray(ct))[0].items()}
    assert set(j_grads) == set(leaves)
    for k, g in j_grads.items():
        tol = dict(GRAD, atol=2e-5) if k == "vertices" else GRAD
        np.testing.assert_allclose(leaves[k].grad.numpy(), g, **tol, err_msg=f"{rays} d/d{k}")
        assert np.abs(g).sum() > 0, k
