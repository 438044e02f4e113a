"""PyTorch port, the training slice as a whole: the two-phase render and its
gradients against the JAX package's two-phase kernel path.

JAX renders with ``backend='pallas'``, ``grad_two_phase='on'`` and
``shade_kernel='on'``: the record-trace kernel and the fused shade kernel
with its custom VJP, in interpret mode.  The port renders with
``backend='cuda'`` and the same switches: on CPU tensors the record-trace
and shade kernels' plain twins.  Scene: ``mixed_tris`` (12 triangles, two
point lights, one reflective material) at 24x24, depth 2, under both
two-phase ray contracts: 'exact' differentiates materials, lights and
vertices; 'recorded' (the materials-only contract) materials and lights.

The loss is the image's mean with a mask: 0 wherever the two packages'
images differ by more than 1e-4 (a tie-break pixel, where the two hit
different triangles; a single such pixel moves a kd gradient by percents).
Tolerances: images as ``assert_images_close``; gradients rtol 2e-4, atol
1e-5 (vertices atol 2e-5).
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
from cg_raytracer_tpu.optim import inverse as jinv
from cg_raytracer_tpu.utils.config import RenderConfig as JConfig
from cg_raytracer_tpu_torch.interop import params_from_numpy
from cg_raytracer_tpu_torch.models import whitted as tw
from cg_raytracer_tpu_torch.optim import inverse as tinv
from cg_raytracer_tpu_torch.utils import bench as tbench
from tests.conftest import assert_images_close
from tests.test_torch_scene import scene_pair

SIZE = 24
GRAD = dict(rtol=2e-4, atol=1e-5)


def _apply(scene, params, inv):
    scene = inv.apply_material_params(scene, params)
    if "vertices" in params:
        scene = inv.apply_vertex_params(scene, params)
    return scene


def jax_render_vjp(j_scene, params, cfg):
    def f(p):
        s = _apply(j_scene, p, jinv)
        return jw.render_image(s, jrt.Camera.default(), cfg, backend=jw.make_backend(s, cfg),
                               key=jax.random.PRNGKey(0))

    img, vjp = jax.vjp(f, {k: jnp.asarray(v) for k, v in params.items()})
    return np.asarray(img), lambda ct: {k: np.asarray(v)
                                        for k, v in vjp(jnp.asarray(ct))[0].items()}


@pytest.mark.parametrize("rays", ["exact", "recorded"])
def test_two_phase_render_and_grads_match_jax(rays):
    j, t = scene_pair("mixed_tris")
    vertices = rays == "exact"
    params = {k: np.asarray(v) for k, v in jinv.material_params(j).items()}
    if vertices:
        params["vertices"] = np.asarray(j.vertices)
    switches = dict(width=SIZE, height=SIZE, grad_two_phase="on", shade_kernel="on",
                    two_phase_rays=rays)
    j_img, j_vjp = jax_render_vjp(j, params, JConfig(backend="pallas", **switches))

    leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(params).items()}
    cfg = trt.RenderConfig(backend="cuda", **switches)
    scene = _apply(t, leaves, tinv)
    t_img = trt.render_image(scene, trt.Camera.default(), cfg)
    assert_images_close(t_img.detach().numpy(), j_img, msg=f"two-phase {rays}")
    assert (j_img.max(axis=-1) > 0.02).mean() > 0.2

    mask = (np.abs(t_img.detach().numpy() - j_img).max(axis=-1) <= 1e-4).astype(np.float32)
    ct = np.repeat(mask[..., None], 3, axis=-1) / mask.size / 3
    (t_img * torch.from_numpy(ct)).sum().backward()
    j_grads = j_vjp(ct)
    assert set(j_grads) == set(leaves)
    for k, g in j_grads.items():
        tol = dict(GRAD, atol=2e-5) if k == "vertices" else GRAD
        np.testing.assert_allclose(leaves[k].grad.numpy(), g, **tol, err_msg=f"{rays} d/d{k}")
        assert np.abs(g).sum() > 0, k


def test_two_phase_matches_one_phase_on_the_stand_in_box():
    # Phase 1 only moves the differentiation boundary: 'exact' gives the
    # one-phase gradients for every parameter, 'recorded' for materials and
    # lights.  Vertex gradients stay finite on both paths.
    _, t = scene_pair("mirror_box")
    cam, jitter = trt.Camera.default(), torch.zeros(3)
    params = tbench.training_params(t, include_vertex_params=True)
    one = trt.RenderConfig(width=SIZE, height=SIZE)
    _, g_one = tbench.fwd_bwd_step(t, cam, one, params, jitter)
    for backend in ("brute", "cuda"):
        for rays in ("exact", "recorded"):
            cfg = dataclasses.replace(one, backend=backend, grad_two_phase="on",
                                      shade_kernel="on", two_phase_rays=rays)
            _, g = tbench.fwd_bwd_step(t, cam, cfg, params, jitter)
            for k, v in g.items():
                assert bool(torch.isfinite(v).all()), (backend, rays, k)
                if k == "vertices" and rays == "recorded":
                    continue  # the reflected-origin term is dropped
                torch.testing.assert_close(v, g_one[k], rtol=1e-5, atol=1e-7,
                                           msg=f"{backend} {rays} d/d{k}")
    assert bool(torch.isfinite(g_one["vertices"]).all()) and g_one["vertices"].abs().sum() > 0


def test_training_step_routes_through_records_and_the_shade_twin():
    from cg_raytracer_tpu_torch.ops import cuda_kernels as ck
    from cg_raytracer_tpu_torch.ops import shade

    _, t = scene_pair("mirror_box")
    cfg = tbench.training_config(trt.RenderConfig(width=8, height=8, backend="cuda"), False)
    assert cfg.grad_two_phase == "on" and cfg.two_phase_rays == "recorded"
    assert not cfg.resolve_shade_kernel(t.device)  # 'auto' is off on the CPU
    cfg = dataclasses.replace(cfg, shade_kernel="on")
    assert tbench.training_config(trt.RenderConfig(), True).two_phase_rays == "auto"
    backend = tw.make_backend(t, cfg)
    assert backend.record_trace is not None and backend.bounce_refl is not None
    assert backend.shade is shade.shade_fused_cuda
    assert tw.make_backend(t, cfg, plain=True).shade is shade.shade_fused_plain
    brute_cfg = dataclasses.replace(cfg, backend="brute")
    assert tw.make_backend(t, brute_cfg).shade is shade.shade_fused_cuda
    assert tw.make_backend(t, brute_cfg, plain=True).shade is shade.shade_fused_plain
    _, mixed = scene_pair("mixed")  # spheres: no fused bounce, records are synthesised
    assert tw.make_backend(mixed, cfg).record_trace is None
    calls = []
    wrapped = backend._replace(shade=lambda *a: calls.append(1) or shade.shade_fused_cuda(*a))
    img = tw.render_image(t, trt.Camera.default(), cfg, backend=wrapped)
    assert len(calls) == 2 and img.shape == (8, 8, 3)
    assert ck.launch_counts()["record_trace_cuda"] == 0  # CPU tensors: the twins


def test_config_resolves_like_jax():
    for field, values in (("grad_two_phase", ("auto", "on", "off")),
                          ("two_phase_rays", ("auto", "exact", "recorded")),
                          ("shade_kernel", ("auto", "on", "off"))):
        for v in values:
            tc, jc = trt.RenderConfig(**{field: v}), JConfig(**{field: v})
            if field == "grad_two_phase":
                assert tc.resolve_grad_two_phase() == jc.resolve_grad_two_phase()
            elif field == "two_phase_rays":
                assert tc.resolve_two_phase_rays() == jc.resolve_two_phase_rays()
            else:
                assert tc.resolve_shade_kernel(torch.device("cpu")) == \
                    jc.resolve_shade_kernel(platform="cpu")
                assert tc.resolve_shade_kernel(torch.device("cuda")) == \
                    jc.resolve_shade_kernel(platform="tpu")
        for cfg in (trt.RenderConfig(**{field: "bogus"}), JConfig(**{field: "bogus"})):
            with pytest.raises(ValueError, match=field):
                {"grad_two_phase": lambda c: c.resolve_grad_two_phase(),
                 "two_phase_rays": lambda c: c.resolve_two_phase_rays(),
                 "shade_kernel": lambda c: c.resolve_shade_kernel("cpu")}[field](cfg)


def test_run_bench_fwd_bwd_needs_cuda():
    _, t = scene_pair("mirror_box")
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench.run_bench(t, width=8, height=8, include_bwd=True, device="cpu")
