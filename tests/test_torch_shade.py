"""PyTorch port: the fused shade (phase 2 of the gradient structure) against
the JAX package's shade kernel.

``shade_fused_cuda`` on CPU tensors runs its plain twin ``shade_plain``; the
JAX ``shade_fused_pallas`` runs its Pallas kernels (forward, and the custom
VJP's backward) in interpret mode.  Both shade the same records (rays, prim
ids from the JAX brute-force oracle, shadow bits drawn with numpy) and take
the same random cotangent on their four outputs, scaled by 1/N as a mean
loss's is.  Interpret mode costs seconds per call: 12 triangles (+ 2 spheres)
at 32x32 camera rays, and one 32-triangle case at 24x24.

Tolerances: forward rtol 1e-5, atol 1e-6; gradients rtol 2e-4, atol 1e-5
(vertices atol 2e-5): sums over rays in another order, and the Pallas
backward's one-hot transpose.  Sphere hits are held apart: the quadratic's
discriminant cancels >= 100-fold for every hit of a 0.3-radius sphere seen
from 3 units (b^2 / disc >= |oc|^2 / r^2), so float32 keeps 2-3 digits fewer
there and XLA rounds it differently.  Their outputs are held to atol 1e-3,
and the gradients with their cotangent included to rtol 2e-3, atol 1e-4
(both packages sit up to ~0.5% off the float64 value of a sphere center's
gradient).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cg_raytracer_tpu as jrt
from cg_raytracer_tpu.ops import intersect as jint
from cg_raytracer_tpu.ops import pallas_shade as jshade
from cg_raytracer_tpu.optim import inverse as jinv
from cg_raytracer_tpu_torch.interop import params_from_numpy, scene_from_numpy
from cg_raytracer_tpu_torch.ops import intersect as tint
from cg_raytracer_tpu_torch.ops import shade as tshade
from cg_raytracer_tpu_torch.ops import shading as tshading
from cg_raytracer_tpu_torch.optim import inverse as tinv
from tests.test_torch_scene import jax_leaves, jax_scene, scene_pair

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=2e-4, atol=1e-5)


def records(j_scene, size, seed):
    o, d = (np.asarray(x) for x in jrt.generate_rays(jrt.Camera.default(), size, size))
    hit = jint.intersect_brute(j_scene, jnp.asarray(o), jnp.asarray(d))
    bits = np.random.default_rng(seed).integers(0, 4, o.shape[0]).astype(np.int32)
    return o, d, hit, bits


def scene_params(j_scene):
    """The differentiated leaves: material_params, vertices, normals and the
    spheres' centers and radii."""
    p = jinv.material_params(j_scene)
    p["vertices"], p["normals"] = j_scene.vertices, j_scene.normals
    if j_scene.spheres.radius.shape[0]:
        p["center"], p["radius"] = j_scene.spheres.center, j_scene.spheres.radius
    return {k: np.asarray(v) for k, v in p.items()}


def with_params(scene, params, inv):
    scene = inv.apply_material_params(scene, params)
    scene = dataclasses.replace(scene, vertices=params["vertices"], normals=params["normals"])
    if "center" in params:
        scene = dataclasses.replace(scene, spheres=dataclasses.replace(
            scene.spheres, center=params["center"], radius=params["radius"]))
    return scene


def jax_shade_vjp(j_scene, params, o, d, hit, bits, *cts):
    """JAX outputs and, per cotangent set in ``cts``, the gradient dict."""
    def f(p, o_, d_):
        direct, _, ks, normal, position = jshade.shade_fused_pallas(
            with_params(j_scene, p, jinv), o_, d_, hit, jnp.asarray(bits), interpret=True)
        return direct, ks, normal, position

    outs, vjp = jax.vjp(f, {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(o),
                        jnp.asarray(d))
    grads = []
    for ct in cts:
        g_params, g_o, g_d = vjp(tuple(jnp.asarray(c) for c in ct))
        grads.append({**{k: np.asarray(v) for k, v in g_params.items()},
                      "o": np.asarray(g_o), "d": np.asarray(g_d)})
    return [np.asarray(x) for x in outs], *grads


def port_shade_grads(t_scene, params, o, d, hit, bits, shade_fn, *cts):
    """The port's outputs and, per cotangent set in ``cts``, the gradient dict."""
    leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(params).items()}
    o_t = torch.from_numpy(o.copy()).requires_grad_(True)
    d_t = torch.from_numpy(d.copy()).requires_grad_(True)
    outs = shade_fn(with_params(t_scene, leaves, tinv), o_t, d_t, hit, torch.from_numpy(bits))
    wrt, names = [*leaves.values(), o_t, d_t], [*leaves, "o", "d"]
    grads = []
    for ct in cts:
        g = torch.autograd.grad(outs, wrt, [torch.from_numpy(c) for c in ct],
                                allow_unused=True, retain_graph=True)
        grads.append({k: (np.zeros(w.shape, np.float32) if x is None else x.numpy())
                      for k, w, x in zip(names, wrt, g)})
    return [x.detach().numpy() for x in outs], *grads


def fused_outputs(scene, o, d, hit, bits):
    direct, _, ks, normal, position = tshade.shade_fused_cuda(scene, o, d, hit, bits)
    return direct, ks, normal, position


def assert_close_to_jax(port, ref, loose, what):
    """Within FWD per ray, and within atol 1e-3 on the ``loose`` rays (sphere hits)."""
    np.testing.assert_allclose(port[~loose], ref[~loose], **FWD, err_msg=what)
    np.testing.assert_allclose(port[loose], ref[loose], rtol=0, atol=1e-3, err_msg=what)


def cotangents(n, seed):
    return [(np.random.default_rng(seed + k).normal(size=(n, 3)) / n).astype(np.float32)
            for k in range(4)]


@pytest.mark.parametrize("name", ["mixed_tris", "mixed"])
def test_shade_matches_jax_kernel(name):
    j, t = scene_pair(name)
    o, d, jhit, bits = records(j, 32, seed=31)
    thit = tint.Hit(*(torch.from_numpy(np.array(x)) for x in jhit))
    loose = (thit.prim_id >= t.num_triangles).numpy()  # sphere hits
    cts = cotangents(o.shape[0], seed=41)
    strict = [np.where(loose[:, None], 0.0, c).astype(np.float32) for c in cts]
    params = scene_params(j)
    j_outs, j_grads, j_all = jax_shade_vjp(j, params, o, d, jhit, bits, strict, cts)
    t_outs, t_grads, t_all = port_shade_grads(t, params, o, d, thit, bits, fused_outputs,
                                              strict, cts)
    for what, a, b in zip(("direct", "ks", "normal", "position"), t_outs, j_outs):
        assert_close_to_jax(a, b, loose, f"{name} {what}")
    assert set(t_grads) == set(j_grads)
    for k, g in j_grads.items():
        tol = dict(GRAD, atol=2e-5) if k == "vertices" else GRAD
        np.testing.assert_allclose(t_grads[k], g, **tol, err_msg=f"{name} d/d{k}")
        # With the sphere hits' cotangent: 1/sqrt(disc) amplifies their
        # rounding (sphere centers move ~0.5% off float64 in both packages).
        np.testing.assert_allclose(t_all[k], j_all[k], rtol=2e-3, atol=1e-4,
                                   err_msg=f"{name} d/d{k}, sphere hits included")
    assert (thit.prim_id >= 0).float().mean() > 0.2
    for k in ("kd", "ks", "light_color", "light_position", "vertices", "normals", "o", "d"):
        assert np.abs(t_grads[k]).sum() > 0, k
    if name == "mixed":
        assert 0.02 < loose.mean() < 0.2
        assert np.abs(t_all["center"]).sum() > 0 and np.abs(t_all["radius"]).sum() > 0


def test_vertex_grads_on_the_stand_in_box_match_the_jax_kernel():
    # The records that gave NaN vertex gradients through the port's
    # reconstruct_hit before its inputs were gated (misses fall through to
    # triangle 0): the repaired chain and the shade twin both give the JAX
    # shade kernel's vertex gradient, which gates dead lanes.
    j, t = scene_pair("mirror_box")
    o, d, jhit, bits = records(j, 24, seed=51)
    bits &= 1  # one light
    thit = tint.Hit(*(torch.from_numpy(np.array(x)) for x in jhit))
    params, cts = scene_params(j), cotangents(o.shape[0], seed=61)
    _, j_grads = jax_shade_vjp(j, params, o, d, jhit, bits, cts)
    assert (np.asarray(jhit.prim_id) < 0).sum() > 100

    def chain(scene, o_, d_, hit, bits_):
        surf = tint.reconstruct_hit(scene, o_, d_, hit)
        direct = tshading.direct_point_lights(scene, d_, surf, None, shadow_bits=bits_)
        return direct, surf.ks, surf.normal, surf.position

    for fn in (chain, fused_outputs):
        _, t_grads = port_shade_grads(t, params, o, d, thit, bits, fn, cts)
        assert np.isfinite(t_grads["vertices"]).all()
        np.testing.assert_allclose(t_grads["vertices"], j_grads["vertices"], rtol=2e-4,
                                   atol=2e-5, err_msg=fn.__name__)
        assert np.abs(t_grads["vertices"][:3]).sum() > 0


def _tri_mesh(n, seed, material=None):
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1, 1, (3 * n, 3)).astype(np.float32)
    nrm = np.tile(np.asarray([0.0, 1.0, 0.0], np.float32), (3 * n, 1))
    return {"vertices": v, "normals": nrm, "triangles": np.arange(3 * n).reshape(n, 3),
            "material": material or {"kd": (0.5, 0.5, 0.5)}}


def _gate_scene(kind):
    from cg_raytracer_tpu_torch.scene import standins

    lights = standins.MIXED_LIGHTS
    meshes, spheres = standins.mixed_meshes(), None
    if kind == "17 point lights":
        lights = tuple(((0.1 * k, 1.0, 0.0), (0.1, 0.1, 0.1)) for k in range(17))
    elif kind == "9 spheres":
        spheres = {"center": np.zeros((9, 3), np.float32), "radius": np.full(9, 0.1, np.float32),
                   "kd": np.full((9, 3), 0.5, np.float32), "ks": np.zeros((9, 3), np.float32),
                   "shininess": np.ones(9, np.float32)}
    elif kind == "T = 65":
        meshes = [_tri_mesh(65, 1)]
    elif kind == "T = 65, 65 materials":
        meshes = [_tri_mesh(1, k) for k in range(65)]
    elif kind == "T = 257":
        meshes = [_tri_mesh(257, 2)]
    j = jax_scene(meshes, spheres, lights)
    if kind == "a spherical light":
        j = dataclasses.replace(j, spherical_lights=jrt.SphericalLights.of(
            ((0.0, 1.0, 0.0), 0.2, (1.0, 1.0, 1.0))))
    return j, scene_from_numpy(jax_leaves(j))


@pytest.mark.parametrize("kind,same", [
    ("mixed", True), ("17 point lights", True), ("9 spheres", True), ("a spherical light", True),
    ("T = 65", True), ("T = 65, 65 materials", False), ("T = 257", True)])
def test_supports_shade_kernel_matches_jax_gate(kind, same):
    # The select kernel indexes its triangle row in shared memory: no
    # material cap up to T = 256 (the Pallas kernel capped materials past
    # T = 64).  Past 256 the pregathered kernels keep the JAX gate.
    j, t = _gate_scene(kind)
    want = jshade.supports_shade_kernel(j)
    got = tshade.supports_shade_kernel(t)
    assert (got == want) == same, (kind, got, want)
    if not same:
        assert got and t.num_triangles <= 256
    if kind == "a spherical light":
        # Spherical lights are ported (ROADMAP A8): the shade takes their
        # recorded fractions, and without them raises, as the JAX wrapper does.
        o = torch.zeros((4, 3))
        d = torch.tensor([[0.0, -1.0, 0.0]] * 4)
        hit = tint.intersect_brute(t, o, d)
        bits = torch.zeros(4, dtype=torch.int32)
        with pytest.raises(ValueError, match="fractions"):
            tshade.shade_fused_cuda(t, o, d, hit, bits)
        lit = tshade.shade_fused_cuda(t, o, d, hit, bits, torch.ones((1, 4)))[0]
        dark = tshade.shade_fused_cuda(t, o, d, hit, bits, torch.zeros((1, 4)))[0]
        valid = hit.prim_id >= 0
        assert bool(valid.any()) and bool((lit[valid] > dark[valid]).any())


def test_shade_plain_miss_lanes_add_exactly_zero():
    _, t = scene_pair("mixed")
    o, d = (torch.from_numpy(np.array(x)) for x in jrt.generate_rays(jrt.Camera.default(), 16, 16))
    hit = tint.intersect_brute(t, o, d)
    tri, aux, lights, spheres, num_tris = tshade._shade_tables(t)
    leaves = [x.detach().clone().requires_grad_(True) for x in (tri, aux, lights, spheres)]
    miss = hit.prim_id < 0
    bits = torch.zeros_like(hit.prim_id)

    def grads(keep):
        outs = tshade.shade_plain(*leaves, o[keep], d[keep], hit.prim_id[keep], bits[keep],
                                  num_tris=num_tris)
        return torch.autograd.grad(sum(x.sum() for x in outs), leaves)

    assert miss.any() and (~miss).any()
    for a, b in zip(grads(torch.ones_like(miss)), grads(~miss)):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    for x in grads(miss):
        assert not x.any()


def test_shade_grads_close_rejects_a_wrong_gradient():
    """The on-card rule for the shade backward (``utils.checks``), on the CPU
    twin: the twin's gradients pass against themselves, and a table or a ray
    gradient off by 1% at one element fails."""
    from cg_raytracer_tpu_torch.utils import checks

    _, t = scene_pair("mixed")
    o, d = (torch.from_numpy(np.array(x)) for x in jrt.generate_rays(jrt.Camera.default(), 16, 16))
    prim = tint.intersect_brute(t, o, d).prim_id
    tri, aux, lights, spheres, num_tris = tshade._shade_tables(t)
    tables = tuple(x.detach() for x in (tri, aux, lights, spheres))
    gen = torch.Generator().manual_seed(0)
    cts = [torch.randn(o.shape, generator=gen) for _ in range(4)]
    twin, exact = checks.twin_grads(tables, o, d, prim, torch.ones_like(prim), num_tris, cts)
    report = checks.shade_grads_close(twin, twin, exact, o.shape[0])
    assert set(report) == set(checks.GRAD_NAMES)
    assert all(ratio == 0.0 and past == 0.0 for ratio, past in report.values())
    for i in (checks.GRAD_NAMES.index("d_tri"), checks.GRAD_NAMES.index("d_d")):
        wrong = [g.clone() for g in twin]
        wrong[i].view(-1)[wrong[i].abs().argmax()] *= 1.01
        with pytest.raises(AssertionError, match=checks.GRAD_NAMES[i]):
            checks.shade_grads_close(wrong, twin, exact, o.shape[0])
