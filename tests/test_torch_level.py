"""PyTorch port, one bounce level of the default forward route
(``ops/level.py``) against the JAX package, on the CPU.

- One level: the same numpy-seeded inputs (rays with misses, triangle and
  sphere hits, random shadow bits, dead lanes, a level's state or none)
  through JAX's ``reconstruct_hit`` + ``direct_light`` + the level update
  (``cg_raytracer_tpu/models/whitted.py:700-725``) and through
  ``level_plain``, at rtol 1e-5 and atol 1e-6, with and without
  ``reference_quirks``: on the stand-in mirror box, the triangles + spheres
  scene, the ``spheres`` preset (no triangle) and the box lit by the
  spherical box's light with given fractions.  ``level_cuda`` on CPU
  tensors is ``level_plain`` (the twin runs by device).
- A whole 24x24 frame through ``trace_rays`` against JAX's one-phase render
  (``assert_images_close``).
- Routing: a render being differentiated (a ``kd`` that requires grad)
  takes ``level_plain`` and never the kernels' wrapper, and its gradient
  equals JAX's; a render under no grad takes the wrapper.
- The ctypes mirror of ``csrc/level.cu``'s ``LevelArgs`` has its fields in
  the struct's order, and the guard raises on a backward.
"""
import dataclasses
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cg_raytracer_tpu as jrt
import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu.models import whitted as jw
from cg_raytracer_tpu.ops import intersect as jint
from cg_raytracer_tpu.ops import shading as jsh
from cg_raytracer_tpu.ops.linalg import reflect as jreflect
from cg_raytracer_tpu.ops.linalg import safe_normalize as jnormalize
from cg_raytracer_tpu_torch.interop import scene_from_numpy
from cg_raytracer_tpu_torch.models import whitted as tw
from cg_raytracer_tpu_torch.ops import cuda_kernels as ck
from cg_raytracer_tpu_torch.ops import level as lv
from cg_raytracer_tpu_torch.ops.intersect import Hit
from cg_raytracer_tpu_torch.scene import standins
from tests.conftest import assert_images_close
from tests.test_torch_render import cameras
from tests.test_torch_scene import jax_leaves, scene_pair

TOL = dict(rtol=1e-5, atol=1e-6)
SIZE = 24
NO_ORACLE = types.SimpleNamespace(occluded=None, soft_vis=None, sample_split=None)


def spherical_box_pair():
    """The mirror box lit by the spherical box's light and its point light."""
    j = jrt.make_scene(standins.mirror_box_meshes(),
                       point_lights=jrt.PointLights.of(*standins.MIRROR_BOX_LIGHTS),
                       spherical_lights=jrt.SphericalLights.of(*standins.SPHERICAL_BOX_LIGHTS))
    return j, scene_from_numpy(jax_leaves(j))


def pair(name):
    return spherical_box_pair() if name == "spherical_box" else scene_pair(name)


def level_inputs(scene, seed, state):
    """Camera rays and random rays (some from inside the scene, so misses,
    triangle and sphere hits all occur), their hits, random shadow bits,
    fractions and, for a later level, a state with dead lanes (numpy)."""
    rng = np.random.default_rng(seed)
    _, tc = cameras()
    o, d = (x.numpy() for x in trt.generate_rays(tc, 16, 16))
    ro = rng.uniform(-0.5, 0.5, (200, 3)).astype(np.float32)
    rd = rng.normal(size=(200, 3)).astype(np.float32)
    o, d = np.concatenate([o, ro]), np.concatenate([d, rd])
    hit = ck.intersect_plain(scene, torch.from_numpy(o), torch.from_numpy(d))
    n = o.shape[0]
    num_pl = scene.point_lights.position.shape[0]
    out = dict(o=o, d=d, prim=hit.prim_id.numpy(),
               bits=rng.integers(0, 1 << num_pl, n).astype(np.int32),
               fracs=rng.uniform(0, 1, (scene.spherical_lights.position.shape[0], n))
               .astype(np.float32))
    if state:
        out.update(color=rng.uniform(0, 1, (n, 3)).astype(np.float32),
                   throughput=rng.uniform(0, 1, (n, 3)).astype(np.float32),
                   active=rng.uniform(0, 1, n) < 0.7)
    return out


def jax_level(j, x, quirks, last):
    """whitted.py:700-725 of the JAX package on one level's inputs."""
    n = x["o"].shape[0]
    o, d = jnp.asarray(x["o"]), jnp.asarray(x["d"])
    prim = jnp.asarray(x["prim"])
    hit = jint.Hit(jnp.zeros(n), prim, jnp.zeros(n), jnp.zeros(n))
    surf = jint.reconstruct_hit(j, o, d, hit)
    fracs = jnp.asarray(x["fracs"]) if x["fracs"].shape[0] else None
    direct = jsh.direct_light(j, d, surf, None, None, shadow_bits=jnp.asarray(x["bits"]),
                              soft_fracs=fracs)
    color = jnp.asarray(x.get("color", np.zeros((n, 3), np.float32)))
    throughput = jnp.asarray(x.get("throughput", np.ones((n, 3), np.float32)))
    active = jnp.asarray(x.get("active", np.ones(n, bool)))
    lit = active & surf.valid
    color = color + throughput * direct * lit[..., None].astype(jnp.float32)
    if last:
        return [np.asarray(color)]
    reflective = surf.ks[..., 2] > 0.01 if quirks else jnp.any(surf.ks > 0.01, axis=-1)
    active = lit & reflective
    throughput = throughput * surf.ks
    refl = jnormalize(jreflect(d, surf.normal))
    o_next = surf.position + jw.REFLECT_EPS * refl
    d_next = jnp.where(active[..., None], refl, d)
    return [np.asarray(a) for a in (color, throughput, active, o_next, d_next)]


def port_level(fn, scene, x, quirks, last):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}
    hit = Hit(torch.zeros(len(x["o"])), t["prim"], torch.zeros(len(x["o"])),
              torch.zeros(len(x["o"])))
    cfg = trt.RenderConfig(reference_quirks=quirks)
    if scene.spherical_lights.position.shape[0]:
        # The fractions as given: the sampler's draws are held to JAX elsewhere.
        orig = lv.shading.spherical_fracs
        lv.shading.spherical_fracs = lambda *a, **k: t["fracs"]
    try:
        outs = fn(scene, t["o"], t["d"], hit, t["bits"], t.get("color"), t.get("throughput"),
                  t.get("active"), cfg, NO_ORACLE, None, last=last)
    finally:
        if scene.spherical_lights.position.shape[0]:
            lv.shading.spherical_fracs = orig
    return [x.numpy() for x in outs if x is not None]


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("quirks", [False, True])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("name", ["mirror_box", "mixed", "spheres", "spherical_box"])
def test_level_matches_jax(name, state, quirks, last):
    j, t = pair(name)
    x = level_inputs(t, seed=len(name), state=state)
    prim = x["prim"]
    assert (prim < 0).any() and (prim >= 0).any()
    if name != "spheres":
        assert (prim >= 0).any() and (prim < t.num_triangles).any()
    if name in ("mixed", "spheres"):
        assert (prim >= t.num_triangles).any(), "no sphere hit"
    if t.point_lights.position.shape[0]:
        assert 0 < (x["bits"] & 1).mean() < 1
    want = jax_level(j, x, quirks, last)
    for fn in (lv.level_plain, lv.level_cuda):
        got = port_level(fn, t, x, quirks, last)
        assert len(got) == len(want)
        for k, (g, w) in enumerate(zip(got, want)):
            if w.dtype == bool:
                np.testing.assert_array_equal(g, w, err_msg=f"{name} output {k}")
            else:
                np.testing.assert_allclose(g, w, **TOL, err_msg=f"{name} output {k}")
    assert np.abs(want[0]).sum() > 0
    if state and not last:  # some rays go on (the preset's spheres reflect nothing), some stop
        assert want[2].mean() < 1 and (name == "spheres" or want[2].any())


@pytest.mark.parametrize("quirks", [False, True])
@pytest.mark.parametrize("name", ["mirror_box", "mixed"])
def test_frame_matches_jax_one_phase(name, quirks):
    j, t = scene_pair(name)
    jc, tc = cameras()
    jcfg = jrt.RenderConfig(width=SIZE, height=SIZE, backend="brute", grad_two_phase="off",
                            reference_quirks=quirks)
    ref = np.asarray(jrt.render(j, jc, jcfg))
    cfg = trt.RenderConfig(width=SIZE, height=SIZE, reference_quirks=quirks)
    assert not cfg.resolve_grad_two_phase()
    img = trt.render(t, tc, cfg)
    assert_images_close(img.numpy(), ref, msg=f"{name} quirks={quirks}")
    assert (ref.max(axis=-1) > 0.02).mean() > 0.05


def test_grad_takes_the_chain_and_matches_jax(monkeypatch):
    """A kd that requires grad sends every level to level_plain (the
    kernels' wrapper raises if called); the gradient equals JAX's.  The
    loss masks the pixels where the two images differ (a tie-break pixel,
    where the two hit different triangles, moves a kd gradient by percents;
    tests/test_torch_train.py)."""
    j, t = scene_pair("mirror_box")
    jc, tc = cameras()
    size = 16
    jcfg = jrt.RenderConfig(width=size, height=size, backend="brute", grad_two_phase="off")

    def j_image(kd_):
        s = dataclasses.replace(j, materials=dataclasses.replace(j.materials, kd=kd_))
        return jw.render_image(s, jc, jcfg, backend=jw.make_backend(s, jcfg),
                               key=jax.random.PRNGKey(0))

    cfg = trt.RenderConfig(width=size, height=size)
    ref = np.asarray(jax.jit(j_image)(j.materials.kd))
    mask = (np.abs(trt.render(t, tc, cfg).numpy() - ref).max(axis=-1) <= 1e-4)[..., None]
    assert mask.mean() > 0.95

    calls = {"plain": 0}
    plain = lv.level_plain

    def counted(*a, **k):
        calls["plain"] += 1
        return plain(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("a render being differentiated reached level_cuda")

    monkeypatch.setattr(lv, "level_plain", counted)
    monkeypatch.setattr(lv, "level_cuda", refuse)
    kd = t.materials.kd.clone().requires_grad_(True)
    scene = dataclasses.replace(t, materials=dataclasses.replace(t.materials, kd=kd))
    img = tw.render_image(scene, tc, cfg, backend=tw.make_backend(scene, cfg))
    (img * torch.from_numpy(mask.astype(np.float32))).mean().backward()
    assert calls["plain"] == cfg.max_depth

    want = np.asarray(jax.jit(jax.grad(lambda kd_: (j_image(kd_) * mask).mean()))(j.materials.kd))
    np.testing.assert_allclose(kd.grad.numpy(), want, rtol=2e-4, atol=1e-5)
    assert np.abs(want).sum() > 0


def test_no_grad_render_takes_the_wrapper(monkeypatch):
    _, t = scene_pair("mirror_box")
    _, tc = cameras()
    calls = {"cuda": 0}
    wrapper = lv.level_cuda

    def counted(*a, **k):
        calls["cuda"] += 1
        return wrapper(*a, **k)

    monkeypatch.setattr(lv, "level_cuda", counted)
    cfg = trt.RenderConfig(width=8, height=8)
    img = trt.render(t, tc, cfg)
    assert calls["cuda"] == cfg.max_depth and bool(torch.isfinite(img).all())
    # The plain backend is the reference: it takes the chain.
    plain = tw.render_image(t, tc, cfg, backend=tw.make_backend(t, cfg, plain=True))
    assert calls["cuda"] == cfg.max_depth
    assert torch.equal(plain, img)  # on the CPU the wrapper is the chain
    assert all(v == 0 for v in lv.launch_counts().values())


def test_args_mirror_the_kernel_struct():
    """``_Args`` lists ``LevelArgs``'s fields in order, pointers as pointers."""
    with open(lv.__file__.replace("ops/level.py", "csrc/level.cu")) as f:
        src = f.read()
    body = re.search(r"struct LevelArgs \{(.*?)\n\};", src, re.S).group(1)
    fields = re.findall(r"^\s*(?:const )?(\w+)(\*?) (\w+);", body, re.M)
    assert [name for _, _, name in fields] == [name for name, _ in lv._Args._fields_]
    for (ctype, star, name), (_, py) in zip(fields, lv._Args._fields_):
        assert (py is lv._P) == (star == "*"), name
        assert star == "*" or ctype == "int32_t", name


def test_guard_raises_on_backward():
    x = torch.ones(3, requires_grad=True)
    (y,) = lv._LevelGuard.apply(1, torch.ones(3), x)  # an output made under no grad
    assert y.requires_grad
    with pytest.raises(NotImplementedError, match="no backward"):
        y.sum().backward()
    _, t = scene_pair("mirror_box")
    assert not lv.needs_chain(t, torch.zeros(2, 3))
    assert lv.needs_chain(t, x)
    with torch.no_grad():
        assert not lv.needs_chain(t, x)
