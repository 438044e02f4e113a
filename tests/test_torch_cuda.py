"""PyTorch port on an NVIDIA GPU: each CUDA kernel against its plain PyTorch
twin on the card, the wide BVH kernels on the procedural teacup (48,000
triangles; node widths 2, 4 and 8) and on the donut (320,000, past the JAX
package's on-chip tier; widths 4 and 2),
the soft-shadow samplers and the spherical-light shade on the spherical
stand-ins (``presets.load_standin``), the donut's render and training step,
``optimize()`` with the refit, and compiled dispatch (``render()``'s graph
replaying new inputs, ``optimize()``'s graphed chunks against the eager
loop, ``csrc/bloom.cu`` against its twins), and the default route's level
kernels (``csrc/level.cu``) bit-equal to the chain.  Skipped where there is
no CUDA device.

This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: prim ids and booleans equal on >= 99.5% of rays; where ids match,
t/u/v (and the records' next rays, where active) within atol 1e-5, rtol
1e-5; colors on <= 0.5% of rays off by > 1e-4; shade outputs rtol 1e-5,
atol 1e-6; shade gradients as ``utils.checks.shade_grads_close``.  The
4-wide BVH kernels walk the same per-ray descent as their twins and are
held to them exactly, and so are the soft-shadow samplers' counts (their
sample rays are the twins' op for op); the twin's Philox words equal
curand's.
"""
import dataclasses

import pytest
import torch

from cg_raytracer_tpu_torch.models.whitted import build_accel
from cg_raytracer_tpu_torch.ops import bvh4 as b4
from cg_raytracer_tpu_torch.ops import cuda_kernels as ck
from cg_raytracer_tpu_torch.ops import shade, soft
from cg_raytracer_tpu_torch.ops.camera import generate_rays
from cg_raytracer_tpu_torch.ops.refit import make_refit_plan, refit_accel
from cg_raytracer_tpu_torch.scene import standins
from cg_raytracer_tpu_torch.scene.presets import load_scene, load_standin
from cg_raytracer_tpu_torch.scene.types import Camera, PointLights, Spheres, make_scene
from cg_raytracer_tpu_torch.utils import bench, checks
from cg_raytracer_tpu_torch.utils.config import RenderConfig


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def card_inputs(device):
    box = make_scene(standins.mirror_box_meshes(),
                     point_lights=PointLights.of(*standins.MIRROR_BOX_LIGHTS), device=device)
    mixed = make_scene(standins.mixed_meshes(),
                       spheres=Spheres(**{k: torch.as_tensor(v)
                                          for k, v in standins.mixed_spheres().items()}),
                       point_lights=PointLights.of(*standins.MIXED_LIGHTS), device=device)
    gen = torch.Generator(device).manual_seed(0)
    o_cam, d_cam = generate_rays(Camera.default(device=device), 256, 256)
    o_rand = torch.rand((1 << 16, 3), device=device, generator=gen) * 2.4 - 1.2
    d_rand = torch.randn((1 << 16, 3), device=device, generator=gen)
    d_rand = d_rand / d_rand.norm(dim=1, keepdim=True)
    return box, mixed, torch.cat([o_cam, o_rand]), torch.cat([d_cam, d_rand]), gen


def colors_close(a, b):
    bad = ((a - b).abs().amax(dim=-1) > 1e-4).float().mean().item()
    assert bad <= 0.005, f"{bad:.4%} of rays differ"


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["closest", "anyhit", "bounce", "trace"])
def test_kernel_matches_plain_on_card(kernel, cuda_device):
    box, mixed, o, d, gen = card_inputs(cuda_device)
    before = ck.launch_counts()
    if kernel == "closest":
        for scene in (box, mixed):
            got, want = ck.intersect_cuda(scene, o, d), ck.intersect_plain(scene, o, d)
            same = got.prim_id == want.prim_id
            assert same.float().mean().item() >= 0.995
            hit = same & torch.isfinite(want.t)
            assert bool(torch.isinf(got.t[got.prim_id < 0]).all())
            for a, b in ((got.t, want.t), (got.u, want.u), (got.v, want.v)):
                torch.testing.assert_close(a[hit], b[hit], rtol=1e-5, atol=1e-5)
    elif kernel == "anyhit":
        tm = torch.rand(o.shape[0], device=cuda_device, generator=gen) * 2.0
        for scene in (box, mixed):
            got, want = ck.occluded_cuda(scene, o, d, tm), ck.occluded_plain(scene, o, d, tm)
            assert got.dtype == torch.bool
            assert (got == want).float().mean().item() >= 0.995
    elif kernel == "bounce":
        live = torch.arange(o.shape[0], device=cuda_device) % 5 != 0
        (gh, gb), (wh, wb) = ck.bounce_cuda(box, o, d, live), ck.bounce_plain(box, o, d, live)
        assert (gh.prim_id == wh.prim_id).float().mean().item() >= 0.995
        assert (gb == wb).float().mean().item() >= 0.995
        assert bool((gh.prim_id[~live] == -1).all())
    else:
        for scene in (box, mixed):
            for quirks in (False, True):
                colors_close(ck.trace_cuda(scene, o, d, 2, quirks),
                             ck.trace_plain(scene, o, d, 2, quirks))
    torch.cuda.synchronize()
    name = {"closest": "intersect_cuda", "anyhit": "occluded_cuda", "bounce": "bounce_cuda",
            "trace": "trace_cuda"}[kernel]
    assert ck.launch_counts()[name] > before[name]


def shade_inputs(scene, o, d, gen):
    hit = ck.intersect_plain(scene, o, d)
    bits = torch.randint(0, 1 << scene.point_lights.position.shape[0], (o.shape[0],),
                         device=o.device, dtype=torch.int32, generator=gen)
    tri, aux, lights, spheres, num_tris = shade._shade_tables(scene)
    return (tri, aux, lights, spheres), hit.prim_id.contiguous(), bits, num_tris


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["record_trace", "bounce_refl", "shade_fwd", "shade_bwd"])
def test_training_kernel_matches_plain_on_card(kernel, cuda_device):
    box, mixed, o, d, gen = card_inputs(cuda_device)
    before = {**ck.launch_counts(), **shade.launch_counts()}
    if kernel == "record_trace":
        for quirks in (False, True):
            got = ck.record_trace_cuda(box, o, d, 2, quirks)
            want = ck.record_trace_plain(box, o, d, 2, quirks)
            for (go, gd, gh, gb, ga), (wo, wd, wh, wb, wa) in zip(got, want):
                assert (gh.prim_id == wh.prim_id).float().mean().item() >= 0.995
                assert (gb == wb).float().mean().item() >= 0.995
                assert (ga == wa).float().mean().item() >= 0.995
                same = (gh.prim_id == wh.prim_id) & torch.isfinite(wh.t)
                for a, b in ((gh.t, wh.t), (gh.u, wh.u), (gh.v, wh.v)):
                    torch.testing.assert_close(a[same], b[same], rtol=1e-5, atol=1e-5)
                both = ga & wa
                for a, b in ((go, wo), (gd, wd)):
                    torch.testing.assert_close(a[both], b[both], rtol=1e-5, atol=1e-5)
            assert bool(got[1][4].any())
    elif kernel == "bounce_refl":
        live = torch.arange(o.shape[0], device=cuda_device) % 5 != 0
        got, want = ck.bounce_refl_cuda(box, o, d, live), ck.bounce_refl_plain(box, o, d, live)
        same = got[0].prim_id == want[0].prim_id
        assert same.float().mean().item() >= 0.995
        assert (got[1] == want[1]).float().mean().item() >= 0.995
        assert (got[4] == want[4]).float().mean().item() >= 0.995
        for a, b in ((got[2], want[2]), (got[3], want[3])):
            torch.testing.assert_close(a[same], b[same], rtol=1e-5, atol=1e-5)
        assert bool((got[0].prim_id[~live] == -1).all()) and not bool(got[4][~live].any())
    else:
        o_cap, d_cap = generate_rays(Camera.default(dist=4.0, device=cuda_device), 128, 128)
        cap = checks.cap_scene(cuda_device)
        for scene, o, d in ((box, o, d), (mixed, o, d), (cap, o_cap, d_cap)):
            tables, prim, bits, num_tris = shade_inputs(scene, o, d, gen)
            if kernel == "shade_fwd":
                got = shade.shade_fwd_cuda(*tables, o, d, prim, bits, num_tris)
                want = shade.shade_plain(*tables, o, d, prim, bits, num_tris=num_tris)
                for a, b in zip(got, want):
                    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
                continue
            cts = [torch.randn(o.shape, device=cuda_device, generator=gen) for _ in range(4)]
            got = shade.shade_bwd_cuda(*tables, o, d, prim, bits, num_tris, cts)
            twin, exact = checks.twin_grads(tables, o, d, prim, bits, num_tris, cts)
            checks.shade_grads_close(got, twin, exact, o.shape[0])
    torch.cuda.synchronize()
    name = {"record_trace": "record_trace_cuda", "bounce_refl": "bounce_refl_cuda",
            "shade_fwd": "shade_fwd_cuda", "shade_bwd": "shade_bwd_cuda"}[kernel]
    assert {**ck.launch_counts(), **shade.launch_counts()}[name] > before[name]


@pytest.fixture(scope="module")
def teacup_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    device = torch.device("cuda")
    teacup = load_scene("teacup", device=device)
    tree = build_accel(teacup, RenderConfig())
    gen = torch.Generator(device).manual_seed(3)
    o_cam, d_cam = generate_rays(Camera.default(device=device), 256, 256)
    o_rand = torch.rand((1 << 16, 3), device=device, generator=gen) * 2.4 - 1.2
    d_rand = torch.randn((1 << 16, 3), device=device, generator=gen)
    d_rand = d_rand / d_rand.norm(dim=1, keepdim=True)
    return teacup, tree, torch.cat([o_cam, o_rand]), torch.cat([d_cam, d_rand]), gen


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["bvh4_closest", "bvh4_anyhit", "bvh4_bounce", "shade_pre_fwd",
                                    "shade_pre_bwd"])
def test_mesh_kernel_matches_plain_on_card(kernel, teacup_on_card):
    teacup, tree, o, d, gen = teacup_on_card
    before = {**b4.launch_counts(), **shade.launch_counts()}
    if kernel == "bvh4_closest":
        got = b4.intersect_bvh4_cuda(teacup, tree, o, d)
        want = b4.intersect_bvh4_plain(teacup, tree, o, d)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert 0.1 < (got.prim_id >= 0).float().mean().item() < 0.9
    elif kernel == "bvh4_anyhit":
        tm = torch.rand(o.shape[0], device=o.device, generator=gen) * 3.0 - 0.5
        got = b4.occluded_bvh4_cuda(teacup, tree, o, d, tm)
        assert torch.equal(got, b4.occluded_bvh4_plain(teacup, tree, o, d, tm))
        assert bool(got.any()) and not bool(got[tm < 0].any())
    elif kernel == "bvh4_bounce":
        live = torch.arange(o.shape[0], device=o.device) % 5 != 0
        (gh, gb), (wh, wb) = (b4.bounce_bvh4_cuda(teacup, tree, o, d, live),
                              b4.bounce_bvh4_plain(teacup, tree, o, d, live))
        assert all(torch.equal(a, b) for a, b in zip(gh, wh)) and torch.equal(gb, wb)
        assert bool((gh.prim_id[~live] == -1).all()) and bool(gb.any())
    else:
        hit = b4.intersect_bvh4_cuda(teacup, tree, o, d)
        prim = hit.prim_id.contiguous()
        bits = torch.randint(0, 2, prim.shape, device=o.device, dtype=torch.int32, generator=gen)
        payload, mats, lights, spheres, num_tris = shade._pre_tables(teacup)
        tables = tuple(x.detach().contiguous() for x in (payload, mats, lights, spheres))
        if kernel == "shade_pre_fwd":
            got = shade.shade_pre_fwd_cuda(*tables, o, d, prim, bits)
            want = shade.shade_plain_pre(*tables, o, d, prim, bits)
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        else:
            cts = [torch.randn(o.shape, device=o.device, generator=gen) for _ in range(4)]
            got = shade.shade_pre_bwd_cuda(*tables, o, d, prim, bits, cts)
            twin, exact = checks.twin_grads(tables, o, d, prim, bits, num_tris, cts,
                                            plain=shade.shade_plain_pre)
            checks.shade_grads_close(got, twin, exact, o.shape[0], names=checks.PRE_GRAD_NAMES)
            assert not bool(got[0][:, 18].any())
    torch.cuda.synchronize()
    name = {"bvh4_closest": "intersect_bvh4_cuda", "bvh4_anyhit": "occluded_bvh4_cuda",
            "bvh4_bounce": "bounce_bvh4_cuda", "shade_pre_fwd": "shade_pre_fwd_cuda",
            "shade_pre_bwd": "shade_pre_bwd_cuda"}[kernel]
    assert {**b4.launch_counts(), **shade.launch_counts()}[name] > before[name]


@pytest.mark.cuda
def test_past_the_4_wide_cap_the_card_raises(teacup_on_card):
    import dataclasses

    from cg_raytracer_tpu_torch.models.whitted import make_backend

    teacup, *_ = teacup_on_card
    n = b4.MAX_TRIS + 1  # past the limit of the kernels' int32 indexing
    big = dataclasses.replace(
        teacup, triangles=torch.zeros((1, 3), dtype=torch.int32,
                                      device=teacup.device).expand(n, 3),
        tri_material=torch.zeros((1,), dtype=torch.int32, device=teacup.device).expand(n))
    with pytest.raises(NotImplementedError, match="MAX_TRIS"):
        make_backend(big, RenderConfig())


@pytest.fixture(scope="module")
def spherical_on_card():
    """The spherical stand-ins on the card, the teacup's tree, and the
    level-0 hit points of a 128^2 frame of each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    device = torch.device("cuda")
    box, cup = load_standin("spherical_box", device), load_standin("spherical_teacup", device)
    tree = build_accel(cup, RenderConfig()).primary
    o, d = generate_rays(Camera.default(device=device), 128, 128)
    points = {}
    for label, hit in (("box", ck.intersect_cuda(box, o, d)),
                       ("cup", b4.intersect_bvh4_cuda(cup, tree, o, d))):
        valid = hit.prim_id >= 0
        t = torch.where(valid, hit.t, 0.0)
        points[label] = (torch.where(valid[:, None], o + d * t[:, None], 0.0), valid)
    return box, cup, tree, o, d, points


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["soft_table", "soft_prng", "soft4_table", "soft4_prng"])
def test_soft_shadow_kernel_matches_plain_on_card(kernel, spherical_on_card):
    box, cup, tree, _, _, points = spherical_on_card
    scene, label = (cup, "cup") if kernel.startswith("soft4") else (box, "box")
    pos, valid = points[label]
    lpos, lrad = scene.spherical_lights.position[0], scene.spherical_lights.radius[0]
    before = soft.launch_counts()
    key = soft.SampleKey(11, 22, 33)
    args = (scene, tree) if label == "cup" else (scene,)
    if kernel.endswith("table"):
        gauss = torch.randn((64, pos.shape[0], 3), device=pos.device,
                            generator=torch.Generator(pos.device).manual_seed(1))
        run = soft.soft4_table_cuda if label == "cup" else soft.soft_table_cuda
        plain = soft.soft4_table_plain if label == "cup" else soft.soft_table_plain
        got, want = (f(*args, pos, lpos, lrad, gauss, valid=valid) for f in (run, plain))
    else:
        run = soft.soft4_prng_cuda if label == "cup" else soft.soft_prng_cuda
        plain = soft.soft4_prng_plain if label == "cup" else soft.soft_prng_plain
        got, want = (f(*args, pos, lpos, lrad, key, 200, valid=valid) for f in (run, plain))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not bool(got[~valid].any())
    frac = got[valid] / (64 if kernel.endswith("table") else 200)
    assert bool(((frac > 0) & (frac < 1)).any()) and bool((frac == 1).any())
    name = {"soft_table": "soft_table_cuda", "soft_prng": "soft_prng_cuda",
            "soft4_table": "soft4_table_cuda", "soft4_prng": "soft4_prng_cuda"}[kernel]
    assert soft.launch_counts()[name] > before[name]


@pytest.mark.cuda
def test_philox_twin_matches_curand(cuda_device):
    assert checks.philox_matches_curand(cuda_device, n=4096) == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["shade_sph", "shade_pre_sph"])
def test_spherical_shade_matches_plain_on_card(kernel, spherical_on_card):
    box, cup, tree, o, d, _ = spherical_on_card
    gen = torch.Generator(o.device).manual_seed(5)
    scene = box if kernel == "shade_sph" else cup
    hit = (ck.intersect_cuda(box, o, d) if kernel == "shade_sph"
           else b4.intersect_bvh4_cuda(cup, tree, o, d))
    prim, bits = hit.prim_id.contiguous(), torch.zeros_like(hit.prim_id)
    sph = shade._sph_table(scene).detach()
    fracs = torch.rand((1, o.shape[0]), device=o.device, generator=gen)
    fracs[0, ::7] = 0.0
    cts = [torch.randn(o.shape, device=o.device, generator=gen) for _ in range(4)]
    if kernel == "shade_sph":
        tri, aux, lights, spheres, num_tris = shade._shade_tables(scene)
        tables = tuple(x.detach() for x in (tri, aux, lights, spheres))
        got = shade.shade_fwd_cuda(*tables, o, d, prim, bits, num_tris, sph, fracs)
        want = shade.shade_plain(*tables, o, d, prim, bits, num_tris=num_tris, sph=sph,
                                 fracs=fracs)
        grads = shade.shade_bwd_cuda(*tables, o, d, prim, bits, num_tris, cts, sph, fracs)
        twin, exact = checks.twin_grads(tables, o, d, prim, bits, num_tris, cts, sph=sph,
                                        fracs=fracs)
        names = checks.GRAD_NAMES
    else:
        payload, mats, lights, spheres, num_tris = shade._pre_tables(scene)
        tables = tuple(x.detach() for x in (payload, mats, lights, spheres))
        got = shade.shade_pre_fwd_cuda(*tables, o, d, prim, bits, sph, fracs)
        want = shade.shade_plain_pre(*tables, o, d, prim, bits, sph=sph, fracs=fracs)
        grads = shade.shade_pre_bwd_cuda(*tables, o, d, prim, bits, cts, sph, fracs)
        twin, exact = checks.twin_grads(tables, o, d, prim, bits, num_tris, cts,
                                        plain=shade.shade_plain_pre, sph=sph, fracs=fracs)
        names = checks.PRE_GRAD_NAMES
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert want[0].abs().sum().item() > 0
    checks.shade_grads_close(grads, twin, exact, o.shape[0], names=names)
    assert grads[-1].abs().sum().item() > 0  # d_sph


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["spherical_box", "spherical_teacup"])
def test_spherical_standin_renders_through_the_kernels(name, spherical_on_card):
    from cg_raytracer_tpu_torch.models.whitted import make_backend, render, render_image

    box, cup, tree, *_ = spherical_on_card
    scene = box if name == "spherical_box" else cup
    cam = Camera.default(device=scene.device)
    cfg = RenderConfig(width=64, height=64)
    soft.reset_launch_counts()
    img = render(scene, cam, cfg)
    counts = soft.launch_counts()
    assert counts["soft4_prng_cuda" if name == "spherical_teacup" else "soft_prng_cuda"] > 0
    plain = render_image(scene, cam, cfg, backend=make_backend(scene, cfg, plain=True,
                                                               accel=build_accel(scene, cfg)),
                         generator=torch.Generator().manual_seed(0))
    bad = ((img - plain).abs().amax(dim=-1) > 1e-4).float().mean().item()
    assert bad <= 0.005 and bool(torch.isfinite(img).all())
    assert (img.amax(dim=-1) > 0.02).float().mean().item() > 0.1


@pytest.fixture(scope="module")
def donut_on_card():
    """The donut on the card, its tree (the auto: median, leaf 4), and a
    256^2 frame of camera rays plus 64K random rays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    device = torch.device("cuda")
    donut = load_scene("donut", device=device)
    tree = build_accel(donut, RenderConfig())
    gen = torch.Generator(device).manual_seed(5)
    o_cam, d_cam = generate_rays(Camera.default(device=device), 256, 256)
    o_rand = torch.rand((1 << 16, 3), device=device, generator=gen) * 2.4 - 1.2
    d_rand = torch.randn((1 << 16, 3), device=device, generator=gen)
    d_rand = d_rand / d_rand.norm(dim=1, keepdim=True)
    return donut, tree, torch.cat([o_cam, o_rand]), torch.cat([d_cam, d_rand]), gen


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["closest", "anyhit", "bounce"])
def test_large_tier_kernel_matches_plain_on_card(kernel, donut_on_card):
    donut, tree, o, d, gen = donut_on_card
    assert isinstance(tree, b4.BVH4) and tree.num_tris > b4.VMEM_MAX_TRIS
    before = b4.launch_counts()
    if kernel == "closest":
        got = b4.intersect_bvh4_cuda(donut, tree, o, d)
        assert all(torch.equal(a, b) for a, b in zip(got, b4.intersect_bvh4_plain(donut, tree,
                                                                                   o, d)))
        assert 0.05 < (got.prim_id >= 0).float().mean().item() < 0.9
    elif kernel == "anyhit":
        tm = torch.rand(o.shape[0], device=o.device, generator=gen) * 3.0 - 0.5
        got = b4.occluded_bvh4_cuda(donut, tree, o, d, tm)
        assert torch.equal(got, b4.occluded_bvh4_plain(donut, tree, o, d, tm))
        assert bool(got.any()) and not bool(got[tm < 0].any())
    else:
        live = torch.arange(o.shape[0], device=o.device) % 5 != 0
        (gh, gb), (wh, wb) = (b4.bounce_bvh4_cuda(donut, tree, o, d, live),
                              b4.bounce_bvh4_plain(donut, tree, o, d, live))
        assert all(torch.equal(a, b) for a, b in zip(gh, wh)) and torch.equal(gb, wb)
        assert bool(gb.any())
    torch.cuda.synchronize()
    name = {"closest": "intersect_bvh4_cuda", "anyhit": "occluded_bvh4_cuda",
            "bounce": "bounce_bvh4_cuda"}[kernel]
    assert b4.launch_counts()[name] > before[name]


@pytest.mark.cuda
def test_donut_renders_and_trains_on_card(donut_on_card):
    from cg_raytracer_tpu_torch.models.whitted import make_backend, render, render_image

    donut, tree, *_ = donut_on_card
    cam = Camera.default(device=donut.device)
    cfg = RenderConfig(width=64, height=64)
    b4.reset_launch_counts()
    shade.reset_launch_counts()
    img = render(donut, cam, cfg, accel=tree)
    assert b4.launch_counts()["bounce_bvh4_cuda"] > 0
    depth1 = dataclasses.replace(cfg, max_depth=1)  # ks 0: render() traces one level
    plain = render_image(donut, cam, depth1,
                         backend=make_backend(donut, depth1, plain=True, accel=tree))
    colors_close(img, plain)
    assert (img.amax(dim=-1) > 0.02).float().mean().item() > 0.1
    tcfg = bench.training_config(cfg, True)
    params = bench.training_params(donut, True)
    jitter = torch.zeros(3, device=donut.device)
    (lk, gk), (lp, gp) = (bench.fwd_bwd_step(donut, cam, tcfg, params, jitter, plain=plain,
                                             accel=tree) for plain in (False, True))
    assert shade.launch_counts()["shade_pre_bwd_cuda"] > 0
    torch.testing.assert_close(lk, lp, rtol=1e-5, atol=1e-7)
    for name in gk:
        tol = dict(checks.TABLE_GRAD, atol=2e-5) if name == "vertices" else checks.TABLE_GRAD
        torch.testing.assert_close(gk[name], gp[name], **tol, msg=name)
    assert gk["vertices"].abs().sum().item() > 0


@pytest.mark.cuda
def test_optimize_refits_the_tree_on_card(teacup_on_card):
    from cg_raytracer_tpu_torch.models.whitted import render
    from cg_raytracer_tpu_torch.optim import inverse

    teacup, _, o, d, _ = teacup_on_card
    cam = Camera.default(device=teacup.device)
    cfg = RenderConfig(width=64, height=64)
    target = render(teacup, cam, cfg)
    moved = dataclasses.replace(
        teacup, vertices=teacup.vertices + torch.tensor([0.0, 0.0, 0.02], device=teacup.device))
    run = dict(steps=3, learning_rate=1e-3, params=inverse.vertex_params(moved),
               apply_params=inverse.apply_vertex_params, log_every=0)
    params, losses = inverse.optimize(moved, cam, target, cfg, **run)
    _, plain_losses = inverse.optimize(moved, cam, target, cfg, plain=True, **run)
    torch.testing.assert_close(torch.tensor(losses), torch.tensor(plain_losses), rtol=1e-4,
                               atol=0.0)
    assert losses[-1] < losses[0]
    tree0 = build_accel(moved, inverse.training_config(cfg, True))  # the tree optimize built
    final = inverse.apply_vertex_params(moved, params)
    refit = refit_accel(tree0, final, make_refit_plan(tree0))
    fresh = b4.build_bvh4(final, max_leaf=4, builder="sah")[1]
    a, b = b4.intersect_bvh4_cuda(final, refit, o, d), b4.intersect_bvh4_cuda(final, fresh, o, d)
    big = lambda t: torch.where(torch.isinf(t), 1e9, t)  # noqa: E731
    assert torch.isclose(big(a.t), big(b.t), atol=1e-4, rtol=1e-5).float().mean().item() >= 0.998
    assert (a.prim_id == b.prim_id).float().mean().item() >= 0.998


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["closest", "anyhit", "bounce"])
@pytest.mark.parametrize("width", [2, 8])
def test_width_kernel_matches_plain_on_card(width, kernel, teacup_on_card):
    # B13 (width 2) and B15 (width 8): the walk's other instantiations,
    # exactly equal to their twins, on the teacup's binary tree collapsed.
    teacup, _, o, d, gen = teacup_on_card
    tree = build_accel(teacup, RenderConfig(bvh_wide=str(width)))
    assert isinstance(tree, b4.BVH4) and tree.width == width
    before = b4.launch_counts()
    if kernel == "closest":
        got = b4.intersect_bvh4_cuda(teacup, tree, o, d)
        assert all(torch.equal(a, b) for a, b in zip(got, b4.intersect_bvh4_plain(teacup, tree,
                                                                                   o, d)))
    elif kernel == "anyhit":
        tm = torch.rand(o.shape[0], device=o.device, generator=gen) * 3.0 - 0.5
        got = b4.occluded_bvh4_cuda(teacup, tree, o, d, tm)
        assert torch.equal(got, b4.occluded_bvh4_plain(teacup, tree, o, d, tm))
        assert bool(got.any()) and not bool(got[tm < 0].any())
    else:
        live = torch.arange(o.shape[0], device=o.device) % 5 != 0
        (gh, gb), (wh, wb) = (b4.bounce_bvh4_cuda(teacup, tree, o, d, live),
                              b4.bounce_bvh4_plain(teacup, tree, o, d, live))
        assert all(torch.equal(a, b) for a, b in zip(gh, wh)) and torch.equal(gb, wb)
    torch.cuda.synchronize()
    name = {"closest": "intersect_bvh4_cuda", "anyhit": "occluded_bvh4_cuda",
            "bounce": "bounce_bvh4_cuda"}[kernel]
    assert b4.launch_counts()[f"{name}:w{width}"] > before[f"{name}:w{width}"]


@pytest.mark.cuda
@pytest.mark.parametrize("route,width", [("sample", 2), ("cone", 2), ("cone", 8)])
def test_tree_sampler_widths_on_card(route, width, spherical_on_card):
    # B12 ('sample', the primary binary tree), B11 ('cone' over a binary
    # tree) and B15's cone at width 8: the PRNG kernel equal to its twin,
    # and its counts equal to the 4-wide kernel's (a count does not depend
    # on the tree).
    _, cup, tree4, _, _, points = spherical_on_card
    pos, valid = points["cup"]
    lpos, lrad = cup.spherical_lights.position[0], cup.spherical_lights.radius[0]
    tree = build_accel(cup, RenderConfig(bvh_wide=str(width), soft_shadow_tile=route))
    tree = tree if isinstance(tree, b4.BVH4) else tree.soft
    assert tree.width == width
    run, plain = ((soft.soft_bvh_prng_cuda, soft.soft_bvh_prng_plain) if route == "sample"
                  else (soft.soft4_prng_cuda, soft.soft4_prng_plain))
    key = soft.SampleKey(11, 22, 33)
    before = soft.launch_counts()
    got = run(cup, tree, pos, lpos, lrad, key, 200, valid=valid)
    assert torch.equal(got, plain(cup, tree, pos, lpos, lrad, key, 200, valid=valid))
    assert torch.equal(got, soft.soft4_prng_cuda(cup, tree4, pos, lpos, lrad, key, 200,
                                                 valid=valid))
    name = "soft_bvh_prng_cuda" if route == "sample" else "soft4_prng_cuda"
    assert soft.launch_counts()[f"{name}:w{width}"] > before[f"{name}:w{width}"]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["sample", "bvh_wide_hbm=2"])
def test_width_routes_render_on_card(route, spherical_on_card, donut_on_card):
    from cg_raytracer_tpu_torch.models.whitted import make_backend, render, render_image

    if route == "sample":
        scene = spherical_on_card[1]
        cfg = RenderConfig(width=64, height=64, soft_shadow_tile="sample")
        gen = torch.Generator().manual_seed(0)
    else:
        scene = donut_on_card[0]
        cfg = RenderConfig(width=64, height=64, bvh_wide_hbm="2", max_depth=1)
        gen = None
    accel = build_accel(scene, cfg)
    assert accel.width == 2
    cam = Camera.default(device=scene.device)
    b4.reset_launch_counts()
    soft.reset_launch_counts()
    img = render(scene, cam, cfg, accel=accel)
    counts = {**b4.launch_counts(), **soft.launch_counts()}
    if route == "sample":
        assert counts["soft_bvh_prng_cuda:w2"] > 0 and counts["soft4_prng_cuda"] == 0
    assert counts["bounce_bvh4_cuda:w2"] > 0
    plain = render_image(scene, cam, cfg, backend=make_backend(scene, cfg, plain=True,
                                                               accel=accel), generator=gen)
    colors_close(img, plain)
    assert (img.amax(dim=-1) > 0.02).float().mean().item() > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mirror_box", "spherical_box"])
def test_graphed_render_replays_new_inputs_on_card(name, cuda_device):
    # One graph for both calls: the second replay takes the moved camera and
    # (spherical lights) the new key, and equals the eager frame bit for bit.
    from cg_raytracer_tpu_torch.models.whitted import render
    from cg_raytracer_tpu_torch.utils import graphs

    scene = load_standin(name, device=cuda_device)
    cfg = RenderConfig(width=128, height=128)
    graphs.clear()
    frames = []
    for seed, look_at in ((1, (0.0, 0.0, 0.0)), (2, (0.02, 0.0, -0.01))):
        cam = Camera.default(look_at=look_at, device=cuda_device)
        got = render(scene, cam, cfg, generator=torch.Generator().manual_seed(seed))
        want = render(scene, cam, cfg, generator=torch.Generator().manual_seed(seed), jit=False)
        assert torch.equal(got, want)
        frames.append(got)
    assert len(graphs.CACHE) == 1 and not torch.equal(*frames)
    graphs.clear()


@pytest.mark.cuda
def test_graphed_optimize_matches_the_eager_loop_on_card(cuda_device):
    from cg_raytracer_tpu_torch.models.whitted import render
    from cg_raytracer_tpu_torch.optim import inverse

    box = load_standin("mirror_box", device=cuda_device)
    cam = Camera.default(device=cuda_device)
    cfg = RenderConfig(width=64, height=64)
    target = render(box, cam, cfg) * 0.8
    run = dict(steps=5, steps_per_call=2, log_every=0)  # chunks 2 + 2 + 1
    p_g, l_g = inverse.optimize(box, cam, target, cfg, **run)
    p_e, l_e = inverse.optimize(box, cam, target, cfg, jit=False, **run)
    # The shade backward's table gradients add by atomics, in another order
    # in each run.
    torch.testing.assert_close(torch.tensor(l_g), torch.tensor(l_e), rtol=1e-5, atol=0.0)
    for k in p_g:
        torch.testing.assert_close(p_g[k], p_e[k], **checks.TABLE_GRAD)
    with pytest.raises(ValueError, match="capturable"):
        inverse.optimize(box, cam, target, cfg, steps=1, log_every=0,
                         optimizer=lambda p: torch.optim.Adam(list(p.values())))


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(37, 53), (256, 256)])
def test_quirk_blur_kernels_match_their_twins_on_card(hw, cuda_device):
    from cg_raytracer_tpu_torch.ops import effects

    gen = torch.Generator(cuda_device).manual_seed(sum(hw))
    x = torch.rand((*hw, 3), device=cuda_device, generator=gen) * 1.5
    g = torch.randn((*hw, 3), device=cuda_device, generator=gen)
    effects.reset_launch_counts()
    torch.testing.assert_close(effects.bloom_quirk_cuda(x), effects.bloom_quirk_plain(x),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(effects.bloom_quirk_adjoint_cuda(g),
                               effects.bloom_quirk_adjoint_plain(g), rtol=1e-5, atol=1e-5)
    assert effects.launch_counts() == {"bloom_quirk_cuda": 1, "bloom_quirk_adjoint_cuda": 1}


def _bits_equal(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mirror_box", "mixed", "spheres", "spherical_box"])
def test_level_kernels_match_the_chain_on_card(name, cuda_device):
    # Every level of the default route through the kernels' wrapper and the
    # chain on the same inputs, bit for bit; the graphed frame equals the
    # chain's eager frame.
    from cg_raytracer_tpu_torch.models import whitted
    from cg_raytracer_tpu_torch.ops import level as lv
    from cg_raytracer_tpu_torch.ops.intersect import reconstruct_hit
    from cg_raytracer_tpu_torch.utils import graphs

    box, mixed, _, _, _ = card_inputs(cuda_device)
    scene = {"mirror_box": box, "mixed": mixed,
             "spheres": load_scene("spheres", device=cuda_device),
             "spherical_box": load_standin("spherical_box", device=cuda_device)}[name]
    cam = Camera.default(device=cuda_device)
    cfg, accel = whitted.resolve_render(scene, RenderConfig(width=256, height=256))
    levels = []

    def checked(scene_, o, d, hit, bits, color, thr, active, cfg_, backend, key=None,
                last=False):
        args = (scene_, o, d, hit, bits, color, thr, active, cfg_, backend, key)
        got, want = lv.level_cuda(*args, last=last), lv.level_plain(*args, last=last)
        for g, w in zip(got, want):
            assert (g is None and w is None) or _bits_equal(g, w)
        for g, w in zip(lv.level_surface_cuda(scene_, o, d, hit),
                        reconstruct_hit(scene_, o, d, hit)):
            assert _bits_equal(g, w)
        levels.append(bits is not None)
        return got

    backend = whitted.make_backend(scene, cfg, accel=accel)
    lv.reset_launch_counts()
    img = whitted.render_image(scene, cam, cfg, backend=backend._replace(level=checked),
                               generator=torch.Generator().manual_seed(1))
    assert len(levels) == cfg.max_depth
    counts = lv.launch_counts()
    fused = levels[0] and scene.spherical_lights.position.shape[0] == 0
    assert (counts["level_cuda"] > 0) == fused
    assert (counts["level_shade_cuda"] > 0) != fused
    chain = whitted.render_image(scene, cam, cfg, backend=backend._replace(level=lv.level_plain),
                                 generator=torch.Generator().manual_seed(1))
    graphs.clear()
    graphed = whitted.render(scene, cam, RenderConfig(width=256, height=256),
                             generator=torch.Generator().manual_seed(1))
    graphs.clear()
    assert _bits_equal(img, chain) and _bits_equal(graphed, chain)
    assert (chain.amax(dim=-1) > 0.02).float().mean().item() > 0.05


@pytest.mark.cuda
def test_level_kernels_stay_out_of_a_differentiated_render_on_card(cuda_device):
    from cg_raytracer_tpu_torch.models import whitted
    from cg_raytracer_tpu_torch.ops import level as lv

    box = load_standin("mirror_box", device=cuda_device)
    cam = Camera.default(device=cuda_device)
    cfg = RenderConfig(width=64, height=64)
    kd = box.materials.kd.clone().requires_grad_(True)
    scene = dataclasses.replace(box, materials=dataclasses.replace(box.materials, kd=kd))
    lv.reset_launch_counts()
    img = whitted.render(scene, cam, cfg, jit=False)
    img.mean().backward()
    assert lv.launch_counts() == {w: 0 for w in lv.launch_counts()}
    assert kd.grad.abs().sum().item() > 0
    # Called directly under grad, the kernels' outputs refuse a backward.
    backend = whitted.make_backend(scene, cfg)
    o, d = generate_rays(cam, 64, 64)
    hit, bits = backend.bounce(o, d)
    color = lv.level_cuda(scene, o, d, hit, bits, None, None, None, cfg, backend, last=True)[0]
    assert lv.launch_counts()["level_cuda"] == 1
    with pytest.raises(NotImplementedError, match="no backward"):
        color.sum().backward()
