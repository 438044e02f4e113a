"""PyTorch port on an NVIDIA GPU: each CUDA kernel against its plain PyTorch
twin on the card.  Skipped where there is no CUDA device.

This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: prim ids and booleans equal on >= 99.5% of rays; where ids match,
t/u/v (and the records' next rays, where active) within atol 1e-5, rtol
1e-5; colors on <= 0.5% of rays off by > 1e-4; shade outputs rtol 1e-5,
atol 1e-6; shade gradients as ``utils.checks.shade_grads_close``.
"""
import pytest
import torch

from cg_raytracer_tpu_torch.ops import cuda_kernels as ck
from cg_raytracer_tpu_torch.ops import shade
from cg_raytracer_tpu_torch.ops.camera import generate_rays
from cg_raytracer_tpu_torch.scene import standins
from cg_raytracer_tpu_torch.scene.types import Camera, PointLights, Spheres, make_scene
from cg_raytracer_tpu_torch.utils import checks


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
