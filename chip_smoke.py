#!/usr/bin/env python3
"""On-card check of the PyTorch + CUDA port: the forward render path and the
training path.

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases, each printing its own lines:
 1. the card's name and power limit (nvidia-smi);
 2. build the CUDA kernels from cg_raytracer_tpu_torch/csrc (ptxas report);
 3. each kernel against its plain PyTorch twin on the card, on the stand-in
    mirror box and on a triangles + spheres scene, at 1024x1024 primary rays
    plus one set of secondary rays;
 4. the main path: ``render`` of the stand-in box at 800x800 and 1024x1024,
    forward-only (trace kernel, what ``cgrt-torch render`` runs) and default
    (bounce kernel + PyTorch shading), plus the triangles + spheres scene
    (closest-hit and any-hit kernels);
 5. ``cli.main(["render", "--scene", "spheres", ...])`` once;
 6. every kernel's launch count from phases 4-5 is > 0, and every image
    agrees with the plain path on the card and is not trivial;
 7. each kernel's median time against its twin at 1024x1024 (CUDA events),
    and the main path's end-to-end rays/s;
 8. the training kernels (record-trace, bounce-refl, shade forward and
    backward) against their plain twins on the card at 1024x1024 primary
    rays: the records on the stand-in box, the shade on the triangles +
    spheres scene and the box, and at 256x256 on a scene at the shade
    kernel's caps (256 triangles, 8 spheres, 16 lights);
 9. the training main path: ``run_bench(include_bwd=True)`` on the stand-in
    box at 1024x1024 under the full-gradient and the materials-only
    contract, whose record-trace and shade launch counts are > 0; then, with
    the counts set to 0 again, one step whose records come level by level
    from the bounce-refl kernel, whose count is > 0; and one step's gradients
    agree with the same step through the plain path and are finite and
    non-zero;
10. each training kernel's time against its twin, and per contract ms/step,
    rays/s, the device-busy share and the plain path's ms/step.

Then one JSON line with the kernels' results and, last, ``{"ok": true,
"device": ...}``.  Any failure raises and exits non-zero; so does a machine
without CUDA.  Images and a results file go to ``--out`` (default
``chip_smoke_out/`` beside this script).
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNELS = {  # wrapper -> (name, source, Pallas kernel replaced), forward path first
    "intersect_cuda": ("closest", "cg_raytracer_tpu_torch/csrc/oracle.cu",
                       "cg_raytracer_tpu/ops/pallas_kernels.py:88"),
    "occluded_cuda": ("anyhit", "cg_raytracer_tpu_torch/csrc/oracle.cu",
                      "cg_raytracer_tpu/ops/pallas_kernels.py:131"),
    "bounce_cuda": ("bounce", "cg_raytracer_tpu_torch/csrc/oracle.cu",
                    "cg_raytracer_tpu/ops/pallas_kernels.py:176"),
    "trace_cuda": ("trace", "cg_raytracer_tpu_torch/csrc/trace.cu",
                   "cg_raytracer_tpu/ops/pallas_kernels.py:877"),
    "record_trace_cuda": ("record_trace", "cg_raytracer_tpu_torch/csrc/record.cu",
                          "cg_raytracer_tpu/ops/pallas_kernels.py:378"),
    "bounce_refl_cuda": ("bounce_refl", "cg_raytracer_tpu_torch/csrc/record.cu",
                         "cg_raytracer_tpu/ops/pallas_kernels.py:357"),
    "shade_fwd_cuda": ("shade_fwd", "cg_raytracer_tpu_torch/csrc/shade.cu",
                       "cg_raytracer_tpu/ops/pallas_shade.py:323"),
    "shade_bwd_cuda": ("shade_bwd", "cg_raytracer_tpu_torch/csrc/shade.cu",
                       "cg_raytracer_tpu/ops/pallas_shade.py:510"),
}
FORWARD_KERNELS = ("intersect_cuda", "occluded_cuda", "bounce_cuda", "trace_cuda")
TRAIN_KERNELS = ("record_trace_cuda", "bounce_refl_cuda", "shade_fwd_cuda", "shade_bwd_cuda")
TOL = 1e-5  # t/u/v where prim ids match
MIN_MATCH = 0.995  # prim ids, shadow bits, booleans
IMG_ATOL, IMG_MAX_BAD = 1e-4, 0.005  # assert_images_close
SHADE_FWD = dict(rtol=1e-5, atol=1e-6)


def images_close(a, b, what):
    bad = ((a - b).abs().amax(dim=-1) > IMG_ATOL).float().mean().item()
    err = (a - b).abs().max().item()
    print(f"  {what}: {bad:.5%} of pixels off by > {IMG_ATOL}, max abs diff {err:.3g}")
    assert bad <= IMG_MAX_BAD, f"{what}: {bad:.4%} of pixels differ"
    return bad, err


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="On-card check of the forward render path.")
    parser.add_argument("--out", default=os.path.join(ROOT, "chip_smoke_out"),
                        help="directory for the renders and results.json")
    out = parser.parse_args(argv).out
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from cg_raytracer_tpu_torch import cli
    from cg_raytracer_tpu_torch.models.whitted import make_backend, render, render_image
    from cg_raytracer_tpu_torch.models import whitted
    from cg_raytracer_tpu_torch.ops import _build
    from cg_raytracer_tpu_torch.ops import cuda_kernels as ck
    from cg_raytracer_tpu_torch.ops import shade
    from cg_raytracer_tpu_torch.ops.camera import generate_rays
    from cg_raytracer_tpu_torch.ops.intersect import reconstruct_hit
    from cg_raytracer_tpu_torch.ops.linalg import norm, reflect, safe_normalize
    from cg_raytracer_tpu_torch.scene import standins
    from cg_raytracer_tpu_torch.scene.types import Camera, PointLights, Spheres, make_scene
    from cg_raytracer_tpu_torch.utils import bench, checks
    from cg_raytracer_tpu_torch.utils.bench import median, run_bench, time_frames
    from cg_raytracer_tpu_torch.utils.config import RenderConfig
    from cg_raytracer_tpu_torch.utils.image import read_image, write_png
    from cg_raytracer_tpu_torch.utils.profiling import device_breakdown

    os.makedirs(out, exist_ok=True)
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}

    print("phase 1: nvidia-smi --query-gpu=name,power.limit --format=csv,noheader")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    print("phase 2: build the kernels")
    t0 = time.perf_counter()
    _build.load()
    results["build_s"] = time.perf_counter() - t0
    log = _build.library_path()[:-3] + ".log"
    print(f"  built {os.path.relpath(_build.library_path(), ROOT)} in {results['build_s']:.1f} s")
    with open(log) as f:
        print("".join(f"  ptxas: {line}" for line in f if "registers" in line or "spill" in line))

    box = make_scene(standins.mirror_box_meshes(),
                     point_lights=PointLights.of(*standins.MIRROR_BOX_LIGHTS), device=device)
    mixed = make_scene(standins.mixed_meshes(),
                       spheres=Spheres(**{k: torch.as_tensor(v)
                                          for k, v in standins.mixed_spheres().items()}),
                       point_lights=PointLights.of(*standins.MIXED_LIGHTS), device=device)
    cam = Camera.default(device=device)

    print("phase 3: kernels against their plain twins, 1024^2 primary + secondary rays")
    o1, d1 = generate_rays(cam, 1024, 1024)

    def ray_sets(scene):
        """Primary rays + their reflections, and shadow rays toward light 0."""
        surf = reconstruct_hit(scene, o1, d1, ck.intersect_plain(scene, o1, d1))
        refl = safe_normalize(reflect(d1, surf.normal))
        o2 = surf.position + 1e-3 * refl
        d2 = torch.where(surf.valid[:, None], refl, d1)
        to_light = scene.point_lights.position[0] - surf.position
        ldir = safe_normalize(to_light)
        shadow = (surf.position + 1e-3 * ldir, ldir, norm(to_light) - 1e-3)
        return torch.cat([o1, o2]), torch.cat([d1, d2]), surf.valid, shadow

    def hit_diff(got, want):
        same = got.prim_id == want.prim_id
        match = same.float().mean().item()
        finite = same & torch.isfinite(want.t)
        err = max((a[finite] - b[finite]).abs().max().item() if finite.any() else 0.0
                  for a, b in ((got.t, want.t), (got.u, want.u), (got.v, want.v)))
        for a, b in ((got.t, want.t), (got.u, want.u), (got.v, want.v)):
            torch.testing.assert_close(a[finite], b[finite], rtol=TOL, atol=TOL)
        assert match >= MIN_MATCH, f"prim ids agree on {match:.4%}"
        return match, err

    check = {k: {"mismatch": 0.0, "err": 0.0} for k in KERNELS}

    def note(wrapper, mismatch, err):
        check[wrapper]["mismatch"] = max(check[wrapper]["mismatch"], mismatch)
        check[wrapper]["err"] = max(check[wrapper]["err"], err)

    sets = {}
    for label, scene in (("box", box), ("mixed", mixed)):
        o, d, valid1, shadow = sets[label] = ray_sets(scene)
        match, err = hit_diff(ck.intersect_cuda(scene, o, d), ck.intersect_plain(scene, o, d))
        print(f"  closest {label}: prim ids agree on {match:.5%}, max |dt|,|du|,|dv| {err:.3g}")
        note("intersect_cuda", 1 - match, err)
        got = ck.occluded_cuda(scene, *shadow)
        want = ck.occluded_plain(scene, *shadow)
        match = (got == want).float().mean().item()
        err = (got.float() - want.float()).abs().max().item()
        print(f"  anyhit {label}: agree on {match:.5%} of {got.numel()} shadow rays "
              f"({want.float().mean().item():.2%} occluded)")
        assert match >= MIN_MATCH
        note("occluded_cuda", 1 - match, err)
        for quirks in (False, True):
            bad, err = images_close(ck.trace_cuda(scene, o1, d1, 2, quirks),
                                    ck.trace_plain(scene, o1, d1, 2, quirks),
                                    f"trace {label} depth 2 quirks={quirks}")
            note("trace_cuda", bad, err)
    o, d, valid1, _ = sets["box"]
    live = torch.cat([torch.ones_like(valid1), valid1])
    (gh, gb), (wh, wb) = ck.bounce_cuda(box, o, d, live), ck.bounce_plain(box, o, d, live)
    match, err = hit_diff(gh, wh)
    bits = (gb == wb).float().mean().item()
    print(f"  bounce box: prim ids agree on {match:.5%}, shadow bits on {bits:.5%}, "
          f"max |dt|,|du|,|dv| {err:.3g}")
    assert bits >= MIN_MATCH
    note("bounce_cuda", max(1 - match, 1 - bits), err)
    torch.cuda.synchronize()

    print("phase 4: main path (render) on the stand-in box and the triangles + spheres scene")
    ck.reset_launch_counts()
    renders = {}
    for size in (800, 1024):
        for fo in (True, False):
            cfg = RenderConfig(width=size, height=size, forward_only=fo)
            renders[("box", size, fo)] = (box, cfg, render(box, cam, cfg))
    for fo in (True, False):
        cfg = RenderConfig(width=800, height=800, forward_only=fo)
        renders[("mixed", 800, fo)] = (mixed, cfg, render(mixed, cam, cfg))
    print("phase 5: cgrt-torch render --scene spheres --device cuda")
    cli_png = os.path.join(out, "cli_spheres.png")
    assert cli.main(["render", "--scene", "spheres", "--device", "cuda", "--width", "800",
                     "--height", "800", "-o", cli_png]) == 0
    torch.cuda.synchronize()
    counts = {k: ck.launch_counts()[k] for k in FORWARD_KERNELS}

    print(f"phase 6: launch counts of the main path {counts}")
    for wrapper, n in counts.items():
        assert n > 0, f"{wrapper} never launched its kernel on the main path"
    for (label, size, fo), (scene, cfg, img) in renders.items():
        what = f"{label} {size}^2 forward_only={fo}"
        assert img.shape == (size, size, 3) and bool(torch.isfinite(img).all()), what
        plain = render_image(scene, cam, cfg, backend=make_backend(scene, cfg, plain=True))
        images_close(img, plain, f"{what} vs plain path")
        write_png(os.path.join(out, f"{label}_{size}_{'trace' if fo else 'bounce'}.png"), img)
        lit = (img.amax(dim=-1) > 0.02).float().mean().item()
        print(f"  {what}: lit fraction {lit:.3f}, mean {img.mean().item():.4f}")
        assert lit > 0.15, what
        if label == "box":
            r, g, b = img[..., 0], img[..., 1], img[..., 2]
            red = ((r > 0.05) & (r > 3 * g) & (r > 3 * b)).float().mean().item()
            green = ((g > 0.05) & (g > 1.5 * r) & (g > 1.5 * b)).float().mean().item()
            print(f"  {what}: red wall {red:.3f}, green wall {green:.3f} of pixels")
            assert red > 0.02 and green > 0.02, what
    for label, size in (("box", 800), ("box", 1024), ("mixed", 800)):
        images_close(renders[(label, size, True)][2], renders[(label, size, False)][2],
                     f"{label} {size}^2 trace kernel vs bounce/oracle path")
    # An independent reference: the CPU brute-force path, at 64^2.
    cpu_cfg = RenderConfig(width=64, height=64, backend="brute")
    for label, scene in (("box", box), ("mixed", mixed)):
        ref = render(scene.to("cpu"), Camera.default(), cpu_cfg)
        for fo in (True, False):
            img = render(scene, cam, RenderConfig(width=64, height=64, forward_only=fo))
            images_close(img.cpu(), ref, f"{label} 64^2 forward_only={fo} vs CPU brute force")
    spheres_img = read_image(cli_png)
    assert spheres_img.shape == (800, 800, 3) and (spheres_img.max(axis=-1) > 0.02).mean() > 0.05

    print("phase 7: times at 1024^2 on the stand-in box")
    _, _, _, (so, sd, st) = sets["box"]
    tri, aux, sph, lt = (ck._tri_table(box), ck._aux_table(box), ck._sphere_table(box),
                         ck._light_table(box))
    lpos = box.point_lights.position.contiguous()
    calls = {  # wrapper: (wrapper call, the bare kernel launch, its plain twin)
        "intersect_cuda": (lambda: ck.intersect_cuda(box, o1, d1),
                           lambda: ck._closest_kernel(tri, o1, d1, None),
                           lambda: ck._closest_plain(tri, o1, d1, None)),
        "occluded_cuda": (lambda: ck.occluded_cuda(box, so, sd, st),
                          lambda: ck._anyhit_kernel(tri, so, sd, st),
                          lambda: ck._anyhit_plain(tri, so, sd, st)),
        "bounce_cuda": (lambda: ck.bounce_cuda(box, o1, d1),
                        lambda: ck._bounce_kernel(tri, lpos, o1, d1, None),
                        lambda: ck._bounce_plain(tri, lpos, o1, d1, None)),
        "trace_cuda": (lambda: ck.trace_cuda(box, o1, d1, 2),
                       lambda: ck._trace_kernel(tri, aux, sph, lt, o1, d1, 2, False),
                       lambda: ck._trace_plain(tri, aux, sph, lt, o1, d1, 2, False)),
    }
    print("  ms = kernel time on the device (profiler); launch_ms = one bare launch between "
          "CUDA events; wrapper_ms = the wrapper call; plain_ms = the plain twin (events)")
    kernels = []
    for wrapper, (wrapper_fn, kernel_fn, plain_fn) in calls.items():
        wrapper_ms = median(time_frames(wrapper_fn, iters=20))
        launch_ms = median(time_frames(kernel_fn, iters=20))
        device_ms = device_breakdown(kernel_fn, iters=20)["device_ms"]
        plain_ms = median(time_frames(plain_fn, iters=5, warmup=1))
        ms = device_ms if device_ms is not None else launch_ms
        name, source, replaces = KERNELS[wrapper]
        print(f"  {name}: ms {ms:.5f} ({1024 * 1024 / ms / 1e3:.5g} M rays/s), launch_ms "
              f"{launch_ms:.5f}, wrapper_ms {wrapper_ms:.5f}, plain_ms {plain_ms:.4f} "
              f"(x{plain_ms / ms:.1f}); device time "
              f"{'measured' if device_ms is not None else 'not measured'}")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": counts[wrapper], "max_abs_err": check[wrapper]["err"],
                        "mismatch_frac": check[wrapper]["mismatch"], "ms": ms,
                        "plain_ms": plain_ms, "launch_ms": launch_ms,
                        "wrapper_ms": wrapper_ms})
    e2e = {}
    for size in (800, 1024):
        for fo in (True, False):
            path = "trace" if fo else "bounce"
            r = run_bench(box, width=size, height=size, cfg_overrides={"forward_only": fo})
            cfg = RenderConfig(width=size, height=size, forward_only=fo)
            kernel_be, plain_be = make_backend(box, cfg), make_backend(box, cfg, plain=True)
            prof = device_breakdown(lambda: render_image(box, cam, cfg, backend=kernel_be))
            plain_ms = median(time_frames(lambda: render_image(box, cam, cfg, backend=plain_be),
                                          iters=3, warmup=1))
            e2e[f"box_{size}_{path}"] = {"ms": r["seconds_per_frame"] * 1e3,
                                         "rays_per_s": r["value"], "plain_ms": plain_ms,
                                         "profile": prof}
            busy = f"{prof['busy']:.3f}" if prof["busy"] is not None else "not measured"
            print(f"  render box {size}^2 {path} path: {r['seconds_per_frame'] * 1e3:.5f} "
                  f"ms/frame (CUDA events), {r['value']:.5g} primary rays/s; plain path "
                  f"{plain_ms:.3f} ms; profiled wall {prof['wall_ms']:.4f} ms, device busy {busy}")
            for kname, kms, n in prof["kernels"][:6]:
                print(f"    {kms:.5f} ms x{n:g}  {kname[:90]}")

    print("phase 8: training kernels against their plain twins, 1024^2 primary rays")
    rec_tables = ck._record_tables(box, "record")
    for quirks in (False, True):
        got, want = ck.record_trace_cuda(box, o1, d1, 2, quirks), ck.record_trace_plain(
            box, o1, d1, 2, quirks)
        for level, ((go, gd, gh, gb, ga), (wo, wd, wh, wb, wa)) in enumerate(zip(got, want)):
            match, err = hit_diff(gh, wh)
            same_bits = (gb == wb).float().mean().item()
            same_active = (ga == wa).float().mean().item()
            both = ga & wa & (gh.prim_id == wh.prim_id)
            for a, b in ((go, wo), (gd, wd)):
                torch.testing.assert_close(a[both], b[both], rtol=TOL, atol=TOL)
                err = max(err, (a[both] - b[both]).abs().max().item() if both.any() else 0.0)
            assert min(same_bits, same_active) >= MIN_MATCH
            print(f"  record_trace level {level} quirks={quirks}: prim ids agree on "
                  f"{match:.5%}, bits {same_bits:.5%}, active {same_active:.5%} "
                  f"({ga.float().mean().item():.2%} active), max |d t,u,v,o,d| {err:.3g}")
            note("record_trace_cuda", 1 - min(match, same_bits, same_active), err)
    live = torch.arange(o1.shape[0], device=device) % 5 != 0
    got, want = ck.bounce_refl_cuda(box, o1, d1, live), ck.bounce_refl_plain(box, o1, d1, live)
    match, err = hit_diff(got[0], want[0])
    same = got[0].prim_id == want[0].prim_id
    for a, b in ((got[2], want[2]), (got[3], want[3])):
        torch.testing.assert_close(a[same], b[same], rtol=TOL, atol=TOL)
        err = max(err, (a[same] - b[same]).abs().max().item())
    agree = min((got[1] == want[1]).float().mean().item(),
                (got[4] == want[4]).float().mean().item())
    assert agree >= MIN_MATCH
    print(f"  bounce_refl box: prim ids agree on {match:.5%}, bits and reflective flags on "
          f"{agree:.5%}, max |d t,u,v,position,reflection| {err:.3g}")
    note("bounce_refl_cuda", 1 - min(match, agree), err)
    gen = torch.Generator(device).manual_seed(8)
    o_cap, d_cap = generate_rays(Camera.default(dist=4.0, device=device), 256, 256)
    cap = checks.cap_scene(device)
    for label, scene, so, sd in (("mixed", mixed, o1, d1), ("box", box, o1, d1),
                                 ("256-triangle cap scene at 256^2", cap, o_cap, d_cap)):
        hit = ck.intersect_plain(scene, so, sd)
        prim = hit.prim_id.contiguous()
        bits = torch.randint(0, 1 << scene.point_lights.position.shape[0], prim.shape,
                             device=device, dtype=torch.int32, generator=gen)
        tri, aux, lights, spheres, num_tris = shade._shade_tables(scene)
        tables = (tri.detach(), aux.detach(), lights.detach(), spheres.detach())
        got = shade.shade_fwd_cuda(*tables, so, sd, prim, bits, num_tris)
        want = shade.shade_plain(*tables, so, sd, prim, bits, num_tris=num_tris)
        err = 0.0
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **SHADE_FWD)
            err = max(err, (a - b).abs().max().item())
        print(f"  shade_fwd {label}: max |d direct,ks,normal,position| {err:.3g} "
              f"({(prim >= 0).float().mean().item():.2%} of rays hit)")
        note("shade_fwd_cuda", 0.0, err)
        cts = [torch.randn(so.shape, device=device, generator=gen) for _ in range(4)]
        got = shade.shade_bwd_cuda(*tables, so, sd, prim, bits, num_tris, cts)
        twin, exact = checks.twin_grads(tables, so, sd, prim, bits, num_tris, cts)
        report = checks.shade_grads_close(got, twin, exact, so.shape[0])
        for name, a, b in zip(checks.GRAD_NAMES, got, twin):
            err = (a - b).abs().max().item() if b.numel() else 0.0
            scale = b.abs().max().item() if b.numel() else 0.0
            ratio, past = report[name]
            print(f"  shade_bwd {label} {name}: max |kernel - twin| {err:.3g} (max |twin| "
                  f"{scale:.3g}), at most {ratio:.3g} of the (widened) tolerance; {past:.5%} of "
                  f"elements past the tolerance before the float32 widening")
            note("shade_bwd_cuda", past, err)
    torch.cuda.synchronize()

    print("phase 9: training main path, run_bench(include_bwd=True) on the stand-in box 1024^2")
    contracts = {"full": True, "materials": False}
    ck.reset_launch_counts()
    shade.reset_launch_counts()
    train = {c: run_bench(box, width=1024, height=1024, include_bwd=True, iters=10,
                          include_vertex_params=v, scene_name="stand-in mirror box")
             for c, v in contracts.items()}
    torch.cuda.synchronize()
    train_counts = {**ck.launch_counts(), **shade.launch_counts()}
    print(f"  launch counts of run_bench(include_bwd=True) {train_counts}")
    for wrapper in ("record_trace_cuda", "shade_fwd_cuda", "shade_bwd_cuda"):
        assert train_counts[wrapper] > 0, f"{wrapper} never launched its kernel on the main path"
    # The by-level record path: one step whose records come level by level
    # from the bounce-refl kernel (a backend without record_trace).
    cfg_full = bench.training_config(RenderConfig(width=1024, height=1024), True)
    scn = dataclasses.replace(box, vertices=box.vertices.detach().requires_grad_(True))
    by_level = whitted.make_backend(scn, cfg_full)._replace(record_trace=None)
    ck.reset_launch_counts()
    shade.reset_launch_counts()
    render_image(scn, cam, cfg_full, backend=by_level).mean().backward()
    torch.cuda.synchronize()
    level_counts = {**ck.launch_counts(), **shade.launch_counts()}
    print(f"  launch counts of one step through the by-level records {level_counts}")
    assert level_counts["bounce_refl_cuda"] > 0, "bounce_refl_cuda never launched its kernel"
    train_counts["bounce_refl_cuda"] = level_counts["bounce_refl_cuda"]
    for c, r in train.items():
        print(f"  {r['metric']}: {r['seconds_per_frame'] * 1e3:.5f} ms/step, "
              f"{r['value']:.6g} rays/s ({r['vs_baseline']:.4g}x the reference CPU's forward)")
    jitter = bench.camera_jitter(torch.Generator(device).manual_seed(9), device)
    steps = {}
    for c, v in contracts.items():
        cfg = bench.training_config(RenderConfig(width=1024, height=1024), v)
        params = bench.training_params(box, v)
        (lk, gk), (lp, gp) = (bench.fwd_bwd_step(box, cam, cfg, params, jitter, plain=plain)
                              for plain in (False, True))
        steps[c] = (cfg, params)
        print(f"  {c} contract, one step: loss {lk.item():.8g} (plain path {lp.item():.8g})")
        torch.testing.assert_close(lk, lp, rtol=1e-5, atol=1e-7)
        for k in gk:
            tol = dict(checks.TABLE_GRAD, atol=2e-5) if k == "vertices" else checks.TABLE_GRAD
            assert bool(torch.isfinite(gk[k]).all()), k
            torch.testing.assert_close(gk[k], gp[k], **tol, msg=f"{c} d/d{k}")
            print(f"    d/d{k}: max |kernel - plain| {(gk[k] - gp[k]).abs().max().item():.3g}, "
                  f"max |grad| {gp[k].abs().max().item():.3g}")
        for k in ("kd", "ks", "light_color", "light_position") + (("vertices",) if v else ()):
            assert gk[k].abs().sum().item() > 0, f"{c}: d/d{k} is zero"

    print("phase 10: training kernel times at 1024^2 on the stand-in box")
    recs = ck.record_trace_cuda(box, o1, d1, 2)
    ro, rd, rhit, rbits, _ = recs[0]
    s_tables = tuple(x.detach() for x in shade._shade_tables(box)[:4])
    num_t = box.num_triangles
    cts = [torch.full_like(o1, 1.0 / o1.numel()) for _ in range(4)]

    def shade_bwd_plain():
        leaves = [x.detach().requires_grad_(True) for x in (*s_tables, ro, rd)]
        outs = shade.shade_plain(*leaves, rhit.prim_id, rbits, num_tris=num_t)
        return torch.autograd.grad(outs, leaves, cts, allow_unused=True)

    train_calls = {
        "record_trace_cuda": (lambda: ck._record_kernel(*rec_tables, o1, d1, 2, False),
                              lambda: ck._record_plain(*rec_tables, o1, d1, 2, False)),
        "bounce_refl_cuda": (lambda: ck._bounce_refl_kernel(*rec_tables, o1, d1, None, False),
                             lambda: ck._bounce_refl_plain(*rec_tables, o1, d1, None, False)),
        "shade_fwd_cuda": (lambda: shade.shade_fwd_cuda(*s_tables, ro, rd, rhit.prim_id, rbits,
                                                        num_t),
                           lambda: shade.shade_plain(*s_tables, ro, rd, rhit.prim_id, rbits,
                                                     num_tris=num_t)),
        "shade_bwd_cuda": (lambda: shade.shade_bwd_cuda(*s_tables, ro, rd, rhit.prim_id, rbits,
                                                        num_t, cts),
                           shade_bwd_plain),
    }
    print("  ms = kernel time on the device (profiler); launch_ms = one bare launch between "
          "CUDA events; plain_ms = the plain twin (events; for shade_bwd the twin's forward "
          "and autograd backward)")
    for wrapper, (kernel_fn, plain_fn) in train_calls.items():
        launch_ms = median(time_frames(kernel_fn, iters=20))
        device_ms = device_breakdown(kernel_fn, iters=20)["device_ms"]
        plain_ms = median(time_frames(plain_fn, iters=5, warmup=1))
        ms = device_ms if device_ms is not None else launch_ms
        name, source, replaces = KERNELS[wrapper]
        print(f"  {name}: ms {ms:.5f}, launch_ms {launch_ms:.5f}, plain_ms {plain_ms:.4f} "
              f"(x{plain_ms / ms:.1f}); device time "
              f"{'measured' if device_ms is not None else 'not measured'}")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": train_counts[wrapper],
                        "max_abs_err": check[wrapper]["err"],
                        "mismatch_frac": check[wrapper]["mismatch"], "ms": ms,
                        "plain_ms": plain_ms, "launch_ms": launch_ms})
    for c, (cfg, params) in steps.items():
        step = lambda: bench.fwd_bwd_step(box, cam, cfg, params, jitter)  # noqa: E731
        prof = device_breakdown(step, iters=5)
        plain_ms = median(time_frames(lambda: bench.fwd_bwd_step(box, cam, cfg, params, jitter,
                                                                 plain=True),
                                      iters=2, warmup=1))
        r = train[c]
        busy = f"{prof['busy']:.3f}" if prof["busy"] is not None else "not measured"
        e2e[f"box_1024_train_{c}"] = {"ms": r["seconds_per_frame"] * 1e3,
                                      "rays_per_s": r["value"], "plain_ms": plain_ms,
                                      "profile": prof}
        print(f"  train {c} contract 1024^2: {r['seconds_per_frame'] * 1e3:.5f} ms/step (CUDA "
              f"events), {r['value']:.6g} primary rays/s fwd+bwd; plain path {plain_ms:.3f} "
              f"ms/step; profiled wall {prof['wall_ms']:.4f} ms, device busy {busy}")
        for kname, kms, n in prof["kernels"][:8]:
            print(f"    {kms:.5f} ms x{n:g}  {kname[:90]}")
    counts.update({k: train_counts[k] for k in TRAIN_KERNELS})

    results.update(card=smi, counts=counts, kernels=kernels, end_to_end=e2e)
    with open(os.path.join(out, "results.json"), "w") as f:
        json.dump(results, f, indent=1)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
