"""Benchmarks on the card, as ``run_bench`` of ``cg_raytracer_tpu/utils/bench.py``:
the forward render (``include_bwd=False``) and the training step
(``include_bwd=True``: render, mean loss, backward).

Each frame or step is one call, timed with CUDA events after a warm-up; the
result is the median over ``iters`` calls.  With ``jit`` (the default) a
call is what ``render()`` and ``optimize()`` run on the card: one replay of
the frame's or the step's cached CUDA graph (``utils/graphs.py``; the
step's jittered camera and sample key are inputs of the replay), where the
JAX package times its jitted call.  ``jit=False`` times the eager call.
One frame or step per measurement is what a serving user or a trainer
waits for, so none are batched into one call (the JAX package scanned
frames to amortise dispatch through a remote TPU).  There is no CPU
fallback: the benchmark needs a CUDA device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ..optim.inverse import training_config

BASELINE_RAYS_PER_S = 3.8e6  # reference CPU, Cornell/point 800x800 (BASELINE.md)


def time_frames(fn, iters: int = 10, warmup: int = 2) -> list:
    """Milliseconds of each of ``iters`` calls of ``fn`` on the current CUDA
    stream (CUDA events around each call, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


def time_fn(fn, *args, iters: int = 5, warmup: int = 2) -> float:
    """Median seconds of ``fn(*args)`` by the host clock, each call ending in
    a synchronize of the card (``time_fn`` of the JAX package, which blocks
    on the result)."""
    import time

    def sync():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    for _ in range(warmup):
        fn(*args)
        sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        times.append(time.perf_counter() - t0)
    return median(times)


def median(values):
    values = sorted(values)
    return values[len(values) // 2]


def training_params(scene, include_vertex_params: bool) -> dict:
    """What a step differentiates: materials and point lights, plus the
    vertices under the full-gradient contract."""
    from ..optim.inverse import material_params

    params = material_params(scene)
    if include_vertex_params:
        params["vertices"] = scene.vertices
    return params


def camera_jitter(generator: torch.Generator, device) -> torch.Tensor:
    """A look_at offset drawn uniform in [-1e-4, 1e-4)^3 (utils/bench.py:72-79):
    each step renders a distinct frame."""
    return torch.rand((3,), generator=generator, device=device) * 2e-4 - 1e-4


def _training_apply(scene, params):
    from ..optim.inverse import apply_material_params, apply_vertex_params

    scene = apply_material_params(scene, params)
    return apply_vertex_params(scene, params) if "vertices" in params else scene


def fwd_bwd_step(scene, camera, cfg, params: dict, jitter, plain: bool = False, accel=None,
                 generator=None):
    """One training step (``optim/inverse.py::loss_and_grads`` of
    ``render_params``): fresh leaves of ``params`` -> scene -> render with
    the camera's look_at moved by ``jitter`` -> mean -> backward.  Returns (loss, {name: gradient}).
    ``plain=True`` routes the kernels through their plain twins (the
    reference the kernel step is checked against).  ``accel``: the scene's
    tree, built once by the caller (the step's fresh vertex leaves would
    defeat ``build_accel``'s memo and rebuild it every step).
    ``generator``: the step's ``torch.Generator`` for the spherical lights'
    samples (None: seeded 0)."""
    from ..optim.inverse import loss_and_grads, render_params

    cam = dataclasses.replace(camera, look_at=camera.look_at + jitter)
    return loss_and_grads(lambda p: render_params(p, scene, cam, cfg, _training_apply,
                                                  generator, accel, plain=plain).mean(), params)


def run_bench(scene: Union[str, "Scene"] = "cornell_box", width: int = 1024,
              height: int = 1024, backend: str = "auto", include_bwd: bool = False,
              iters: int = 10, max_depth: int = 2, data_dir: Optional[str] = None,
              cfg_overrides: Optional[dict] = None, device="cuda",
              include_vertex_params: bool = False, seed: int = 0,
              scene_name: Optional[str] = None, jit: bool = True) -> dict:
    """Steady-state throughput in primary rays/s: forward frames, or with
    ``include_bwd`` training steps (materials + lights, plus vertices with
    ``include_vertex_params``; the camera jittered per step from a
    generator seeded with ``seed``, and each step's spherical-light samples
    from a CPU generator of its own, seeded from ``seed``).  ``scene`` is a
    preset name, a stand-in (``presets.STANDIN_NAMES``) or a Scene
    (moved to ``device``, and named in the metric by ``scene_name``).  A
    mesh scene's tree is built once on the host (``accel_build_s``, not
    timed in the frames) and serves every frame and step, as the JAX
    package's run_bench does.  ``jit``: each frame or step is one replay of
    its CUDA graph (captured in the warm-up), else the eager call.  A
    brute-force scene without spheres also gets ``pct_of_roofline`` and
    ``roofline`` (the JAX package's condition: only that path has a
    closed-form work count)."""
    import time

    from ..models.whitted import (build_accel, effective_max_depth, make_backend, needs_bvh,
                                  render_image, render_resolved, resolve_fwd_shade_kernel)
    from ..ops import soft
    from ..scene.presets import STANDIN_NAMES, load_scene, load_standin
    from ..scene.types import Camera
    from . import graphs
    from .config import RenderConfig
    from .roofline import headline_roofline, pct_of_roofline

    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"run_bench times the card with CUDA events; no CUDA device "
                           f"({device}, torch.cuda.is_available()="
                           f"{torch.cuda.is_available()})")
    if isinstance(scene, str):
        standin = scene in STANDIN_NAMES
        name = f"stand-in {scene.replace('_', ' ')}" if standin else scene
        scn = (load_standin(scene, device=device) if standin
               else load_scene(scene, data_dir=data_dir, device=device))
    else:
        name, scn = scene_name or "custom scene", scene.to(device)
    cfg = RenderConfig(width=width, height=height, max_depth=max_depth, backend=backend,
                       forward_only=not include_bwd)
    cfg = dataclasses.replace(cfg, **(cfg_overrides or {}))
    cfg = dataclasses.replace(cfg, max_depth=effective_max_depth(scn, cfg))
    cfg = resolve_fwd_shade_kernel(scn, cfg)
    camera = Camera.default(aspect=width / height, device=device)
    t0 = time.perf_counter()
    accel = build_accel(scn, cfg) if needs_bvh(cfg, scn.num_triangles, device) else None
    accel_build_s = time.perf_counter() - t0
    spherical = scn.spherical_lights.position.shape[0] > 0
    if include_bwd:
        cfg = training_config(cfg, include_vertex_params)
        params = training_params(scn, include_vertex_params)
        gen = torch.Generator(device=device).manual_seed(seed)
        jitters = iter([camera_jitter(gen, device) for _ in range(iters + 2)])
        seeds = torch.randint(0, 1 << 62, (iters + 2,),
                              generator=torch.Generator().manual_seed(seed))
        gens = iter([torch.Generator().manual_seed(s) for s in seeds.tolist()])

        def graphed_step(s, c, jitter, key):
            return fwd_bwd_step(s, c, cfg, training_params(s, include_vertex_params), jitter,
                                accel=accel, generator=key)

        def step():
            jitter, g = next(jitters), next(gens)
            if not jit:
                return fwd_bwd_step(scn, camera, cfg, params, jitter, accel=accel, generator=g)
            key = soft.draw_key(g) if spherical else None
            return graphs.fwd_bwd(graphed_step, (scn, camera, jitter), key, cfg, accel,
                                  owner=graphed_step)

        ms = median(time_frames(step, iters=iters, warmup=2))
        graphs.forget(graphed_step)
        what = ("fwd+bwd", "materials + lights + vertices" if include_vertex_params
                else "materials + lights")
    else:
        if jit:
            frame = lambda: render_resolved(scn, camera, cfg, accel)  # noqa: E731
        else:
            backend_ = make_backend(scn, cfg, accel=accel)
            frame = lambda: render_image(scn, camera, cfg, backend=backend_)  # noqa: E731
        ms = median(time_frames(frame, iters=iters))
        what = ("fwd", f"forward_only={cfg.forward_only}")
    rays_per_s = width * height / (ms / 1e3)
    result = {
        "metric": f"primary rays/s {what[0]} ({name} {width}x{height}, {scn.num_triangles} "
                  f"tris, {what[1]})",
        "value": rays_per_s,
        "unit": "rays/s",
        "vs_baseline": rays_per_s / BASELINE_RAYS_PER_S,
        "seconds_per_frame": ms / 1e3,
        "accel_build_s": accel_build_s,
        "device": torch.cuda.get_device_name(device),
        "jit": jit,
    }
    if scn.num_triangles <= cfg.pallas_brute_max_tris and scn.spheres.radius.shape[0] == 0:
        info = headline_roofline(width, height, scn.num_triangles,
                                 scn.point_lights.position.shape[0], cfg.max_depth,
                                 include_bwd=include_bwd)
        result["pct_of_roofline"] = pct_of_roofline(
            ms / 1e3, info["gflops_per_frame"] * 1e9, info["mbytes_per_frame"] * 1e6)
        result["roofline"] = info
    return result
