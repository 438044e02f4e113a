"""Benchmarks on the card, as ``run_bench`` of ``cg_raytracer_tpu/utils/bench.py``:
the forward render (``include_bwd=False``) and the training step
(``include_bwd=True``: render, mean loss, backward).

Each frame or step is one call, timed with CUDA events after a warm-up; the
result is the median over ``iters`` calls.  One frame or step per
measurement is what a serving user or a trainer waits for, so none are
batched into one call (the JAX package scanned frames only to amortise
dispatch through a remote TPU).  There is no CPU fallback: the benchmark
needs a CUDA device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

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


def median(values):
    values = sorted(values)
    return values[len(values) // 2]


def training_config(cfg, include_vertex_params: bool):
    """The JAX package's training routing (utils/bench.py:81-97): the
    two-phase structure on, and phase 2 on the recorded rays when no vertex
    is differentiated (the reflected-origin vertex term is then zero)."""
    if cfg.grad_two_phase == "auto":
        cfg = dataclasses.replace(cfg, grad_two_phase="on")
    if cfg.two_phase_rays == "auto" and not include_vertex_params:
        cfg = dataclasses.replace(cfg, two_phase_rays="recorded")
    return cfg


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


def fwd_bwd_step(scene, camera, cfg, params: dict, jitter, plain: bool = False):
    """One training step: fresh leaves of ``params`` -> scene -> render with
    the camera's look_at moved by ``jitter`` -> mean -> backward.  Returns
    (loss, {name: gradient}).  ``plain=True`` routes the kernels through
    their plain twins (the reference the kernel step is checked against)."""
    from ..models.whitted import make_backend, render_image
    from ..optim.inverse import apply_material_params, apply_vertex_params

    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    scn = apply_material_params(scene, leaves)
    if "vertices" in leaves:
        scn = apply_vertex_params(scn, leaves)
    cam = dataclasses.replace(camera, look_at=camera.look_at + jitter)
    loss = render_image(scn, cam, cfg, backend=make_backend(scn, cfg, plain=plain)).mean()
    loss.backward()
    return loss.detach(), {k: v.grad for k, v in leaves.items()}


def run_bench(scene: Union[str, "Scene"] = "cornell_box", width: int = 1024,
              height: int = 1024, backend: str = "auto", include_bwd: bool = False,
              iters: int = 10, max_depth: int = 2, data_dir: Optional[str] = None,
              cfg_overrides: Optional[dict] = None, device="cuda",
              include_vertex_params: bool = False, seed: int = 0,
              scene_name: Optional[str] = None) -> dict:
    """Steady-state throughput in primary rays/s: forward frames, or with
    ``include_bwd`` training steps (materials + lights, plus vertices with
    ``include_vertex_params``; the camera jittered per step from a
    generator seeded with ``seed``).  ``scene`` is a preset name or a Scene
    (moved to ``device``, and named in the metric by ``scene_name``)."""
    from ..models.whitted import effective_max_depth, make_backend, render_image
    from ..scene.presets import load_scene
    from ..scene.types import Camera
    from .config import RenderConfig

    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"run_bench times the card with CUDA events; no CUDA device "
                           f"({device}, torch.cuda.is_available()="
                           f"{torch.cuda.is_available()})")
    name = scene if isinstance(scene, str) else (scene_name or "custom scene")
    scn = (load_scene(scene, data_dir=data_dir, device=device) if isinstance(scene, str)
           else scene.to(device))
    cfg = RenderConfig(width=width, height=height, max_depth=max_depth, backend=backend,
                       forward_only=not include_bwd)
    cfg = dataclasses.replace(cfg, **(cfg_overrides or {}))
    cfg = dataclasses.replace(cfg, max_depth=effective_max_depth(scn, cfg))
    camera = Camera.default(aspect=width / height, device=device)
    if include_bwd:
        cfg = training_config(cfg, include_vertex_params)
        params = training_params(scn, include_vertex_params)
        gen = torch.Generator(device=device).manual_seed(seed)
        jitters = iter([camera_jitter(gen, device) for _ in range(iters + 2)])
        ms = median(time_frames(lambda: fwd_bwd_step(scn, camera, cfg, params, next(jitters)),
                                iters=iters, warmup=2))
        what = ("fwd+bwd", "materials + lights + vertices" if include_vertex_params
                else "materials + lights")
    else:
        backend_ = make_backend(scn, cfg)
        ms = median(time_frames(lambda: render_image(scn, camera, cfg, backend=backend_),
                                iters=iters))
        what = ("fwd", f"forward_only={cfg.forward_only}")
    rays_per_s = width * height / (ms / 1e3)
    return {
        "metric": f"primary rays/s {what[0]} ({name} {width}x{height}, {scn.num_triangles} "
                  f"tris, {what[1]})",
        "value": rays_per_s,
        "unit": "rays/s",
        "vs_baseline": rays_per_s / BASELINE_RAYS_PER_S,
        "seconds_per_frame": ms / 1e3,
        "device": torch.cuda.get_device_name(device),
    }
