"""Whitted-style renderer, as in ``cg_raytracer_tpu/models/whitted.py`` (the
reference's trace/shade recursion, main.cpp:160-310, and renderRayTracing,
main.cpp:648-720).  The bounce recursion (depth cap 2) is an unrolled loop
with a per-ray throughput and active mask:

    color      += throughput * direct_light(hit)        (shade, main.cpp:244-263)
    throughput *= ks;  ray = reflected ray + eps offset  (main.cpp:252-256)
    active     &= hit && any(ks > 0.01)                  (main.cpp:246, fixed form)

Intersection backends sit behind one oracle contract (``ops/intersect.py``):
``brute`` sweeps in PyTorch on the CPU; ``cuda`` runs the kernels of
``ops/cuda_kernels.py`` on the card (and their plain twins for CPU tensors).

Under ``grad_two_phase='on'`` the trace splits in two (``_trace_two_phase``):
phase 1 records every level's hits, shadow bits and next rays on the
detached scene (the record-trace kernel, or a loop of bounce-refl or bounce
+ ``record_surface``); phase 2 shades the records differentiably, through the
fused shade kernel (``ops/shade.py``) where the scene allows it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from ..ops import camera as cam_ops
from ..ops import cuda_kernels as ck
from ..ops import shade as shade_ops
from ..ops import shading
from ..ops.intersect import (intersect_brute, occluded_brute, reconstruct_hit,
                             record_surface)
from ..ops.linalg import norm, reflect, safe_normalize
from ..scene.types import Camera, Scene
from ..utils.config import RenderConfig

REFLECT_EPS = 1e-3


class Backend(NamedTuple):
    """Intersection oracles.  ``bounce`` (closest hit + per-light shadow bits
    in one kernel), ``bounce_refl`` and ``record_trace`` (the two-phase
    records, one level or all of them in one kernel) and ``trace`` (the whole
    forward trace in one kernel) are fast paths that exist only where the
    scene and config allow them.  ``shade`` is the phase-2 shade: the kernel
    wrapper ``shade_fused_cuda`` or its plain twin."""

    closest: Callable  # (origins, dirs) -> Hit
    occluded: Callable  # (origins, dirs, t_max) -> bool [N]
    # (scene, o, d, hit, bits) -> (direct, valid, ks, normal, position)
    shade: Callable
    bounce: Optional[Callable] = None  # (origins, dirs, live=None) -> (Hit, bits [N] i32)
    # (origins, dirs, live=None) -> (Hit, bits, position [N,3], refl_dir [N,3],
    # reflective [N] bool)
    bounce_refl: Optional[Callable] = None
    # (origins, dirs) -> per-level list of (o, d, Hit, bits, active)
    record_trace: Optional[Callable] = None
    trace: Optional[Callable] = None  # (origins, dirs) -> color [N, 3]


def make_backend(scene: Scene, cfg: RenderConfig, plain: bool = False) -> Backend:
    """Oracles for ``scene`` on its device.  ``plain=True`` routes the cuda
    backend, and the phase-2 shade, through the kernels' plain PyTorch twins
    on any device: the reference a kernel render is checked against."""
    kind = cfg.resolve_backend(scene.num_triangles, scene.device)
    if kind == "brute":
        return Backend(
            closest=lambda o, d: intersect_brute(scene, o, d, tri_chunk=cfg.tri_chunk),
            occluded=lambda o, d, tm: occluded_brute(scene, o, d, tm, tri_chunk=cfg.tri_chunk),
            shade=shade_ops.shade_fused_plain if plain else shade_ops.shade_fused_cuda,
        )
    if scene.num_triangles > cfg.pallas_brute_max_tris:
        raise NotImplementedError(
            f"{scene.num_triangles} triangles exceed the brute-force kernels' cap "
            f"({cfg.pallas_brute_max_tris}); the BVH kernels are not ported yet "
            f"(ROADMAP B5)")
    if plain:
        closest, occluded = ck.intersect_plain, ck.occluded_plain
        bounce, trace = ck.bounce_plain, ck.trace_plain
        bounce_refl, record_trace = ck.bounce_refl_plain, ck.record_trace_plain
    else:
        closest, occluded = ck.intersect_cuda, ck.occluded_cuda
        bounce, trace = ck.bounce_cuda, ck.trace_cuda
        bounce_refl, record_trace = ck.bounce_refl_cuda, ck.record_trace_cuda
    fused = ck.supports_fused_bounce(scene)
    quirk = cfg.reference_quirks
    return Backend(
        closest=lambda o, d: closest(scene, o, d),
        occluded=lambda o, d, tm: occluded(scene, o, d, tm),
        bounce=(lambda o, d, live=None: bounce(scene, o, d, live=live)) if fused else None,
        bounce_refl=((lambda o, d, live=None: bounce_refl(scene, o, d, live=live,
                                                          quirk_ks_z=quirk))
                     if fused else None),
        record_trace=((lambda o, d: record_trace(scene, o, d, cfg.max_depth, quirk_ks_z=quirk))
                      if fused else None),
        trace=((lambda o, d: trace(scene, o, d, cfg.max_depth, quirk_ks_z=quirk))
               if cfg.forward_only and ck.supports_trace_kernel(scene) else None),
        shade=shade_ops.shade_fused_plain if plain else shade_ops.shade_fused_cuda,
    )


def trace_rays(scene: Scene, origins, dirs, cfg: RenderConfig, backend: Backend,
               generator: Optional[torch.Generator] = None):
    """Iterative Whitted trace of a ray batch -> color [N, 3].

    - miss -> black (main.cpp:289-294); contributions past ``max_depth``
      levels are dropped (main.cpp:267);
    - reflection continues while any ks > 0.01; under ``reference_quirks``
      only ks.z is tested (the reference's comma-operator bug, main.cpp:246);
    - reflected ray: reflect(dir, shading normal), origin offset by 1e-3.
    """
    if backend.trace is not None:
        return backend.trace(origins, dirs)
    if cfg.resolve_grad_two_phase():
        return _trace_two_phase(scene, origins, dirs, cfg, backend, generator)

    n = origins.shape[0]
    color = torch.zeros((n, 3), dtype=torch.float32, device=origins.device)
    throughput = torch.ones_like(color)
    active = torch.ones((n,), dtype=torch.bool, device=origins.device)
    o, d = origins, dirs
    for level in range(cfg.max_depth):
        shadow_bits = None
        if backend.bounce is not None:
            hit, shadow_bits = backend.bounce(o, d, live=active if level > 0 else None)
        else:
            hit = backend.closest(o, d)
        surf = reconstruct_hit(scene, o, d, hit)
        direct = shading.direct_light(scene, d, surf, backend.occluded, generator,
                                      shadow_bits=shadow_bits)
        lit = active & surf.valid
        color = color + throughput * direct * lit[:, None].to(torch.float32)
        if level + 1 >= cfg.max_depth:
            break
        if cfg.reference_quirks:
            reflective = surf.ks[:, 2] > 0.01  # comma-operator bug (main.cpp:246)
        else:
            reflective = (surf.ks > 0.01).any(dim=1)
        active = lit & reflective
        throughput = throughput * surf.ks
        refl_dir = safe_normalize(reflect(d, surf.normal))
        o = surf.position + REFLECT_EPS * refl_dir
        d = torch.where(active[:, None], refl_dir, d)
    return color


def _detached(obj):
    """A copy of a scene dataclass with every tensor detached."""
    return dataclasses.replace(obj, **{
        f.name: (_detached(v) if dataclasses.is_dataclass(v) else v.detach())
        for f in dataclasses.fields(obj) for v in (getattr(obj, f.name),)})


def _synth_bounce(scene: Scene, backend: Backend):
    """A (Hit, bits) bounce composed from the closest and any-hit oracles, for
    backends without a fused bounce kernel (brute force, scenes with sphere
    primitives): the bits come from the same occluded oracle the one-phase
    ``direct_point_lights`` calls, at the recorded hit positions."""
    lights = scene.point_lights.position.detach()

    @torch.no_grad()
    def bounce(o, d, live=None):
        hit = backend.closest(o, d)
        valid = hit.prim_id >= 0
        t = torch.where(valid, hit.t, 0.0)
        pos = torch.where(valid[:, None], o + d * t[:, None], 0.0)
        bits = torch.zeros((o.shape[0],), dtype=torch.int32, device=o.device)
        for li in range(lights.shape[0]):
            to_light = lights[li] - pos
            ldir = safe_normalize(to_light)
            blocked = backend.occluded(pos + shading.SHADOW_EPS * ldir, ldir,
                                       norm(to_light) - shading.SHADOW_EPS)
            bits = bits | (blocked.to(torch.int32) << li)
        return hit, bits

    return bounce


def _two_phase_records(sg_scene: Scene, origins, dirs, cfg: RenderConfig, backend: Backend):
    """Phase 1 by levels: per level (o, d, hit, bits, active), from the
    bounce-refl kernel where the backend has it, else from a bounce and the
    recorded surface (``record_surface``) on the detached scene."""
    records = []
    o, d = origins, dirs
    active = torch.ones((origins.shape[0],), dtype=torch.bool, device=origins.device)
    for level in range(cfg.max_depth):
        live = active if level > 0 else None
        if backend.bounce_refl is not None:
            hit, bits, pos, refl, refl_ok = backend.bounce_refl(o, d, live=live)
            records.append((o, d, hit, bits, active))
            if level + 1 >= cfg.max_depth:
                break
            active = active & refl_ok
            o = pos + REFLECT_EPS * refl
            d = torch.where(active[:, None], refl, d)
            continue
        hit, bits = backend.bounce(o, d, live=live)
        records.append((o, d, hit, bits, active))
        if level + 1 >= cfg.max_depth:
            break
        surf = record_surface(sg_scene, o, d, hit)
        if cfg.reference_quirks:
            reflective = surf.ks[:, 2] > 0.01
        else:
            reflective = (surf.ks > 0.01).any(dim=1)
        active = active & surf.valid & reflective
        refl_dir = safe_normalize(reflect(d, surf.normal))
        o = surf.position + REFLECT_EPS * refl_dir
        d = torch.where(active[:, None], refl_dir, d)
    return records


def _trace_two_phase(scene: Scene, origins, dirs, cfg: RenderConfig, backend: Backend,
                     generator=None):
    """The two-phase gradient structure (``trace_rays`` of the JAX package,
    whitted.py:567-695).

    Phase 1 records every level on the detached scene: the masks are
    discrete and the records' rays feed only oracles, so the gradients are
    those of the one-phase trace.  Phase 2 shades each level's records
    differentiably.  Under ``two_phase_rays='exact'`` the bounce rays are
    recomputed from the previous level's differentiable surface, so the
    reflected-origin vertex term flows; under 'recorded' phase 2 takes the
    records' rays.  The shade is the fused kernel where
    ``resolve_shade_kernel`` and ``supports_shade_kernel`` hold, else the
    differentiable ``reconstruct_hit`` + ``direct_light``: the JAX package's
    own routing.
    """
    if scene.spherical_lights.position.shape[0] > 0:
        raise NotImplementedError(
            "the two-phase records of spherical-light soft shadows "
            "(shading.spherical_fracs) are not ported yet (ROADMAP A8)")
    if backend.bounce is None:
        backend = backend._replace(bounce=_synth_bounce(scene, backend))
    use_shade_kernel = (cfg.resolve_shade_kernel(scene.device)
                        and shade_ops.supports_shade_kernel(scene))

    if backend.record_trace is not None:
        records = backend.record_trace(origins, dirs)
    else:
        records = _two_phase_records(_detached(scene), origins, dirs, cfg, backend)

    exact_rays = cfg.resolve_two_phase_rays() == "exact" and not cfg.forward_only
    color = torch.zeros_like(origins)
    throughput = torch.ones_like(origins)
    o_l, d_l = origins, dirs
    for level, (o_rec, d_rec, hit_l, bits_l, active_l) in enumerate(records):
        if not exact_rays and level > 0:
            o_l, d_l = o_rec, d_rec
        if use_shade_kernel:
            direct, valid, ks, normal, position = backend.shade(scene, o_l, d_l, hit_l, bits_l)
        else:
            surf = reconstruct_hit(scene, o_l, d_l, hit_l)
            direct = shading.direct_light(scene, d_l, surf, backend.occluded, generator,
                                          shadow_bits=bits_l)
            valid, ks, normal, position = surf.valid, surf.ks, surf.normal, surf.position
        lit = active_l & valid
        color = color + throughput * direct * lit[:, None].to(torch.float32)
        throughput = throughput * ks
        if level + 1 >= len(records) or not exact_rays:
            continue
        refl_dir = safe_normalize(reflect(d_l, normal))
        o_l = position + REFLECT_EPS * refl_dir
        d_l = torch.where(records[level + 1][4][:, None], refl_dir, d_l)
    return color


def _render_flat(scene: Scene, camera: Camera, cfg: RenderConfig, backend: Backend,
                 generator=None):
    """Primary rays in raster order, traced (in ``ray_chunk`` slices if set)."""
    origins, dirs = cam_ops.generate_rays(camera, cfg.height, cfg.width)
    num = origins.shape[0]
    chunk = cfg.ray_chunk if 0 < cfg.ray_chunk < num else num
    color = torch.cat([trace_rays(scene, origins[s:s + chunk], dirs[s:s + chunk], cfg,
                                  backend, generator)
                       for s in range(0, num, chunk)])
    return color.reshape(cfg.height, cfg.width, 3)


def render_image(scene: Scene, camera: Camera, cfg: RenderConfig,
                 backend: Optional[Backend] = None, generator=None):
    """[H, W, 3] float32 on the scene's device, image-row order (row 0 = top),
    linear values (clamp/quantize happens at write time)."""
    if cfg.anti_aliasing or cfg.bloom or cfg.motion_blur:
        raise NotImplementedError(
            "anti-aliasing, bloom and motion blur are not ported yet (ROADMAP A9)")
    if camera.device != scene.device:
        raise ValueError(f"camera on {camera.device} but scene on {scene.device}")
    if backend is None:
        backend = make_backend(scene, cfg)
    return _render_flat(scene, camera, cfg, backend, generator)


def effective_max_depth(scene: Scene, cfg: RenderConfig) -> int:
    """If no material can pass the reflection continue-test, every bounce past
    the first contributes exactly zero: render one level."""
    ks = scene.materials.ks.detach().cpu()
    sks = scene.spheres.ks.detach().cpu()
    if cfg.reference_quirks:
        reflective = bool((ks[:, 2] > 0.01).any()) or bool((sks[:, 2] > 0.01).any())
    else:
        reflective = bool((ks > 0.01).any()) or bool((sks > 0.01).any())
    return cfg.max_depth if reflective else min(cfg.max_depth, 1)


def render(scene: Scene, camera: Camera, cfg: RenderConfig,
           generator: Optional[torch.Generator] = None):
    """User-facing render entry point -> [H, W, 3] float32 on the scene's device.

    ``generator`` takes the place of the JAX package's PRNG key; point lights
    draw no samples, so it is unused on this path.
    """
    depth = effective_max_depth(scene, cfg)
    if depth != cfg.max_depth:
        cfg = dataclasses.replace(cfg, max_depth=depth)
    return render_image(scene, camera, cfg, generator=generator)
