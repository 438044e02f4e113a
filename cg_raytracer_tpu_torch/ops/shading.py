"""Phong shading with hard shadows from point lights and soft shadows from
spherical lights, as in ``cg_raytracer_tpu/ops/shading.py`` (the reference's
diffuseOneLight, specularOneLight and pointInShadow, main.cpp:61-135, and
its soft shadows, main.cpp:166-218).

A spherical light shades as a point light at its center, scaled by the
fraction of ``num_samples`` shadow rays toward Gaussian-normalised random
points on its sphere that reach it (``spherical_fracs``).  The fractions
come from a sampler kernel (``Backend.soft_vis``, ``ops/soft.py``) or from a
scan over the any-hit oracle, ``sample_chunk`` samples per step.  Both draw
the samples of ``ops/soft.py``'s stream: the render's key folded per level
(by the caller) and per light (here), so for the same key the two see the
same samples.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..scene.types import Scene
from . import soft
from .intersect import Surface
from .linalg import dot, norm, reflect, safe_normalize

SHADOW_EPS = 1e-3


def phong_one_light(view_dir, normal, kd, ks, shininess, light_dir, light_color):
    """Diffuse and specular [N,3] from one light direction (no visibility).

    ``view_dir`` is the camera->surface ray direction (the reference reuses
    ``ray.direction``, main.cpp:63); ``light_dir`` is normalized surface->light.
    """
    diffuse = light_color * kd * torch.clamp_min(dot(light_dir, normal), 0.0)[:, None]
    spec_cos = dot(safe_normalize(reflect(view_dir, normal)), light_dir)
    # Base clamped strictly positive keeps the pow finite; the <= 0 branch is
    # zero, as the reference's early-out (main.cpp:70-75).
    spec = torch.pow(torch.clamp_min(spec_cos, 1e-30), shininess)
    specular = light_color * ks * torch.where(spec_cos > 0.0, spec, 0.0)[:, None]
    return diffuse, specular


def shadow_ray(light_pos, positions):
    """The shadow ray toward a point light -> (origins, unit dirs, t_max): it
    starts SHADOW_EPS along the light direction and is blocked by a hit at
    t < dist - SHADOW_EPS (main.cpp:110-119)."""
    to_light = light_pos - positions
    ldir = safe_normalize(to_light)
    return positions + SHADOW_EPS * ldir, ldir, norm(to_light) - SHADOW_EPS


def shadow_masks(scene: Scene, positions, occluded_fn):
    """[L, N] bool: True where point light l is blocked from the point."""
    lights = scene.point_lights.position
    if lights.shape[0] == 0:
        return torch.zeros((0, positions.shape[0]), dtype=torch.bool, device=positions.device)
    return torch.stack([occluded_fn(*shadow_ray(lights[li], positions))
                        for li in range(lights.shape[0])])


def direct_point_lights(scene: Scene, view_dir, surf: Surface, occluded_fn,
                        shadow_bits=None, blocked=None):
    """Phong over the point lights, gated by hard shadows.

    ``occluded_fn(origins, dirs, t_max) -> bool [N]`` is the any-hit oracle,
    called with each light's ``shadow_ray``; ``shadow_bits`` ([N] int32, bit
    l = light l blocked) from a fused bounce kernel, or ``blocked`` ([L, N]
    bool, ``shadow_masks``), replaces the per-light oracle calls.
    """
    color = torch.zeros_like(surf.position)
    lights = scene.point_lights
    for li in range(lights.position.shape[0]):
        ldir = safe_normalize(lights.position[li] - surf.position)
        if shadow_bits is not None:
            hidden = ((shadow_bits >> li) & 1) > 0
        elif blocked is not None:
            hidden = blocked[li]
        else:
            hidden = occluded_fn(*shadow_ray(lights.position[li], surf.position))
        diffuse, specular = phong_one_light(view_dir, surf.normal, surf.kd, surf.ks,
                                            surf.shininess, ldir, lights.color[li])
        lit = (~hidden) & surf.valid
        color = color + (diffuse + specular) * lit[:, None].to(diffuse.dtype)
    return color


def _random_unit_vectors(key: soft.SampleKey, points, samples):
    """Gaussian-normalised unit vectors [len(samples), len(points), 3] of the
    stream (randomUnitVector, main.cpp:46-59)."""
    return safe_normalize(soft.philox_gauss(key, points, samples).transpose(0, 1))


class SampleSplit(NamedTuple):
    """One rank's share of the scan's sample chunks (``parallel/sharding.py::
    sample_sharded_render``): chunks ``index``, ``index + count``, ...;
    ``all_sum(counts)`` adds the ranks' visible counts ([Ls, N] float32,
    integers) in place and returns them."""

    index: int
    count: int
    all_sum: Callable


def spherical_fracs(scene: Scene, positions, occluded_fn, generator, num_samples: int = 200,
                    sample_chunk: int = 20, soft_vis_fn=None, gauss=None, valid=None,
                    sample_split=None):
    """Per-(light, point) soft-shadow visibility fractions [Ls, N]: the
    spherical-light oracle (discrete, not differentiated, like the any-hit
    bools it counts).

    ``generator``: the render's ``torch.Generator`` (a key is drawn from it)
    or the ``soft.SampleKey`` drawn from one; light l samples under
    ``fold_in(l)``.  ``soft_vis_fn(light_pos, light_radius, positions, key,
    valid) -> counts [N]`` (a sampler kernel) counts out of ``num_samples``;
    without it the scan over ``occluded_fn`` counts ``sample_chunk`` samples
    per step out of ``ceil(num_samples / chunk) * chunk``, each path by its
    own total, as in the JAX package.  ``gauss`` ([S, N, 3], or [Ls, S, N, 3]
    per light) replaces the scan's draws, so that a test can feed it another
    stream.  ``valid`` ([N] bool): points to sample; the rest do no work and
    get fraction 0.  ``sample_split`` (a ``SampleSplit``): the scan counts
    only this rank's chunks and sums the counts across ranks before the
    division; the counts are integers and each (point, sample) draws the
    same stream, so the fractions equal the unsplit scan's bit for bit."""
    num_lights = scene.spherical_lights.position.shape[0]
    n = positions.shape[0]
    if num_lights == 0:
        return torch.zeros((0, n), dtype=torch.float32, device=positions.device)
    positions = positions.detach()
    key = soft.as_key(generator)
    lights = scene.spherical_lights
    if soft_vis_fn is not None and sample_split is not None:
        raise ValueError("spherical_fracs: a sample split runs the scan, not a sampler kernel")
    if soft_vis_fn is not None:
        return torch.stack([
            soft_vis_fn(lights.position[li], lights.radius[li], positions, key.fold_in(li),
                        valid) / float(num_samples) for li in range(num_lights)])

    chunk = max(1, min(sample_chunk, num_samples))
    num_chunks = -(-num_samples // chunk)
    total = num_chunks * chunk
    rows = torch.arange(n, device=positions.device)
    first, stride = (0, 1) if sample_split is None else sample_split[:2]
    counts = []
    for li in range(num_lights):
        lpos, lrad = lights.position[li].detach(), lights.radius[li].detach()
        lkey = key.fold_in(li)
        count = torch.zeros((n,), dtype=torch.float32, device=positions.device)
        for ci in range(first, num_chunks, stride):
            samples = torch.arange(ci * chunk, (ci + 1) * chunk, device=positions.device)
            if gauss is None:
                units = _random_unit_vectors(lkey, rows, samples)  # [C, N, 3]
            else:
                g = gauss[li] if gauss.ndim == 4 else gauss
                units = safe_normalize(g[ci * chunk:(ci + 1) * chunk].to(positions))
            sample_pts = lpos + lrad * units
            sdir = safe_normalize(sample_pts - positions[None])
            sorigin = positions[None] + SHADOW_EPS * sdir
            light_t = norm(sample_pts - sorigin)  # main.cpp:181 measures from the origin
            if valid is not None:
                light_t = torch.where(valid[None], light_t, -1.0)
            blocked = occluded_fn(sorigin.reshape(-1, 3), sdir.reshape(-1, 3),
                                  light_t.reshape(-1))
            visible = ~blocked.reshape(chunk, n)
            if valid is not None:
                visible = visible & valid[None]
            count = count + visible.to(torch.float32).sum(dim=0)
        counts.append(count)
    counts = torch.stack(counts)
    if sample_split is not None:
        counts = sample_split.all_sum(counts)
    return counts / float(total)


def direct_spherical_lights(scene: Scene, view_dir, surf: Surface, fracs):
    """Soft-shadowed Phong from the spherical lights: the terms toward each
    light's center, scaled by its visibility fraction (``fracs`` [Ls, N])
    where the surface is valid (main.cpp:168-218)."""
    contrib = torch.zeros_like(surf.position)
    lights = scene.spherical_lights
    for li in range(lights.position.shape[0]):
        ldir = safe_normalize(lights.position[li] - surf.position)
        diffuse, specular = phong_one_light(view_dir, surf.normal, surf.kd, surf.ks,
                                            surf.shininess, ldir, lights.color[li])
        w = fracs[li] * surf.valid.to(torch.float32)
        contrib = contrib + (diffuse + specular) * w[:, None]
    return contrib


def direct_light(scene: Scene, view_dir, surf: Surface, occluded_fn, generator=None,
                 shadow_bits=None, soft_shadow_samples: int = 200, sample_chunk: int = 20,
                 soft_vis_fn=None, soft_fracs=None, sample_split=None, blocked=None):
    """Total direct lighting = point lights + spherical lights (shading(),
    main.cpp:160-235).  ``generator``: the level's ``torch.Generator`` or
    ``soft.SampleKey``, for the spherical lights' samples (unused without
    them); ``soft_fracs`` ([Ls, N]): recorded fractions, which skip the
    sampling; ``sample_split``: as ``spherical_fracs``; ``shadow_bits`` and
    ``blocked``: as ``direct_point_lights``."""
    color = direct_point_lights(scene, view_dir, surf, occluded_fn, shadow_bits=shadow_bits,
                                blocked=blocked)
    if scene.spherical_lights.position.shape[0] == 0:
        return color
    if soft_fracs is None:
        soft_fracs = spherical_fracs(scene, surf.position, occluded_fn, generator,
                                     num_samples=soft_shadow_samples, sample_chunk=sample_chunk,
                                     soft_vis_fn=soft_vis_fn, valid=surf.valid,
                                     sample_split=sample_split)
    return color + direct_spherical_lights(scene, view_dir, surf, soft_fracs)
