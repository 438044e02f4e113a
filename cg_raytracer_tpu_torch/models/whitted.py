"""Whitted-style renderer, as in ``cg_raytracer_tpu/models/whitted.py`` (the
reference's trace/shade recursion, main.cpp:160-310, and renderRayTracing,
main.cpp:648-720).  The bounce recursion (depth cap 2) is an unrolled loop
with a per-ray throughput and active mask:

    color      += throughput * direct_light(hit)        (shade, main.cpp:244-263)
    throughput *= ks;  ray = reflected ray + eps offset  (main.cpp:252-256)
    active     &= hit && any(ks > 0.01)                  (main.cpp:246, fixed form)

Intersection backends sit behind one oracle contract (``ops/intersect.py``):
``brute`` sweeps in PyTorch on the CPU and ``bvh`` traverses a BVH there
(``ops/bvh.py``); ``cuda`` runs the kernels on the card (and their plain
twins for CPU tensors): the brute-force kernels of ``ops/cuda_kernels.py`` up
to ``pallas_brute_max_tris`` triangles, the wide BVH kernels of
``ops/bvh4.py`` beyond (node width ``bvh_wide`` up to ``VMEM_MAX_TRIS``
triangles, ``bvh_wide_hbm`` past it; 4 by default).  The acceleration structure is built on the host
once per scene (``build_accel``) and passed in as ``accel``.

After its query each level of the one-phase trace runs ``Backend.level``
(``ops/level.py``): on the card ``level_cuda``, the surface, the shading
and the update in ``csrc/level.cu`` (the JAX package's jit-fused level);
the differentiable chain (``level_plain``: ``reconstruct_hit`` +
``direct_light`` + the update) on the CPU, for the plain reference backend
and wherever the render is being differentiated.

Under ``grad_two_phase='on'`` the trace splits in two (``_trace_two_phase``):
phase 1 records every level's hits, shadow bits and next rays on the
detached scene (the record-trace kernel, or a loop of bounce-refl or bounce
+ ``record_surface``), and the spherical lights' visibility fractions at the
recorded hits; phase 2 shades the records differentiably, through the fused
shade kernel (``ops/shade.py``) where the scene allows it.

Spherical lights are sampled by the soft-shadow kernels of ``ops/soft.py``
(``Backend.soft_vis``: the brute sampler up to 256 triangles, a tree
sampler beyond: 'cone' over ``AccelBundle.soft``, 'sample' over the binary
primary tree) where ``soft_shadow_kernel`` resolves
on, else by a scan over the any-hit oracle (``shading.spherical_fracs``).  A
render draws one sample key from its generator (``soft.draw_key``; a CPU
generator seeded 0 when none is given) and folds it per level, as the JAX
package folds its PRNG key.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from ..ops import bvh4 as b4
from ..ops import camera as cam_ops
from ..ops import cuda_kernels as ck
from ..ops import effects
from ..ops import level as level_ops
from ..ops import shade as shade_ops
from ..ops import shading
from ..ops import soft
from ..ops.bvh import BVH, build_bvh, intersect_bvh, occluded_bvh
from ..ops.intersect import (intersect_brute, occluded_brute, reconstruct_hit,
                             record_surface)
from ..ops.linalg import reflect, safe_normalize
from ..scene.types import Camera, Scene
from ..utils.config import RenderConfig

REFLECT_EPS = level_ops.REFLECT_EPS


class AccelBundle(NamedTuple):
    """The wide tree of the primary kernels and the one the cone soft-shadow
    sampler walks (``soft_bvh_max_leaf`` / ``soft_bvh_builder``, at the
    primary tree's width); the same object when the knobs match the primary
    tree's, their auto."""

    primary: object
    soft: object


class Backend(NamedTuple):
    """Intersection oracles.  ``bounce`` (closest hit + per-light shadow bits
    in one kernel, over the triangle table or the 4-wide tree),
    ``bounce_refl`` and ``record_trace`` (the two-phase records, one level or
    all of them in one kernel; small scenes only) and ``trace`` (the whole
    forward trace in one kernel; small scenes only) are fast paths that
    exist only where the scene and config allow them.  ``shade`` is the
    phase-2 shade: the kernel wrapper ``shade_fused_cuda`` or its plain twin."""

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
    # The soft-shadow sampler kernel: (light_pos [3], light_radius, positions
    # [N, 3], soft.SampleKey, valid [N] bool) -> visible-sample counts [N] f32.
    soft_vis: Optional[Callable] = None
    # This rank's share of the soft-shadow scan (shading.SampleSplit; set by
    # parallel/sharding.py::sample_sharded_render, with soft_vis None).
    sample_split: Optional[shading.SampleSplit] = None
    # One level of the one-phase trace after its query (ops/level.py): the
    # kernels' wrapper, or the chain for the plain reference.
    level: Callable = level_ops.level_cuda


def needs_bvh(cfg: RenderConfig, num_tris: int, device) -> bool:
    """Whether the resolved backend traverses a prebuilt tree (built on the host)."""
    kind = cfg.resolve_backend(num_tris, device)
    return kind == "bvh" or (kind == "cuda" and num_tris > cfg.pallas_brute_max_tris)


def _soft_route(scene: Scene, cfg: RenderConfig) -> Optional[str]:
    """'cone' or 'sample' where a tree sampler samples this scene's
    spherical lights, else None (never past ``VMEM_MAX_TRIS``: the JAX
    package's streaming tier has no sampler, so its spherical lights take
    the scan over the any-hit kernel)."""
    if (cfg.resolve_soft_shadow_kernel(scene.device)
            and soft.supports_soft_shadow_kernel_bvh(scene)):
        return cfg.resolve_soft_shadow_tile()
    return None


def tree_width(scene: Scene, cfg: RenderConfig) -> int:
    """The node width of the card's tree for ``scene``: ``bvh_wide`` up to
    ``VMEM_MAX_TRIS`` triangles, where the 'sample' sampler makes it binary
    (the JAX package's ``build_accel`` and ``make_backend``, whitted.py:
    970-984, 249-260); ``bvh_wide_hbm`` past it."""
    if scene.num_triangles > b4.VMEM_MAX_TRIS:
        return int(cfg.resolve_bvh_wide_hbm())
    if _soft_route(scene, cfg) == "sample":
        return 2
    return int(cfg.resolve_bvh_wide())


def build_accel(scene: Scene, cfg: RenderConfig):
    """The resolved backend's acceleration structure: a ``BVH`` for the CPU
    traversal, a ``BVH4`` of width ``tree_width`` on the scene's device for
    the card's kernels (an ``AccelBundle`` with the cone sampler's tree
    where that samples the scene's spherical lights), or None.  Memoized on
    the identity of the scene's triangle and vertex tensors
    (``_cached_accel``), the binary tree once for every width; a caller
    whose vertex tensors change every step (a training step makes fresh
    leaves) builds once and passes ``accel=`` instead."""
    num_tris, device = scene.num_triangles, scene.device
    kind = cfg.resolve_backend(num_tris, device)
    builder = cfg.resolve_bvh_builder(num_tris, device)
    if kind == "bvh":
        return _cached_accel(scene, ("bvh", builder), lambda: build_bvh(scene, builder=builder))
    if kind == "cuda" and num_tris > cfg.pallas_brute_max_tris:
        b4.check_max_tris(num_tris)
        primary = _wide_tree(scene, cfg.resolve_bvh_max_leaf(), builder, tree_width(scene, cfg))
        if _soft_route(scene, cfg) != "cone":
            return primary
        soft_tree = _soft_tree(scene, cfg, primary)
        # One bundle per pair of trees: a graph of render() is keyed on it.
        return _cached_accel(scene, ("bundle", id(primary), id(soft_tree)),
                             lambda: AccelBundle(primary, soft_tree))
    return None


def _wide_tree(scene: Scene, leaf: int, builder: str, width: int):
    """The ``width``-wide collapse of the scene's binary tree (each memoized)."""
    binary = _cached_accel(scene, ("binary", leaf, builder),
                           lambda: build_bvh(scene, max_leaf=leaf, builder=builder))
    return _cached_accel(scene, ("bvh4", leaf, builder, width),
                         lambda: b4.collapse_bvhw(binary, width).to(scene.device))


def _soft_tree(scene: Scene, cfg: RenderConfig, primary):
    """The cone sampler's tree, at the primary tree's width: ``primary``
    itself where the soft-tree knobs resolve to the primary tree's (their
    auto), else a build of its own."""
    num_tris, device = scene.num_triangles, scene.device
    leaf, builder = cfg.resolve_bvh_max_leaf(), cfg.resolve_bvh_builder(num_tris, device)
    sleaf = cfg.resolve_soft_bvh_max_leaf()
    sbuilder = cfg.resolve_soft_bvh_builder(num_tris, device)
    if (sleaf, sbuilder) == (leaf, builder):
        return primary
    return _wide_tree(scene, sleaf, sbuilder, primary.width)


_ACCEL_CACHE: dict = {}


def _cached_accel(scene: Scene, tag: tuple, builder):
    """Accel memo keyed on the triangle and vertex tensors' identities
    (geometry only: materials and lights do not shape the tree).  An entry
    goes when either tensor is freed, so a stale id() is never reused."""
    import weakref

    tris, verts = scene.triangles, scene.vertices
    key = (id(tris), id(verts), scene.num_triangles, str(scene.device)) + tag
    hit = _ACCEL_CACHE.get(key)
    if hit is not None:
        return hit
    accel = _ACCEL_CACHE[key] = builder()
    for buf in (tris, verts):
        weakref.finalize(buf, _ACCEL_CACHE.pop, key, None)
    return accel


def make_backend(scene: Scene, cfg: RenderConfig, plain: bool = False, accel=None) -> Backend:
    """Oracles for ``scene`` on its device.  ``plain=True`` routes the cuda
    backend, and the phase-2 shade, through the kernels' plain PyTorch twins
    on any device: the reference a kernel render is checked against.
    ``accel``: the tree ``build_accel`` gives for this scene and config
    (built here when None)."""
    kind = cfg.resolve_backend(scene.num_triangles, scene.device)
    shade = shade_ops.shade_fused_plain if plain else shade_ops.shade_fused_cuda
    level = level_ops.level_plain if plain else level_ops.level_cuda
    if kind == "brute":
        return Backend(
            closest=lambda o, d: intersect_brute(scene, o, d, tri_chunk=cfg.tri_chunk),
            occluded=lambda o, d, tm: occluded_brute(scene, o, d, tm, tri_chunk=cfg.tri_chunk),
            shade=shade, level=level,
        )
    if kind == "bvh":
        tree = accel if accel is not None else build_accel(scene, cfg)
        if not isinstance(tree, BVH):
            raise TypeError(f"backend='bvh' traverses a BVH (ops/bvh.py), got {type(tree)}")
        return Backend(closest=lambda o, d: intersect_bvh(scene, tree, o, d),
                       occluded=lambda o, d, tm: occluded_bvh(scene, tree, o, d, tm),
                       shade=shade, level=level)
    if scene.num_triangles > cfg.pallas_brute_max_tris:
        return _bvh4_backend(scene, cfg, plain, accel, shade)
    if plain:
        closest, occluded = ck.intersect_plain, ck.occluded_plain
        bounce, trace = ck.bounce_plain, ck.trace_plain
        bounce_refl, record_trace = ck.bounce_refl_plain, ck.record_trace_plain
        sampler = soft.soft_prng_plain
    else:
        closest, occluded = ck.intersect_cuda, ck.occluded_cuda
        bounce, trace = ck.bounce_cuda, ck.trace_cuda
        bounce_refl, record_trace = ck.bounce_refl_cuda, ck.record_trace_cuda
        sampler = soft.soft_prng_cuda
    fused = ck.supports_fused_bounce(scene)
    quirk = cfg.reference_quirks
    soft_vis = None
    if (cfg.resolve_soft_shadow_kernel(scene.device)
            and soft.supports_soft_shadow_kernel(scene)):
        ns = cfg.soft_shadow_samples
        soft_vis = lambda lpos, lrad, pos, key, valid=None: sampler(  # noqa: E731
            scene, pos, lpos, lrad, key, ns, valid=valid)
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
        shade=shade,
        soft_vis=soft_vis,
        level=level,
    )


def _bvh4_backend(scene: Scene, cfg: RenderConfig, plain: bool, accel, shade) -> Backend:
    """The wide BVH kernels at the width ``tree_width`` resolves (the JAX
    package's ``bvh_wide`` branches, whitted.py:243-368, and past
    ``VMEM_MAX_TRIS`` its streaming tier, ``_hbm_backend`` /
    ``_hbm4_backend`` :196-232): closest hit and any hit, the fused bounce
    where the scene has no sphere primitives, and up to ``VMEM_MAX_TRIS`` a
    tree sampler, 'cone' over ``AccelBundle.soft`` or 'sample' over the
    primary tree (whitted.py:276-306, 341-360).  There is no record or trace
    kernel over the tree: phase 1 runs level by level on the bounce."""
    b4.check_max_tris(scene.num_triangles)
    tree = accel if accel is not None else build_accel(scene, cfg)
    soft_tree = None
    if isinstance(tree, AccelBundle):
        tree, soft_tree = tree
    width = tree_width(scene, cfg)
    for t in (tree, soft_tree):
        if t is None:
            continue
        if not isinstance(t, b4.BVH4):
            raise TypeError(f"the wide BVH kernels traverse a BVH4 (ops/bvh4.py), got {type(t)}")
        if t.device != scene.device or t.num_tris != scene.num_triangles:
            raise ValueError(f"accel: a tree of {t.num_tris} triangles on {t.device} for a "
                             f"scene of {scene.num_triangles} on {scene.device}")
        if t.width != width:
            raise ValueError(f"accel: a width-{t.width} tree where the config resolves width "
                             f"{width} (bvh_wide, bvh_wide_hbm, soft_shadow_tile)")
    if plain:
        closest, occluded, bounce = (b4.intersect_bvh4_plain, b4.occluded_bvh4_plain,
                                     b4.bounce_bvh4_plain)
        samplers = {"cone": soft.soft4_prng_plain, "sample": soft.soft_bvh_prng_plain}
    else:
        closest, occluded, bounce = (b4.intersect_bvh4_cuda, b4.occluded_bvh4_cuda,
                                     b4.bounce_bvh4_cuda)
        samplers = {"cone": soft.soft4_prng_cuda, "sample": soft.soft_bvh_prng_cuda}
    fused = b4.supports_fused_bounce_bvh4(scene)
    soft_vis = None
    route = _soft_route(scene, cfg)
    if route is not None:
        if route == "sample":
            sampled = tree
        else:
            sampled = soft_tree if soft_tree is not None else _soft_tree(scene, cfg, tree)
        sampler, ns = samplers[route], cfg.soft_shadow_samples
        soft_vis = lambda lpos, lrad, pos, key, valid=None: sampler(  # noqa: E731
            scene, sampled, pos, lpos, lrad, key, ns, valid=valid)
    return Backend(
        closest=lambda o, d: closest(scene, tree, o, d),
        occluded=lambda o, d, tm: occluded(scene, tree, o, d, tm),
        bounce=(lambda o, d, live=None: bounce(scene, tree, o, d, live=live)) if fused else None,
        shade=shade,
        soft_vis=soft_vis,
        level=level_ops.level_plain if plain else level_ops.level_cuda,
    )


def trace_rays(scene: Scene, origins, dirs, cfg: RenderConfig, backend: Backend,
               generator: Optional[torch.Generator] = None):
    """Iterative Whitted trace of a ray batch -> color [N, 3].

    - miss -> black (main.cpp:289-294); contributions past ``max_depth``
      levels are dropped (main.cpp:267);
    - reflection continues while any ks > 0.01; under ``reference_quirks``
      only ks.z is tested (the reference's comma-operator bug, main.cpp:246);
    - reflected ray: reflect(dir, shading normal), origin offset by 1e-3.

    ``generator``: a ``torch.Generator`` (the spherical lights' sample key is
    drawn from it), or the ``soft.SampleKey`` already drawn, whose offset is
    the global index of the batch's first ray.
    """
    if backend.trace is not None:
        return backend.trace(origins, dirs)
    key = (soft.as_key(generator) if scene.spherical_lights.position.shape[0] > 0
           else None)
    # forward_only renders past the trace kernel's cap take the two-phase
    # structure where resolve_fwd_shade_kernel turned it on (whitted.py:575-583).
    fwd_only_kernel = cfg.forward_only and cfg.fwd_shade_kernel == "on"
    if cfg.resolve_grad_two_phase() or fwd_only_kernel:
        return _trace_two_phase(scene, origins, dirs, cfg, backend, key)

    # Each level after its query: the backend's level function (the kernel of
    # ops/level.py on the card) unless the render is being differentiated,
    # which takes the chain (reconstruct_hit + direct_light + the update).
    level_fn = (level_ops.level_plain if level_ops.needs_chain(scene, origins, dirs)
                else backend.level)
    color = throughput = active = None
    o, d = origins, dirs
    for level in range(cfg.max_depth):
        shadow_bits = None
        if backend.bounce is not None:
            hit, shadow_bits = backend.bounce(o, d, live=active)
        else:
            hit = backend.closest(o, d)
        color, throughput, active, o, d = level_fn(
            scene, o, d, hit, shadow_bits, color, throughput, active, cfg, backend,
            key.fold_in(level) if key is not None else None, last=level + 1 >= cfg.max_depth)
    if color is None:
        color = torch.zeros((origins.shape[0], 3), dtype=torch.float32, device=origins.device)
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
            blocked = backend.occluded(*shading.shadow_ray(lights[li], pos))
            bits = bits | (blocked.to(torch.int32) << li)
        return hit, bits

    return bounce


def _two_phase_records(sg_scene: Scene, origins, dirs, cfg: RenderConfig, backend: Backend):
    """Phase 1 by levels: per level (o, d, hit, bits, active), from the
    bounce-refl kernel where the backend has it, else from a bounce and the
    recorded surface (``record_surface``) on the detached scene.

    The JAX package's ``_resorted_query`` ('park', 'pos', 'posdir') is not
    ported: it regrouped dead and live rays into separate tiles for the
    tile-synchronous TPU kernels and left every result the same.  The
    kernels here walk one ray per thread, and a dead ray (``live`` False,
    t_max < 0) exits at once."""
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
                     key=None):
    """The two-phase gradient structure (``trace_rays`` of the JAX package,
    whitted.py:567-695).

    Phase 1 records every level on the detached scene: the masks are
    discrete and the records' rays feed only oracles, so the gradients are
    those of the one-phase trace.  With spherical lights it records each
    level's visibility fractions at the recorded hits (o + t d, under the
    level's key: the one-phase trace's samples), as whitted.py:633-652 does.
    Phase 2 shades each level's records
    differentiably.  Under ``two_phase_rays='exact'`` the bounce rays are
    recomputed from the previous level's differentiable surface, so the
    reflected-origin vertex term flows; under 'recorded' phase 2 takes the
    records' rays.  The shade is the fused kernel where
    ``resolve_shade_kernel`` and ``supports_shade_kernel`` hold, else the
    differentiable ``reconstruct_hit`` + ``direct_light``: the JAX package's
    own routing.
    """
    if backend.bounce is None:
        backend = backend._replace(bounce=_synth_bounce(scene, backend))
    use_shade_kernel = (cfg.resolve_shade_kernel(scene.device)
                        and shade_ops.supports_shade_kernel(scene))

    if backend.record_trace is not None:
        records = backend.record_trace(origins, dirs)
    else:
        records = _two_phase_records(_detached(scene), origins, dirs, cfg, backend)

    fracs = [None] * len(records)
    if scene.spherical_lights.position.shape[0] > 0:
        sg_scene = _detached(scene)
        for level, (o_rec, d_rec, hit_l, _, _) in enumerate(records):
            valid_l = hit_l.prim_id >= 0
            t_l = torch.where(valid_l, hit_l.t, 0.0)
            pos_l = torch.where(valid_l[:, None], o_rec + d_rec * t_l[:, None], 0.0)
            fracs[level] = shading.spherical_fracs(
                sg_scene, pos_l, backend.occluded, key.fold_in(level),
                num_samples=cfg.soft_shadow_samples, sample_chunk=cfg.soft_shadow_chunk,
                soft_vis_fn=backend.soft_vis, valid=valid_l, sample_split=backend.sample_split)

    exact_rays = cfg.resolve_two_phase_rays() == "exact" and not cfg.forward_only
    color = torch.zeros_like(origins)
    throughput = torch.ones_like(origins)
    o_l, d_l = origins, dirs
    for level, (o_rec, d_rec, hit_l, bits_l, active_l) in enumerate(records):
        if not exact_rays and level > 0:
            o_l, d_l = o_rec, d_rec
        if use_shade_kernel:
            direct, valid, ks, normal, position = backend.shade(scene, o_l, d_l, hit_l, bits_l,
                                                                fracs[level])
        else:
            surf = reconstruct_hit(scene, o_l, d_l, hit_l)
            direct = shading.direct_light(scene, d_l, surf, backend.occluded,
                                          shadow_bits=bits_l, soft_fracs=fracs[level])
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
                 key: Optional[soft.SampleKey] = None, offset=(0.0, 0.0), rows=None):
    """Primary rays of image rows ``rows`` = (start, stop) (every row when
    None) in raster order, each shifted by ``offset`` pixels, traced (in
    ``ray_chunk`` slices if set) -> [stop - start, W, 3].  ``key``: the
    frame's sample key (spherical lights), whose stream is indexed by each
    pixel's raster index in the whole frame, so neither the slicing nor the
    rows change a pixel's samples."""
    start, stop = (0, cfg.height) if rows is None else rows
    ndc = cam_ops.pixel_ndc(cfg.height, cfg.width, offset, device=camera.device)[start:stop]
    origin, dirs = cam_ops.generate_ray(camera, ndc.reshape(-1, 2))
    origins = origin.expand_as(dirs).contiguous()
    num = dirs.shape[0]
    chunk = cfg.ray_chunk if 0 < cfg.ray_chunk < num else num
    first = start * cfg.width
    color = torch.cat([trace_rays(scene, origins[s:s + chunk], dirs[s:s + chunk], cfg,
                                  backend, key.at(first + s) if key is not None else None)
                       for s in range(0, num, chunk)])
    return color.reshape(stop - start, cfg.width, 3)


def _frame_key(scene: Scene, generator) -> Optional[soft.SampleKey]:
    """The one sample key of a frame with spherical lights (drawn from
    ``generator`` unless it is a key), which every sub-render of the
    effects takes, as the JAX package hands its one PRNG key to each."""
    return soft.as_key(generator) if scene.spherical_lights.position.shape[0] > 0 else None


def _with_effects(camera: Camera, cfg: RenderConfig, render_fn):
    """``render_fn(camera, offset)`` under motion blur over a base render
    that supersamples inside it (``anti_aliasing``)."""
    def base(cam):
        if cfg.anti_aliasing:
            return effects.supersample_render(lambda off: render_fn(cam, off), cfg)
        return render_fn(cam, (0.0, 0.0))

    return effects.motion_blur(base, camera, cfg) if cfg.motion_blur else base(camera)


def render_image(scene: Scene, camera: Camera, cfg: RenderConfig,
                 backend: Optional[Backend] = None, generator=None):
    """[H, W, 3] float32 on the scene's device, image-row order (row 0 = top),
    linear values (clamp/quantize happens at write time): the render with
    AA, motion blur and bloom (``render_image`` of the JAX package,
    whitted.py:800-846; the reference's renderRayTracing, main.cpp:648-720).
    Without a ``backend``, ``make_backend`` builds one (and its tree,
    memoized).  ``generator``: a ``torch.Generator`` or a ``SampleKey``; a
    frame with spherical lights draws one key from it, whatever the
    effects."""
    if camera.device != scene.device:
        raise ValueError(f"camera on {camera.device} but scene on {scene.device}")
    if backend is None:
        backend = make_backend(scene, cfg)
    key = _frame_key(scene, generator)

    def flat(cam, off):
        return _render_flat(scene, cam, cfg, backend, key, off)

    if effects.is_bloom_quirk_aa(cfg):
        # The reference's AA + bloom path thresholds the running subsample
        # sum and replaces the AA average (main.cpp:663-705): no post-pass.
        return effects.bloom_quirk_aa(lambda off: flat(camera, off), cfg)
    img = _with_effects(camera, cfg, flat)
    return effects.bloom(img, cfg) if cfg.bloom else img


def render_rows(scene: Scene, camera: Camera, cfg: RenderConfig, rows: slice,
                backend: Optional[Backend] = None, generator=None):
    """Image rows [rows.start, rows.stop) of ``render_image`` -> [k, W, 3]
    (``render_rows`` of the JAX package, whitted.py:849-891): the row tile
    of multi-host output and of failure recovery.  AA and motion blur are
    per pixel and compose within the rows; bloom gathers a 21x21
    neighbourhood across tile boundaries and raises, as does a slice with a
    step or no rows.  With spherical lights each pixel samples its place in the frame's
    stream (the key at ``start * W``), so the tiles of a frame put together
    are the frame."""
    if cfg.bloom:
        raise ValueError("render_rows cannot apply bloom: it gathers a 21x21 pixel "
                         "neighborhood across row-tile boundaries; apply ops.effects.bloom "
                         "on the assembled frame")
    start, stop, step = rows.indices(cfg.height)
    if step != 1 or stop <= start:
        raise ValueError(f"render_rows requires a contiguous, non-empty row slice, got {rows}")
    if camera.device != scene.device:
        raise ValueError(f"camera on {camera.device} but scene on {scene.device}")
    if backend is None:
        backend = make_backend(scene, cfg)
    key = _frame_key(scene, generator)
    return _with_effects(camera, cfg, lambda cam, off: _render_flat(
        scene, cam, cfg, backend, key, off, rows=(start, stop)))


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


def resolve_fwd_shade_kernel(scene: Scene, cfg: RenderConfig) -> RenderConfig:
    """Resolve ``fwd_shade_kernel='auto'`` (whitted.py:913-939 of the JAX
    package): 'on' for a forward-only render at depth >= 2 with the shade
    kernel on, point lights only, a scene the shade kernel covers and more
    than 5% of its triangles reflective; else 'off'."""
    if cfg.fwd_shade_kernel not in ("auto", "on", "off"):
        raise ValueError(f"fwd_shade_kernel must be 'auto' | 'on' | 'off', got "
                         f"{cfg.fwd_shade_kernel!r}")
    if not cfg.forward_only or cfg.fwd_shade_kernel != "auto":
        return cfg
    on = False
    if (cfg.max_depth >= 2 and cfg.resolve_shade_kernel(scene.device)
            and scene.spherical_lights.position.shape[0] == 0
            and shade_ops.supports_shade_kernel(scene) and scene.num_triangles > 0):
        ks = scene.materials.ks.detach()[scene.tri_material.long()]
        on = (ks > 0.01).any(dim=1).float().mean().item() > 0.05
    return dataclasses.replace(cfg, fwd_shade_kernel="on" if on else "off")


def resolve_render(scene: Scene, cfg: RenderConfig, accel=None):
    """``render()``'s config and tree for ``scene``: the depth cut to what
    its materials can reach (``effective_max_depth``), ``fwd_shade_kernel``
    resolved, and the tree built (memoized) where the backend walks one.
    Both resolutions read scene values on the host."""
    depth = effective_max_depth(scene, cfg)
    if depth != cfg.max_depth:
        cfg = dataclasses.replace(cfg, max_depth=depth)
    cfg = resolve_fwd_shade_kernel(scene, cfg)
    if accel is None and needs_bvh(cfg, scene.num_triangles, scene.device):
        accel = build_accel(scene, cfg)
    return cfg, accel


def render_resolved(scene: Scene, camera: Camera, cfg: RenderConfig, accel=None,
                    generator=None, jit: bool = True):
    """``render()`` of a config ``resolve_render`` gave: on the card with
    ``jit`` one replay of the frame's cached CUDA graph
    (``utils/graphs.py``), else ``render_image`` eagerly."""
    if jit and scene.device.type == "cuda":
        from ..utils import graphs

        return graphs.render(scene, camera, cfg, accel, _frame_key(scene, generator))
    return render_image(scene, camera, cfg, backend=make_backend(scene, cfg, accel=accel),
                        generator=generator)


def render(scene: Scene, camera: Camera, cfg: RenderConfig,
           generator: Optional[torch.Generator] = None, accel=None, jit: bool = True):
    """User-facing render entry point -> [H, W, 3] float32 on the scene's device.

    ``generator`` (a ``torch.Generator``) takes the place of the JAX
    package's PRNG key: the spherical lights' sample key is drawn from it
    once per frame (``soft.draw_key``).  Without one, a CPU generator seeded
    0 (the JAX package's ``PRNGKey(0)``), so repeated renders agree.  Point
    lights draw no samples.  ``accel``: the scene's tree from
    ``build_accel`` (the JAX package's ``bvh=``); built and memoized here
    when None.

    ``jit`` (the JAX package's default, whitted.py:1056): on the card the
    whole frame, its effects included, is captured once per resolved config,
    input shapes, tree and spherical lights as a CUDA graph and replayed
    (``utils/graphs.py``; the first call pays the warm-up and the capture,
    as JAX's pays compilation).  The graph takes no gradient: a scene that
    requires one raises under ``jit``.  ``jit=False``, and every CPU scene,
    renders eagerly.
    """
    cfg, accel = resolve_render(scene, cfg, accel)
    return render_resolved(scene, camera, cfg, accel, generator, jit)
