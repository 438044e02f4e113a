"""Hand-written CUDA kernels for small scenes: the counterpart of
``cg_raytracer_tpu/ops/pallas_kernels.py``.

Six kernels (``csrc/oracle.cu``, ``csrc/trace.cu``, ``csrc/record.cu``)
replace six Pallas kernels:

=====================  ==========================================  ======================
wrapper                Pallas kernel replaced                      plain twin
=====================  ==========================================  ======================
``intersect_cuda``     ``_closest_kernel_entry`` (closest hit)     ``intersect_plain``
``occluded_cuda``      ``_anyhit_kernel`` (shadow any-hit)         ``occluded_plain``
``bounce_cuda``        ``_bounce_kernel`` (hit + shadow bits)      ``bounce_plain``
``trace_cuda``         ``_trace_kernel`` (whole forward trace)     ``trace_plain``
``bounce_refl_cuda``   ``_bounce_refl_kernel`` (one record level)  ``bounce_refl_plain``
``record_trace_cuda``  ``_record_trace_kernel`` (all levels)       ``record_trace_plain``
=====================  ==========================================  ======================

The shade kernels of the two-phase structure are in ``shade.py``.

Each wrapper takes the plain PyTorch twin only because its rays lie on the
CPU; for CUDA tensors it launches its kernel or raises, and counts the launch
(``utils/counters.py``; ``launch_counts``).
The twins compute the same function with PyTorch operations on any device;
the CPU tests hold them to the JAX kernels, and ``chip_smoke.py`` holds the
kernels to them on the card.

The kernels are oracles: their outputs carry no gradient.  Spheres are merged
in PyTorch after the triangle kernels, as ``intersect_pallas`` /
``occluded_pallas`` do; the trace kernel handles them itself.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..scene.types import Scene
from ..utils import counters
from . import _build
from .intersect import (INF, MISS, Hit, any_hit_sweep, closest_sweep,
                        intersect_spheres_one, merge_spheres_closest,
                        spheres_occluded)
from .linalg import cross, dot, norm

UNROLL_MAX_TRIS = 256  # shared-memory table cap; the JAX package's unroll cap
MAX_FUSED_LIGHTS = 30  # shadow bits live in one int32
MAX_TRACE_LIGHTS = 8
MAX_TRACE_SPHERES = 16
SHADOW_EPS = 1e-3  # shading.SHADOW_EPS
REFLECT_EPS = 1e-3  # models/whitted.py::REFLECT_EPS
PLAIN_TRI_CHUNK = 32  # triangles per step of the plain twins' sweeps


# --------------------------------------------------------------------------
# Tables the kernels read (all float32, contiguous, on the scene's device).
# --------------------------------------------------------------------------

def _tri_table(scene: Scene):
    """[T, 9]: v0, v1, v2 of each triangle."""
    tris = scene.triangles.long()
    return torch.cat([scene.vertices[tris[:, k]] for k in range(3)], dim=1).contiguous()


def _aux_table(scene: Scene):
    """[T, 19] shading attributes: n0 n1 n2 (9), face normal (3), kd (3),
    ks (3), shininess (1)."""
    tris = scene.triangles.long()
    v0, v1, v2 = (scene.vertices[tris[:, k]] for k in range(3))
    face = cross(v1 - v0, v2 - v0)
    face = face / torch.clamp_min(norm(face), 1e-20)[:, None]
    mat = scene.tri_material.long()
    return torch.cat(
        [scene.normals[tris[:, 0]], scene.normals[tris[:, 1]], scene.normals[tris[:, 2]],
         face, scene.materials.kd[mat], scene.materials.ks[mat],
         scene.materials.shininess[mat][:, None]], dim=1).contiguous()


def _sphere_table(scene: Scene):
    """[S, 11]: center (3), radius (1), kd (3), ks (3), shininess (1)."""
    s = scene.spheres
    return torch.cat([s.center, s.radius[:, None], s.kd, s.ks, s.shininess[:, None]],
                     dim=1).contiguous()


def _light_table(scene: Scene):
    """[L, 6]: point-light position (3), color (3)."""
    pl = scene.point_lights
    return torch.cat([pl.position, pl.color], dim=1).contiguous()


def supports_trace_kernel(scene: Scene, max_tris: int = UNROLL_MAX_TRIS) -> bool:
    """The trace kernel covers small triangle/sphere scenes lit by point lights only."""
    num_prims = scene.num_triangles + scene.spheres.radius.shape[0]
    return (0 < num_prims
            and scene.num_triangles <= max_tris
            and scene.spheres.radius.shape[0] <= MAX_TRACE_SPHERES
            and scene.spherical_lights.position.shape[0] == 0
            and 0 < scene.point_lights.position.shape[0] <= MAX_TRACE_LIGHTS)


def supports_fused_bounce(scene: Scene, max_tris: int = UNROLL_MAX_TRIS) -> bool:
    """The bounce kernel sweeps triangles only: no sphere primitives."""
    num_pl = scene.point_lights.position.shape[0]
    num_sph = scene.spherical_lights.position.shape[0]
    return (0 < scene.num_triangles <= max_tris
            and scene.spheres.radius.shape[0] == 0
            and num_pl <= MAX_FUSED_LIGHTS
            and 0 < num_pl + num_sph)


# --------------------------------------------------------------------------
# Launch plumbing.
# --------------------------------------------------------------------------

def _ptr(x):
    return ctypes.c_void_p(x.data_ptr() if x is not None else 0)


def _check(name, *tensors, device, dtype=torch.float32):
    for x in tensors:
        if x is None:
            continue
        if x.device != device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dtype} tensors on {device}, "
                             f"got {x.dtype} on {x.device} (contiguous={x.is_contiguous()})")


def _launch(fn_name, device, *args):
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} "
                           f"({lib.cgrt_error_string(err).decode()})")


def _rays(origins, dirs):
    """Oracle inputs: detached, contiguous float32 [N, 3]."""
    o = origins.detach().to(torch.float32).contiguous()
    d = dirs.detach().to(torch.float32).contiguous()
    if o.shape != d.shape or o.ndim != 2 or o.shape[1] != 3:
        raise ValueError(f"rays must be [N, 3] pairs, got {tuple(o.shape)} and {tuple(d.shape)}")
    if o.shape[0] >= 2 ** 31:
        raise ValueError("at most 2**31 - 1 rays per launch")
    return o, d


def _t_max(t_max, n, device):
    if t_max is None:
        return None
    return torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=device),
                              (n,)).detach().contiguous()


def _empty_hit(n, device):
    z = torch.zeros((n,), dtype=torch.float32, device=device)
    return Hit(torch.full((n,), INF, dtype=torch.float32, device=device),
               torch.full((n,), MISS, dtype=torch.int32, device=device), z, z.clone())


def _check_tris(name, tri):
    """The sweeps stage the table in shared memory: 1..UNROLL_MAX_TRIS rows."""
    if not 0 < tri.shape[0] <= UNROLL_MAX_TRIS:
        raise ValueError(f"{name}: the kernel takes 1..{UNROLL_MAX_TRIS} triangles, "
                         f"got {tri.shape[0]}")


def _closest_kernel(tri, o, d, tm):
    n = o.shape[0]
    _check("cgrt_closest", o, d, tm, tri, device=o.device)
    _check_tris("cgrt_closest", tri)
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    slot = torch.empty((n,), dtype=torch.int32, device=o.device)
    u, v = torch.empty_like(t), torch.empty_like(t)
    _launch("cgrt_closest", o.device, _ptr(o), _ptr(d), _ptr(tm), n, _ptr(tri),
            tri.shape[0], _ptr(t), _ptr(slot), _ptr(u), _ptr(v))
    counters.count("intersect_cuda")
    return Hit(t, slot, u, v)


def _anyhit_kernel(tri, o, d, tm):
    n = o.shape[0]
    _check("cgrt_anyhit", o, d, tm, tri, device=o.device)
    _check_tris("cgrt_anyhit", tri)
    hit = torch.empty((n,), dtype=torch.uint8, device=o.device)
    _launch("cgrt_anyhit", o.device, _ptr(o), _ptr(d), _ptr(tm), n, _ptr(tri),
            tri.shape[0], _ptr(hit))
    counters.count("occluded_cuda")
    return hit.bool()


def _bounce_kernel(tri, lights, o, d, tm):
    n = o.shape[0]
    _check("cgrt_bounce", o, d, tm, tri, lights, device=o.device)
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    slot = torch.empty((n,), dtype=torch.int32, device=o.device)
    u, v = torch.empty_like(t), torch.empty_like(t)
    bits = torch.empty((n,), dtype=torch.int32, device=o.device)
    _launch("cgrt_bounce", o.device, _ptr(o), _ptr(d), _ptr(tm), n, _ptr(tri),
            tri.shape[0], _ptr(lights), lights.shape[0], _ptr(t), _ptr(slot), _ptr(u),
            _ptr(v), _ptr(bits))
    counters.count("bounce_cuda")
    return Hit(t, slot, u, v), bits


def _trace_kernel(tri, aux, sph, lights, o, d, max_depth, quirk_ks_z):
    n = o.shape[0]
    _check("cgrt_trace", o, d, tri, aux, sph, lights, device=o.device)
    rgb = torch.empty((n, 3), dtype=torch.float32, device=o.device)
    _launch("cgrt_trace", o.device, _ptr(o), _ptr(d), n, _ptr(tri), tri.shape[0],
            _ptr(aux), _ptr(sph), sph.shape[0], _ptr(lights), lights.shape[0],
            int(max_depth), int(bool(quirk_ks_z)), _ptr(rgb))
    counters.count("trace_cuda")
    return rgb


def _bounce_refl_kernel(tri, aux, lights, o, d, tm, quirk_ks_z):
    n = o.shape[0]
    _check("cgrt_bounce_refl", o, d, tm, tri, aux, lights, device=o.device)
    f32 = dict(dtype=torch.float32, device=o.device)
    t, u, v = (torch.empty((n,), **f32) for _ in range(3))
    slot, bits = (torch.empty((n,), dtype=torch.int32, device=o.device) for _ in range(2))
    pos, refl = torch.empty((n, 3), **f32), torch.empty((n, 3), **f32)
    reflective = torch.empty((n,), dtype=torch.uint8, device=o.device)
    _launch("cgrt_bounce_refl", o.device, _ptr(o), _ptr(d), _ptr(tm), n, _ptr(tri),
            tri.shape[0], _ptr(aux), _ptr(lights), lights.shape[0], int(bool(quirk_ks_z)),
            _ptr(t), _ptr(slot), _ptr(u), _ptr(v), _ptr(bits), _ptr(pos), _ptr(refl),
            _ptr(reflective))
    counters.count("bounce_refl_cuda")
    return Hit(t, slot, u, v), bits, pos, refl, reflective.bool()


def _record_kernel(tri, aux, lights, o, d, max_depth, quirk_ks_z):
    n = o.shape[0]
    _check("cgrt_record_trace", o, d, tri, aux, lights, device=o.device)
    f32 = dict(dtype=torch.float32, device=o.device)
    t, u, v = (torch.empty((max_depth, n), **f32) for _ in range(3))
    slot, bits = (torch.empty((max_depth, n), dtype=torch.int32, device=o.device)
                  for _ in range(2))
    o_next, d_next = (torch.empty((max_depth - 1, n, 3), **f32) for _ in range(2))
    active = torch.empty((max_depth - 1, n), dtype=torch.uint8, device=o.device)
    _launch("cgrt_record_trace", o.device, _ptr(o), _ptr(d), n, _ptr(tri), tri.shape[0],
            _ptr(aux), _ptr(lights), lights.shape[0], int(max_depth), int(bool(quirk_ks_z)),
            _ptr(t), _ptr(slot), _ptr(u), _ptr(v), _ptr(bits), _ptr(o_next), _ptr(d_next),
            _ptr(active))
    counters.count("record_trace_cuda")
    return t, slot, u, v, bits, o_next, d_next, active.bool()


# --------------------------------------------------------------------------
# Plain PyTorch twins of the kernels (same inputs, same outputs).
# --------------------------------------------------------------------------

def _columns(tri):
    return tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]


def _closest_plain(tri, o, d, tm):
    n = o.shape[0]
    t0 = tm if tm is not None else torch.full((n,), INF, dtype=torch.float32, device=o.device)
    t, slot, u, v = closest_sweep(o, d, *_columns(tri), t0, PLAIN_TRI_CHUNK)
    return Hit(torch.where(slot >= 0, t, INF), slot, u, v)


def _anyhit_plain(tri, o, d, tm):
    return any_hit_sweep(o, d, *_columns(tri), tm, PLAIN_TRI_CHUNK)


def _shadow_rays(p, light_pos):
    """Shadow ray toward one light: (origin, unit dir, distance), with the
    direction scaled by a reciprocal as the kernels do."""
    to_light = light_pos - p
    dist = norm(to_light)
    ldir = to_light * (1.0 / torch.clamp_min(dist, 1e-20))[:, None]
    return p + SHADOW_EPS * ldir, ldir, dist


def _bounce_plain(tri, lights, o, d, tm):
    hit = _closest_plain(tri, o, d, tm)
    hit_mask = hit.prim_id >= 0
    p = o + d * torch.where(hit_mask, hit.t, 0.0)[:, None]
    bits = torch.zeros((o.shape[0],), dtype=torch.int32, device=o.device)
    for li in range(lights.shape[0]):
        so, sd, dist = _shadow_rays(p, lights[li, 0:3])
        t_l = torch.where(hit_mask, dist - SHADOW_EPS, -1.0)
        blocked = _anyhit_plain(tri, so, sd, t_l)
        bits = bits | (blocked.to(torch.int32) << li)
    return hit, bits


def _unit(x):
    return x * (1.0 / torch.clamp_min(norm(x), 1e-20))[:, None]


def _trace_plain(tri, aux, sph, lights, o, d, max_depth, quirk_ks_z):
    n, num_tris, num_spheres = o.shape[0], tri.shape[0], sph.shape[0]
    color = torch.zeros((n, 3), dtype=torch.float32, device=o.device)
    through = torch.ones_like(color)
    active = torch.ones((n,), dtype=torch.bool, device=o.device)
    for level in range(max_depth):
        hit = _closest_plain(tri, o, d, None) if num_tris else _empty_hit(n, o.device)
        t_best, slot, u, v = hit
        for s in range(num_spheres):
            t, ok = intersect_spheres_one(o, d, sph[s, 0:3], sph[s, 3])
            closer = ok & (t < t_best)
            t_best = torch.where(closer, t, t_best)
            slot = torch.where(closer, num_tris + s, slot)
            u = torch.where(closer, 0.0, u)
            v = torch.where(closer, 0.0, v)
        hit_mask = slot >= 0
        p = o + d * torch.where(hit_mask, t_best, 0.0)[:, None]

        # Attributes of the hit row (zero on a miss), interpolated facing normal.
        attr = torch.zeros((n, 19), dtype=torch.float32, device=o.device)
        if num_tris:
            is_tri = hit_mask & (slot < num_tris)
            attr = torch.where(is_tri[:, None], aux[torch.clamp(slot, 0, num_tris - 1).long()],
                               attr)
        kd, ks, shin = attr[:, 12:15], attr[:, 15:18], torch.where(hit_mask, attr[:, 18], 1.0)
        w0 = 1.0 - u - v
        nrm = _unit(w0[:, None] * attr[:, 0:3] + u[:, None] * attr[:, 3:6]
                    + v[:, None] * attr[:, 6:9])
        nrm = nrm * torch.where(dot(attr[:, 9:12], d) < 0.0, 1.0, -1.0)[:, None]
        if num_spheres:
            is_sph = hit_mask & (slot >= num_tris)
            srow = sph[torch.clamp(slot - num_tris, 0, num_spheres - 1).long()]
            kd = torch.where(is_sph[:, None], srow[:, 4:7], kd)
            ks = torch.where(is_sph[:, None], srow[:, 7:10], ks)
            shin = torch.where(is_sph, srow[:, 10], shin)
            nrm = torch.where(is_sph[:, None], _unit(p - srow[:, 0:3]), nrm)

        refl = _unit(d - 2.0 * dot(d, nrm)[:, None] * nrm)
        for li in range(lights.shape[0]):
            so, ld, dist = _shadow_rays(p, lights[li, 0:3])
            t_l = torch.where(hit_mask, dist - SHADOW_EPS, -1.0)
            blocked = (_anyhit_plain(tri, so, ld, t_l) if num_tris
                       else torch.zeros_like(hit_mask))
            for s in range(num_spheres):
                t2, ok = intersect_spheres_one(so, ld, sph[s, 0:3], sph[s, 3])
                blocked = blocked | (ok & (t2 < t_l))
            dcos = torch.clamp_min(dot(ld, nrm), 0.0)
            scos = dot(refl, ld)
            spec = torch.where(scos > 0.0, torch.pow(torch.clamp_min(scos, 1e-30), shin), 0.0)
            w = ((~blocked) & hit_mask & active).to(torch.float32)
            color = color + through * lights[li, 3:6] * (
                kd * dcos[:, None] + ks * spec[:, None]) * w[:, None]
        if level + 1 < max_depth:
            reflective = ks[:, 2] > 0.01 if quirk_ks_z else (ks > 0.01).any(dim=1)
            active = active & hit_mask & reflective
            through = through * ks
            o = p + REFLECT_EPS * refl
            d = torch.where(active[:, None], refl, d)
    return color


def _bounce_refl_plain(tri, aux, lights, o, d, tm, quirk_ks_z):
    hit, bits = _bounce_plain(tri, lights, o, d, tm)
    hit_mask = hit.prim_id >= 0
    p = o + d * torch.where(hit_mask, hit.t, 0.0)[:, None]
    # The hit row's attributes; zero on a miss, whose normal is then zero and
    # whose reflection is the unit direction.
    attr = torch.where(hit_mask[:, None],
                       aux[torch.clamp(hit.prim_id, 0, tri.shape[0] - 1).long()], 0.0)
    w0 = 1.0 - hit.u - hit.v
    nrm = _unit(w0[:, None] * attr[:, 0:3] + hit.u[:, None] * attr[:, 3:6]
                + hit.v[:, None] * attr[:, 6:9])
    nrm = nrm * torch.where(dot(attr[:, 9:12], d) < 0.0, 1.0, -1.0)[:, None]
    refl = _unit(d - 2.0 * dot(d, nrm)[:, None] * nrm)
    ks = attr[:, 15:18]
    reflective = hit_mask & (ks[:, 2] > 0.01 if quirk_ks_z else (ks > 0.01).any(dim=1))
    if tm is not None:  # the dead record
        live = (tm >= 0.0)[:, None]
        p, refl = torch.where(live, p, 0.0), torch.where(live, refl, 0.0)
    return hit, bits, p, refl, reflective


def _record_plain(tri, aux, lights, o, d, max_depth, quirk_ks_z):
    levels, rays = [], []
    tm = None
    for level in range(max_depth):
        hit, bits, p, refl, reflective = _bounce_refl_plain(tri, aux, lights, o, d, tm,
                                                            quirk_ks_z)
        levels.append((hit.t, hit.prim_id, hit.u, hit.v, bits))
        if level + 1 >= max_depth:
            break
        o = p + REFLECT_EPS * refl
        d = torch.where(reflective[:, None], refl, d)
        tm = torch.where(reflective, INF, -1.0)
        rays.append((o, d, reflective))
    t, slot, u, v, bits = (torch.stack(x) for x in zip(*levels))
    if rays:
        o_next, d_next, active = (torch.stack(x) for x in zip(*rays))
    else:
        n = o.shape[0]
        o_next = d_next = torch.zeros((0, n, 3), dtype=torch.float32, device=o.device)
        active = torch.zeros((0, n), dtype=torch.bool, device=o.device)
    return t, slot, u, v, bits, o_next, d_next, active


# --------------------------------------------------------------------------
# Public wrappers and their twins.
# --------------------------------------------------------------------------

@torch.no_grad()
def _intersect(scene, origins, dirs, t_max, on_card):
    o, d = _rays(origins, dirs)
    if scene.num_triangles > 0:
        tm = _t_max(t_max, o.shape[0], o.device)
        sweep = _closest_kernel if on_card else _closest_plain
        hit = sweep(_tri_table(scene), o, d, tm)
    else:
        hit = _empty_hit(o.shape[0], o.device)
    return merge_spheres_closest(scene, o, d, hit)


def intersect_cuda(scene: Scene, origins, dirs, t_max=None) -> Hit:
    """Closest hit over the scene's triangles (kernel) and spheres (PyTorch)."""
    return _intersect(scene, origins, dirs, t_max, on_card=origins.is_cuda)


def intersect_plain(scene: Scene, origins, dirs, t_max=None) -> Hit:
    return _intersect(scene, origins, dirs, t_max, on_card=False)


@torch.no_grad()
def _occluded(scene, origins, dirs, t_max, on_card):
    o, d = _rays(origins, dirs)
    tm = _t_max(t_max, o.shape[0], o.device)
    blocked = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    if scene.num_triangles > 0:
        sweep = _anyhit_kernel if on_card else _anyhit_plain
        blocked = sweep(_tri_table(scene), o, d, tm)
    return blocked | spheres_occluded(scene, o, d, tm)


def occluded_cuda(scene: Scene, origins, dirs, t_max):
    """Any-hit (shadow) query: True where a primitive lies at t in [0, t_max)."""
    return _occluded(scene, origins, dirs, t_max, on_card=origins.is_cuda)


def occluded_plain(scene: Scene, origins, dirs, t_max):
    return _occluded(scene, origins, dirs, t_max, on_card=False)


@torch.no_grad()
def _bounce(scene, origins, dirs, live, on_card):
    if not supports_fused_bounce(scene):
        raise ValueError("bounce kernel: the scene needs 1..256 triangles, no spheres "
                         "and at most 30 point lights (supports_fused_bounce)")
    o, d = _rays(origins, dirs)
    tm = None
    if live is not None:
        tm = torch.where(live.to(o.device), INF, -1.0).to(torch.float32).contiguous()
    lights = scene.point_lights.position.contiguous()
    if on_card:
        return _bounce_kernel(_tri_table(scene), lights, o, d, tm)
    return _bounce_plain(_tri_table(scene), lights, o, d, tm)


def bounce_cuda(scene: Scene, origins, dirs, live=None):
    """Closest hit plus per-point-light shadow bits (bit l = light l occluded
    from the hit point; meaningful where the ray hit) -> (Hit, bits [N] i32).
    ``live`` ([N] bool): rays marked dead skip every sweep and report a miss."""
    return _bounce(scene, origins, dirs, live, on_card=origins.is_cuda)


def bounce_plain(scene: Scene, origins, dirs, live=None):
    return _bounce(scene, origins, dirs, live, on_card=False)


def _record_tables(scene, what):
    if not supports_fused_bounce(scene):
        raise ValueError(f"{what} kernel: the scene needs 1..256 triangles, no spheres and "
                         f"at most 30 point lights (supports_fused_bounce)")
    return _tri_table(scene), _aux_table(scene), scene.point_lights.position.contiguous()


@torch.no_grad()
def _bounce_refl(scene, origins, dirs, live, quirk_ks_z, on_card):
    tables = _record_tables(scene, "bounce_refl")
    o, d = _rays(origins, dirs)
    tm = None
    if live is not None:
        tm = torch.where(live.to(o.device), INF, -1.0).to(torch.float32).contiguous()
    run = _bounce_refl_kernel if on_card else _bounce_refl_plain
    hit, bits, pos, refl, reflective = run(*tables, o, d, tm, quirk_ks_z)
    return Hit(torch.where(hit.prim_id >= 0, hit.t, INF), *hit[1:]), bits, pos, refl, reflective


def bounce_refl_cuda(scene: Scene, origins, dirs, live=None, quirk_ks_z: bool = False):
    """One level of records: the bounce kernel's (Hit, bits) plus the hit
    position [N, 3], the unit reflected direction [N, 3] and whether the hit
    passes the reflection continue-test ([N] bool).  ``live`` ([N] bool):
    rays marked dead skip every sweep and give the dead record (a miss,
    zero position and reflection, not reflective)."""
    return _bounce_refl(scene, origins, dirs, live, quirk_ks_z, on_card=origins.is_cuda)


def bounce_refl_plain(scene: Scene, origins, dirs, live=None, quirk_ks_z: bool = False):
    return _bounce_refl(scene, origins, dirs, live, quirk_ks_z, on_card=False)


@torch.no_grad()
def _record_trace(scene, origins, dirs, max_depth, quirk_ks_z, on_card):
    tables = _record_tables(scene, "record_trace")
    if max_depth < 1:
        raise ValueError(f"max_depth must be >= 1, got {max_depth}")
    o, d = _rays(origins, dirs)
    run = _record_kernel if on_card else _record_plain
    t, slot, u, v, bits, o_next, d_next, active = run(*tables, o, d, max_depth, quirk_ks_z)
    records = [(o, d, Hit(t[0], slot[0], u[0], v[0]), bits[0],
                torch.ones((o.shape[0],), dtype=torch.bool, device=o.device))]
    for level in range(1, max_depth):
        records.append((o_next[level - 1], d_next[level - 1],
                        Hit(t[level], slot[level], u[level], v[level]), bits[level],
                        active[level - 1]))
    return records


def record_trace_cuda(scene: Scene, origins, dirs, max_depth: int, quirk_ks_z: bool = False):
    """Every level's records in one kernel launch: a list of per-level
    (o [N, 3], d [N, 3], Hit, bits [N] i32, active [N] bool), level 0 being
    the given rays, all active.  The format of the JAX package's
    ``record_trace_pallas``, with the real u/v in each Hit."""
    return _record_trace(scene, origins, dirs, max_depth, quirk_ks_z, on_card=origins.is_cuda)


def record_trace_plain(scene: Scene, origins, dirs, max_depth: int, quirk_ks_z: bool = False):
    return _record_trace(scene, origins, dirs, max_depth, quirk_ks_z, on_card=False)


class _ForwardOnlyGuard(torch.autograd.Function):
    """Identity whose backward raises: differentiating a forward-only render
    fails loudly instead of returning zero gradients through the kernel."""

    @staticmethod
    def forward(ctx, colors, *deps):
        return colors.clone()

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "RenderConfig.forward_only=True routed this render through the trace "
            "kernel, which has no backward; set forward_only=False (the default) to "
            "differentiate renders")


def _tensor_leaves(obj):
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        if dataclasses.is_dataclass(val):
            yield from _tensor_leaves(val)
        else:
            yield val


def _trace(scene, origins, dirs, max_depth, quirk_ks_z, on_card):
    if not supports_trace_kernel(scene):
        raise ValueError("trace kernel: the scene needs <= 256 triangles, <= 16 spheres, "
                         "1..8 point lights and no spherical lights (supports_trace_kernel)")
    if max_depth < 1:
        raise ValueError(f"max_depth must be >= 1, got {max_depth}")
    with torch.no_grad():
        o, d = _rays(origins, dirs)
        tables = (_tri_table(scene), _aux_table(scene), _sphere_table(scene),
                  _light_table(scene))
        run = _trace_kernel if on_card else _trace_plain
        color = run(*tables, o, d, max_depth, quirk_ks_z)
    deps = [x for x in (*_tensor_leaves(scene), origins, dirs) if x.requires_grad]
    if deps and torch.is_grad_enabled():
        color = _ForwardOnlyGuard.apply(color, *deps)
    return color


def trace_cuda(scene: Scene, origins, dirs, max_depth: int, quirk_ks_z: bool = False):
    """Whole forward Whitted trace -> color [N, 3] in one kernel launch.
    Differentiating the result raises NotImplementedError."""
    return _trace(scene, origins, dirs, max_depth, quirk_ks_z, on_card=origins.is_cuda)


def trace_plain(scene: Scene, origins, dirs, max_depth: int, quirk_ks_z: bool = False):
    return _trace(scene, origins, dirs, max_depth, quirk_ks_z, on_card=False)


_COUNTS = counters.Group("intersect_cuda", "occluded_cuda", "bounce_cuda", "trace_cuda",
                         "bounce_refl_cuda", "record_trace_cuda")
launch_counts, reset_launch_counts = _COUNTS.launch_counts, _COUNTS.reset
