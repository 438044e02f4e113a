"""Primitive intersectors over ray batches, as in ``cg_raytracer_tpu/ops/intersect.py``.

Contract shared by every backend (brute force here, the kernels in
``cuda_kernels.py``): a closest-hit query returns ``Hit(t, prim_id, u, v)``
with ``t = inf`` and ``prim_id = -1`` on a miss; an any-hit query returns a
bool per ray.  The search is a non-differentiated oracle; shading recomputes
the hit point, normal and barycentrics from ``prim_id`` (``reconstruct_hit``).

prim_id convention: -1 = miss, [0, T) = triangle index, T + s = sphere s.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..scene.types import Scene
from .linalg import cross, dot, safe_normalize

INF = float("inf")
MISS = -1
BARY_EPS = 1e-6


class Hit(NamedTuple):
    t: torch.Tensor  # [N] f32, inf on miss
    prim_id: torch.Tensor  # [N] i32, -1 on miss
    u: torch.Tensor  # [N] f32 barycentric of v1 (triangles only)
    v: torch.Tensor  # [N] f32 barycentric of v2


class Surface(NamedTuple):
    """Surface attributes reconstructed at hit points."""

    valid: torch.Tensor  # [N] bool
    position: torch.Tensor  # [N,3]
    normal: torch.Tensor  # [N,3] shading normal (interpolated, camera-facing)
    kd: torch.Tensor  # [N,3]
    ks: torch.Tensor  # [N,3]
    shininess: torch.Tensor  # [N]


def moller_trumbore(origins, dirs, v0, v1, v2, eps: float = 1e-9):
    """Batched Moller-Trumbore over broadcastable [..., 3] operands -> (t, u, v, valid).

    Double-sided; hits behind the origin are invalid; the inside test is
    edge-inclusive by BARY_EPS so rays grazing a shared edge hit consistently
    across backends.  ``det_safe`` keeps the masked 1/det branch finite.
    """
    return moller_trumbore_edges(origins, dirs, v0, v1 - v0, v2 - v0, eps)


def moller_trumbore_edges(origins, dirs, v0, e1, e2, eps: float = 1e-9):
    """``moller_trumbore`` on a triangle given as v0 and its edges
    e1 = v1 - v0, e2 = v2 - v0 (the layout of the BVH kernels' table)."""
    pvec = cross(dirs, e2)
    det = dot(e1, pvec)
    ok_det = torch.abs(det) > eps
    det_safe = torch.where(ok_det, det, 1.0)
    inv_det = torch.where(ok_det, 1.0 / det_safe, 0.0)
    tvec = origins - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(dirs, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    valid = (ok_det & (u >= -BARY_EPS) & (v >= -BARY_EPS)
             & (u + v <= 1.0 + BARY_EPS) & (t >= 0.0))
    return t, u, v, valid


def intersect_plane(origins, dirs, normal, d):
    """Ray-plane intersection (the reference's intersectRayWithPlane,
    ray_tracing.cpp:40-72): the plane dot(x, normal) == d -> (t, valid),
    t = inf where invalid; hits behind the origin and parallel rays are
    invalid, an origin on the plane hits at t = 0."""
    denom = dot(dirs, normal)
    num = d - dot(origins, normal)
    on_plane = num == 0.0
    t = torch.where(torch.abs(denom) > 0.0, num / torch.where(denom == 0.0, 1.0, denom), -1.0)
    t = torch.where(on_plane, 0.0, t)
    valid = on_plane | ((denom != 0.0) & (t >= 0.0))
    return torch.where(valid, t, INF), valid


def intersect_aabb(origins, inv_dirs, lo, hi):
    """Slab test (ray_tracing.cpp:162-200) -> (t_entry, hit): hit where the
    ray's [0, inf) overlaps the box, an origin inside included (t_entry <=
    0).  Axis-parallel rays take IEEE infinities, as the reference's float
    division does."""
    t0 = (lo - origins) * inv_dirs
    t1 = (hi - origins) * inv_dirs
    t_in = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_out = torch.amin(torch.maximum(t0, t1), dim=-1)
    return t_in, (t_in <= t_out) & (t_out >= 0.0)


def intersect_spheres_one(origins, dirs, center, radius):
    """Ray-sphere quadratic (ray_tracing.cpp:118-158) -> (t, valid): the
    smaller root if >= 0, else the bigger one (origin inside), else a miss."""
    oc = origins - center
    a = dot(dirs, dirs)
    b = 2.0 * dot(dirs, oc)
    c = dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t_small = (-b - sq) / (2.0 * a)
    t_big = (-b + sq) / (2.0 * a)
    t = torch.where(t_small >= 0.0, t_small, t_big)
    valid = (disc >= 0.0) & (t >= 0.0)
    return torch.where(valid, t, INF), valid


def _take(x, j):
    return x.gather(1, j[:, None])[:, 0]


def closest_sweep(origins, dirs, v0, v1, v2, t_best, tri_chunk: int = 2048):
    """Closest triangle hit (v0/v1/v2 [T,3]) per ray that beats ``t_best`` [N].

    Strict ``<`` with the lowest index winning ties: the result of a
    sequential sweep over the triangles.  Returns (t, prim [N] i32, u, v);
    ``prim`` is -1 and ``t`` is ``t_best`` where no triangle beat it.
    """
    n = origins.shape[0]
    prim = torch.full((n,), MISS, dtype=torch.int32, device=origins.device)
    u_best = torch.zeros((n,), dtype=torch.float32, device=origins.device)
    v_best = torch.zeros_like(u_best)
    o, d = origins[:, None, :], dirs[:, None, :]
    for start in range(0, v0.shape[0], tri_chunk):
        sl = slice(start, start + tri_chunk)
        t, u, v, valid = moller_trumbore(o, d, v0[None, sl], v1[None, sl], v2[None, sl])
        t = torch.where(valid, t, INF)
        j = torch.argmin(t, dim=1)  # first minimum: the lowest index wins ties
        t_new = _take(t, j)
        closer = t_new < t_best
        t_best = torch.where(closer, t_new, t_best)
        prim = torch.where(closer, (j + start).to(torch.int32), prim)
        u_best = torch.where(closer, _take(u, j), u_best)
        v_best = torch.where(closer, _take(v, j), v_best)
    return t_best, prim, u_best, v_best


def any_hit_sweep(origins, dirs, v0, v1, v2, t_max, tri_chunk: int = 2048):
    """True where some triangle lies at t in [0, t_max)."""
    blocked = torch.zeros((origins.shape[0],), dtype=torch.bool, device=origins.device)
    o, d = origins[:, None, :], dirs[:, None, :]
    for start in range(0, v0.shape[0], tri_chunk):
        sl = slice(start, start + tri_chunk)
        t, _, _, valid = moller_trumbore(o, d, v0[None, sl], v1[None, sl], v2[None, sl])
        blocked = blocked | (valid & (t < t_max[:, None])).any(dim=1)
    return blocked


def triangle_vertices(scene: Scene):
    """(v0, v1, v2) [T,3] of every triangle."""
    tris = scene.triangles.long()
    return tuple(scene.vertices[tris[:, k]] for k in range(3))


def merge_spheres_closest(scene: Scene, origins, dirs, hit: Hit) -> Hit:
    """Fold the sphere primitives into a triangle ``hit`` whose ``t`` holds the
    running best: a sphere replaces it where strictly closer (prim T + s)."""
    centers, radii = scene.spheres.center, scene.spheres.radius
    if radii.shape[0] == 0:
        return hit
    t_s = torch.stack([intersect_spheres_one(origins, dirs, centers[s], radii[s])[0]
                       for s in range(radii.shape[0])])  # [S, N]
    s = torch.argmin(t_s, dim=0)
    t_best_s = t_s.gather(0, s[None])[0]
    closer = t_best_s < hit.t
    return Hit(
        t=torch.where(closer, t_best_s, hit.t),
        prim_id=torch.where(closer, scene.num_triangles + s.to(torch.int32), hit.prim_id),
        u=torch.where(closer, 0.0, hit.u),
        v=torch.where(closer, 0.0, hit.v),
    )


def spheres_occluded(scene: Scene, origins, dirs, t_max):
    """True where some sphere lies at t in [0, t_max)."""
    blocked = torch.zeros((origins.shape[0],), dtype=torch.bool, device=origins.device)
    for s in range(scene.spheres.radius.shape[0]):
        t, valid = intersect_spheres_one(origins, dirs, scene.spheres.center[s],
                                         scene.spheres.radius[s])
        blocked = blocked | (valid & (t < t_max))
    return blocked


def intersect_brute(scene: Scene, origins, dirs, t_max=None, tri_chunk: int = 2048) -> Hit:
    """Closest hit over all triangles + spheres by brute force, swept in
    triangle chunks so memory stays O(N * tri_chunk)."""
    n = origins.shape[0]
    t_best = torch.full((n,), INF, dtype=torch.float32, device=origins.device)
    if t_max is not None:
        t_best = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                                    device=origins.device), (n,))
    if scene.num_triangles > 0:
        t, prim, u, v = closest_sweep(origins, dirs, *triangle_vertices(scene), t_best,
                                      tri_chunk)
        best = Hit(t, prim, u, v)
    else:
        zeros = torch.zeros((n,), dtype=torch.float32, device=origins.device)
        best = Hit(t_best, torch.full((n,), MISS, dtype=torch.int32,
                                      device=origins.device), zeros, zeros)
    best = merge_spheres_closest(scene, origins, dirs, best)
    miss = torch.isinf(best.t) | (best.prim_id < 0)
    return Hit(t=torch.where(miss, INF, best.t),
               prim_id=torch.where(miss, MISS, best.prim_id), u=best.u, v=best.v)


def occluded_brute(scene: Scene, origins, dirs, t_max, tri_chunk: int = 2048):
    """Any-hit (shadow) query: True where some primitive lies at t in [0, t_max)."""
    blocked = torch.zeros((origins.shape[0],), dtype=torch.bool, device=origins.device)
    if scene.num_triangles > 0:
        blocked = any_hit_sweep(origins, dirs, *triangle_vertices(scene), t_max, tri_chunk)
    return blocked | spheres_occluded(scene, origins, dirs, t_max)


def reconstruct_hit(scene: Scene, origins, dirs, hit: Hit) -> Surface:
    """Surface at the hit from the (non-differentiated) prim ids, recomputed
    differentiably: Moller-Trumbore on the one hit triangle, barycentric normal
    interpolation flipped toward the viewer (ray_tracing.cpp:94-106); spheres
    recompute the quadratic and take the geometric normal (:156).

    The per-triangle row (3 vertices, 3 normals, kd, ks, shininess: [T, 25])
    is fetched with an exact index gather.

    Grad-safe on every lane: a lane that is not a triangle hit (a miss falls
    through to row 0, a sphere hit to its clipped row) runs the triangle math
    on gated inputs, as the sphere branch gates its discriminant, so its
    derivatives are finite and it adds exactly 0 to every table gradient.
    (Ungated, a miss ray far outside row 0's triangle gives barycentrics of
    ~1e7 whose interpolated normal can cancel to exactly zero, and the norm's
    derivative there turns the zero cotangent into NaN.)
    """
    num_tris = scene.num_triangles
    prim = hit.prim_id.detach().long()
    valid = prim >= 0
    is_sphere = valid & (prim >= num_tris)
    is_tri = valid & (prim < num_tris)
    unit_x = torch.eye(3, dtype=origins.dtype, device=origins.device)[0]  # no host copy

    if num_tris > 0:
        tris = scene.triangles.long()
        mat = scene.tri_material.long()
        packed = torch.cat([
            scene.vertices[tris[:, 0]], scene.vertices[tris[:, 1]], scene.vertices[tris[:, 2]],
            scene.normals[tris[:, 0]], scene.normals[tris[:, 1]], scene.normals[tris[:, 2]],
            scene.materials.kd[mat], scene.materials.ks[mat],
            scene.materials.shininess[mat][:, None],
        ], dim=1)  # [T, 25]
        row = packed[torch.clamp(prim, 0, num_tris - 1)]
        v0, v1, v2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
        n0, n1, n2 = row[:, 9:12], row[:, 12:15], row[:, 15:18]
        kd_tri, ks_tri, shin_tri = row[:, 18:21], row[:, 21:24], row[:, 24]
        face_n = safe_normalize(cross(v1 - v0, v2 - v0))
        # Gated inputs: other lanes recompute on the ray that meets their
        # row's triangle head-on at its centroid (detached), so det is the
        # triangle's area term, and normalise a unit vector.
        tri3 = is_tri[:, None]
        fn_c = face_n.detach()
        centroid = ((v0 + v1 + v2) / 3.0).detach()
        t_tri, u, v, _ = moller_trumbore(torch.where(tri3, origins, centroid + fn_c),
                                         torch.where(tri3, dirs, -fn_c), v0, v1, v2)
        w0 = 1.0 - u - v
        n_raw = w0[:, None] * n0 + u[:, None] * n1 + v[:, None] * n2
        n_interp = safe_normalize(torch.where(tri3, n_raw, unit_x))
        facing = dot(face_n, -dirs) > 0.0
        n_tri = torch.where(facing[:, None], n_interp, -n_interp)
    else:
        t_tri = torch.zeros_like(hit.t)
        n_tri = kd_tri = ks_tri = torch.zeros_like(origins)
        shin_tri = torch.zeros_like(hit.t)

    num_spheres = scene.spheres.radius.shape[0]
    if num_spheres > 0:
        sp = torch.clamp(prim - num_tris, 0, num_spheres - 1)
        center = scene.spheres.center[sp]
        radius = scene.spheres.radius[sp]
        # Discriminant gated at the input (the det_safe pattern) so the sqrt
        # has a finite derivative on lanes that are not sphere hits.
        oc = origins - center
        qa = dot(dirs, dirs)
        qb = 2.0 * dot(dirs, oc)
        qc = dot(oc, oc) - radius * radius
        disc = qb * qb - 4.0 * qa * qc
        disc_ok = disc > 0.0
        sq = torch.where(disc_ok, torch.sqrt(torch.where(disc_ok, disc, 1.0)), 0.0)
        t_small = (-qb - sq) / (2.0 * qa)
        t_big = (-qb + sq) / (2.0 * qa)
        t_sp = torch.where(t_small >= 0.0, t_small, t_big)
        t_sp = torch.where(disc_ok & (t_sp >= 0.0), t_sp, 0.0)
        n_sp = safe_normalize(torch.where(is_sphere[:, None],
                                          origins + dirs * t_sp[:, None] - center, unit_x))
        kd_sp, ks_sp = scene.spheres.kd[sp], scene.spheres.ks[sp]
        shin_sp = scene.spheres.shininess[sp]
    else:
        t_sp = torch.zeros_like(hit.t)
        n_sp = kd_sp = ks_sp = torch.zeros_like(origins)
        shin_sp = torch.zeros_like(hit.t)

    t = torch.where(valid, torch.where(is_sphere, t_sp, t_tri), 0.0)
    position = origins + dirs * t[:, None]
    sph3, valid3 = is_sphere[:, None], valid[:, None]
    zero3 = torch.zeros_like(position)
    return Surface(
        valid=valid,
        position=torch.where(valid3, position, zero3),
        normal=torch.where(valid3, torch.where(sph3, n_sp, n_tri), zero3),
        kd=torch.where(valid3, torch.where(sph3, kd_sp, kd_tri), zero3),
        ks=torch.where(valid3, torch.where(sph3, ks_sp, ks_tri), zero3),
        shininess=torch.where(valid, torch.where(is_sphere, shin_sp, shin_tri), 1.0),
    )


def record_surface(scene: Scene, origins, dirs, hit: Hit) -> Surface:
    """Phase-1 surface straight from a record's (t, u, v, prim), with no
    Moller-Trumbore recompute (``record_surface`` of the JAX package).

    The two-phase record loop (``models/whitted.py::_two_phase_records``)
    needs only position, normal, ks and valid to build the next bounce's
    rays, and runs on a detached scene, so the recorded barycentrics are
    exact there.  kd and shininess are not needed and return as 0 and 1.
    Sphere hits take the geometric normal at the recorded t.
    """
    num_tris = scene.num_triangles
    prim = hit.prim_id.detach().long()
    t_rec, u, v = hit.t.detach(), hit.u.detach(), hit.v.detach()
    valid = prim >= 0
    is_sphere = valid & (prim >= num_tris)
    t = torch.where(valid & torch.isfinite(t_rec), t_rec, 0.0)
    position = origins + dirs * t[:, None]

    if num_tris > 0:
        tris = scene.triangles.long()
        mat = scene.tri_material.long()
        v0, v1, v2 = (scene.vertices[tris[:, k]] for k in range(3))
        packed = torch.cat([
            scene.normals[tris[:, 0]], scene.normals[tris[:, 1]], scene.normals[tris[:, 2]],
            safe_normalize(cross(v1 - v0, v2 - v0)), scene.materials.ks[mat],
        ], dim=1)  # [T, 15]
        row = packed[torch.clamp(prim, 0, num_tris - 1)]
        w0 = 1.0 - u - v
        n_interp = safe_normalize(w0[:, None] * row[:, 0:3] + u[:, None] * row[:, 3:6]
                                  + v[:, None] * row[:, 6:9])
        facing = dot(row[:, 9:12], -dirs) > 0.0
        n_tri = torch.where(facing[:, None], n_interp, -n_interp)
        ks_tri = row[:, 12:15]
    else:
        n_tri = ks_tri = torch.zeros_like(origins)

    num_spheres = scene.spheres.radius.shape[0]
    if num_spheres > 0:
        sp = torch.clamp(prim - num_tris, 0, num_spheres - 1)
        n_sp = safe_normalize(position - scene.spheres.center[sp])
        ks_sp = scene.spheres.ks[sp]
    else:
        n_sp = ks_sp = torch.zeros_like(origins)

    valid3, sph3 = valid[:, None], is_sphere[:, None]
    zero3 = torch.zeros_like(position)
    return Surface(
        valid=valid,
        position=torch.where(valid3, position, zero3),
        normal=torch.where(valid3, torch.where(sph3, n_sp, n_tri), zero3),
        kd=zero3,
        ks=torch.where(valid3, torch.where(sph3, ks_sp, ks_tri), zero3),
        shininess=torch.ones_like(t),
    )
