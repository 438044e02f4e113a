"""Fused differentiable shade: reconstruct + point-light Phong at recorded
hits in one kernel each way, the counterpart of
``cg_raytracer_tpu/ops/pallas_shade.py``.

Phase 2 of the two-phase gradient structure (``models/whitted.py``) calls
``shade_fused_cuda`` once per bounce level on the phase-1 records (rays,
prim ids, shadow bits).  Two kernels (``csrc/shade.cu``) replace two Pallas
kernels:

==================  ============================================  =================
wrapper             Pallas kernel replaced                        plain twin
==================  ============================================  =================
``shade_fwd_cuda``  ``_shade_fwd_kernel`` (direct, ks, normal,    ``shade_plain``
                    position)
``shade_bwd_cuda``  ``_shade_bwd_kernel`` (its VJP)               autograd of
                                                                  ``shade_plain``
==================  ============================================  =================

``_ShadeFn`` (a ``torch.autograd.Function``) runs the forward kernel and, in
its backward, the backward kernel, whose reverse pass is derived by hand
(``csrc/SHADE_BWD.md``).  It returns cotangents for the tables ``tri
[T, 9]``, ``aux [T, 19]``, ``lights [L, 6]``, ``spheres [S, 11]`` and for
the rays; autograd carries the tables' on through the differentiable table
builders of ``cuda_kernels.py`` to vertices, normals, materials, spheres and
point lights.  The prim ids, the shadow bits, the facing flip and the hit
mask are discrete, as in the JAX package.

``shade_fused_cuda`` runs the twin for CPU tensors and the kernels for CUDA
tensors.  The twin is ``_shade_math`` (``pallas_shade.py:128-261``) op for op;
where a lane's branch is discarded (a miss, or the triangle branch of a
sphere hit) its inputs are gated, so every derivative is finite and the lane
adds exactly 0 to every gradient, as the Pallas backward's dead-lane gating
(``_bwd_dead``) and the kernel here (which skips such lanes) do.
"""
from __future__ import annotations

import torch

from ..scene.types import Scene
from . import cuda_kernels as ck
from .intersect import moller_trumbore
from .linalg import dot

SHADE_MAX_LIGHTS = 16  # the Pallas backward's per-light cotangent packing
SHADE_MAX_SPHERES = 8  # the Pallas backward's per-sphere cotangent packing
SHADE_MAX_TRIS = ck.UNROLL_MAX_TRIS  # shared-memory tables; past it the pregathered path (B7)
_NORM_EPS = 1e-20
_SPEC_EPS = 1e-30


def supports_shade_kernel(scene: Scene) -> bool:
    """The JAX package's gate (pallas_shade.py:78-104) with this kernel's cap:
    1..16 point lights, <= 8 spheres, T <= 256 (the kernel indexes the
    triangle row in shared memory, so there is no material cap)."""
    num_pl = scene.point_lights.position.shape[0]
    num_sph = scene.spherical_lights.position.shape[0]
    num_spheres = scene.spheres.radius.shape[0]
    return (0 < scene.num_triangles + num_spheres
            and num_spheres <= SHADE_MAX_SPHERES
            and 0 < num_pl + num_sph
            and num_pl <= SHADE_MAX_LIGHTS
            and num_sph <= SHADE_MAX_LIGHTS
            and scene.num_triangles <= SHADE_MAX_TRIS)


def _shade_tables(scene: Scene):
    """(tri [rows, 9], aux [rows, 19], lights [L, 6], spheres [S, 11],
    num_tris), differentiable.  An all-sphere scene gets one constant,
    non-degenerate triangle row that no lane hits."""
    if scene.num_triangles > 0:
        tri, aux = ck._tri_table(scene), ck._aux_table(scene)
    else:
        f32 = dict(dtype=torch.float32, device=scene.device)
        tri = torch.tensor([[1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]], **f32)
        aux = torch.zeros((1, 19), **f32)
        aux[0, 0:12] = 0.5773503
        aux[0, 18] = 1.0
    return tri, aux, ck._light_table(scene), ck._sphere_table(scene), scene.num_triangles


def _max(x, c):
    """max(x, c) whose derivative splits a tie in half, as jnp.maximum's."""
    return torch.maximum(x, x.new_tensor(c))


def _unit(x):
    return x * (1.0 / _max(torch.sqrt(dot(x, x)), _NORM_EPS))[:, None]


def shade_plain(tri, aux, lights, spheres, o, d, prim, bits, num_tris=None):
    """Plain PyTorch twin of the shade kernels -> (direct, ks, normal,
    position), each [N, 3]; differentiable by autograd in every float input,
    in any float dtype.  ``num_tris`` (default: the rows of ``tri``) is where
    sphere ids start."""
    num_tris = tri.shape[0] if num_tris is None else num_tris
    num_spheres = spheres.shape[0]
    prim = prim.long()
    live = (prim >= 0) & (prim < num_tris + num_spheres)
    is_tri = live & (prim < num_tris)
    is_sph = live & (prim >= num_tris)
    hit_f = live.to(o.dtype)
    tri3, sph3 = is_tri[:, None], is_sph[:, None]
    unit_x = o.new_tensor([1.0, 0.0, 0.0])

    # Triangle: Moller-Trumbore recompute on the hit row (misses fall through
    # to row 0), on the ray that meets it head-on where the lane is not a
    # triangle hit.
    row = torch.clamp(prim, 0, tri.shape[0] - 1)
    trow, arow = tri[row], aux[row]
    v0, v1, v2 = trow[:, 0:3], trow[:, 3:6], trow[:, 6:9]
    face = arow[:, 9:12]
    centroid = ((v0 + v1 + v2) / 3.0).detach()
    t, u, v, _ = moller_trumbore(torch.where(tri3, o, centroid + face.detach()),
                                 torch.where(tri3, d, -face.detach()), v0, v1, v2)
    t = torch.where(is_tri, t, 0.0)
    p = o + d * t[:, None]
    w0 = 1.0 - u - v
    n = (w0[:, None] * arow[:, 0:3] + u[:, None] * arow[:, 3:6]
         + v[:, None] * arow[:, 6:9])
    n = _unit(torch.where(tri3, n, unit_x))
    n = n * torch.where(dot(face, d) < 0.0, 1.0, -1.0)[:, None]
    kd, ks = arow[:, 12:15], arow[:, 15:18]
    shin = torch.where(live, arow[:, 18], 1.0)

    if num_spheres:
        # Sphere: the quadratic recompute with the sqrt gated at its input,
        # and the geometric normal.
        srow = spheres[torch.clamp(prim - num_tris, 0, num_spheres - 1)]
        center, rad = srow[:, 0:3], srow[:, 3]
        oc = o - center
        qa = dot(d, d)
        qb = 2.0 * dot(d, oc)
        qc = dot(oc, oc) - rad * rad
        disc = qb * qb - 4.0 * qa * qc
        disc_ok = disc > 0.0
        sq = torch.where(disc_ok, torch.sqrt(torch.where(disc_ok, disc, 1.0)), 0.0)
        inv2a = 1.0 / (2.0 * qa)
        t_small = (-qb - sq) * inv2a
        t_big = (-qb + sq) * inv2a
        t_sp = torch.where(t_small >= 0.0, t_small, t_big)
        t_sp = torch.where(disc_ok & (t_sp >= 0.0), t_sp, 0.0)
        sp = o + d * t_sp[:, None]
        p = torch.where(sph3, sp, p)
        n = torch.where(sph3, _unit(torch.where(sph3, sp - center, unit_x)), n)
        kd = torch.where(sph3, srow[:, 4:7], kd)
        ks = torch.where(sph3, srow[:, 7:10], ks)
        shin = torch.where(is_sph, srow[:, 10], shin)

    # Unit reflection of the view ray (the specular lobe).
    r = _unit(d - (2.0 * dot(d, n))[:, None] * n)

    direct = torch.zeros_like(o)
    bits = bits.to(torch.int32)
    for li in range(lights.shape[0]):
        w = torch.where(((bits >> li) & 1) > 0, 0.0, hit_f)
        ld = _unit(torch.where(live[:, None], lights[li, 0:3] - p, unit_x))
        dcos = _max(dot(ld, n), 0.0)
        scos = dot(r, ld)
        spec = torch.pow(_max(scos, _SPEC_EPS), shin)
        spec = torch.where(scos > 0.0, spec, 0.0)
        direct = direct + lights[li, 3:6] * (kd * dcos[:, None] + ks * spec[:, None]) * w[:, None]

    # Miss semantics: zero position, normal and ks (direct is gated by w).
    hit3 = hit_f[:, None]
    return direct, ks * hit3, n * hit3, p * hit3


# --------------------------------------------------------------------------
# The kernels.
# --------------------------------------------------------------------------

def _shade_inputs(name, tri, aux, lights, spheres, o, d, prim, bits):
    ck._check(name, o, d, tri, aux, lights, spheres, device=o.device)
    ck._check(name, prim, bits, device=o.device, dtype=torch.int32)
    if o.shape != d.shape or o.ndim != 2 or o.shape[1] != 3 or prim.shape != o.shape[:1]:
        raise ValueError(f"{name}: rays must be [N, 3] pairs with [N] prim ids and bits")
    return (ck._ptr(o), ck._ptr(d), ck._ptr(prim), ck._ptr(bits), o.shape[0], ck._ptr(tri),
            ck._ptr(aux), tri.shape[0])


def shade_fwd_cuda(tri, aux, lights, spheres, o, d, prim, bits, num_tris):
    """The forward kernel -> (direct, ks, normal, position), each [N, 3]."""
    head = _shade_inputs("cgrt_shade_fwd", tri, aux, lights, spheres, o, d, prim, bits)
    outs = [torch.empty_like(o) for _ in range(4)]
    ck._launch("cgrt_shade_fwd", o.device, *head, int(num_tris), ck._ptr(lights),
               lights.shape[0], ck._ptr(spheres), spheres.shape[0],
               *(ck._ptr(x) for x in outs))
    shade_fwd_cuda.launches += 1
    return tuple(outs)


def shade_bwd_cuda(tri, aux, lights, spheres, o, d, prim, bits, num_tris, cotangents):
    """The backward kernel: the four outputs' cotangents ([N, 3] each) ->
    (d_tri, d_aux, d_lights, d_spheres, d_o, d_d)."""
    head = _shade_inputs("cgrt_shade_bwd", tri, aux, lights, spheres, o, d, prim, bits)
    ck._check("cgrt_shade_bwd", *cotangents, device=o.device)
    d_tables = [torch.zeros_like(x) for x in (tri, aux, lights, spheres)]
    d_o, d_d = torch.empty_like(o), torch.empty_like(d)
    ck._launch("cgrt_shade_bwd", o.device, *head, int(num_tris), ck._ptr(lights),
               lights.shape[0], ck._ptr(spheres), spheres.shape[0],
               *(ck._ptr(g) for g in cotangents), ck._ptr(d_o), ck._ptr(d_d),
               *(ck._ptr(x) for x in d_tables))
    shade_bwd_cuda.launches += 1
    return (*d_tables, d_o, d_d)


class _ShadeFn(torch.autograd.Function):
    """Forward and backward shade kernels around one differentiable op."""

    @staticmethod
    def forward(ctx, tri, aux, lights, spheres, o, d, prim, bits, num_tris):
        inputs = [x.contiguous() for x in (tri, aux, lights, spheres, o, d)]
        ctx.save_for_backward(*inputs, prim, bits)
        ctx.num_tris = num_tris
        return shade_fwd_cuda(*inputs, prim, bits, num_tris)

    @staticmethod
    def backward(ctx, *grads):
        tri, aux, lights, spheres, o, d, prim, bits = ctx.saved_tensors
        cotangents = [torch.zeros_like(o) if g is None else g.to(torch.float32).contiguous()
                      for g in grads]
        return (*shade_bwd_cuda(tri, aux, lights, spheres, o, d, prim, bits, ctx.num_tris,
                                cotangents), None, None, None)


def _shade_fused(scene: Scene, origins, dirs, hit, bits, on_card):
    if scene.spherical_lights.position.shape[0] > 0:
        raise NotImplementedError(
            "the shade kernel's spherical-light fractions (shading.spherical_fracs) are "
            "not ported yet (ROADMAP A8)")
    if not supports_shade_kernel(scene):
        raise ValueError("shade kernel: the scene needs <= 256 triangles, <= 8 spheres and "
                         "1..16 point lights (supports_shade_kernel)")
    tri, aux, lights, spheres, num_tris = _shade_tables(scene)
    prim = hit.prim_id.detach().to(torch.int32).contiguous()
    bits = (torch.zeros_like(prim) if bits is None
            else bits.detach().to(torch.int32).contiguous())
    if on_card:
        direct, ks, normal, position = _ShadeFn.apply(tri, aux, lights, spheres, origins,
                                                      dirs, prim, bits, num_tris)
    else:
        direct, ks, normal, position = shade_plain(tri, aux, lights, spheres, origins, dirs,
                                                   prim, bits, num_tris=num_tris)
    valid = (prim >= 0) & (prim < num_tris + scene.spheres.radius.shape[0])
    return direct, valid, ks, normal, position


def shade_fused_cuda(scene: Scene, origins, dirs, hit, bits):
    """Reconstruct + point-light Phong at recorded hits -> (direct [N, 3],
    valid [N], ks, normal, position), the drop-in for ``reconstruct_hit`` +
    ``direct_light`` in phase 2.  Differentiable in the scene's vertices,
    normals, materials, spheres and point lights, and in the rays.  ``hit``
    and ``bits`` ([N] i32 shadow bits) are records, not differentiated."""
    return _shade_fused(scene, origins, dirs, hit, bits, on_card=origins.is_cuda)


def shade_fused_plain(scene: Scene, origins, dirs, hit, bits):
    """``shade_fused_cuda`` through the plain twin on any device."""
    return _shade_fused(scene, origins, dirs, hit, bits, on_card=False)


KERNEL_WRAPPERS = (shade_fwd_cuda, shade_bwd_cuda)
for _wrapper in KERNEL_WRAPPERS:
    _wrapper.launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for w in KERNEL_WRAPPERS:
        w.launches = 0
