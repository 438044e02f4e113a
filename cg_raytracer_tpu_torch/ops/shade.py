"""Fused differentiable shade: reconstruct + Phong from point lights and
spherical lights at recorded hits in one kernel each way, the counterpart of
``cg_raytracer_tpu/ops/pallas_shade.py``.

Phase 2 of the two-phase gradient structure (``models/whitted.py``) calls
``shade_fused_cuda`` once per bounce level on the phase-1 records (rays,
prim ids, shadow bits, and the spherical lights' visibility fractions).  Four
kernels (``csrc/shade.cu``) replace four Pallas kernels:

======================  ===============================================  =================
wrapper                 Pallas kernel replaced                           plain twin
======================  ===============================================  =================
``shade_fwd_cuda``      ``_shade_fwd_kernel`` (direct, ks, normal,       ``shade_plain``
                        position)
``shade_bwd_cuda``      ``_shade_bwd_kernel`` (its VJP)                  autograd of
                                                                         ``shade_plain``
``shade_pre_fwd_cuda``  ``_shade_fwd_kernel_pre`` (the same outputs      ``shade_plain_pre``
                        from a [T, 19] payload and [M, 7] materials)
``shade_pre_bwd_cuda``  ``_shade_bwd_kernel_pre`` (its VJP)              autograd of
                                                                         ``shade_plain_pre``
======================  ===============================================  =================

Up to ``SHADE_MAX_TRIS`` triangles the select kernels read the tables ``tri
[T, 9]`` and ``aux [T, 19]`` from shared memory.  Past it the pregathered
kernels read the hit's row of ``payload [T, 19]`` (v0 v1 v2, n0 n1 n2,
material id) from device memory, recompute the face normal from the
vertices and take kd, ks, shininess from ``mats [M, 7]``, as
``_shade_math19`` does; their backward adds the payload cotangents into a
[T, 19] table itself, where the JAX package left the gather and its
scatter-add to XLA.

``_ShadeFn`` and ``_ShadePreFn`` (``torch.autograd.Function``) run a forward
kernel and, in their backward, the backward kernel, whose reverse pass is
derived by hand (``csrc/SHADE_BWD.md``).  They return cotangents for the
tables, the lights ``[L, 6]``, the spheres ``[S, 11]``, the spherical
lights ``sph [Ls, 6]`` (center, color) and the rays; autograd carries the
tables' on through the differentiable table builders to vertices, normals,
materials, spheres, point lights and spherical lights.  The prim ids, the
shadow bits, the fractions ``fracs [Ls, N]``, the facing flip, the material
id and the hit mask are discrete, as in the JAX package.  A spherical light
shades as a point light at its center whose terms are scaled by the
fraction (``_shade_math``'s ``fr * hit_f`` weight).

``shade_fused_cuda`` runs a twin for CPU tensors and the kernels for CUDA
tensors.  The twins are ``_shade_math`` (``pallas_shade.py:128-261``) and
``_shade_math19`` (:289) op for op; where a lane's branch is discarded (a
miss, or the triangle branch of a sphere hit) its inputs are gated, so every
derivative is finite and the lane adds exactly 0 to every gradient, as the
Pallas backward's dead-lane gating (``_bwd_dead``) and the kernels here
(which skip such lanes) do.
"""
from __future__ import annotations

import torch

from ..scene.types import Scene
from ..utils import counters
from . import cuda_kernels as ck
from .intersect import moller_trumbore
from .linalg import cross, dot

SHADE_MAX_LIGHTS = 16  # the Pallas backward's per-light cotangent packing
SHADE_MAX_SPHERES = 8  # the Pallas backward's per-sphere cotangent packing
SHADE_MAX_MATS = 16  # the Pallas pregathered backward's per-material cotangent packing
SHADE_MAX_TRIS = ck.UNROLL_MAX_TRIS  # shared-memory tables; past it the pregathered path
_NORM_EPS = 1e-20
_SPEC_EPS = 1e-30


def supports_shade_kernel(scene: Scene) -> bool:
    """The JAX package's gate (pallas_shade.py:78-104): 1..16 point lights,
    <= 8 spheres, and T <= 64 or at most 16 materials; here the select
    kernel indexes its triangle row in shared memory, so T <= 256 needs no
    material cap, and past 256 the pregathered kernels keep the cap of 16."""
    num_pl = scene.point_lights.position.shape[0]
    num_sph = scene.spherical_lights.position.shape[0]
    num_spheres = scene.spheres.radius.shape[0]
    return (0 < scene.num_triangles + num_spheres
            and num_spheres <= SHADE_MAX_SPHERES
            and 0 < num_pl + num_sph
            and num_pl <= SHADE_MAX_LIGHTS
            and num_sph <= SHADE_MAX_LIGHTS
            and (scene.num_triangles <= SHADE_MAX_TRIS
                 or scene.materials.kd.shape[0] <= SHADE_MAX_MATS))


def _shade_tables(scene: Scene):
    """(tri [rows, 9], aux [rows, 19], lights [L, 6], spheres [S, 11],
    num_tris), differentiable.  An all-sphere scene gets one constant,
    non-degenerate triangle row that no lane hits."""
    if scene.num_triangles > 0:
        tri, aux = ck._tri_table(scene), ck._aux_table(scene)
    else:
        f32 = dict(dtype=torch.float32, device=scene.device)
        tri = torch.eye(3, **f32).reshape(1, 9)  # made on the device: no host copy
        aux = torch.zeros((1, 19), **f32)
        aux[0, 0:12] = 0.5773503
        aux[0, 18] = 1.0
    return tri, aux, ck._light_table(scene), ck._sphere_table(scene), scene.num_triangles


def _sph_table(scene: Scene):
    """[Ls, 6]: spherical-light center (3), color (3); the radius shapes only
    the fractions."""
    s = scene.spherical_lights
    return torch.cat([s.position, s.color], dim=1).contiguous()


def _max(x, c):
    """max(x, c) whose derivative splits a tie in half, as jnp.maximum's."""
    return torch.maximum(x, x.new_tensor(c))


def _unit(x):
    return x * (1.0 / _max(torch.sqrt(dot(x, x)), _NORM_EPS))[:, None]


def _shade_rows(v0, v1, v2, nrm, face, mat, lights, spheres, o, d, prim, bits, num_tris,
                sph=None, fracs=None):
    """The shade of ``_shade_math`` on per-ray rows: the hit triangle's
    vertices, normals n0 n1 n2 (``nrm`` [N, 9]), face normal and kd, ks,
    shininess (``mat`` [N, 7]); misses fall through to row 0."""
    num_spheres = spheres.shape[0]
    prim = prim.long()
    live = (prim >= 0) & (prim < num_tris + num_spheres)
    is_tri = live & (prim < num_tris)
    is_sph = live & (prim >= num_tris)
    hit_f = live.to(o.dtype)
    tri3, sph3 = is_tri[:, None], is_sph[:, None]
    unit_x = o.new_tensor([1.0, 0.0, 0.0])

    # Triangle: Moller-Trumbore recompute on the hit row, on the ray that
    # meets it head-on where the lane is not a triangle hit.
    centroid = ((v0 + v1 + v2) / 3.0).detach()
    t, u, v, _ = moller_trumbore(torch.where(tri3, o, centroid + face.detach()),
                                 torch.where(tri3, d, -face.detach()), v0, v1, v2)
    t = torch.where(is_tri, t, 0.0)
    p = o + d * t[:, None]
    w0 = 1.0 - u - v
    n = w0[:, None] * nrm[:, 0:3] + u[:, None] * nrm[:, 3:6] + v[:, None] * nrm[:, 6:9]
    n = _unit(torch.where(tri3, n, unit_x))
    n = n * torch.where(dot(face, d) < 0.0, 1.0, -1.0)[:, None]
    kd, ks = mat[:, 0:3], mat[:, 3:6]
    shin = torch.where(live, mat[:, 6], 1.0)

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

    # Point lights gated by their bits, then spherical lights scaled by
    # their fractions: one Phong body, only the weight differs.
    bits = bits.to(torch.int32)
    rows = [lights[li] for li in range(lights.shape[0])]
    weights = [torch.where(((bits >> li) & 1) > 0, 0.0, hit_f) for li in range(len(rows))]
    if sph is not None:
        rows += [sph[li] for li in range(sph.shape[0])]
        weights += [fracs[li].detach() * hit_f for li in range(sph.shape[0])]
    direct = torch.zeros_like(o)
    for row, w in zip(rows, weights):
        ld = _unit(torch.where(live[:, None], row[0:3] - p, unit_x))
        dcos = _max(dot(ld, n), 0.0)
        scos = dot(r, ld)
        spec = torch.pow(_max(scos, _SPEC_EPS), shin)
        spec = torch.where(scos > 0.0, spec, 0.0)
        direct = direct + row[3:6] * (kd * dcos[:, None] + ks * spec[:, None]) * w[:, None]

    # Miss semantics: zero position, normal and ks (direct is gated by w).
    hit3 = hit_f[:, None]
    return direct, ks * hit3, n * hit3, p * hit3


def shade_plain(tri, aux, lights, spheres, o, d, prim, bits, num_tris=None, sph=None,
                fracs=None):
    """Plain PyTorch twin of the select shade kernels -> (direct, ks, normal,
    position), each [N, 3]; differentiable by autograd in every float input
    (``fracs`` excepted), in any float dtype.  ``num_tris`` (default: the
    rows of ``tri``) is where sphere ids start; ``sph`` [Ls, 6] and
    ``fracs`` [Ls, N]: spherical lights and their fractions."""
    num_tris = tri.shape[0] if num_tris is None else num_tris
    row = torch.clamp(prim.long(), 0, tri.shape[0] - 1)
    trow, arow = tri[row], aux[row]
    return _shade_rows(trow[:, 0:3], trow[:, 3:6], trow[:, 6:9], arow[:, 0:9], arow[:, 9:12],
                       arow[:, 12:19], lights, spheres, o, d, prim, bits, num_tris, sph, fracs)


def shade_plain_pre(payload, mats, lights, spheres, o, d, prim, bits, num_tris=None, sph=None,
                    fracs=None):
    """Plain PyTorch twin of the pregathered shade kernels (``_shade_math19``):
    the hit's row of ``payload`` [T, 19] (v0 v1 v2, n0 n1 n2, material id),
    the face normal recomputed from its vertices, kd, ks and shininess from
    row ``id`` of ``mats`` [M, 7] (an id outside 0..M-1 takes row 0, as the
    Pallas select does).  Same outputs and contract as ``shade_plain``."""
    num_tris = payload.shape[0] if num_tris is None else num_tris
    prow = payload[torch.clamp(prim.long(), 0, payload.shape[0] - 1)]
    v0, v1, v2 = prow[:, 0:3], prow[:, 3:6], prow[:, 6:9]
    mid = prow[:, 18].detach()
    m = mid.long()
    m = torch.where((m >= 0) & (m < mats.shape[0]) & (m.to(mid.dtype) == mid), m, 0)
    return _shade_rows(v0, v1, v2, prow[:, 9:18], _unit(cross(v1 - v0, v2 - v0)), mats[m],
                       lights, spheres, o, d, prim, bits, num_tris, sph, fracs)


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


def _sph_inputs(name, sph, fracs, o):
    """(sph pointer, Ls, fracs pointer): the spherical lights [Ls, 6] and
    their fractions [Ls, N] (none when ``sph`` is None)."""
    if sph is None:
        sph = torch.zeros((0, 6), dtype=torch.float32, device=o.device)
        fracs = torch.zeros((0, o.shape[0]), dtype=torch.float32, device=o.device)
    ck._check(name, sph, fracs, device=o.device)
    if sph.ndim != 2 or sph.shape[1] != 6 or fracs.shape != (sph.shape[0], o.shape[0]):
        raise ValueError(f"{name}: spherical lights must be [Ls, 6] with fractions [Ls, N], got "
                         f"{tuple(sph.shape)} and {tuple(fracs.shape)}")
    return ck._ptr(sph), sph.shape[0], ck._ptr(fracs)


def _d_sph(sph, o):
    return (torch.zeros((0, 6), dtype=torch.float32, device=o.device) if sph is None
            else torch.zeros_like(sph))


def shade_fwd_cuda(tri, aux, lights, spheres, o, d, prim, bits, num_tris, sph=None, fracs=None):
    """The forward kernel -> (direct, ks, normal, position), each [N, 3]."""
    head = _shade_inputs("cgrt_shade_fwd", tri, aux, lights, spheres, o, d, prim, bits)
    outs = [torch.empty_like(o) for _ in range(4)]
    ck._launch("cgrt_shade_fwd", o.device, *head, int(num_tris), ck._ptr(lights),
               lights.shape[0], ck._ptr(spheres), spheres.shape[0],
               *_sph_inputs("cgrt_shade_fwd", sph, fracs, o), *(ck._ptr(x) for x in outs))
    counters.count("shade_fwd_cuda")
    return tuple(outs)


def shade_bwd_cuda(tri, aux, lights, spheres, o, d, prim, bits, num_tris, cotangents, sph=None,
                   fracs=None):
    """The backward kernel: the four outputs' cotangents ([N, 3] each) ->
    (d_tri, d_aux, d_lights, d_spheres, d_o, d_d, d_sph); d_sph is [0, 6]
    without spherical lights."""
    head = _shade_inputs("cgrt_shade_bwd", tri, aux, lights, spheres, o, d, prim, bits)
    ck._check("cgrt_shade_bwd", *cotangents, device=o.device)
    d_tables = [torch.zeros_like(x) for x in (tri, aux, lights, spheres)]
    d_o, d_d, d_sph = torch.empty_like(o), torch.empty_like(d), _d_sph(sph, o)
    ck._launch("cgrt_shade_bwd", o.device, *head, int(num_tris), ck._ptr(lights),
               lights.shape[0], ck._ptr(spheres), spheres.shape[0],
               *_sph_inputs("cgrt_shade_bwd", sph, fracs, o),
               *(ck._ptr(g) for g in cotangents), ck._ptr(d_o), ck._ptr(d_d),
               *(ck._ptr(x) for x in d_tables), ck._ptr(d_sph))
    counters.count("shade_bwd_cuda")
    return (*d_tables, d_o, d_d, d_sph)


class _ShadeFn(torch.autograd.Function):
    """Forward and backward shade kernels around one differentiable op."""

    @staticmethod
    def forward(ctx, tri, aux, lights, spheres, sph, o, d, prim, bits, fracs, num_tris):
        inputs = [x.contiguous() for x in (tri, aux, lights, spheres, sph, o, d)]
        fracs = fracs.detach().contiguous()
        ctx.save_for_backward(*inputs, prim, bits, fracs)
        ctx.num_tris = num_tris
        tri, aux, lights, spheres, sph, o, d = inputs
        return shade_fwd_cuda(tri, aux, lights, spheres, o, d, prim, bits, num_tris, sph, fracs)

    @staticmethod
    def backward(ctx, *grads):
        tri, aux, lights, spheres, sph, o, d, prim, bits, fracs = ctx.saved_tensors
        cotangents = [torch.zeros_like(o) if g is None else g.to(torch.float32).contiguous()
                      for g in grads]
        d_tri, d_aux, d_lights, d_spheres, d_o, d_d, d_sph = shade_bwd_cuda(
            tri, aux, lights, spheres, o, d, prim, bits, ctx.num_tris, cotangents, sph, fracs)
        return d_tri, d_aux, d_lights, d_spheres, d_sph, d_o, d_d, None, None, None, None


def _pre_tables(scene: Scene):
    """(payload [T, 19], mats [M, 7], lights [L, 6], spheres [S, 11],
    num_tris) of the pregathered kernels, differentiable in vertices,
    normals, materials, point lights and spheres (pallas_shade.py:1087-1096)."""
    tris = scene.triangles.long()
    payload = torch.cat([ck._tri_table(scene)]
                        + [scene.normals[tris[:, k]] for k in range(3)]
                        + [scene.tri_material.to(torch.float32)[:, None]], dim=1).contiguous()
    m = scene.materials
    mats = torch.cat([m.kd, m.ks, m.shininess[:, None]], dim=1).contiguous()
    return payload, mats, ck._light_table(scene), ck._sphere_table(scene), scene.num_triangles


def _pre_inputs(name, payload, mats, lights, spheres, o, d, prim, bits):
    ck._check(name, o, d, payload, mats, lights, spheres, device=o.device)
    ck._check(name, prim, bits, device=o.device, dtype=torch.int32)
    if o.shape != d.shape or o.ndim != 2 or o.shape[1] != 3 or prim.shape != o.shape[:1]:
        raise ValueError(f"{name}: rays must be [N, 3] pairs with [N] prim ids and bits")
    return (ck._ptr(o), ck._ptr(d), ck._ptr(prim), ck._ptr(bits), o.shape[0], ck._ptr(payload),
            payload.shape[0], ck._ptr(mats), mats.shape[0], ck._ptr(lights), lights.shape[0],
            ck._ptr(spheres), spheres.shape[0])


def shade_pre_fwd_cuda(payload, mats, lights, spheres, o, d, prim, bits, sph=None, fracs=None):
    """The pregathered forward kernel -> (direct, ks, normal, position), each [N, 3]."""
    args = _pre_inputs("cgrt_shade_pre_fwd", payload, mats, lights, spheres, o, d, prim, bits)
    outs = [torch.empty_like(o) for _ in range(4)]
    ck._launch("cgrt_shade_pre_fwd", o.device, *args,
               *_sph_inputs("cgrt_shade_pre_fwd", sph, fracs, o), *(ck._ptr(x) for x in outs))
    counters.count("shade_pre_fwd_cuda")
    return tuple(outs)


def shade_pre_bwd_cuda(payload, mats, lights, spheres, o, d, prim, bits, cotangents, sph=None,
                       fracs=None):
    """The pregathered backward kernel: the four outputs' cotangents ([N, 3]
    each) -> (d_payload, d_mats, d_lights, d_spheres, d_o, d_d, d_sph); the
    material-id column of d_payload is 0."""
    args = _pre_inputs("cgrt_shade_pre_bwd", payload, mats, lights, spheres, o, d, prim, bits)
    ck._check("cgrt_shade_pre_bwd", *cotangents, device=o.device)
    d_tables = [torch.zeros_like(x) for x in (payload, mats, lights, spheres)]
    d_o, d_d, d_sph = torch.empty_like(o), torch.empty_like(d), _d_sph(sph, o)
    ck._launch("cgrt_shade_pre_bwd", o.device, *args,
               *_sph_inputs("cgrt_shade_pre_bwd", sph, fracs, o),
               *(ck._ptr(g) for g in cotangents), ck._ptr(d_o), ck._ptr(d_d),
               *(ck._ptr(x) for x in d_tables), ck._ptr(d_sph))
    counters.count("shade_pre_bwd_cuda")
    return (*d_tables, d_o, d_d, d_sph)


class _ShadePreFn(torch.autograd.Function):
    """The pregathered forward and backward kernels around one differentiable op."""

    @staticmethod
    def forward(ctx, payload, mats, lights, spheres, sph, o, d, prim, bits, fracs):
        inputs = [x.contiguous() for x in (payload, mats, lights, spheres, sph, o, d)]
        fracs = fracs.detach().contiguous()
        ctx.save_for_backward(*inputs, prim, bits, fracs)
        payload, mats, lights, spheres, sph, o, d = inputs
        return shade_pre_fwd_cuda(payload, mats, lights, spheres, o, d, prim, bits, sph, fracs)

    @staticmethod
    def backward(ctx, *grads):
        payload, mats, lights, spheres, sph, o, d, prim, bits, fracs = ctx.saved_tensors
        cotangents = [torch.zeros_like(o) if g is None else g.to(torch.float32).contiguous()
                      for g in grads]
        d_pay, d_mats, d_lights, d_spheres, d_o, d_d, d_sph = shade_pre_bwd_cuda(
            payload, mats, lights, spheres, o, d, prim, bits, cotangents, sph, fracs)
        return d_pay, d_mats, d_lights, d_spheres, d_sph, d_o, d_d, None, None, None


def _shade_fused(scene: Scene, origins, dirs, hit, bits, fracs, on_card):
    if not supports_shade_kernel(scene):
        raise ValueError("shade kernel: the scene needs <= 8 spheres, <= 16 point lights, <= 16 "
                         "spherical lights, at least one light, and <= 256 triangles or <= 16 "
                         "materials (supports_shade_kernel)")
    num_sph = scene.spherical_lights.position.shape[0]
    if num_sph and fracs is None:
        raise ValueError("shade kernel: the scene has spherical lights but no fractions were "
                         "recorded (pass shading.spherical_fracs' output as fracs)")
    prim = hit.prim_id.detach().to(torch.int32).contiguous()
    bits = (torch.zeros_like(prim) if bits is None
            else bits.detach().to(torch.int32).contiguous())
    sph = _sph_table(scene)
    fracs = (fracs.detach().to(torch.float32).contiguous() if num_sph
             else torch.zeros((0, prim.shape[0]), dtype=torch.float32, device=prim.device))
    if scene.num_triangles <= SHADE_MAX_TRIS:
        tri, aux, lights, spheres, num_tris = _shade_tables(scene)
        if on_card:
            outs = _ShadeFn.apply(tri, aux, lights, spheres, sph, origins, dirs, prim, bits, fracs,
                                  num_tris)
        else:
            outs = shade_plain(tri, aux, lights, spheres, origins, dirs, prim, bits,
                               num_tris=num_tris, sph=sph, fracs=fracs)
    else:
        payload, mats, lights, spheres, num_tris = _pre_tables(scene)
        if on_card:
            outs = _ShadePreFn.apply(payload, mats, lights, spheres, sph, origins, dirs, prim, bits,
                                     fracs)
        else:
            outs = shade_plain_pre(payload, mats, lights, spheres, origins, dirs, prim, bits,
                                   sph=sph, fracs=fracs)
    direct, ks, normal, position = outs
    valid = (prim >= 0) & (prim < num_tris + scene.spheres.radius.shape[0])
    return direct, valid, ks, normal, position


def shade_fused_cuda(scene: Scene, origins, dirs, hit, bits, fracs=None):
    """Reconstruct + Phong at recorded hits -> (direct [N, 3], valid [N], ks,
    normal, position), the drop-in for ``reconstruct_hit`` + ``direct_light``
    in phase 2.  Differentiable in the scene's vertices, normals, materials,
    spheres, point lights and spherical lights (center and color), and in the
    rays.  ``hit``, ``bits`` ([N] i32 shadow bits) and ``fracs`` ([Ls, N]
    visibility fractions, required with spherical lights) are records, not
    differentiated."""
    return _shade_fused(scene, origins, dirs, hit, bits, fracs, on_card=origins.is_cuda)


def shade_fused_plain(scene: Scene, origins, dirs, hit, bits, fracs=None):
    """``shade_fused_cuda`` through the plain twin on any device."""
    return _shade_fused(scene, origins, dirs, hit, bits, fracs, on_card=False)


_COUNTS = counters.Group("shade_fwd_cuda", "shade_bwd_cuda", "shade_pre_fwd_cuda",
                         "shade_pre_bwd_cuda")
launch_counts, reset_launch_counts = _COUNTS.launch_counts, _COUNTS.reset
