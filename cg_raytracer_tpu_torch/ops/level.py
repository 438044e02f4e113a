"""One bounce level of the default forward route on the card: the
counterpart of the JAX package's compiled one-phase level
(``cg_raytracer_tpu/models/whitted.py:697-727``: ``shade_level`` :600-613
and the level's update, which XLA fuses into a few fusions under
``jax.jit``; not a Pallas kernel).

``models/whitted.py::trace_rays`` calls a level function once per bounce
level, after the level's closest-hit (and shadow-bit) query:
``level(scene, o, d, hit, bits, color, throughput, active, cfg, backend,
key, last) -> (color, throughput, active, o_next, d_next)``.  The next
three are ``None`` at the last level; ``color``, ``throughput`` and
``active`` are ``None`` at level 0 (color 0, throughput 1, every ray
active).

- ``level_plain`` is the chain: ``reconstruct_hit`` + ``direct_light`` +
  the update, the differentiable code that renders being differentiated
  and CPU tensors run.
- ``level_cuda`` runs ``csrc/level.cu`` for CUDA tensors (and
  ``level_plain`` for CPU ones).  Three kernels, one body:

  ======================  ===============================================  ==================
  wrapper                 kernel (``csrc/level.cu``)                       plain twin
  ======================  ===============================================  ==================
  ``level_cuda``          ``cgrt_level``: surface, shade and update, with  ``level_plain``
                          a fused bounce's shadow bits and no spherical
                          lights
  ``level_surface_cuda``  ``cgrt_level_surface``: the surface              ``reconstruct_hit``
  ``level_shade_cuda``    ``cgrt_level_shade``: shade and update from the  ``level_shade_plain``
                          surface, shadow bits or blocked masks, and the
                          spherical lights' fractions
  ======================  ===============================================  ==================

  Where the scene has spherical lights, their sampler reads the surface's
  position, so a level runs ``level_surface_cuda``, ``spherical_fracs``
  and ``level_shade_cuda``; where the backend has no fused bounce (sphere
  primitives, brute force past the caps), the shadow rays toward the
  point lights go between the two kernels as the chain shoots them
  (``shading.shadow_masks``).

The kernels carry no gradient.  ``trace_rays`` takes the chain where a
tensor the level reads requires grad while grad is enabled; a caller who
differentiates ``level_cuda``'s outputs anyway gets an error, not zeros
(``_LevelGuard``).  Each wrapper adds one to its ``launches`` count (a
plain integer attribute) per launch; a failed build or launch raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..scene.types import Scene
from . import cuda_kernels as ck
from . import shading
from .intersect import Surface, reconstruct_hit
from .linalg import reflect, safe_normalize

REFLECT_EPS = 1e-3  # the reflected ray's origin offset (main.cpp:252-256)
MAX_BIT_LIGHTS = 31  # point lights a [N] int32 of shadow bits can carry


def soft_args(cfg, backend) -> dict:
    """``direct_light``'s spherical-light arguments from a config and backend."""
    return dict(soft_shadow_samples=cfg.soft_shadow_samples,
                sample_chunk=cfg.soft_shadow_chunk, soft_vis_fn=backend.soft_vis,
                sample_split=backend.sample_split)


def _state(n, device, color, throughput, active):
    """Level 0's state where none is given: color 0, throughput 1, all active."""
    if color is None:
        color = torch.zeros((n, 3), dtype=torch.float32, device=device)
    if throughput is None:
        throughput = torch.ones((n, 3), dtype=torch.float32, device=device)
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=device)
    return color, throughput, active


def _update(surf: Surface, d, direct, color, throughput, active, quirk_ks_z: bool, last: bool):
    """The level's update (``trace_rays``; whitted.py:709-725 of the JAX package)."""
    color, throughput, active = _state(d.shape[0], d.device, color, throughput, active)
    lit = active & surf.valid
    color = color + throughput * direct * lit[:, None].to(torch.float32)
    if last:
        return color, None, None, None, None
    if quirk_ks_z:
        reflective = surf.ks[:, 2] > 0.01  # comma-operator bug (main.cpp:246)
    else:
        reflective = (surf.ks > 0.01).any(dim=1)
    active = lit & reflective
    throughput = throughput * surf.ks
    refl_dir = safe_normalize(reflect(d, surf.normal))
    o = surf.position + REFLECT_EPS * refl_dir
    d = torch.where(active[:, None], refl_dir, d)
    return color, throughput, active, o, d


def level_plain(scene: Scene, o, d, hit, bits, color, throughput, active, cfg, backend,
                key=None, last: bool = False):
    """One level through the chain: ``reconstruct_hit``, ``direct_light``
    (shadow rays through ``backend.occluded`` where ``bits`` is None, the
    spherical lights sampled under ``key``) and the update."""
    surf = reconstruct_hit(scene, o, d, hit)
    direct = shading.direct_light(scene, d, surf, backend.occluded, key, shadow_bits=bits,
                                  **soft_args(cfg, backend))
    return _update(surf, d, direct, color, throughput, active, cfg.reference_quirks, last)


def level_shade_plain(scene: Scene, d, surf: Surface, bits, masks, fracs, color, throughput,
                      active, quirk_ks_z: bool, last: bool = False):
    """``level_shade_cuda``'s twin: ``direct_light`` from a surface, the
    shadow bits or blocked masks ([L, N] bool) and the fractions, then the
    update."""
    direct = shading.direct_light(scene, d, surf, None, shadow_bits=bits, blocked=masks,
                                  soft_fracs=fracs)
    return _update(surf, d, direct, color, throughput, active, quirk_ks_z, last)


# --------------------------------------------------------------------------
# The kernels' launches.
# --------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int32


class _Args(ctypes.Structure):
    """``csrc/level.cu``'s ``LevelArgs``, field by field."""

    _fields_ = [
        ("o", _P), ("d", _P), ("prim", _P), ("n", _I),
        ("active", _P), ("throughput", _P), ("color", _P),
        ("bits", _P), ("masks", _P), ("fracs", _P),
        ("vertices", _P), ("normals", _P), ("triangles", _P), ("tri_material", _P),
        ("mat_kd", _P), ("mat_ks", _P), ("mat_shininess", _P), ("num_tris", _I),
        ("sph_center", _P), ("sph_radius", _P), ("sph_kd", _P), ("sph_ks", _P),
        ("sph_shininess", _P), ("num_spheres", _I),
        ("pl_position", _P), ("pl_color", _P), ("num_pl", _I),
        ("sl_position", _P), ("sl_color", _P), ("num_sl", _I),
        ("quirk_ks_z", _I), ("last", _I),
        ("position", _P), ("normal", _P), ("kd", _P), ("ks", _P), ("shininess", _P),
        ("valid", _P),
        ("color_out", _P), ("throughput_out", _P), ("active_out", _P), ("o_next", _P),
        ("d_next", _P),
    ]


_F32, _I32, _U8 = torch.float32, torch.int32, torch.uint8


def _as(x, dtype, device, what):
    """``x`` as a contiguous tensor of ``dtype`` on ``device`` (a bool as its
    bytes), or None."""
    if x is None:
        return None
    x = x.detach()
    if x.dtype == torch.bool and dtype == _U8:
        x = x.contiguous().view(_U8)
    x = x.to(dtype).contiguous()
    if x.device != device:
        raise ValueError(f"{what}: a tensor on {x.device} for a launch on {device}")
    return x


def _scene_fields(scene: Scene, device) -> dict:
    m, s = scene.materials, scene.spheres
    pl, sl = scene.point_lights, scene.spherical_lights
    f = dict(vertices=(scene.vertices, _F32), normals=(scene.normals, _F32),
             triangles=(scene.triangles, _I32), tri_material=(scene.tri_material, _I32),
             mat_kd=(m.kd, _F32), mat_ks=(m.ks, _F32), mat_shininess=(m.shininess, _F32),
             sph_center=(s.center, _F32), sph_radius=(s.radius, _F32), sph_kd=(s.kd, _F32),
             sph_ks=(s.ks, _F32), sph_shininess=(s.shininess, _F32),
             pl_position=(pl.position, _F32), pl_color=(pl.color, _F32),
             sl_position=(sl.position, _F32), sl_color=(sl.color, _F32))
    out = {k: _as(x, dt, device, k) for k, (x, dt) in f.items()}
    out.update(num_tris=scene.num_triangles, num_spheres=int(s.radius.shape[0]),
               num_pl=int(pl.position.shape[0]), num_sl=int(sl.position.shape[0]))
    return out


def _launch(fn_name: str, fields: dict) -> None:
    """Fill ``LevelArgs`` from ``fields`` (tensors, ints; absent ones null) and
    launch ``fn_name`` on the current stream of the rays' device."""
    args = _Args()
    for name, _ in _Args._fields_:
        val = fields.get(name)
        if torch.is_tensor(val):
            setattr(args, name, val.data_ptr())
        elif val is not None:
            setattr(args, name, int(val))
    ck._launch(fn_name, fields["d"].device, ctypes.c_void_p(ctypes.addressof(args)))


def _state_fields(n, device, color, throughput, active, last) -> dict:
    """The level's state in and its outputs out."""
    f32 = dict(dtype=_F32, device=device)
    fields = dict(color=_as(color, _F32, device, "color"),
                  throughput=_as(throughput, _F32, device, "throughput"),
                  active=_as(active, _U8, device, "active"),
                  color_out=torch.empty((n, 3), **f32))
    if not last:
        fields.update(throughput_out=torch.empty((n, 3), **f32),
                      active_out=torch.empty((n,), dtype=_U8, device=device),
                      o_next=torch.empty((n, 3), **f32), d_next=torch.empty((n, 3), **f32))
    return fields


def _outputs(fields, last):
    if last:
        return fields["color_out"], None, None, None, None
    return (fields["color_out"], fields["throughput_out"], fields["active_out"].view(torch.bool),
            fields["o_next"], fields["d_next"])


def _check_bits(scene: Scene, bits, masks):
    num_pl = scene.point_lights.position.shape[0]
    if bits is not None and num_pl > MAX_BIT_LIGHTS:
        raise ValueError(f"level kernel: shadow bits carry at most {MAX_BIT_LIGHTS} point "
                         f"lights, the scene has {num_pl}; pass blocked masks")
    if bits is None and masks is None and num_pl > 0:
        raise ValueError("level kernel: the point lights need shadow bits or blocked masks")


@torch.no_grad()
def _level_kernel(scene, o, d, prim, bits, color, throughput, active, quirk_ks_z, last):
    o, d = ck._rays(o, d)
    device, n = d.device, d.shape[0]
    _check_bits(scene, bits, None)
    fields = dict(o=o, d=d, prim=_as(prim, _I32, device, "prim"), n=n,
                  bits=_as(bits, _I32, device, "bits"), quirk_ks_z=int(bool(quirk_ks_z)),
                  last=int(bool(last)), **_scene_fields(scene, device),
                  **_state_fields(n, device, color, throughput, active, last))
    _launch("cgrt_level", fields)
    level_cuda.launches += 1
    return _outputs(fields, last)


@torch.no_grad()
def _surface_kernel(scene, o, d, prim) -> Surface:
    o, d = ck._rays(o, d)
    device, n = d.device, d.shape[0]
    f32 = dict(dtype=_F32, device=device)
    fields = dict(o=o, d=d, prim=_as(prim, _I32, device, "prim"), n=n,
                  position=torch.empty((n, 3), **f32), normal=torch.empty((n, 3), **f32),
                  kd=torch.empty((n, 3), **f32), ks=torch.empty((n, 3), **f32),
                  shininess=torch.empty((n,), **f32),
                  valid=torch.empty((n,), dtype=_U8, device=device),
                  **_scene_fields(scene, device))
    _launch("cgrt_level_surface", fields)
    level_surface_cuda.launches += 1
    return Surface(valid=fields["valid"].view(torch.bool), position=fields["position"],
                   normal=fields["normal"], kd=fields["kd"], ks=fields["ks"],
                   shininess=fields["shininess"])


@torch.no_grad()
def _shade_kernel(scene, d, surf: Surface, bits, masks, fracs, color, throughput, active,
                  quirk_ks_z, last):
    d = _as(d, _F32, d.device, "d")
    device, n = d.device, d.shape[0]
    _check_bits(scene, bits, masks)
    num_sl = scene.spherical_lights.position.shape[0]
    if num_sl and (fracs is None or tuple(fracs.shape) != (num_sl, n)):
        raise ValueError(f"level kernel: the scene's {num_sl} spherical lights need fractions "
                         f"[{num_sl}, {n}]")
    if bits is None and masks is not None and tuple(masks.shape) != (
            scene.point_lights.position.shape[0], n):
        raise ValueError(f"level kernel: blocked masks of shape {tuple(masks.shape)} for "
                         f"{scene.point_lights.position.shape[0]} lights and {n} rays")
    fields = dict(d=d, n=n, bits=_as(bits, _I32, device, "bits"),
                  masks=None if bits is not None else _as(masks, _U8, device, "masks"),
                  fracs=_as(fracs, _F32, device, "fracs") if num_sl else None,
                  position=_as(surf.position, _F32, device, "position"),
                  normal=_as(surf.normal, _F32, device, "normal"),
                  kd=_as(surf.kd, _F32, device, "kd"), ks=_as(surf.ks, _F32, device, "ks"),
                  shininess=_as(surf.shininess, _F32, device, "shininess"),
                  valid=_as(surf.valid, _U8, device, "valid"),
                  quirk_ks_z=int(bool(quirk_ks_z)), last=int(bool(last)),
                  **_scene_fields(scene, device),
                  **_state_fields(n, device, color, throughput, active, last))
    _launch("cgrt_level_shade", fields)
    level_shade_cuda.launches += 1
    return _outputs(fields, last)


# --------------------------------------------------------------------------
# Public wrappers.
# --------------------------------------------------------------------------

class _LevelGuard(torch.autograd.Function):
    """Identity on a level's first ``num`` float outputs, tied to the
    tensors after them that require grad, whose backward raises: the
    kernels have no backward, and a caller who differentiates them fails
    loudly instead of getting zero gradients."""

    @staticmethod
    def forward(ctx, num, *tensors):
        return tuple(t.clone() for t in tensors[:num])

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "ops/level.py's kernels have no backward: models/whitted.py::trace_rays routes a "
            "render being differentiated through level_plain (the chain)")


def _grad_deps(scene: Scene, *tensors) -> list:
    return [x for x in (*ck._tensor_leaves(scene), *tensors)
            if x is not None and x.requires_grad]


def needs_chain(scene: Scene, *tensors) -> bool:
    """Whether a level reading ``scene`` and ``tensors`` must take the
    differentiable chain: grad is enabled and one of them requires it (the
    predicate of ``cuda_kernels.py::_trace``)."""
    return torch.is_grad_enabled() and bool(_grad_deps(scene, *tensors))


def _guarded(outs, scene, *tensors):
    deps = _grad_deps(scene, *tensors)
    if not (deps and torch.is_grad_enabled()):
        return outs
    color, throughput, active, o, d = outs
    if throughput is None:
        return _LevelGuard.apply(1, color, *deps)[0], None, None, None, None
    color, throughput, o, d = _LevelGuard.apply(4, color, throughput, o, d, *deps)
    return color, throughput, active, o, d


def level_cuda(scene: Scene, o, d, hit, bits, color, throughput, active, cfg, backend,
               key=None, last: bool = False):
    """One level on the card: ``cgrt_level`` where ``bits`` come from a fused
    bounce and the scene has no spherical lights, else ``cgrt_level_surface``,
    the shadow rays (without bits) and the spherical lights' fractions,
    then ``cgrt_level_shade``.  CPU tensors run ``level_plain``."""
    if not d.is_cuda:
        return level_plain(scene, o, d, hit, bits, color, throughput, active, cfg, backend,
                           key, last)
    quirk = cfg.reference_quirks
    if bits is not None and scene.spherical_lights.position.shape[0] == 0:
        outs = _level_kernel(scene, o, d, hit.prim_id, bits, color, throughput, active, quirk,
                             last)
    else:
        with torch.no_grad():
            surf = _surface_kernel(scene, o, d, hit.prim_id)
            masks = None
            if bits is None:
                masks = shading.shadow_masks(scene, surf.position, backend.occluded)
            fracs = None
            if scene.spherical_lights.position.shape[0] > 0:
                fracs = shading.spherical_fracs(
                    scene, surf.position, backend.occluded, key,
                    num_samples=cfg.soft_shadow_samples, sample_chunk=cfg.soft_shadow_chunk,
                    soft_vis_fn=backend.soft_vis, valid=surf.valid,
                    sample_split=backend.sample_split)
            outs = _shade_kernel(scene, d, surf, bits, masks, fracs, color, throughput, active,
                                 quirk, last)
    return _guarded(outs, scene, o, d, color, throughput)


def level_surface_cuda(scene: Scene, o, d, hit) -> Surface:
    """``reconstruct_hit``'s surface from ``cgrt_level_surface`` (CPU tensors:
    ``reconstruct_hit``).  Not differentiable."""
    if not d.is_cuda:
        return reconstruct_hit(scene, o, d, hit)
    return _surface_kernel(scene, o, d, hit.prim_id)


def level_shade_cuda(scene: Scene, d, surf: Surface, bits, masks, fracs, color, throughput,
                     active, quirk_ks_z: bool, last: bool = False):
    """``level_shade_plain`` through ``cgrt_level_shade`` (CPU tensors: the
    twin).  Not differentiable."""
    if not d.is_cuda:
        return level_shade_plain(scene, d, surf, bits, masks, fracs, color, throughput, active,
                                 quirk_ks_z, last)
    return _shade_kernel(scene, d, surf, bits, masks, fracs, color, throughput, active,
                         quirk_ks_z, last)


KERNEL_WRAPPERS = (level_cuda, level_surface_cuda, level_shade_cuda)
for _wrapper in KERNEL_WRAPPERS:
    _wrapper.launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for w in KERNEL_WRAPPERS:
        w.launches = 0
