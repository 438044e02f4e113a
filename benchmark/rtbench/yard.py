"""The yardstick's arithmetic: the least time an H100 could take for a
piece of work, the larger of its operations over the card's rates and its
bytes over the memory rate.

Frozen copies of ``bound_ms``, ``level_work`` and ``headline_roofline``
(with ``brute_flops_per_ray`` and ``bytes_per_ray``) from
``cg_raytracer_tpu_torch/utils/roofline.py`` at commit 3c561914e6c9, and a
sampler count of its own (``sampler_work``).  Later changes to the program
do not move this yardstick.

Peaks (NVIDIA's H100 SXM data sheet, at its 700 W limit): 67 TFLOP/s
float32 outside the tensor cores, 3.35 TB/s of HBM3; 32-bit integer
operations at 64 per clock per SM on compute capability 9.0: 132 SMs x 64
x 1.98 GHz = 16.7 Tops/s.  Integer and float32 instructions share the
issue slots, so their two times add.
"""
from __future__ import annotations

F32_FLOPS = 67e12
INT32_OPS = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12

MT_FLOPS = 64
CLOSEST_UPDATE = 6
ANYHIT_UPDATE = 4
SHADOW_SETUP = 21
RECON_FLOPS = 150
SHADE_FLOPS = 60
BOUNCE_MISC_FLOPS = 50
SAMPLE_FLOPS = 65  # a soft-shadow sample's float work: Box-Muller (25), its ray (40)
KERNEL_BYTES = 48
RECON_BYTES = 28 * 4 + 60
SHADE_BYTES = 120
PHILOX_INT_OPS = 10 * (4 + 4 + 2) + 4  # ten rounds, then four 24-bit masks

LEVEL_RAY_IN = 12 + 12 + 4
LEVEL_STATE = 1 + 12 + 12
LEVEL_NEXT = 12 + 1 + 12 + 12
LEVEL_SURFACE = 4 * 12 + 4 + 1


def bound_s(flops: float, bytes_: float, int_ops: float = 0.0) -> tuple:
    """(least seconds, 'operations' or 'bytes')."""
    t_ops = flops / F32_FLOPS + int_ops / INT32_OPS
    t_bytes = bytes_ / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def level_work(num_tris: int, triangles, tri_material, num_pl: int, num_sl: int, prim,
               kind: str = "level", bits: bool = True, state: bool = True,
               last: bool = False) -> tuple:
    """(operations, bytes) of one bounce level's kernel on the hits ``prim``
    [N] (int64, -1 a miss): each ray's streams, plus the scene rows the hits
    gather, each once; a hit's surface, Phong toward each light and every
    ray's update.  Triangles only (no sphere primitives)."""
    import torch

    n = int(prim.shape[0])
    valid = prim >= 0
    n_valid = int(valid.sum())
    flops, byts = 0.0, 0
    if kind in ("level", "surface"):
        tri = torch.unique(prim[valid & (prim < num_tris)])
        verts = torch.unique(triangles[tri]) if tri.numel() else tri
        mats = torch.unique(tri_material[tri]) if tri.numel() else tri
        byts += n * LEVEL_RAY_IN + tri.numel() * 16 + verts.numel() * 24 + mats.numel() * 28
        flops += n_valid * RECON_FLOPS
    if kind == "surface":
        return float(flops), float(byts + n * LEVEL_SURFACE)
    if kind == "shade":
        byts += n * (12 + LEVEL_SURFACE)
    byts += n * ((4 if bits else num_pl) + 4 * num_sl + (LEVEL_STATE if state else 0) + 12
                 + (0 if last else LEVEL_NEXT)) + 24 * (num_pl + num_sl)
    flops += n_valid * SHADE_FLOPS * (num_pl + num_sl) + n * BOUNCE_MISC_FLOPS
    return float(flops), float(byts)


def brute_flops_per_ray(num_tris: int, num_lights: int, bounces: int,
                        include_bwd: bool = False) -> float:
    closest = num_tris * (MT_FLOPS + CLOSEST_UPDATE)
    shadow = num_lights * (SHADOW_SETUP + num_tris * (MT_FLOPS + ANYHIT_UPDATE))
    fwd = bounces * (RECON_FLOPS + num_lights * SHADE_FLOPS + BOUNCE_MISC_FLOPS)
    return float(bounces * (closest + shadow) + fwd + (2 * fwd if include_bwd else 0))


def bytes_per_ray(num_lights: int, bounces: int, include_bwd: bool = False) -> float:
    fwd = bounces * (RECON_BYTES + SHADE_BYTES)
    return float(bounces * KERNEL_BYTES + fwd + (2 * fwd if include_bwd else 0))


def headline_roofline(width: int, height: int, num_tris: int, num_lights: int, bounces: int,
                      include_bwd: bool) -> dict:
    """The least time of a brute-force frame or training step in closed
    form: every ray tests every triangle at each bounce, a shadow ray per
    light tests them all, then the surface and Phong; the backward about
    twice the forward's surface and shading."""
    rays = width * height
    flops = rays * brute_flops_per_ray(num_tris, num_lights, bounces, include_bwd)
    byts = rays * bytes_per_ray(num_lights, bounces, include_bwd)
    s, by = bound_s(flops, byts)
    return {"flops": flops, "bytes": byts, "seconds": s, "bound": by}


def sampler_work(points: int, samples: int) -> tuple:
    """(float operations, integer operations, bytes) that any soft-shadow
    sampler must do for ``points`` shading points of ``samples`` samples
    each: Philox4x32-10 and Box-Muller per (point, sample), each sample
    ray's set-up, each point read and each fraction written once.  No tree
    visit or triangle test is counted: those depend on the tree and the
    walk, not on the inputs."""
    pairs = float(points) * samples
    return pairs * SAMPLE_FLOPS, pairs * PHILOX_INT_OPS, float(points) * (12 + 4)


def blur_bytes(height: int, width: int) -> float:
    """The quirk blur's least traffic: the image read once and written once."""
    return 2.0 * height * width * 3 * 4
