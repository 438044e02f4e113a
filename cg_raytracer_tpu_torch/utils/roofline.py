"""The least time an H100 could take for a kernel's work: the larger of its
operations over the card's rates and its bytes over the memory rate
(``chip_smoke.py`` reports it as each kernel's ``bound_ms``).

Per-operation counts are those of ``cg_raytracer_tpu/utils/roofline.py``
(counted there line by line from the Pallas kernels; each add, multiply,
compare, select, min, max, division, square root or transcendental is one
operation), with the wide node visits counted here.  Work that depends on
the data is counted on this run's data: an any-hit sweep's triangle tests
up to its first blocker (``anyhit_tests``), a tree walk's node visits and
triangle tests (counted by the twins' traversal, ``ops/bvh4.py``
``_traverse_plain(stats=)``).  Bytes count each input read once and each
output written once.

Peaks (NVIDIA's H100 SXM data sheet, at its 700 W limit): 67 TFLOP/s float32
outside the tensor cores, 3.35 TB/s of HBM3.  32-bit integer operations
(the samplers' Philox) run at 64 per clock per SM on compute capability 9.0
(CUDA C++ Programming Guide, arithmetic instruction throughput), against 128
for float32: 132 SMs x 64 x 1.98 GHz boost = 16.7 Tops/s.  Integer and
float32 instructions share each SM's issue slots, so their two times add.
A card set below 700 W runs slower; the callers print its limit beside these
numbers.
"""
from __future__ import annotations

import torch

from ..ops.intersect import moller_trumbore

F32_FLOPS = 67e12
INT32_OPS = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12

MT_FLOPS = 64  # one Moller-Trumbore test
CLOSEST_UPDATE = 6  # closer = ok & t < t_best, four selects
ANYHIT_UPDATE = 4  # ok & t < t_max
SHADOW_SETUP = 21  # a point light's shadow ray
SLAB_FLOPS = 30  # one child box's slab test
TBOUND_FLOPS = 6  # its prune against the padded best
CSWAP_FLOPS = 3  # a compare-exchange of the children's sort
RECON_FLOPS = 150  # the hit's surface: MT re-solve, normal, flip, masks
SHADE_FLOPS = 60  # Phong toward one light
BOUNCE_MISC_FLOPS = 50  # reflection, throughput, masks
SAMPLE_FLOPS = 65  # a soft-shadow sample's float work: Box-Muller (25), its ray (40)
# Per-ray byte streams of a frame (the JAX package's bytes_per_ray): the
# bounce kernel's rays in and records out, the surface's gathered row and
# fields, shading's re-reads and the color.
KERNEL_BYTES = 48
RECON_BYTES = 28 * 4 + 60
SHADE_BYTES = 120
# Philox4x32-10's integer work per sample: ten rounds of two 32 x 32 -> 64-bit
# products (a high and a low word each), four xors and two key bumps, then
# the four 24-bit masks of the uniforms.
PHILOX_INT_OPS = 10 * (4 + 4 + 2) + 4


def internal_visit_flops(width: int) -> int:
    """A width-W node visit: W child slab tests (6 W subtractions and
    multiplies, the min/max tree) and prunes, and the comparators of the
    sort network for W (ops/bvh4.py SORT_NET: 1, 5, 19): 75, 159, 345."""
    from ..ops.bvh4 import SORT_NET

    return width * (SLAB_FLOPS + TBOUND_FLOPS) + CSWAP_FLOPS * len(SORT_NET[width])


def bound_ms(flops: float, bytes_: float, int_ops: float = 0.0):
    """(least ms, 'operations' or 'bytes': which of the two bounds it);
    ``int_ops`` are 32-bit integer operations beside the float ``flops``."""
    t_ops, t_bytes = flops / F32_FLOPS + int_ops / INT32_OPS, bytes_ / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


@torch.no_grad()
def anyhit_tests(tri, o, d, t_max, chunk: int = 1 << 16):
    """Triangle tests [N] of any-hit sweeps over ``tri`` [T, 9] that stop at
    their first blocker (t in [0, t_max)); a ray with t_max <= 0 tests none."""
    v0, v1, v2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    num = tri.shape[0]
    out = torch.empty((o.shape[0],), dtype=torch.int64, device=o.device)
    for s in range(0, o.shape[0], chunk):
        oc, dc, tc = o[s:s + chunk, None], d[s:s + chunk, None], t_max[s:s + chunk]
        t, _, _, ok = moller_trumbore(oc, dc, v0[None], v1[None], v2[None])
        blocked = ok & (t < tc[:, None])
        first = torch.where(blocked.any(dim=1), blocked.to(torch.int8).argmax(dim=1) + 1, num)
        out[s:s + chunk] = torch.where(tc > 0.0, first, 0)
    return out


def table_bytes(*tables) -> int:
    return sum(int(x.numel()) * x.element_size() for x in tables if x is not None)


def tree_bytes(tree) -> int:
    """The wide tree's tables (ops/bvh4.py BVH4)."""
    return table_bytes(tree.boxes, tree.meta, tree.nchild, tree.tris, tree.slot_to_prim)


@torch.no_grad()
def brute_bounce_flops(tri, lights, o, d, live=None):
    """Operations of a closest sweep over every triangle for each live ray,
    then per point light a shadow ray and its any-hit sweep from each hit
    (the bounce kernels; with no lights, the closest sweep alone) ->
    (flops, hit mask [N])."""
    from ..ops import cuda_kernels as ck

    num = tri.shape[0]
    tm = None if live is None else torch.where(live, float("inf"), -1.0)
    hit = ck._closest_plain(tri, o, d, tm)
    ok = hit.prim_id >= 0
    n_live = o.shape[0] if live is None else int(live.sum())
    flops = n_live * num * (MT_FLOPS + CLOSEST_UPDATE)
    p = o + d * torch.where(ok, hit.t, 0.0)[:, None]
    for li in range(lights.shape[0]):
        so, sd, dist = ck._shadow_rays(p, lights[li, 0:3])
        tests = anyhit_tests(tri, so, sd, torch.where(ok, dist - ck.SHADOW_EPS, -1.0))
        flops += int(ok.sum()) * SHADOW_SETUP + int(tests.sum()) * (MT_FLOPS + ANYHIT_UPDATE)
    return float(flops), ok


@torch.no_grad()
def tree_anyhit_flops(tree, o, d, t_max) -> float:
    """Operations of any-hit walks of the tree (any width): the node visits
    and triangle tests as the twin counts them on these rays."""
    from ..ops import bvh4 as b4

    stats: dict = {}
    b4._anyhit_plain(tree, o, d, t_max, stats=stats)
    return float(stats.get("visits", 0) * internal_visit_flops(tree.width)
                 + stats.get("tests", 0) * (MT_FLOPS + ANYHIT_UPDATE))


@torch.no_grad()
def tree_bounce_flops(tree, lights, o, d, live=None):
    """``brute_bounce_flops`` over the tree (any width): the walks' node
    visits and triangle tests as the twin counts them -> (flops, hit mask
    [N])."""
    from ..ops import bvh4 as b4
    from ..ops import cuda_kernels as ck

    stats: dict = {}
    tm = None if live is None else torch.where(live, float("inf"), -1.0)
    t, slot, _, _ = b4._traverse_plain(tree, o, d, tm, any_hit=False, stats=stats)
    flops = float(stats.get("visits", 0) * internal_visit_flops(tree.width)
                  + stats.get("tests", 0) * (MT_FLOPS + CLOSEST_UPDATE))
    ok = slot >= 0
    p = o + d * torch.where(ok, t, 0.0)[:, None]
    for li in range(lights.shape[0]):
        so, sd, dist = ck._shadow_rays(p, lights[li, 0:3])
        flops += int(ok.sum()) * SHADOW_SETUP + tree_anyhit_flops(
            tree, so, sd, torch.where(ok, dist - ck.SHADOW_EPS, -1.0))
    return flops, ok


def shade_flops(n_live: int, num_lights: int, backward: bool = False) -> float:
    """The shade kernels: each live ray's surface and Phong toward each
    light (its backward about three times the forward)."""
    return float(n_live * (RECON_FLOPS + SHADE_FLOPS * num_lights) * (3 if backward else 1))


# One bounce level (ops/level.py, csrc/level.cu): per-ray streams in bytes.
LEVEL_RAY_IN = 12 + 12 + 4  # o, d, prim id
LEVEL_STATE = 1 + 12 + 12  # active, throughput, color (none at level 0)
LEVEL_NEXT = 12 + 1 + 12 + 12  # throughput, active, o and d out (none at the last level)
LEVEL_SURFACE = 4 * 12 + 4 + 1  # position, normal, kd, ks, shininess, valid


@torch.no_grad()
def level_work(scene, prim, kind: str = "level", bits: bool = True, state: bool = True,
               last: bool = False):
    """(operations, bytes) of one level's kernel on these hits (``prim`` [N]):
    ``kind`` 'level' (surface, shade and update), 'surface' or 'shade'.
    Bytes: each ray's streams (rays, prim id, ``bits`` [N] int32 or a byte
    per point light of blocked masks, a fraction per spherical light, the
    ``state`` in, the color and, unless ``last``, the next rays out; the
    surface between the split kernels), plus the scene rows the hits gather,
    each once: the triangles' index and material rows, their vertices and
    vertex normals, their materials, the spheres, the lights.  Operations:
    a hit's surface (``RECON_FLOPS``: the Moller-Trumbore re-solve or the
    sphere's quadratic, the normal and its flip), Phong toward each light,
    and every ray's update (``BOUNCE_MISC_FLOPS``)."""
    n = int(prim.shape[0])
    num_pl = int(scene.point_lights.position.shape[0])
    num_sl = int(scene.spherical_lights.position.shape[0])
    valid = prim >= 0
    n_valid = int(valid.sum())
    flops, byts = 0.0, 0
    if kind in ("level", "surface"):
        num_tris = scene.num_triangles
        tri = torch.unique(prim[valid & (prim < num_tris)]).long()
        sph = torch.unique(prim[prim >= num_tris] - num_tris).long()
        verts = torch.unique(scene.triangles[tri].long()) if tri.numel() else tri
        mats = torch.unique(scene.tri_material[tri].long()) if tri.numel() else tri
        byts += (n * LEVEL_RAY_IN + tri.numel() * 16 + verts.numel() * 24 + mats.numel() * 28
                 + sph.numel() * 44)
        flops += n_valid * RECON_FLOPS
    if kind == "surface":
        return float(flops), float(byts + n * LEVEL_SURFACE)
    if kind == "shade":
        byts += n * (12 + LEVEL_SURFACE)  # d and the surface
    byts += n * ((4 if bits else num_pl) + 4 * num_sl + (LEVEL_STATE if state else 0) + 12
                 + (0 if last else LEVEL_NEXT)) + 24 * (num_pl + num_sl)
    flops += n_valid * SHADE_FLOPS * (num_pl + num_sl) + n * BOUNCE_MISC_FLOPS
    return float(flops), float(byts)


def brute_flops_per_ray(num_tris: int, num_lights: int, bounces: int,
                        include_bwd: bool = False) -> float:
    """Operations per primary ray of a brute-force frame in closed form
    (``cg_raytracer_tpu/utils/roofline.py::brute_flops_per_ray``): every ray
    tests every triangle at each bounce, a shadow ray per light tests them
    all, then the surface and Phong; the backward replays the surface and
    shading at about twice their forward (the sweeps are oracles)."""
    closest = num_tris * (MT_FLOPS + CLOSEST_UPDATE)
    shadow = num_lights * (SHADOW_SETUP + num_tris * (MT_FLOPS + ANYHIT_UPDATE))
    fwd = bounces * (RECON_FLOPS + num_lights * SHADE_FLOPS + BOUNCE_MISC_FLOPS)
    return float(bounces * (closest + shadow) + fwd + (2 * fwd if include_bwd else 0))


def bytes_per_ray(num_lights: int, bounces: int, include_bwd: bool = False) -> float:
    """The per-ray byte streams of a frame (``cg_raytracer_tpu/utils/
    roofline.py::bytes_per_ray``; the scene's tables amortise to ~0 per
    ray)."""
    fwd = bounces * (RECON_BYTES + SHADE_BYTES)
    return float(bounces * KERNEL_BYTES + fwd + (2 * fwd if include_bwd else 0))


def headline_roofline(width: int, height: int, num_tris: int, num_lights: int, bounces: int,
                      include_bwd: bool) -> dict:
    """The least time of a brute-force frame or training step on an H100
    (``cg_raytracer_tpu/utils/roofline.py::headline_roofline`` over this
    card's peaks): the closed-form operations over 67 TFLOP/s against the
    bytes over 3.35 TB/s."""
    rays = width * height
    flops = rays * brute_flops_per_ray(num_tris, num_lights, bounces, include_bwd)
    byts = rays * bytes_per_ray(num_lights, bounces, include_bwd)
    ms, by = bound_ms(flops, byts)
    return {"chip": "NVIDIA H100 SXM (67 TFLOP/s float32, 3.35 TB/s)", "rays": rays,
            "gflops_per_frame": flops / 1e9, "mbytes_per_frame": byts / 1e6,
            "ideal_seconds": ms / 1e3, "bound": by, "ideal_rays_per_s": rays / (ms / 1e3)}


def pct_of_roofline(measured_s: float, flops: float, bytes_: float) -> float:
    """The least time of ``flops`` and ``bytes_`` on the card as a percentage
    of ``measured_s``."""
    return 100.0 * bound_ms(flops, bytes_)[0] / 1e3 / measured_s
