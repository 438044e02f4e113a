"""Geometry-sharded rendering, as in ``cg_raytracer_tpu/parallel/geometry.py``:
the triangles split over the ranks of a mesh axis ('prims'), each rank
walking its own shard, the hits merged across ranks.

- **Partition** (host, numpy, the JAX package's bit for bit): triangles
  sorted by the 30-bit morton code of their centroids and cut into S equal
  contiguous shards of K = ceil(T / S), padded with the degenerate triangle
  (0, 0, 0), which no ray hits; ``perm`` maps (shard, slot) to the triangle
  id (-1 on padding).
- **Per rank**: the shard's triangles and materials and the tree of that
  shard only (``build_accel`` of the shard's scene: the brute kernels up to
  256 triangles, the wide tree beyond); vertices, normals, materials, lights
  and spheres are the whole scene's.  The JAX package stacks the shards'
  trees for ``shard_map``; a rank here holds one, so nothing is stacked.
- **Merge** (``merge_hit_across_shards``): ``all_reduce(MIN)`` of t, then of
  the shard index among the ranks whose hit reaches it (the lowest shard
  wins a tie), then a masked SUM of the winner's (global prim id, u, v)
  bits: every rank gets the winning shard's own u and v.  The surface is
  reconstructed from that global hit on the whole scene, on every rank.
  Shadow any-hits are an OR across shards (``all_reduce(MAX)``).  The fused
  bounce and record kernels are not used per shard (their shadow rays
  would leave from a hit that may lose the merge): the per-shard
  closest-hit and any-hit kernels are, inside the ordinary trace loop
  (``models/whitted.py::trace_rays``) over a ``Backend`` that merges.
  Spherical lights take the scan over the merged any-hit oracle.
- A 2-D ('rays', 'prims') mesh composes the pixel rows with this
  (``ray_axis='rays'``): each rank traces its row block against its shard.

Every collective is an ``all_reduce`` (see ``sharding.py``), so ranks may
share a card over gloo.  The result equals a replicated render except where
a tie of equal t across a shard boundary resolves to another triangle.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models import whitted
from ..ops.intersect import INF, MISS, Hit
from ..scene.types import Camera, Scene
from ..utils.config import RenderConfig
from .sharding import MAX, MIN, SUM, Mesh, render_on_mesh

PRIM_AXIS = "prims"


class GeometryShards(NamedTuple):
    """The partition, [S, ...] on the scene's device, and one shard's tree.

    ``accel`` is the tree of shard ``shard`` (None where that shard runs the
    brute kernels, or when no shard was named)."""

    tris: torch.Tensor  # [S, K, 3] int32 (the scene's vertex indices)
    tri_mat: torch.Tensor  # [S, K] int32
    perm: torch.Tensor  # [S, K] int32: triangle id, -1 on padding
    accel: object
    shard: Optional[int]
    n_shards: int
    shard_size: int


def _morton30(centroids: np.ndarray) -> np.ndarray:
    """30-bit 3-D morton code of centroids normalized to their AABB."""
    lo = centroids.min(axis=0)
    span = np.maximum(centroids.max(axis=0) - lo, 1e-12)
    q = np.clip((centroids - lo) / span * 1023.0, 0, 1023).astype(np.uint64)

    def spread(v):
        v = (v | (v << np.uint64(16))) & np.uint64(0x030000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x0300F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x030C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x09249249)
        return v

    return spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2))


def _shard_cfg(cfg: RenderConfig) -> RenderConfig:
    """Spherical lights take the scan over the merged any-hit oracle: no
    sampler kernel, so no sampler tree either."""
    return dataclasses.replace(cfg, soft_shadow_kernel="off")


def shard_scene(scene: Scene, shards: GeometryShards, s: int) -> Scene:
    """The scene holding shard ``s``'s triangles (the rest shared)."""
    return dataclasses.replace(scene, triangles=shards.tris[s], tri_material=shards.tri_mat[s])


def build_geometry_shards(scene: Scene, n_shards: int, cfg: RenderConfig,
                          shard: Optional[int] = None) -> GeometryShards:
    """Host-side partition (the JAX package's, bit for bit) and the tree of
    shard ``shard`` (a rank passes its index on the 'prims' axis; None
    builds no tree)."""
    num_tris = scene.num_triangles
    if num_tris == 0:
        raise ValueError("geometry sharding requires a non-empty triangle buffer")
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    verts = scene.vertices.detach().cpu().numpy()
    tris = scene.triangles.cpu().numpy()
    tri_mat = scene.tri_material.cpu().numpy()
    cent = (verts[tris[:, 0]] + verts[tris[:, 1]] + verts[tris[:, 2]]) / 3.0
    order = np.argsort(_morton30(cent), kind="stable").astype(np.int32)

    k = -(-num_tris // n_shards)
    pad = n_shards * k - num_tris
    perm = np.concatenate([order, np.full(pad, -1, np.int32)])
    tris_p = np.concatenate([tris[order], np.zeros((pad, 3), np.int32)])
    mat_p = np.concatenate([tri_mat[order], np.zeros(pad, np.int32)])
    as_t = lambda a, *shape: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a.reshape(n_shards, k, *shape), np.int32)).to(scene.device)
    shards = GeometryShards(tris=as_t(tris_p, 3), tri_mat=as_t(mat_p), perm=as_t(perm),
                            accel=None, shard=shard, n_shards=n_shards, shard_size=k)
    if shard is None:
        return shards
    return shards._replace(accel=whitted.build_accel(shard_scene(scene, shards, shard),
                                                     _shard_cfg(cfg)))


def merge_hit_across_shards(hit: Hit, mesh: Mesh, axis: str, perm, num_tris: int):
    """The closest hit over every shard, in global ids, on every rank, and
    whether this rank's shard won each ray.  ``hit``: this shard's, in its
    local ids (slots < K, spheres K + s); ``perm``: this shard's row of the
    permutation; ``num_tris``: the scene's triangle count."""
    idx, n, k = mesh.index(axis), mesh.size(axis), perm.shape[0]
    t = mesh.all_reduce(hit.t.clone(), MIN, axis)
    claim = (hit.prim_id >= 0) & (hit.t <= t)
    winner = mesh.all_reduce(torch.where(claim, idx, n).to(torch.int32), MIN, axis)
    mine = claim & (winner == idx)
    local = hit.prim_id.long()
    glob = torch.where(local >= k, local - k + num_tris, perm.long()[local.clamp(0, k - 1)])
    packed = torch.stack([glob.to(torch.int32), hit.u.contiguous().view(torch.int32),
                          hit.v.contiguous().view(torch.int32)], dim=1)
    packed = mesh.all_reduce(torch.where(mine[:, None], packed, 0).contiguous(), SUM, axis)
    found = winner < n
    merged = Hit(t=torch.where(found, t, INF), prim_id=torch.where(found, packed[:, 0], MISS),
                 u=packed[:, 1].contiguous().view(torch.float32),
                 v=packed[:, 2].contiguous().view(torch.float32))
    return merged, mine


def _check_shards(shards: GeometryShards, mesh: Mesh, axis: str) -> None:
    if shards.n_shards != mesh.size(axis):
        raise ValueError(f"shards were built for {shards.n_shards} shards but mesh axis "
                         f"{axis!r} has size {mesh.size(axis)}")


def sharded_backend(scene: Scene, cfg: RenderConfig, mesh: Mesh, shards: GeometryShards,
                    axis: str = PRIM_AXIS) -> whitted.Backend:
    """Oracles over the whole scene answered collectively: this rank's shard
    through the ordinary per-shard backend (its closest-hit and any-hit
    kernels), the hits merged across ``axis``.  The tree is ``shards.accel``
    where ``shards`` was built for this rank's shard, else built here."""
    _check_shards(shards, mesh, axis)
    cfg = _shard_cfg(cfg)
    s = mesh.index(axis)
    sub = shard_scene(scene, shards, s)
    accel = shards.accel if shards.shard == s else whitted.build_accel(sub, cfg)
    local = whitted.make_backend(sub, cfg, accel=accel)
    perm, num_tris = shards.perm[s], scene.num_triangles

    def closest(o, d):
        return merge_hit_across_shards(local.closest(o, d), mesh, axis, perm, num_tris)[0]

    def occluded(o, d, t_max):
        blocked = local.occluded(o, d, t_max).to(torch.int32)
        return mesh.all_reduce(blocked.contiguous(), MAX, axis) > 0

    return whitted.Backend(closest=closest, occluded=occluded, shade=local.shade)


def geometry_sharded_render(scene: Scene, camera: Camera, cfg: RenderConfig, mesh: Mesh,
                            shards: Optional[GeometryShards] = None, generator=None,
                            axis: str = PRIM_AXIS, ray_axis: Optional[str] = None):
    """Render with the triangles sharded over ``mesh`` axis ``axis`` -> [H,
    W, 3] on every rank, the effects as ``render_image`` composes them.

    ``shards``: from ``build_geometry_shards(scene, S, cfg, shard=rank's
    index on axis)`` with S the axis's size (built once on the host: pass it
    in render loops); built here when None.  ``ray_axis``: a second mesh
    axis over which the pixel rows are split too."""
    if shards is None:
        shards = build_geometry_shards(scene, mesh.size(axis), cfg, shard=mesh.index(axis))
    _check_shards(shards, mesh, axis)
    depth = whitted.effective_max_depth(scene, cfg)
    cfg = dataclasses.replace(_shard_cfg(cfg), max_depth=depth)
    backend = sharded_backend(scene, cfg, mesh, shards, axis)
    return render_on_mesh(scene, camera, cfg, mesh, backend, generator, ray_axis=ray_axis)


def geometry_sharded_intersect(scene: Scene, cfg: RenderConfig, mesh: Mesh,
                               shards: GeometryShards, origins, dirs,
                               axis: str = PRIM_AXIS) -> Hit:
    """The closest-hit oracle through the sharded geometry, in global prim
    ids (triangles through ``perm``, spheres shifted from K to T): the
    contract that the merge keeps the single-device oracle."""
    return sharded_backend(scene, cfg, mesh, shards, axis).closest(origins, dirs)
