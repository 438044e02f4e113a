"""BVH build and the CPU traversal, as in ``cg_raytracer_tpu/ops/bvh.py``.

- Build: a binary tree over the triangle soup, on the host in numpy, with the
  reference's longest-axis centroid-median split (``_build_numpy``,
  bounding_volume_hierarchy.cpp:42-464) or binned SAH (``_build_numpy_sah``).
  Leaves are index ranges into one globally reordered triangle buffer.  The
  median split runs in C++ where the host library builds (``native.py``),
  as in the JAX package.  The same inputs give the same arrays as the JAX
  package's builders of the same kind (numpy, or native).
- Traversal (``backend='bvh'`` on the CPU): the ordered near-to-far descent
  with the current closest ``t`` as the bound (bvh.cpp:535-881), one node per
  ray per step over the whole ray batch, with the JAX package's per-ray
  explicit stack, padded slab test and leaf chunks of ``max_leaf``.

The card does not run this traversal: it runs the 4-wide kernels of
``ops/bvh4.py`` over the tree collapsed from this one.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..scene.types import Scene
from .intersect import (INF, MISS, Hit, merge_spheres_closest, moller_trumbore,
                        spheres_occluded)

DEFAULT_MAX_DEPTH = 20
DEFAULT_MAX_LEAF = 4
_SLAB_EPS = 1e-5


class BVH(NamedTuple):
    """Flattened SoA BVH.  Leaf iff count > 0; internal nodes use left/right."""

    node_lo: torch.Tensor  # [Nn, 3] f32
    node_hi: torch.Tensor  # [Nn, 3] f32
    left: torch.Tensor  # [Nn] i32
    right: torch.Tensor  # [Nn] i32
    first: torch.Tensor  # [Nn] i32: offset into the reordered triangle buffer
    count: torch.Tensor  # [Nn] i32: 0 for internal nodes
    tri_order: torch.Tensor  # [T] i32: reordered position -> original triangle id
    tv0: torch.Tensor  # [T, 3] reordered triangle vertices
    tv1: torch.Tensor
    tv2: torch.Tensor
    max_leaf: int

    @property
    def num_nodes(self) -> int:
        return self.node_lo.shape[0]


def _build_numpy(tri_lo, tri_hi, centroids, max_depth, max_leaf):
    """Host BVH build: iterative stack, centroid-median split on the longest axis.

    The reference's split rule (longest axis of the node box, median of
    centroid-sorted triangles; bvh.cpp:284-289, 192-207) with leaves capped at
    ``max_leaf`` triangles or ``max_depth`` levels.
    Returns (node_lo, node_hi, left, right, first, count, order).
    """
    num_tris = tri_lo.shape[0]
    order = np.arange(num_tris, dtype=np.int32)

    node_lo, node_hi = [], []
    left, right, first, count = [], [], [], []

    def new_node():
        node_lo.append(np.zeros(3, np.float32))
        node_hi.append(np.zeros(3, np.float32))
        left.append(-1)
        right.append(-1)
        first.append(0)
        count.append(0)
        return len(left) - 1

    root = new_node()
    stack = [(root, 0, num_tris, 0)]  # (node_idx, begin, end, depth)
    while stack:
        ni, begin, end, depth = stack.pop()
        ids = order[begin:end]
        lo = tri_lo[ids].min(axis=0)
        hi = tri_hi[ids].max(axis=0)
        node_lo[ni], node_hi[ni] = lo, hi
        n = end - begin
        if n <= max_leaf or depth >= max_depth:
            first[ni] = begin
            count[ni] = n
            continue
        axis = int(np.argmax(hi - lo))
        cent = centroids[ids, axis]
        mid = n // 2
        part = np.argpartition(cent, mid)
        order[begin:end] = ids[part]
        li, ri = new_node(), new_node()
        left[ni], right[ni] = li, ri
        stack.append((ri, begin + mid, end, depth + 1))
        stack.append((li, begin, begin + mid, depth + 1))

    return (np.asarray(node_lo, np.float32), np.asarray(node_hi, np.float32),
            np.asarray(left, np.int32), np.asarray(right, np.int32),
            np.asarray(first, np.int32), np.asarray(count, np.int32), order)


def _build_numpy_sah(tri_lo, tri_hi, centroids, max_depth, max_leaf, bins=16):
    """Host BVH build with binned surface-area-heuristic splits: the split
    minimising ``area(L) * n_L + area(R) * n_R`` over ``bins`` candidate
    planes per axis.  Same output contract as ``_build_numpy``."""
    num_tris = tri_lo.shape[0]
    order = np.arange(num_tris, dtype=np.int32)

    node_lo, node_hi = [], []
    left, right, first, count = [], [], [], []

    def new_node():
        node_lo.append(np.zeros(3, np.float32))
        node_hi.append(np.zeros(3, np.float32))
        left.append(-1)
        right.append(-1)
        first.append(0)
        count.append(0)
        return len(left) - 1

    def half_area(ext):
        ext = np.maximum(ext, 0.0)
        return ext[..., 0] * ext[..., 1] + ext[..., 1] * ext[..., 2] + ext[..., 2] * ext[..., 0]

    root = new_node()
    stack = [(root, 0, num_tris, 0)]
    while stack:
        ni, begin, end, depth = stack.pop()
        ids = order[begin:end]
        lo = tri_lo[ids].min(axis=0)
        hi = tri_hi[ids].max(axis=0)
        node_lo[ni], node_hi[ni] = lo, hi
        n = end - begin
        if n <= max_leaf or depth >= max_depth:
            first[ni] = begin
            count[ni] = n
            continue

        cent = centroids[ids]
        clo, chi = cent.min(axis=0), cent.max(axis=0)
        best = None  # (cost, axis, mask_left)
        for axis in range(3):
            ext = np.float64(chi[axis]) - np.float64(clo[axis])
            # A float32-denormal extent would overflow bins / ext to inf
            # (0 * inf = NaN bins): float64 binning and a hard floor.
            if ext <= 1e-30:
                continue
            b = np.minimum(
                ((cent[:, axis].astype(np.float64) - np.float64(clo[axis]))
                 * (bins / ext)).astype(np.int64),
                bins - 1)
            cnt = np.bincount(b, minlength=bins)
            blo = np.full((bins, 3), np.inf, np.float32)
            bhi = np.full((bins, 3), -np.inf, np.float32)
            np.minimum.at(blo, b, tri_lo[ids])
            np.maximum.at(bhi, b, tri_hi[ids])
            # Empty bins carry +/-inf sentinels, which min/max accumulate ignores.
            llo = np.minimum.accumulate(blo, axis=0)
            lhi = np.maximum.accumulate(bhi, axis=0)
            rlo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
            rhi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
            lcnt = np.cumsum(cnt)[:-1]
            rcnt = n - lcnt
            al = half_area(lhi[:-1] - llo[:-1])
            ar = half_area(rhi[1:] - rlo[1:])
            cost = (np.where(lcnt > 0, al * lcnt, 0.0)
                    + np.where(rcnt > 0, ar * rcnt, 0.0))
            # A split with one side empty makes no progress: forbidden.
            cost = np.where((lcnt == 0) | (rcnt == 0), np.inf, cost)
            s = int(np.argmin(cost))
            if np.isfinite(cost[s]) and (best is None or cost[s] < best[0]):
                best = (float(cost[s]), axis, b <= s)
        if best is None:
            # All centroids coincide: split the range in half.
            mid = n // 2
            mask_left = np.zeros(n, bool)
            mask_left[:mid] = True
        else:
            mask_left = best[2]
        order[begin:end] = np.concatenate([ids[mask_left], ids[~mask_left]])
        mid = int(mask_left.sum())
        li, ri = new_node(), new_node()
        left[ni], right[ni] = li, ri
        stack.append((ri, begin + mid, end, depth + 1))
        stack.append((li, begin, begin + mid, depth + 1))

    return (np.asarray(node_lo, np.float32), np.asarray(node_hi, np.float32),
            np.asarray(left, np.int32), np.asarray(right, np.int32),
            np.asarray(first, np.int32), np.asarray(count, np.int32), order)


def build_bvh(scene: Scene, max_depth: int = DEFAULT_MAX_DEPTH,
              max_leaf: int = DEFAULT_MAX_LEAF, builder: str = "median",
              use_native: bool = True) -> BVH:
    """The flat BVH of a scene's triangles, built on the host (one-time cost)
    and returned on the CPU.  ``builder``: 'median' (the reference's split
    rule) or 'sah'.  ``use_native``: the median build in C++
    (``native.native_build_bvh``) where the library builds, else numpy; its
    ``nth_element`` may order the triangles of a leaf, and break ties of
    equal centroids, unlike numpy's ``argpartition``.  Leaves past
    ``max_depth`` may hold more than ``max_leaf`` triangles; the traversals
    handle any leaf size."""
    if builder not in ("median", "sah"):
        raise ValueError(f"builder must be 'median' | 'sah', got {builder!r}")
    verts = scene.vertices.detach().cpu().numpy()
    tris = scene.triangles.detach().cpu().numpy()
    if tris.shape[0] == 0:
        raise ValueError("Cannot build a BVH over an empty triangle buffer")
    p0, p1, p2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    tri_lo = np.minimum(np.minimum(p0, p1), p2)
    tri_hi = np.maximum(np.maximum(p0, p1), p2)
    centroids = (p0 + p1 + p2) / 3.0
    if builder == "median" and use_native and native.available():
        build = native.native_build_bvh
    else:
        build = _build_numpy_sah if builder == "sah" else _build_numpy
    node_lo, node_hi, left, right, first, count, order = build(
        tri_lo, tri_hi, centroids, max_depth, max_leaf)
    t = torch.from_numpy
    return BVH(node_lo=t(node_lo), node_hi=t(node_hi), left=t(left), right=t(right),
               first=t(first), count=t(count), tri_order=t(order),
               tv0=t(np.ascontiguousarray(p0[order])), tv1=t(np.ascontiguousarray(p1[order])),
               tv2=t(np.ascontiguousarray(p2[order])), max_leaf=int(max_leaf))


def node_depths(bvh: BVH) -> np.ndarray:
    """Each node's level, the root's 0 ([Nn] int32)."""
    left, right = bvh.left.cpu().numpy(), bvh.right.cpu().numpy()
    depth = np.zeros(left.shape[0], np.int32)
    # Nodes are appended parent before child, so one forward sweep suffices.
    for i in range(left.shape[0]):
        for c in (left[i], right[i]):
            if c >= 0:
                depth[c] = depth[i] + 1
    return depth


def bvh_num_levels(bvh: BVH) -> int:
    """Tree depth (numLevels, bvh.cpp:214-224)."""
    return int(node_depths(bvh).max()) + 1


def _slab(o, inv_d, lo, hi):
    """Padded slab test, [..., 3] operands -> (t_in, hit): corner- and
    edge-grazing rays (t_in == t_out up to rounding) are never culled.
    torch.minimum/maximum propagate NaN, as jnp's do: a zero direction
    component with the origin on a slab plane gives a NaN, hence a miss."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    t_in = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_out = torch.amin(torch.maximum(t0, t1), dim=-1)
    pad = _SLAB_EPS * (1.0 + torch.abs(t_out))
    return t_in, (t_in <= t_out + pad) & (t_out >= -pad)


@torch.no_grad()
def traverse_closest(bvh: BVH, origins, dirs, t_max=None, max_stack: int = 64,
                     any_hit: bool = False):
    """Closest-hit (or any-hit) traversal of a ray batch -> (Hit with original
    prim ids, found [N] bool).  ``any_hit`` stops a ray at its first hit below
    its bound.

    Each step pops one node for every unfinished ray and runs the JAX
    package's per-ray program: the popped node's slab test, up to
    ``max_leaf`` triangle tests at a leaf (an oversized leaf re-pushes itself
    with an advanced cursor), or both children's slab tests and an ordered
    push (far first, so the near child pops next) at an internal node.
    """
    n, dev = origins.shape[0], origins.device
    chunk = bvh.max_leaf
    t = (torch.full((n,), INF, dtype=torch.float32, device=dev) if t_max is None
         else torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=dev),
                                 (n,)).clone())
    o, d = origins.detach(), dirs.detach()
    inv_d = 1.0 / d
    stack = torch.zeros((n, max_stack), dtype=torch.long, device=dev)
    stack_off = torch.zeros_like(stack)
    sp = torch.ones((n,), dtype=torch.long, device=dev)
    slot = torch.full((n,), MISS, dtype=torch.long, device=dev)
    u = torch.zeros((n,), dtype=torch.float32, device=dev)
    v = torch.zeros_like(u)
    found = torch.zeros((n,), dtype=torch.bool, device=dev)
    first, count = bvh.first.long(), bvh.count.long()
    left, right = bvh.left.long().clamp_min(0), bvh.right.long().clamp_min(0)
    top = max_stack - 1

    while True:
        go = sp > 0
        if any_hit:
            go = go & ~found
        idx = torch.nonzero(go).squeeze(1)
        if idx.numel() == 0:
            break
        oi, di, ii = o[idx], d[idx], inv_d[idx]
        t_i, slot_i, u_i, v_i = t[idx], slot[idx], u[idx], v[idx]
        st, so = stack[idx], stack_off[idx]
        rows = torch.arange(idx.numel(), device=dev)
        sp_i = sp[idx] - 1
        ni = st[rows, sp_i]
        off = so[rows, sp_i]
        t_in, box_hit = _slab(oi, ii, bvh.node_lo[ni], bvh.node_hi[ni])
        box_hit = box_hit & (t_in <= t_i + _SLAB_EPS * (1.0 + torch.abs(t_i)))
        cnt = count[ni]
        is_leaf = cnt > 0
        do_leaf = box_hit & is_leaf

        # Leaf: up to `chunk` triangles from first + off.
        base = first[ni] + off
        t_cur, slot_cur, u_cur, v_cur = t_i, slot_i, u_i, v_i
        for k in range(chunk):
            in_range = do_leaf & (off + k < cnt)
            safe = torch.where(in_range, base + k, 0)
            tt, uu, vv, ok = moller_trumbore(oi, di, bvh.tv0[safe], bvh.tv1[safe], bvh.tv2[safe])
            ok = ok & in_range & (tt < t_cur)
            t_cur = torch.where(ok, tt, t_cur)
            slot_cur = torch.where(ok, safe, slot_cur)
            u_cur = torch.where(ok, uu, u_cur)
            v_cur = torch.where(ok, vv, v_cur)
        found_i = found[idx] | (do_leaf & (slot_cur != slot_i))
        more = do_leaf & (off + chunk < cnt)
        st[rows, sp_i.clamp(max=top)] = ni
        so[rows, sp_i.clamp(max=top)] = off + chunk
        sp_i = sp_i + more.long()

        # Internal: slab-test both children, push far then near.
        do_int = box_hit & ~is_leaf
        li, ri = left[ni], right[ni]
        tl, hl = _slab(oi, ii, bvh.node_lo[li], bvh.node_hi[li])
        tr, hr = _slab(oi, ii, bvh.node_lo[ri], bvh.node_hi[ri])
        bound = t_cur + _SLAB_EPS * (1.0 + torch.abs(t_cur))
        hl = hl & do_int & (tl <= bound)
        hr = hr & do_int & (tr <= bound)
        left_near = tl <= tr
        for child_i, child_h in ((torch.where(left_near, ri, li), torch.where(left_near, hr, hl)),
                                 (torch.where(left_near, li, ri), torch.where(left_near, hl, hr))):
            at = sp_i.clamp(max=top)
            st[rows, at] = torch.where(child_h, child_i, st[rows, at])
            so[rows, at] = torch.where(child_h, 0, so[rows, at])
            sp_i = sp_i + child_h.long()

        stack[idx], stack_off[idx], sp[idx] = st, so, sp_i
        t[idx], slot[idx], u[idx], v[idx], found[idx] = t_cur, slot_cur, u_cur, v_cur, found_i

    prim = torch.where(slot >= 0, bvh.tri_order.long()[slot.clamp_min(0)], MISS)
    miss = slot < 0
    return Hit(t=torch.where(miss, INF, t), prim_id=prim.to(torch.int32), u=u, v=v), found


def intersect_bvh(scene: Scene, bvh: BVH, origins, dirs, t_max=None) -> Hit:
    """Closest hit through the BVH, then the spheres by brute force
    (bvh.cpp:850-881): a sphere replaces the hit where strictly closer."""
    hit, _ = traverse_closest(bvh, origins, dirs, t_max=t_max)
    return merge_spheres_closest(scene, origins, dirs, hit)


def occluded_bvh(scene: Scene, bvh: BVH, origins, dirs, t_max):
    """Any-hit (shadow) query through the BVH, then the spheres."""
    _, found = traverse_closest(bvh, origins, dirs, t_max=t_max, any_hit=True)
    return found | spheres_occluded(scene, origins, dirs, t_max)
