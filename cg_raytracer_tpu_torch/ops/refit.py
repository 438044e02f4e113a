"""BVH refit: the boxes and triangle tables of a built tree recomputed from
moved vertices, its topology kept.  Counterpart of
``cg_raytracer_tpu/ops/refit.py`` for the port's trees.

A tree's topology (splits, triangle order, leaf ranges) is fixed at its host
build; an optimizer step that moves vertices leaves every box stale.  The
refit keeps the topology and recomputes, from the current vertices:

1. the triangle table in leaf order (one gather through ``tri_order`` /
   ``slot_to_prim``): ``tv0..tv2`` of a ``BVH``, ``tris`` (v0, v1 - v0,
   v2 - v0) of a ``BVH4`` of width 2 or 4 (the trees the JAX package
   refits: its binary tree and its 4-wide one, both tiers; width 8 raises,
   as there);
2. the leaf boxes, a segment min/max over each leaf's rows
   (``scatter_reduce`` amin/amax);
3. the internal boxes bottom-up, one gather and min/max per level, as the
   union of the child's boxes.

``make_refit_plan`` extracts the static part on the host once per tree (the
leaf segment of every row, the internal links grouped by level, deepest
first) and moves it to the tree's device; ``refit_accel`` is plain PyTorch
and runs on the tree's device, on the card between kernel launches (the JAX
package computes it in XLA, outside any Pallas kernel).  Min and max are
exact, so a refit of unmoved vertices gives back the built tree bit for bit.

The refit tree is as valid as a fresh build (every box bounds its subtree)
but keeps the original splits, so a walk grows slower as vertices drift;
optimizer steps move them ~1e-2, for which the old splits stay good.
Rebuild when the geometry changes wholesale.

Gradients: none.  The refit runs on detached vertices under
``torch.no_grad`` (the JAX refit is a ``stop_gradient``): trees are oracles,
and gradients reach the vertices only through the differentiable
reconstruct and shade at the recorded hits.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..scene.types import Scene
from .bvh import BVH
from .bvh4 import BVH4


class RefitPlan(NamedTuple):
    """A binary ``BVH``'s static topology, on the tree's device."""

    slot_tri: torch.Tensor  # [T] i64: leaf-order row -> triangle id
    slot_node: torch.Tensor  # [T] i64: row -> its leaf node
    levels: Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], ...]
    # each level: (internal nodes, their left and right children), deepest first
    num_nodes: int


class RefitPlan4(NamedTuple):
    """A width-W ``BVH4``'s static topology, on the tree's device.  A lane
    is (node, child slot c); its box columns are W * k + c (lo) and
    3 W + W * k + c (hi) of ``boxes``."""

    slot_tri: torch.Tensor  # [T] i64: leaf-order row -> triangle id
    slot_lane: torch.Tensor  # [T] i64: row -> W * node + c of its leaf lane
    leaf_lanes: torch.Tensor  # [Lf] i64: every leaf lane, W * node + c
    levels: Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], ...]
    # each level: (parent nodes, child slots, child nodes), deepest child first
    num_nodes: int
    width: int = 4


def _by_depth(depth: np.ndarray, *columns: np.ndarray, device):
    """Rows of ``columns`` grouped by ``depth``, deepest first, as tensors."""
    groups = []
    for dpt in sorted(set(depth.tolist()), reverse=True):
        pick = depth == dpt
        groups.append(tuple(torch.from_numpy(c[pick].astype(np.int64)).to(device)
                            for c in columns))
    return tuple(groups)


def _plan_bvh(bvh: BVH) -> RefitPlan:
    left, right = bvh.left.cpu().numpy(), bvh.right.cpu().numpy()
    first, count = bvh.first.cpu().numpy(), bvh.count.cpu().numpy()
    n, is_leaf = left.shape[0], count > 0
    depth = np.zeros(n, np.int64)
    for i in range(n):  # nodes are appended parent before child
        if not is_leaf[i]:
            depth[left[i]] = depth[right[i]] = depth[i] + 1
    leaves = np.nonzero(is_leaf)[0]
    leaves = leaves[np.argsort(first[leaves], kind="stable")]
    slot_node = np.repeat(leaves, count[leaves])
    internal = np.nonzero(~is_leaf)[0]
    dev = bvh.node_lo.device
    return RefitPlan(
        slot_tri=bvh.tri_order.to(device=dev, dtype=torch.int64),
        slot_node=torch.from_numpy(slot_node.astype(np.int64)).to(dev),
        levels=_by_depth(depth[internal], internal, left[internal], right[internal],
                         device=dev),
        num_nodes=n)


def _plan_bvh4(tree: BVH4) -> RefitPlan4:
    w = tree.width
    if w not in (2, 4):
        raise NotImplementedError(
            f"refit supports width-4 wide trees only (got width={w}); build the accel with "
            f"bvh_wide='4' when optimizing vertices")
    meta, nchild = tree.meta.cpu().numpy(), tree.nchild.cpu().numpy()
    num = nchild.shape[0]
    valid = np.arange(w)[None, :] < nchild[:, None]
    leaf = valid & (meta[:, w:2 * w] > 0)
    inner = valid & (meta[:, w:2 * w] == 0)
    # Depth of each node: rows are appended parent before child (collapse_bvhw).
    par, lane = np.nonzero(inner)
    child = meta[par, lane]
    depth = np.zeros(num, np.int64)
    for p, c in zip(par.tolist(), child.tolist()):
        depth[c] = depth[p] + 1
    lw, lc = np.nonzero(leaf)
    starts = meta[lw, lc]
    order = np.argsort(starts, kind="stable")
    lanes = (w * lw + lc)[order]
    slot_lane = np.repeat(lanes, meta[lw, w + lc][order])
    if slot_lane.shape[0] != tree.num_tris:
        raise ValueError(f"the tree's leaves cover {slot_lane.shape[0]} rows of "
                         f"{tree.num_tris}")
    dev = tree.device
    t = lambda a: torch.from_numpy(a.astype(np.int64)).to(dev)  # noqa: E731
    return RefitPlan4(slot_tri=tree.slot_to_prim.to(device=dev, dtype=torch.int64),
                      slot_lane=t(slot_lane), leaf_lanes=t(lanes),
                      levels=_by_depth(depth[child], par, lane, child, device=dev),
                      num_nodes=num, width=w)


def make_refit_plan(accel):
    """The static topology of ``accel`` (a ``BVH``, a ``BVH4`` or an
    ``AccelBundle``, whose plan is a (primary, soft) pair with the soft
    entry None where both fields are one tree).  A host pass: build it once
    per tree, outside the training loop."""
    from ..models.whitted import AccelBundle

    if isinstance(accel, AccelBundle):
        primary = make_refit_plan(accel.primary)
        return primary, (None if accel.soft is accel.primary else make_refit_plan(accel.soft))
    if isinstance(accel, BVH):
        return _plan_bvh(accel)
    if isinstance(accel, BVH4):
        return _plan_bvh4(accel)
    raise TypeError(f"no refit plan for accel type {type(accel).__name__}")


def _rows(scene: Scene, slot_tri, device):
    """The triangles' vertices in leaf order, detached: (v0, v1, v2) [T, 3]."""
    verts = scene.vertices.detach().to(device)
    tri = scene.triangles.to(device=device, dtype=torch.int64)[slot_tri]
    return verts[tri[:, 0]], verts[tri[:, 1]], verts[tri[:, 2]]


def _segment_boxes(p0, p1, p2, seg, num_segments):
    """Per segment, the min and max over its rows' vertices -> (lo, hi)
    [num_segments, 3]; a segment without rows is (+inf, -inf)."""
    lo = torch.minimum(torch.minimum(p0, p1), p2)
    hi = torch.maximum(torch.maximum(p0, p1), p2)
    index = seg[:, None].expand(-1, 3)
    seg_lo = torch.full((num_segments, 3), float("inf"), dtype=lo.dtype, device=lo.device)
    seg_hi = torch.full((num_segments, 3), float("-inf"), dtype=hi.dtype, device=hi.device)
    return (seg_lo.scatter_reduce(0, index, lo, "amin"),
            seg_hi.scatter_reduce(0, index, hi, "amax"))


def _refit_bvh(bvh: BVH, plan: RefitPlan, scene: Scene) -> BVH:
    p0, p1, p2 = _rows(scene, plan.slot_tri, bvh.node_lo.device)
    node_lo, node_hi = _segment_boxes(p0, p1, p2, plan.slot_node, plan.num_nodes)
    for nodes, left, right in plan.levels:
        node_lo[nodes] = torch.minimum(node_lo[left], node_lo[right])
        node_hi[nodes] = torch.maximum(node_hi[left], node_hi[right])
    return bvh._replace(node_lo=node_lo, node_hi=node_hi, tv0=p0.contiguous(),
                        tv1=p1.contiguous(), tv2=p2.contiguous())


def _refit_bvh4(tree: BVH4, plan: RefitPlan4, scene: Scene) -> BVH4:
    dev, w = tree.device, plan.width
    if tree.width != w:
        raise ValueError(f"a refit plan of width {w} for a width-{tree.width} tree")
    p0, p1, p2 = _rows(scene, plan.slot_tri, dev)
    seg_lo, seg_hi = _segment_boxes(p0, p1, p2, plan.slot_lane, w * plan.num_nodes)
    boxes = tree.boxes.clone()
    lo_cols = w * torch.arange(3, device=dev)  # lo.x, lo.y, lo.z of child slot 0
    hi_cols = 3 * w + lo_cols
    node, slot = plan.leaf_lanes // w, plan.leaf_lanes % w
    boxes[node[:, None], lo_cols + slot[:, None]] = seg_lo[plan.leaf_lanes]
    boxes[node[:, None], hi_cols + slot[:, None]] = seg_hi[plan.leaf_lanes]
    lanes = torch.arange(w, device=dev)
    for parents, slots, children in plan.levels:
        rows = boxes[children].view(-1, 6, w)  # [k, lo.x .. hi.z, child slot]
        live = (lanes < tree.nchild[children].to(torch.int64)[:, None])[:, None, :]
        lo = torch.where(live, rows[:, 0:3], float("inf")).amin(dim=2)
        hi = torch.where(live, rows[:, 3:6], float("-inf")).amax(dim=2)
        boxes[parents[:, None], lo_cols + slots[:, None]] = lo
        boxes[parents[:, None], hi_cols + slots[:, None]] = hi
    tris = torch.cat([p0, p1 - p0, p2 - p0], dim=1).contiguous()
    return tree._replace(boxes=boxes, tris=tris)


@torch.no_grad()
def refit_accel(accel, scene: Scene, plan=None):
    """``accel`` with its boxes and triangle table recomputed from
    ``scene.vertices`` (detached), its topology unchanged; new tensors, the
    given tree untouched.  Pass the ``plan`` of ``make_refit_plan`` inside a
    training loop (making it is a host pass).  An ``AccelBundle`` whose
    fields are one tree is refit once and stays one tree."""
    from ..models.whitted import AccelBundle

    if plan is None:
        plan = make_refit_plan(accel)
    if isinstance(accel, AccelBundle):
        primary = refit_accel(accel.primary, scene, plan[0])
        soft = primary if plan[1] is None else refit_accel(accel.soft, scene, plan[1])
        return AccelBundle(primary, soft)
    if isinstance(accel, BVH):
        return _refit_bvh(accel, plan, scene)
    if isinstance(accel, BVH4):
        return _refit_bvh4(accel, plan, scene)
    raise TypeError(f"no refit for accel type {type(accel).__name__}")
