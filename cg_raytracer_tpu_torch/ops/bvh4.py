"""The wide BVH on the card: its node layout at width 2, 4 or 8, the kernels
over it and their plain twins.  Counterpart of
``cg_raytracer_tpu/ops/pallas_bvh4.py`` (``collapse_bvhw``,
``build_packed_bvh4``, ``build_hbm_bvh4``, ``_bvh4_kernel``,
``_bvh4_bounce_kernel`` and their streaming variants ``_bvh4_hbm_kernel_xn``
and ``_bvh4_hbm_bounce_kernel_xn``) and of ``pallas_bvh.py`` (the binary
kernels ``_bvh_kernel``, ``_bvh_bounce_kernel`` and their streaming variants
``_bvh_hbm_kernel``, ``_bvh_hbm_bounce_kernel``, and the layout parts).

Wrappers, each with its plain twin (``*_plain``), and the Pallas kernels
they replace, by node width W:

- ``intersect_bvh4_cuda`` / ``occluded_bvh4_cuda`` (closest hit, any hit):
  W = 4 ``_bvh4_kernel`` / ``_xn`` (B5) and ``_bvh4_hbm_kernel_xn`` (B8);
  W = 2 ``_bvh_kernel`` (B13) and ``_bvh_hbm_kernel`` (B14); W = 8 the B5
  kernels at width 8 (B15);
- ``bounce_bvh4_cuda`` (closest hit and per-light shadow bits): W = 4
  ``_bvh4_bounce_kernel`` / ``_xn`` (B6) and ``_bvh4_hbm_bounce_kernel_xn``
  (B8); W = 2 ``_bvh_bounce_kernel`` (B13) and ``_bvh_hbm_bounce_kernel``
  (B14); W = 8 B6 at width 8 (B15).

Two walks (``csrc/bvh4.cuh``, templates on the node width W), closest hit
and any hit, serve every row, and the any-hit walk the tree samplers of
``ops/soft.py`` too: the width is a field of the tree (``BVH4.width``), as
it is of the JAX package's ``PackedBVH4``, and the wrappers launch the
instantiation for it.
One kernel body also serves both of the JAX package's tiers: its kernels
kept the nodes and triangle rows in VMEM up to ``VMEM_MAX_TRIS`` triangles
(B5, B6, B13) and streamed each leaf's rows from HBM past it, up to
``HBM_MAX_TRIS`` (B8, B14).  On the card every table sits in global memory
either way (cached in L2 where it fits), so the tiers differ only in the
tree's size.  Past ``HBM_MAX_TRIS`` the JAX package leaves its kernels for
its XLA traversal; the card keeps walking the same kernels, up to
``MAX_TRIS``, the limit of their int32 indexing, and raises past it.

Layout (``BVH4``), built on the host by collapsing the binary tree of
``ops/bvh.py`` log2(W) levels per node, as ``collapse_bvhw`` does (W = 2 is
the binary tree itself, relaid out so that a parent holds its children's
boxes; nothing is rebuilt):

- ``boxes`` [Nw, 6W] f32: the W child boxes of a node as lo.x of children
  0..W-1, then lo.y, lo.z, hi.x, hi.y, hi.z;
- ``meta`` [Nw, 2W] i32: ``meta[c]`` is child c's node id when
  ``meta[W + c] == 0``, else child c is a leaf of ``meta[W + c]`` triangles
  from ``meta[c]`` on;
- ``nchild`` [Nw] i32: children sit in slots 0..nchild-1;
- ``tris`` [T, 9] f32: v0, e1 = v1 - v0, e2 = v2 - v0 of each triangle in
  leaf order, and ``slot_to_prim`` [T] i32 maps a row to its triangle id.
  The Pallas rows of 14 triangles with padding were a VMEM artefact;
- ``nodes`` [Nw, 8W] f32 and ``rows`` [T, 12] f32, what the kernels read,
  built from the above once per tree (``pack_nodes``, ``pack_tris``; in
  ``collapse_bvhw`` and in the refit): per node one record of the 6W box
  floats with NaN in every slot past ``nchild`` (as the Pallas table filled
  its empty slots: a NaN box fails every slab test of the NaN-propagating
  min/max), then the 2W meta ints bit-cast, 32W bytes read with 16-byte
  loads; per triangle its three vectors, each padded to 16 bytes.  The
  twins and the refit read ``boxes``, ``meta`` and ``nchild``.

Traversal, one ray at a time (the kernels run one thread per ray, and the
any-hit walk takes the nearest child at once instead of pushing and popping
it; the twins step every ray at once, one stack entry per ray per step, with
the same child order and tie rule, so each kernel visits the twin's nodes
and triangles and is held to it exactly): a stack of entries (node id >= 0,
or ``~(W * node + c)`` for leaf child c) and their entry t.  A popped entry
whose entry t exceeds the padded current best is skipped.  A node's child boxes get the padded slab test (``_slab``:
pad 1e-5 (1 + |t_out|), NaN-propagating min/max) and are pruned past the
padded best; the hit children are sorted by entry t with the JAX package's
compare-exchange network for W (``SORT_NET``, descending) and pushed, so the
nearest pops first.  At W = 2 the compare swaps on equal t too, so the left
child pops first on a tie, as the binary kernel's ``left_near = min_tl <=
min_tr`` (``pallas_bvh.py:238``).  A leaf runs Moller-Trumbore on its rows
with ``closer = ok & (t < t_best)``; any-hit stops at the first hit.  A ray
with ``t_max < 0`` (dead) does no work.

The Pallas kernels' interleave, batched pop and tile rows hid TPU latency for
a tile that walked the tree in lockstep; a thread per ray needs none of them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..scene.types import Scene
from ..utils import counters
from . import cuda_kernels as ck
from .bvh import _SLAB_EPS, BVH, build_bvh
from .intersect import (INF, MISS, Hit, merge_spheres_closest, moller_trumbore_edges,
                        spheres_occluded)

# The JAX package's tiers (pallas_bvh.py:57-63): its on-chip kernels (B5,
# B6, B13) up to VMEM_MAX_TRIS triangles, its streaming kernels (B8, B14) up
# to HBM_MAX_TRIS.  The card runs the same kernels on both; VMEM_MAX_TRIS
# still routes the width, the builder's auto (utils/config.py) and the
# samplers' gate (ops/soft.py), as in the JAX package.
VMEM_MAX_TRIS = 200_000
# A 6 MB VMEM node budget at 512 B per node, half of the nodes leaves, each
# leaf at most 32 rows of 14 triangles: 2,752,512.  A TPU limit: the card
# routes nothing by it.
HBM_MAX_TRIS = (6 * 1024 * 1024 // 512 // 2) * 32 * 14
# The card's limit: the kernels index a triangle's table rows and the tree's
# node records with int32 arithmetic, and each product must stay <= 2^31 - 1.
# For T triangles (a collapsed tree has Nw <= max(1, T - 1) nodes: every
# node has >= 2 children and every leaf >= 1 triangle):
#   csrc/shade.cu, the pregathered payload rows ``payload + 19 * slot``
#     (slot < T): 19 T <= 2^31 - 1                    T <= 113,025,455  <- binds
#   csrc/bvh4.cuh, node records ``nodes + 2 * W * ref`` (ref < Nw), W = 8:
#     16 T < 2^31                                     T < 134,217,728
#   csrc/bvh4.cuh, leaf entries ``~(W * ref + c)``: 8 T < 2^31
#                                                     T < 268,435,456
#   csrc/bvh4.cuh, triangle rows ``rows + 3 * k`` (k < T): 3 T < 2^31
#                                                     T < 715,827,883
#   slot_to_prim and prim ids (int32), leaf ``first + count``: T < 2^31
# The samplers (csrc/soft.cu) index points and samples, not triangles, in
# 64 bits, and the brute kernels stop at 256 triangles.  The walk's stack is
# checked per tree by ``collapse_bvhw`` (build_bvh's binary depth cap of 20
# bounds it whatever T).
INT32_MAX = 2**31 - 1
MAX_TRIS = INT32_MAX // 19
MAX_STACK = 64  # per-ray stack entries (csrc/bvh4.cuh kStack)
WIDTHS = (2, 4, 8)
_BIG = 3.4e38  # entry t of a child that is not pushed
# Descending compare-exchange networks (pallas_bvh4.py _SORT_NET): pair (a, b)
# swaps when t[a] < t[b] (at W = 2 when t[a] <= t[b]: the left child first
# on a tie).  8 is Batcher's odd-even mergesort, 19 comparators.
SORT_NET = {
    2: ((0, 1),),
    4: ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)),
    8: ((0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
        (1, 2), (5, 6), (0, 4), (1, 5), (2, 6), (3, 7), (2, 4), (3, 5),
        (1, 2), (3, 4), (5, 6)),
}


class BVH4(NamedTuple):
    """The wide tree in the kernels' layout (see the module docstring); make
    one with ``make_bvh4``, which packs ``nodes`` and ``rows``."""

    boxes: torch.Tensor  # [Nw, 6W] f32
    meta: torch.Tensor  # [Nw, 2W] i32
    nchild: torch.Tensor  # [Nw] i32
    tris: torch.Tensor  # [T, 9] f32, leaf order
    slot_to_prim: torch.Tensor  # [T] i32
    nodes: torch.Tensor  # [Nw, 8W] f32, pack_nodes of boxes, meta, nchild
    rows: torch.Tensor  # [T, 12] f32, pack_tris of tris
    depth: int  # levels of W-wide nodes
    width: int = 4

    @property
    def num_nodes(self) -> int:
        return self.boxes.shape[0]

    @property
    def num_tris(self) -> int:
        return self.tris.shape[0]

    @property
    def device(self) -> torch.device:
        return self.boxes.device

    def to(self, device) -> "BVH4":
        return BVH4(*(x.to(device) for x in self[:7]), depth=self.depth, width=self.width)


_NAN_BITS = 0x7FC00000  # float32 quiet NaN


def pack_nodes(boxes, meta, nchild):
    """The kernels' node records [Nw, 8W] float32: each node's 6W box floats
    as ``boxes`` (lo.x of children 0..W-1, then lo.y, lo.z, hi.x, hi.y, hi.z)
    with NaN in every slot past ``nchild``, then its 2W ``meta`` ints
    bit-cast: 32W bytes, one 128-byte line at W = 4, read with 16-byte
    loads.  A NaN box fails every slab test, as the skipped slot does, so
    ``nchild`` needs no column.  Built in integer space, so every bit is
    kept."""
    w = meta.shape[1] // 2
    absent = torch.arange(w, device=boxes.device)[None, :] >= nchild[:, None]
    bits = boxes.view(torch.int32).view(-1, 6, w).masked_fill(absent[:, None, :], _NAN_BITS)
    return torch.cat([bits.view(-1, 6 * w), meta], dim=1).view(torch.float32).contiguous()


def pack_tris(tris):
    """[T, 9] (v0, e1, e2) -> [T, 12], each vertex or edge padded to a
    16-byte row: the rows the kernels read with 16-byte loads."""
    return torch.nn.functional.pad(tris.reshape(-1, 3, 3), (0, 1)).reshape(-1, 12).contiguous()


def make_bvh4(boxes, meta, nchild, tris, slot_to_prim, depth: int, width: int) -> BVH4:
    """The tree with its records packed (on the tensors' device)."""
    return BVH4(boxes, meta, nchild, tris, slot_to_prim, pack_nodes(boxes, meta, nchild),
                pack_tris(tris), depth=depth, width=width)


def _expand(par, ch, left, right, is_leaf):
    """One binary level down: each internal entry of ``ch`` (binary node
    ids, with their rows ``par``) becomes its left and right child in place;
    a leaf stays."""
    split = ~is_leaf[ch]
    k = 1 + split
    starts = np.cumsum(k) - k
    out = np.empty(int(k.sum()), np.int64)
    out[starts] = np.where(split, left[ch], ch)
    out[starts[split] + 1] = right[ch[split]]
    return np.repeat(par, k), out


def collapse_bvhw(bvh: BVH, width: int = 4) -> BVH4:
    """Collapse the binary tree into ``width``-wide nodes: each node's
    children are its binary descendants log2(width) levels down (a leaf
    child stays one child), left to right, and nodes are numbered breadth
    first, as ``collapse_bvhw`` of the JAX package does.  A leaf root
    becomes a node with one leaf child.  Raises if the deepest root-to-leaf
    descent can hold more than ``MAX_STACK`` stack entries."""
    if width not in WIDTHS:
        raise ValueError(f"width must be one of {WIDTHS}, got {width!r}")
    levels = width.bit_length() - 1
    left, right = bvh.left.cpu().numpy().astype(np.int64), bvh.right.cpu().numpy().astype(np.int64)
    first, count = bvh.first.cpu().numpy(), bvh.count.cpu().numpy()
    lo, hi = bvh.node_lo.cpu().numpy(), bvh.node_hi.cpu().numpy()
    is_leaf = count > 0

    # Breadth first, one layer of wide nodes at a time: a layer's rows are
    # the internal children of the layer above, in order.
    pars, chs = [], []
    if is_leaf[0]:
        pars.append(np.zeros(1, np.int64))
        chs.append(np.zeros(1, np.int64))
    else:
        layer, base = np.zeros(1, np.int64), 0
        while layer.size:
            par = np.repeat(base + np.arange(layer.size), 2)
            ch = np.stack([left[layer], right[layer]], axis=1).reshape(-1)
            for _ in range(levels - 1):
                par, ch = _expand(par, ch, left, right, is_leaf)
            pars.append(par)
            chs.append(ch)
            base += layer.size
            layer = ch[~is_leaf[ch]]
    max_depth = len(pars) - 1
    need = (width - 1) * (max_depth + 1) + 1  # each internal pop: one entry off, W on
    if need > MAX_STACK:
        raise ValueError(f"collapsed width-{width} tree depth {max_depth + 1} needs a {need}-entry "
                         f"traversal stack > MAX_STACK={MAX_STACK}; rebuild with a narrower "
                         f"width (bvh_wide='4') or wider leaves")

    ws, bs = np.concatenate(pars), np.concatenate(chs)
    nw = int(ws[-1]) + 1
    cs = np.arange(ws.size) - np.searchsorted(ws, ws)  # slot within the row
    leaf = is_leaf[bs]
    wide_id = np.cumsum(~leaf)  # internal children are the rows 1, 2, ... in order
    boxes = np.zeros((nw, 6 * width), np.float32)
    for k in range(3):
        boxes[ws, width * k + cs] = lo[bs, k]
        boxes[ws, 3 * width + width * k + cs] = hi[bs, k]
    meta = np.zeros((nw, 2 * width), np.int32)
    meta[ws, cs] = np.where(leaf, first[bs], wide_id)
    meta[ws, width + cs] = np.where(leaf, count[bs], 0)
    tv0, tv1, tv2 = (x.cpu().numpy() for x in (bvh.tv0, bvh.tv1, bvh.tv2))
    tris = np.concatenate([tv0, tv1 - tv0, tv2 - tv0], axis=1).astype(np.float32)
    t = torch.from_numpy
    return make_bvh4(t(boxes), t(meta), t(np.bincount(ws, minlength=nw).astype(np.int32)),
                     t(np.ascontiguousarray(tris)), bvh.tri_order.cpu().clone(),
                     depth=max_depth + 1, width=width)


def collapse_bvh4(bvh: BVH) -> BVH4:
    return collapse_bvhw(bvh, width=4)


def build_bvh4(scene: Scene, max_leaf: int, builder: str = "median", width: int = 4):
    """Host build: binary BVH -> ``width``-wide collapse -> (BVH, BVH4 on the
    scene's device).  A caller that wants several widths collapses the one
    ``BVH``."""
    bvh = build_bvh(scene, max_leaf=max_leaf, builder=builder)
    return bvh, collapse_bvhw(bvh, width).to(scene.device)


def supports_bvh4(scene: Scene) -> bool:
    """The kernels' triangle range: 1..``MAX_TRIS`` (both of the JAX
    package's tiers, ``supports_pallas_bvh`` and ``supports_pallas_bvh4_hbm``,
    and past them)."""
    return 0 < scene.num_triangles <= MAX_TRIS


def check_max_tris(num_tris: int) -> None:
    """Raise past ``MAX_TRIS``, the limit of the kernels' int32 indexing."""
    if num_tris > MAX_TRIS:
        raise NotImplementedError(
            f"{num_tris} triangles exceed MAX_TRIS = {MAX_TRIS}, the limit of the card's "
            f"int32 indexing (the pregathered shade's 19-float payload rows, ops/bvh4.py)")


def supports_fused_bounce_bvh4(scene: Scene) -> bool:
    """The bounce kernel traverses triangles only: no sphere primitives, and
    the shadow bits of at most 30 point lights fit one int32."""
    num_pl = scene.point_lights.position.shape[0]
    num_sph = scene.spherical_lights.position.shape[0]
    return (supports_bvh4(scene) and scene.spheres.radius.shape[0] == 0
            and num_pl <= ck.MAX_FUSED_LIGHTS and 0 < num_pl + num_sph)


# --------------------------------------------------------------------------
# The kernels.
# --------------------------------------------------------------------------

def _tree_args(name, tree: BVH4, device):
    """(width, nodes, rows, slot_to_prim) as the kernels take them."""
    check_max_tris(tree.num_tris)
    w = tree.width
    if (w not in WIDTHS or tree.nodes.shape != (tree.num_nodes, 8 * w)
            or tree.rows.shape != (tree.num_tris, 12)):
        raise ValueError(f"{name}: not a width-{w} tree (nodes {tuple(tree.nodes.shape)}, rows "
                         f"{tuple(tree.rows.shape)})")
    ck._check(name, tree.nodes, tree.rows, device=device)
    ck._check(name, tree.slot_to_prim, device=device, dtype=torch.int32)
    for x in (tree.nodes, tree.rows):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: the tree's records must be 16-byte aligned")
    return w, ck._ptr(tree.nodes), ck._ptr(tree.rows), ck._ptr(tree.slot_to_prim)


def _closest_kernel(tree, o, d, tm):
    n = o.shape[0]
    ck._check("cgrt_bvh4_closest", o, d, tm, device=o.device)
    t, u, v = (torch.empty((n,), dtype=torch.float32, device=o.device) for _ in range(3))
    prim = torch.empty((n,), dtype=torch.int32, device=o.device)
    ck._launch("cgrt_bvh4_closest", o.device, ck._ptr(o), ck._ptr(d), ck._ptr(tm), n,
               *_tree_args("cgrt_bvh4_closest", tree, o.device), ck._ptr(t), ck._ptr(prim),
               ck._ptr(u), ck._ptr(v))
    counters.count("intersect_bvh4_cuda", tree.width, n)
    return Hit(t, prim, u, v)


def _anyhit_kernel(tree, o, d, tm):
    n = o.shape[0]
    ck._check("cgrt_bvh4_anyhit", o, d, tm, device=o.device)
    hit = torch.empty((n,), dtype=torch.uint8, device=o.device)
    ck._launch("cgrt_bvh4_anyhit", o.device, ck._ptr(o), ck._ptr(d), ck._ptr(tm), n,
               *_tree_args("cgrt_bvh4_anyhit", tree, o.device), ck._ptr(hit))
    counters.count("occluded_bvh4_cuda", tree.width, n)
    return hit.bool()


def _bounce_kernel(tree, lights, o, d, tm):
    n = o.shape[0]
    ck._check("cgrt_bvh4_bounce", o, d, tm, lights, device=o.device)
    t, u, v = (torch.empty((n,), dtype=torch.float32, device=o.device) for _ in range(3))
    prim, bits = (torch.empty((n,), dtype=torch.int32, device=o.device) for _ in range(2))
    ck._launch("cgrt_bvh4_bounce", o.device, ck._ptr(o), ck._ptr(d), ck._ptr(tm), n,
               *_tree_args("cgrt_bvh4_bounce", tree, o.device), ck._ptr(lights),
               lights.shape[0], ck._ptr(t), ck._ptr(prim), ck._ptr(u), ck._ptr(v), ck._ptr(bits))
    counters.count("bounce_bvh4_cuda", tree.width, n)
    return Hit(t, prim, u, v), bits


# --------------------------------------------------------------------------
# Plain PyTorch twins: the kernels' per-ray traversal, every ray stepped at once.
# --------------------------------------------------------------------------

def _slab(ox, oy, oz, ix, iy, iz, boxes, width: int):
    """Padded slab test of a node's ``width`` child boxes ([k, 6 width])
    against k rays ([k] components, reciprocal directions) -> (t_in, hit),
    each [k, width]."""
    col = lambda a: a[:, None]  # noqa: E731
    w = width
    t0x = (boxes[:, 0:w] - col(ox)) * col(ix)
    t0y = (boxes[:, w:2 * w] - col(oy)) * col(iy)
    t0z = (boxes[:, 2 * w:3 * w] - col(oz)) * col(iz)
    t1x = (boxes[:, 3 * w:4 * w] - col(ox)) * col(ix)
    t1y = (boxes[:, 4 * w:5 * w] - col(oy)) * col(iy)
    t1z = (boxes[:, 5 * w:6 * w] - col(oz)) * col(iz)
    mn, mx = torch.minimum, torch.maximum
    tin = mx(mx(mn(t0x, t1x), mn(t0y, t1y)), mn(t0z, t1z))
    tout = mn(mn(mx(t0x, t1x), mx(t0y, t1y)), mx(t0z, t1z))
    pad = _SLAB_EPS * (1.0 + torch.abs(tout))
    return tin, (tin <= tout + pad) & (tout >= -pad)


def _padded(t):
    return t + _SLAB_EPS * (1.0 + torch.abs(t))


@torch.no_grad()
def _traverse_plain(tree: BVH4, o, d, tm, any_hit: bool, stats=None):
    """-> (t, slot in leaf order, u, v); t = t_max and slot = -1 where nothing
    nearer was hit.  ``tm`` None means no bound.  ``stats`` (a dict): adds
    the walk's node visits ('visits', internal nodes expanded) and triangle
    tests ('tests') over all rays, the work the kernel does on these rays."""
    n, dev, w = o.shape[0], o.device, tree.width
    t_best = (torch.full((n,), INF, dtype=torch.float32, device=dev) if tm is None
              else tm.clone())
    slot = torch.full((n,), MISS, dtype=torch.long, device=dev)
    u = torch.zeros((n,), dtype=torch.float32, device=dev)
    v = torch.zeros_like(u)
    stack = torch.zeros((n, MAX_STACK), dtype=torch.long, device=dev)
    tstack = torch.zeros((n, MAX_STACK), dtype=torch.float32, device=dev)
    tstack[:, 0] = -_BIG
    # Dead rays do no work (an any-hit ray with t_max <= 0 cannot hit).
    sp = ((t_best > 0.0) if any_hit else (t_best >= 0.0)).long()
    inv = 1.0 / d
    meta, nchild = tree.meta.long(), tree.nchild.long()
    lanes = torch.arange(w, device=dev)
    top = MAX_STACK - 1

    while True:
        idx = torch.nonzero(sp > 0).squeeze(1)
        if idx.numel() == 0:
            break
        rows = torch.arange(idx.numel(), device=dev)
        ox, oy, oz = o[idx, 0], o[idx, 1], o[idx, 2]
        ix, iy, iz = inv[idx, 0], inv[idx, 1], inv[idx, 2]
        t_i, slot_i, u_i, v_i = t_best[idx], slot[idx], u[idx], v[idx]
        st, ts = stack[idx], tstack[idx]
        sp_i = sp[idx] - 1
        ref, tin_pushed = st[rows, sp_i], ts[rows, sp_i]
        bound = _padded(t_i)
        fresh = ~(tin_pushed > bound)
        internal = fresh & (ref >= 0)
        leaf = fresh & (ref < 0)

        # Internal node: test, sort and push its children.
        node = torch.where(internal, ref, 0)
        tin, hit = _slab(ox, oy, oz, ix, iy, iz, tree.boxes[node], w)
        hit = hit & (lanes < nchild[node][:, None]) & (tin <= bound[:, None]) & internal[:, None]
        m = meta[node]
        tv = list(torch.where(hit, tin, _BIG).unbind(1))
        ev = list(torch.where(m[:, w:2 * w] > 0, ~(w * node[:, None] + lanes),
                              m[:, 0:w]).unbind(1))
        for a, b in SORT_NET[w]:
            sw = tv[a] <= tv[b] if w == 2 else tv[a] < tv[b]
            tv[a], tv[b] = torch.where(sw, tv[b], tv[a]), torch.where(sw, tv[a], tv[b])
            ev[a], ev[b] = torch.where(sw, ev[b], ev[a]), torch.where(sw, ev[a], ev[b])
        for tc, ec in zip(tv, ev):
            push = tc < _BIG
            at = sp_i.clamp(max=top)
            st[rows, at] = torch.where(push, ec, st[rows, at])
            ts[rows, at] = torch.where(push, tc, ts[rows, at])
            sp_i = sp_i + push.long()

        # Leaf child: sweep its triangles.
        s = torch.where(leaf, ~ref, 0)
        lnode, lc = s // w, s % w
        first = meta[lnode, lc]
        cnt = torch.where(leaf, meta[lnode, w + lc], 0)
        oi, di = o[idx], d[idx]
        if stats is not None:
            stats["visits"] = stats.get("visits", 0) + int(internal.sum())
            tested = torch.zeros_like(cnt)
        for k in range(int(cnt.max().item()) if cnt.numel() else 0):
            in_range = k < cnt
            tri = torch.where(in_range, first + k, 0)
            row = tree.tris[tri]
            t, uu, vv, ok = moller_trumbore_edges(oi, di, row[:, 0:3], row[:, 3:6], row[:, 6:9])
            closer = in_range & ok & (t < t_i)
            if stats is not None:  # an any-hit walk stops at its first hit
                tested = tested + (in_range & ~((slot_i >= 0) & any_hit)).long()
            t_i = torch.where(closer, t, t_i)
            slot_i = torch.where(closer, tri, slot_i)
            u_i = torch.where(closer, uu, u_i)
            v_i = torch.where(closer, vv, v_i)
        if stats is not None:
            stats["tests"] = stats.get("tests", 0) + int(tested.sum())
        if any_hit:
            sp_i = torch.where(slot_i >= 0, 0, sp_i)  # stop at the first hit

        stack[idx], tstack[idx], sp[idx] = st, ts, sp_i
        t_best[idx], slot[idx], u[idx], v[idx] = t_i, slot_i, u_i, v_i
    return t_best, slot, u, v


def _prims(tree, t, slot, u, v):
    hit = slot >= 0
    prim = torch.where(hit, tree.slot_to_prim.long()[slot.clamp_min(0)], MISS)
    return Hit(torch.where(hit, t, INF), prim.to(torch.int32), u, v)


def _closest_plain(tree, o, d, tm):
    return _prims(tree, *_traverse_plain(tree, o, d, tm, any_hit=False))


def _anyhit_plain(tree, o, d, tm, stats=None):
    return _traverse_plain(tree, o, d, tm, any_hit=True, stats=stats)[1] >= 0


def _bounce_plain(tree, lights, o, d, tm):
    hit = _closest_plain(tree, o, d, tm)
    hit_mask = hit.prim_id >= 0
    p = o + d * torch.where(hit_mask, hit.t, 0.0)[:, None]
    bits = torch.zeros((o.shape[0],), dtype=torch.int32, device=o.device)
    for li in range(lights.shape[0]):
        so, sd, dist = ck._shadow_rays(p, lights[li, 0:3])
        t_l = torch.where(hit_mask, dist - ck.SHADOW_EPS, -1.0)
        bits = bits | (_anyhit_plain(tree, so, sd, t_l).to(torch.int32) << li)
    return hit, bits


# --------------------------------------------------------------------------
# Public wrappers and their twins.
# --------------------------------------------------------------------------

def _live_t_max(live, o):
    if live is None:
        return None
    return torch.where(live.to(o.device), INF, -1.0).to(torch.float32).contiguous()


@torch.no_grad()
def _intersect(scene, tree, origins, dirs, t_max, on_card):
    o, d = ck._rays(origins, dirs)
    tm = ck._t_max(t_max, o.shape[0], o.device)
    hit = (_closest_kernel if on_card else _closest_plain)(tree, o, d, tm)
    return merge_spheres_closest(scene, o, d, hit)


def intersect_bvh4_cuda(scene: Scene, tree: BVH4, origins, dirs, t_max=None) -> Hit:
    """Closest hit over the tree's triangles (kernel) and the scene's spheres
    (PyTorch, after the kernel, as ``_sphere_merge`` does)."""
    return _intersect(scene, tree, origins, dirs, t_max, on_card=origins.is_cuda)


def intersect_bvh4_plain(scene: Scene, tree: BVH4, origins, dirs, t_max=None) -> Hit:
    return _intersect(scene, tree, origins, dirs, t_max, on_card=False)


@torch.no_grad()
def _occluded(scene, tree, origins, dirs, t_max, on_card):
    o, d = ck._rays(origins, dirs)
    tm = ck._t_max(t_max, o.shape[0], o.device)
    blocked = (_anyhit_kernel if on_card else _anyhit_plain)(tree, o, d, tm)
    return blocked | spheres_occluded(scene, o, d, tm)


def occluded_bvh4_cuda(scene: Scene, tree: BVH4, origins, dirs, t_max):
    """Any-hit (shadow) query: True where a primitive lies at t in [0, t_max)."""
    return _occluded(scene, tree, origins, dirs, t_max, on_card=origins.is_cuda)


def occluded_bvh4_plain(scene: Scene, tree: BVH4, origins, dirs, t_max):
    return _occluded(scene, tree, origins, dirs, t_max, on_card=False)


@torch.no_grad()
def _bounce(scene, tree, origins, dirs, live, on_card):
    if not supports_fused_bounce_bvh4(scene):
        raise ValueError(f"BVH bounce kernel: the scene needs 1..{MAX_TRIS} triangles, "
                         f"no spheres and at most 30 point lights (supports_fused_bounce_bvh4)")
    o, d = ck._rays(origins, dirs)
    lights = scene.point_lights.position.detach().contiguous()
    run = _bounce_kernel if on_card else _bounce_plain
    return run(tree, lights, o, d, _live_t_max(live, o))


def bounce_bvh4_cuda(scene: Scene, tree: BVH4, origins, dirs, live=None):
    """Closest hit plus per-point-light shadow bits (bit l = light l occluded
    from the hit point; 0 where the ray missed) -> (Hit, bits [N] i32).
    ``live`` ([N] bool): rays marked dead do no work and report a miss."""
    return _bounce(scene, tree, origins, dirs, live, on_card=origins.is_cuda)


def bounce_bvh4_plain(scene: Scene, tree: BVH4, origins, dirs, live=None):
    return _bounce(scene, tree, origins, dirs, live, on_card=False)


# Launches by node width, and the rays each walk was handed (rows of its
# origins, live or not): ``launch_counts``, ``ray_counts``.
_COUNTS = counters.Group("intersect_bvh4_cuda", "occluded_bvh4_cuda", "bounce_bvh4_cuda",
                         widths=WIDTHS)
launch_counts, ray_counts = _COUNTS.launch_counts, _COUNTS.ray_counts
reset_launch_counts = _COUNTS.reset


def tree_shape(tree: BVH4) -> dict:
    """What a tree holds: its nodes, leaves and depth (levels of W-wide
    nodes), the mean and largest leaf in triangles, and the bytes of its
    tensors (on the card, where the tree lives there)."""
    w = tree.width
    sizes = tree.meta[:, w:].reshape(-1)
    sizes = sizes[sizes > 0]
    leaves = int(sizes.numel())
    return {"width": w, "nodes": tree.num_nodes, "leaves": leaves, "depth": tree.depth,
            "triangles": tree.num_tris, "leaf_mean": tree.num_tris / max(1, leaves),
            "leaf_max": int(sizes.max()) if leaves else 0,
            "bytes": sum(x.numel() * x.element_size() for x in tree[:7])}


_TREE_SHAPE: dict = {}


def record_tree(tree: BVH4) -> None:
    """Keep ``tree_shape(tree)`` as the last built tree's (``tree_counts``)."""
    _TREE_SHAPE.clear()
    _TREE_SHAPE.update(tree_shape(tree))


def tree_counts() -> dict:
    """The shape of the last tree ``models/whitted.py::build_accel`` built
    ({} before the first)."""
    return dict(_TREE_SHAPE)
