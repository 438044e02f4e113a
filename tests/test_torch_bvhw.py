"""PyTorch port, the tree width: the collapse at width 2 and 8
(``ops/bvh4.py::collapse_bvhw``), the plain twins of the walk at every width
on one binary tree, the width-2 twins against the JAX package's binary
kernels (B13 ``_bvh_kernel`` / ``_bvh_bounce_kernel``, B14 ``_bvh_hbm_*``)
and the width-8 twins against its 8-wide kernels (B15), all in interpret
mode on the 1,154-triangle cup, and the knobs and the refit against JAX's.

On CPU tensors the wrappers run their twins; ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold each kernel instantiation to its twin on the
card.  Tolerances (the backend contract): t within atol 1e-4, rtol 1e-5 on
>= 99.8% of rays and prim ids on >= 99.5% (``assert_hits_agree``), any-hit
and shadow bits on >= 99.8%, u and v within 1e-5 where the prims agree (the
oracles feed ``record_surface``: their u, v must be real).  Across widths
the any-hit bits are equal on every ray (an any-hit bit does not depend on
the tree) and the closest hits on >= 99.8% (a coincident-t tie may go to
another triangle when the walk visits leaves in another order).
"""
import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu.ops import bvh as jbvh
from cg_raytracer_tpu.ops import pallas_bvh as jpb
from cg_raytracer_tpu.ops import pallas_bvh4 as jb4
from cg_raytracer_tpu.ops import refit as jrefit
from cg_raytracer_tpu.utils.config import RenderConfig as JConfig
from cg_raytracer_tpu_torch.interop import BVH_LEAVES, bvh_from_numpy
from cg_raytracer_tpu_torch.ops import bvh as tbvh
from cg_raytracer_tpu_torch.ops import bvh4 as tb4
from cg_raytracer_tpu_torch.ops import refit as trefit
from tests.test_torch_bvh import assert_hits_agree, cup_pair, mesh_rays

TWO_LIGHTS = (((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0)), ((1.0, 2.0, 0.5), (0.5, 0.5, 0.5)))


def carried(jt):
    """The JAX package's binary tree as the port's ``BVH``."""
    return bvh_from_numpy([np.asarray(getattr(jt, n)) for n in BVH_LEAVES], jt.max_leaf)


def uv_agree(got, want, what):
    same = got.prim_id.numpy() == np.asarray(want.prim_id)
    hit = same & (got.prim_id.numpy() >= 0)
    for a, b in ((got.u, want.u), (got.v, want.v)):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit], atol=1e-5, err_msg=what)


def check_binary_collapse(bvh, tree):
    """Row r of the width-2 tree is an internal binary node: its two slots
    hold that node's children's boxes, and a leaf slot its triangle range."""
    left, right = bvh.left.numpy(), bvh.right.numpy()
    first, count = bvh.first.numpy(), bvh.count.numpy()
    lo, hi = bvh.node_lo.numpy(), bvh.node_hi.numpy()
    boxes, meta, nchild = tree.boxes.numpy(), tree.meta.numpy(), tree.nchild.numpy()
    binary_of, seen = {0: 0}, 0
    for r in range(tree.num_nodes):
        b = binary_of[r]
        assert nchild[r] == 2
        for c, child in enumerate((left[b], right[b])):
            for k in range(3):
                assert boxes[r, 2 * k + c] == lo[child, k] and boxes[r, 6 + 2 * k + c] == hi[child, k]
            if count[child] > 0:
                assert (meta[r, c], meta[r, 2 + c]) == (first[child], count[child])
            else:
                assert meta[r, 2 + c] == 0 and meta[r, c] not in binary_of
                binary_of[int(meta[r, c])] = child
        seen += 1
    assert seen == int((count == 0).sum()) == tree.num_nodes


@pytest.mark.parametrize("leaf,builder", [(4, "sah"), (14, "median")])
def test_collapse_at_width_2_and_8(leaf, builder):
    j, t = cup_pair()
    jt = jbvh.build_bvh(j, max_leaf=leaf, use_native=False, builder=builder)
    bvh = carried(jt)
    two = tb4.collapse_bvhw(bvh, 2)
    assert (two.width, two.boxes.shape[1], two.meta.shape[1]) == (2, 12, 4)
    check_binary_collapse(bvh, two)
    assert two.depth == jbvh.bvh_num_levels(jt) - 1  # the leaves' level holds no node
    # Width 8 against the JAX package's collapse_bvhw: the same nodes in the
    # same order, leaves as (first, count) ranges instead of row codes.
    eight, table = tb4.collapse_bvhw(bvh, 8), np.asarray(
        jb4.collapse_bvhw(jpb.pack_bvh_rows(jt), width=8).nodes4)
    assert eight.num_nodes == table.shape[0] and eight.boxes.shape[1] == 48
    boxes, meta, nchild = eight.boxes.numpy(), eight.meta.numpy(), eight.nchild.numpy()
    for c in range(8):
        valid = c < nchild
        np.testing.assert_array_equal(np.isnan(table[:, 6 * c]), ~valid)
        for k in range(3):
            np.testing.assert_array_equal(boxes[valid, 8 * k + c], table[valid, 6 * c + k])
            np.testing.assert_array_equal(boxes[valid, 24 + 8 * k + c], table[valid, 6 * c + 3 + k])
        enc = table[valid, 48 + c]
        internal = meta[valid, 8 + c] == 0
        np.testing.assert_array_equal(enc >= 0, internal)
        np.testing.assert_array_equal(meta[valid, c][internal], enc[internal].astype(np.int64))
    for tree in (two, eight):
        assert int(tree.meta[:, tree.width:][tree.meta[:, tree.width:] > 0].sum()) == t.num_triangles
        assert torch.equal(tree.tris, tb4.collapse_bvh4(bvh).tris)


def test_leaf_root_and_stack_bound_at_every_width():
    # A scene within one leaf: one node with one leaf child, at every width.
    j, t = cup_pair()
    small = tbvh.build_bvh(t, max_leaf=t.num_triangles)
    for w in tb4.WIDTHS:
        tree = tb4.collapse_bvhw(small, w)
        assert tree.num_nodes == 1 and int(tree.nchild[0]) == 1 and tree.depth == 1
        assert (int(tree.meta[0, 0]), int(tree.meta[0, w])) == (0, t.num_triangles)
    # A chain 80 binary levels deep: 27 eight-wide levels, a 190-entry stack.
    depth = 80
    n = 2 * depth + 1
    left, right = np.full(n, -1, np.int32), np.full(n, -1, np.int32)
    count = np.zeros(n, np.int32)
    for i in range(depth):
        left[2 * i], right[2 * i] = 2 * i + 1, 2 * i + 2
        count[2 * i + 1] = 1
    count[n - 1] = 1
    first = (np.cumsum(count) - count).astype(np.int32)
    lo, hi = np.zeros((n, 3), np.float32), np.ones((n, 3), np.float32)
    tv = torch.zeros((depth + 1, 3))
    chain = tbvh.BVH(*map(torch.from_numpy, (lo, hi, left, right, first, count)),
                     torch.arange(depth + 1, dtype=torch.int32), tv, tv, tv, max_leaf=1)
    with pytest.raises(ValueError) as want:
        jb4.collapse_bvhw(jpb.pack_bvh_rows(chain), width=8)
    with pytest.raises(ValueError) as got:
        tb4.collapse_bvhw(chain, 8)
    assert str(got.value) == str(want.value)
    assert re.search(r"width-8 tree depth 27 needs a 190-entry", str(got.value))
    with pytest.raises(ValueError, match="width must be one of"):
        tb4.collapse_bvhw(chain, 3)


def test_twins_agree_across_widths():
    _, t = cup_pair(lights=TWO_LIGHTS)
    bvh, _ = tb4.build_bvh4(t, max_leaf=4, builder="sah")
    trees = {w: tb4.collapse_bvhw(bvh, w) for w in tb4.WIDTHS}
    o, d, ro, rd, tm = (torch.from_numpy(x) for x in mesh_rays(n_random=512, size=32))
    hits = {w: tb4.intersect_bvh4_cuda(t, tree, o, d) for w, tree in trees.items()}
    occ = {w: tb4.occluded_bvh4_cuda(t, tree, ro, rd, tm) for w, tree in trees.items()}
    bounce = {w: tb4.bounce_bvh4_cuda(t, tree, o, d) for w, tree in trees.items()}
    for w in (2, 8):
        assert_hits_agree(hits[w], hits[4], f"closest, width {w} vs 4")
        assert (hits[w].prim_id == hits[4].prim_id).float().mean().item() >= 0.998
        assert torch.equal(occ[w], occ[4]), f"any-hit, width {w} vs 4"
        same = bounce[w][0].prim_id == bounce[4][0].prim_id
        assert same.float().mean().item() >= 0.998
        assert torch.equal(bounce[w][1][same], bounce[4][1][same]), f"bounce bits, width {w}"
    assert 0.05 < occ[4].float().mean().item() < 0.95
    assert bool((bounce[4][1] > 0).any())


@pytest.fixture(scope="module")
def leaf14():
    """The cup (two point lights), JAX's binary tree at leaf 14 (one row per
    leaf, its ``build_packed_bvh``), its packing and the port's collapse."""
    j, t = cup_pair(lights=TWO_LIGHTS)
    jt, packed = jpb.build_packed_bvh(j)
    return j, t, jt, packed, tb4.collapse_bvhw(carried(jt), 2)


@pytest.mark.parametrize("tier", ["vmem", "hbm"])
def test_width2_twins_match_jax_binary_kernels(tier, leaf14):
    j, t, jt, packed, tree = leaf14
    if tier == "hbm":  # B14: the same tree, its rows streamed per leaf
        bvh_h, packed = jpb.build_hbm_bvh(j, leaf_rows=1)
        tree = tb4.collapse_bvhw(carried(bvh_h), 2)
        closest, occluded, bounce = (jpb.intersect_pallas_bvh_hbm, jpb.occluded_pallas_bvh_hbm,
                                     jpb.bounce_pallas_bvh_hbm)
    else:
        closest, occluded, bounce = (jpb.intersect_pallas_bvh, jpb.occluded_pallas_bvh,
                                     jpb.bounce_pallas_bvh)
    o, d, ro, rd, tm = mesh_rays(n_random=256, size=24)
    got = tb4.intersect_bvh4_cuda(t, tree, torch.from_numpy(o), torch.from_numpy(d))
    want = closest(j, packed, jnp.asarray(o), jnp.asarray(d), interpret=True)
    assert_hits_agree(got, want, f"{tier} closest")
    uv_agree(got, want, f"{tier} closest u, v")
    occ = tb4.occluded_bvh4_cuda(t, tree, torch.from_numpy(ro), torch.from_numpy(rd),
                                 torch.from_numpy(tm)).numpy()
    j_occ = np.asarray(occluded(j, packed, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tm),
                                interpret=True))
    assert (occ == j_occ).mean() >= 0.998 and 0.05 < occ.mean() < 0.95
    live = np.arange(o.shape[0]) % 5 != 0
    hit, bits = tb4.bounce_bvh4_cuda(t, tree, torch.from_numpy(o), torch.from_numpy(d),
                                     live=torch.from_numpy(live))
    j_hit, j_bits = bounce(j, packed, jnp.asarray(o), jnp.asarray(d), live=jnp.asarray(live),
                           interpret=True)
    assert_hits_agree(hit, j_hit, f"{tier} bounce")
    uv_agree(hit, j_hit, f"{tier} bounce u, v")
    assert (bits.numpy() == np.asarray(j_bits)).mean() >= 0.998
    assert 0.02 < (bits.numpy() > 0).mean() < 0.5


def test_width8_twins_match_jax_8_wide_kernels(leaf14):
    j, t, jt, _, _ = leaf14
    tree = tb4.collapse_bvhw(carried(jt), 8)
    packed8 = jb4.collapse_bvhw(jpb.pack_bvh_rows(jt), width=8)
    o, d, ro, rd, tm = mesh_rays(n_random=256, size=24)
    got = tb4.intersect_bvh4_cuda(t, tree, torch.from_numpy(o), torch.from_numpy(d))
    want = jb4.intersect_pallas_bvh4(j, packed8, jnp.asarray(o), jnp.asarray(d), interpret=True)
    assert_hits_agree(got, want, "width 8 closest")
    uv_agree(got, want, "width 8 u, v")
    occ = tb4.occluded_bvh4_cuda(t, tree, torch.from_numpy(ro), torch.from_numpy(rd),
                                 torch.from_numpy(tm)).numpy()
    j_occ = np.asarray(jb4.occluded_pallas_bvh4(j, packed8, jnp.asarray(ro), jnp.asarray(rd),
                                                jnp.asarray(tm), interpret=True))
    assert (occ == j_occ).mean() >= 0.998


def test_width_knobs_match_jax():
    for field, values in (("bvh_wide", ("auto", "2", "4", "8")),
                          ("bvh_wide_hbm", ("auto", "2", "4"))):
        resolve = f"resolve_{field}"
        assert getattr(trt.RenderConfig(), field) == getattr(JConfig(), field) == "auto"
        for v in values:
            assert (getattr(trt.RenderConfig(**{field: v}), resolve)()
                    == getattr(JConfig(**{field: v}), resolve)())
        for bad in ("16", "8" if field == "bvh_wide_hbm" else "3", 4):
            with pytest.raises(ValueError) as want:
                getattr(JConfig(**{field: bad}), resolve)()
            with pytest.raises(ValueError) as got:
                getattr(trt.RenderConfig(**{field: bad}), resolve)()
            assert str(got.value) == str(want.value)


def test_refit_width2_exact_and_width8_raises_as_jax():
    j, t = cup_pair()
    bvh, _ = tb4.build_bvh4(t, max_leaf=4, builder="sah")
    two = tb4.collapse_bvhw(bvh, 2)
    plan = trefit.make_refit_plan(two)
    again = trefit.refit_accel(two, t, plan)
    for name in ("boxes", "meta", "nchild", "tris", "slot_to_prim"):
        assert torch.equal(getattr(again, name), getattr(two, name)), name
    assert again.width == 2
    # Moved vertices: the refit tree's walk finds what a fresh collapse does.
    moved = dataclasses.replace(t, vertices=t.vertices * 1.1 + 0.01)
    o, d, *_ = (torch.from_numpy(x) for x in mesh_rays(n_random=0, size=24))
    fresh = tb4.collapse_bvhw(tbvh.build_bvh(moved, max_leaf=4, builder="sah"), 2)
    assert_hits_agree(tb4.intersect_bvh4_cuda(moved, trefit.refit_accel(two, moved, plan), o, d),
                      tb4.intersect_bvh4_cuda(moved, fresh, o, d), "refit width 2 vs a rebuild")
    eight = tb4.collapse_bvhw(bvh, 8)
    jt = jbvh.build_bvh(j, max_leaf=4, use_native=False, builder="sah")
    with pytest.raises(NotImplementedError) as want:
        jrefit.make_refit_plan(jb4.collapse_bvhw(jpb.pack_bvh_rows(jt), width=8), j)
    with pytest.raises(NotImplementedError) as got:
        trefit.make_refit_plan(eight)
    assert str(got.value) == str(want.value)
