"""PyTorch port: the 4-wide BVH (``ops/bvh4.py``): its collapse against the
JAX package's ``collapse_bvhw``, and the plain twins of kernels B5 (closest
hit, any hit) and B6 (the fused bounce) against the JAX package's
``intersect_pallas_bvh4`` / ``occluded_pallas_bvh4`` / ``bounce_pallas_bvh4``
(Pallas in interpret mode) on the same tree, and against brute force.

On CPU tensors the wrappers run their twins; ``tests/test_torch_cuda.py``
holds the kernels to the twins on the card, exactly.  Tolerances (the
backend contract): t within atol 1e-4, rtol 1e-5 on >= 99.8% of rays, prim
ids, any-hit and shadow bits on >= 99.5% (a per-ray descent visits leaves in
another order than the TPU's tile walk, so a coincident-t tie on a shared
edge may go to another triangle).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cg_raytracer_tpu.ops import bvh as jbvh
from cg_raytracer_tpu.ops import pallas_bvh4 as jb4
from cg_raytracer_tpu.ops.pallas_bvh import pack_bvh_rows
from cg_raytracer_tpu_torch.interop import BVH_LEAVES, bvh_from_numpy
from cg_raytracer_tpu_torch.ops import bvh as tbvh
from cg_raytracer_tpu_torch.ops import bvh4 as tb4
from cg_raytracer_tpu_torch.ops import intersect as tint
from tests.test_torch_bvh import assert_hits_agree, cup_pair, mesh_rays


def jax_and_port_trees(j, leaf=14, builder="sah"):
    jt = jbvh.build_bvh(j, max_leaf=leaf, use_native=False, builder=builder)
    carried = bvh_from_numpy([np.asarray(getattr(jt, n)) for n in BVH_LEAVES], jt.max_leaf)
    return jt, jb4.collapse_bvhw(pack_bvh_rows(jt), width=4), tb4.collapse_bvh4(carried)


@pytest.mark.parametrize("leaf,builder", [(4, "sah"), (14, "median"), (56, "sah")])
def test_collapse_matches_jax(leaf, builder):
    # Same nodes in the same order: the child boxes and child node ids of the
    # JAX table, with leaves as (first, count) ranges instead of row codes.
    j, _ = cup_pair()
    jt, jp4, tree = jax_and_port_trees(j, leaf, builder)
    table = np.asarray(jp4.nodes4)
    assert tree.num_nodes == jp4.num_nodes == table.shape[0]
    boxes, meta, nchild = tree.boxes.numpy(), tree.meta.numpy(), tree.nchild.numpy()
    for c in range(4):
        valid = c < nchild
        np.testing.assert_array_equal(np.isnan(table[:, 6 * c]), ~valid)
        for k in range(3):
            np.testing.assert_array_equal(boxes[valid, 4 * k + c], table[valid, 6 * c + k])
            np.testing.assert_array_equal(boxes[valid, 12 + 4 * k + c],
                                          table[valid, 6 * c + 3 + k])
        enc = table[valid, 24 + c]
        internal = meta[valid, 4 + c] == 0
        np.testing.assert_array_equal(enc >= 0, internal)
        np.testing.assert_array_equal(meta[valid, c][internal], enc[internal].astype(np.int64))
        code = (-enc[~internal] - 1).astype(np.int64)  # row_first * 64 + n_rows
        np.testing.assert_array_equal(-(-meta[valid, 4 + c][~internal] // 14), code % 64)
    counts = meta[:, 4:8][meta[:, 4:8] > 0]
    assert counts.sum() == j.num_triangles
    np.testing.assert_array_equal(tree.slot_to_prim.numpy(), np.asarray(jt.tri_order))
    tv0, tv1 = np.asarray(jt.tv0), np.asarray(jt.tv1)
    np.testing.assert_array_equal(tree.tris.numpy()[:, 3:6], tv1 - tv0)


def test_collapse_refuses_a_tree_past_the_stack():
    # A chain 80 binary levels deep (each level one leaf and one internal
    # child) collapses to 40 levels, whose descent could hold 121 entries.
    depth = 80
    n = 2 * depth + 1
    left = np.full(n, -1, np.int32)
    right = np.full(n, -1, np.int32)
    count = np.zeros(n, np.int32)
    for i in range(depth):
        left[2 * i], right[2 * i] = 2 * i + 1, 2 * i + 2
        count[2 * i + 1] = 1
    count[n - 1] = 1
    first = np.cumsum(count) - count
    lo, hi = np.zeros((n, 3), np.float32), np.ones((n, 3), np.float32)
    t = torch.from_numpy
    tv = torch.zeros((depth + 1, 3))
    chain = tbvh.BVH(t(lo), t(hi), t(left), t(right), t(first.astype(np.int32)), t(count),
                     torch.arange(depth + 1, dtype=torch.int32), tv, tv, tv, max_leaf=1)
    with pytest.raises(ValueError, match="stack"):
        tb4.collapse_bvh4(chain)


@pytest.mark.parametrize("spheres", [False, True])
def test_twins_match_jax_kernels(spheres):
    j, t = cup_pair(spheres=spheres)
    _, jp4, tree = jax_and_port_trees(j)
    o, d, ro, rd, tm = mesh_rays()
    got = tb4.intersect_bvh4_cuda(t, tree, torch.from_numpy(o), torch.from_numpy(d))
    want = jb4.intersect_pallas_bvh4(j, jp4, jnp.asarray(o), jnp.asarray(d), interpret=True)
    assert_hits_agree(got, want, "closest vs JAX")
    assert_hits_agree(got, tint.intersect_brute(t, torch.from_numpy(o), torch.from_numpy(d)),
                      "closest vs brute force")
    hit = got.prim_id.numpy() >= 0
    np.testing.assert_allclose(got.u.numpy()[hit], np.asarray(want.u)[hit], atol=1e-4)
    assert 0.2 < hit.mean() < 0.9
    if spheres:
        assert (got.prim_id.numpy() >= t.num_triangles).any()
    occ = tb4.occluded_bvh4_cuda(t, tree, torch.from_numpy(ro), torch.from_numpy(rd),
                                 torch.from_numpy(tm)).numpy()
    j_occ = np.asarray(jb4.occluded_pallas_bvh4(j, jp4, jnp.asarray(ro), jnp.asarray(rd),
                                                jnp.asarray(tm), interpret=True))
    b_occ = tint.occluded_brute(t, torch.from_numpy(ro), torch.from_numpy(rd),
                                torch.from_numpy(tm)).numpy()
    assert (occ == j_occ).mean() >= 0.995 and (occ == b_occ).mean() >= 0.995
    assert 0.05 < occ.mean() < 0.95


def test_bounce_twin_matches_jax_kernel():
    j, t = cup_pair(lights=(((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0)),
                            ((1.0, 2.0, 0.5), (0.5, 0.5, 0.5))))
    _, jp4, tree = jax_and_port_trees(j)
    o, d, *_ = mesh_rays()
    live = np.arange(o.shape[0]) % 5 != 0
    hit, bits = tb4.bounce_bvh4_cuda(t, tree, torch.from_numpy(o), torch.from_numpy(d),
                                     live=torch.from_numpy(live))
    j_hit, j_bits = jb4.bounce_pallas_bvh4(j, jp4, jnp.asarray(o), jnp.asarray(d),
                                           live=jnp.asarray(live), interpret=True)
    assert_hits_agree(hit, j_hit, "bounce vs JAX")
    assert (bits.numpy() == np.asarray(j_bits)).mean() >= 0.995
    assert (hit.prim_id.numpy()[~live] == -1).all() and (bits.numpy()[~live] == 0).all()
    assert 0.05 < (bits.numpy() > 0).mean() < 0.5
    # The bits are the any-hit oracle's at the hit points.
    plain_hit, plain_bits = tb4.bounce_bvh4_plain(t, tree, torch.from_numpy(o),
                                                  torch.from_numpy(d),
                                                  live=torch.from_numpy(live))
    assert torch.equal(plain_bits, bits) and torch.equal(plain_hit.t, hit.t)
    with pytest.raises(ValueError, match="supports_fused_bounce_bvh4"):
        tb4.bounce_bvh4_cuda(cup_pair(spheres=True)[1], tree, torch.from_numpy(o),
                             torch.from_numpy(d))


def test_twins_run_for_cpu_tensors_without_launching():
    _, t = cup_pair()
    _, tree = tb4.build_bvh4(t, max_leaf=4, builder="sah")
    assert tree.device == torch.device("cpu") and tree.depth >= 3
    before = tb4.launch_counts()
    o, d, *_ = mesh_rays(n_random=0, size=16)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    tb4.intersect_bvh4_cuda(t, tree, o, d)
    tb4.occluded_bvh4_cuda(t, tree, o, d, torch.full((o.shape[0],), 2.0))
    tb4.bounce_bvh4_cuda(t, tree, o, d)
    assert tb4.launch_counts() == before
    assert tb4.supports_bvh4(t) and tb4.supports_fused_bounce_bvh4(t)
    empty = dataclasses.replace(t, triangles=torch.zeros((0, 3), dtype=torch.int32))
    assert not tb4.supports_bvh4(empty)


def test_dead_rays_and_t_max_bounds():
    # t_max < 0 is a dead ray: no hit; a hit must lie below t_max.
    _, t = cup_pair()
    _, tree = tb4.build_bvh4(t, max_leaf=4, builder="sah")
    o, d, *_ = mesh_rays(n_random=0, size=16)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    full = tb4.intersect_bvh4_cuda(t, tree, o, d)
    assert (full.prim_id >= 0).any()
    for scale in (0.999, 1.001):
        t_max = torch.where(torch.arange(o.shape[0]) % 2 == 0, -1.0, full.t * scale)
        bounded = tb4.intersect_bvh4_cuda(t, tree, o, d, t_max=t_max)
        assert (bounded.prim_id[::2] == -1).all()
        want = full.prim_id[1::2] if scale > 1 else torch.full_like(full.prim_id[1::2], -1)
        assert torch.equal(bounded.prim_id[1::2], want)
    assert not tb4.occluded_bvh4_cuda(t, tree, o, d, torch.full((o.shape[0],), -1.0)).any()
