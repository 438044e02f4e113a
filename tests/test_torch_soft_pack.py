"""PyTorch port, the tree samplers' packed tables, on the CPU.

``ops/soft.py::pack_nodes`` lays each node of a ``BVH4`` out as one record
(the 6W box floats with NaN boxes in the absent slots, then the 2W meta ints
bit-cast) and ``pack_tris`` pads each triangle row to three 16-byte rows.
Both must give back the tree exactly: the boxes and meta bit for bit, the
child counts from the NaN slots, at widths 2, 4 and 8 of the 1,154-triangle
cup (``test_torch_bvh.py::cup_pair``), and again after a refit
(``ops/refit.py``, widths 2 and 4) of moved vertices.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from cg_raytracer_tpu_torch.ops import bvh4 as b4
from cg_raytracer_tpu_torch.ops import soft
from cg_raytracer_tpu_torch.ops.refit import refit_accel
from tests.test_torch_bvh import cup_pair

NAN_BITS = 0x7FC00000


@functools.lru_cache(maxsize=None)
def cup_bvh():
    _, scene = cup_pair()
    return scene, b4.build_bvh4(scene, max_leaf=4, builder="sah")[0]


def unpack(rec, width):
    """Node records [Nw, 8W] -> (box bits [Nw, 6W] int32, meta [Nw, 2W],
    nchild [Nw] from the slots whose boxes are not NaN)."""
    bits = rec.view(torch.int32)
    boxes = bits[:, :6 * width]
    present = ~torch.isnan(rec[:, :6 * width].view(-1, 6, width)).any(dim=1)
    return boxes, bits[:, 6 * width:], present.sum(dim=1).to(torch.int32), present


def assert_round_trip(tree):
    w = tree.width
    rec = soft.pack_nodes(tree)
    assert rec.dtype == torch.float32 and rec.shape == (tree.num_nodes, 8 * w)
    assert rec.is_contiguous() and rec.element_size() * rec.shape[1] == 32 * w
    boxes, meta, nchild, present = unpack(rec, w)
    assert torch.equal(meta, tree.meta)
    assert torch.equal(nchild, tree.nchild)
    # Present slots keep the boxes' bits; absent slots hold exactly the NaN.
    lanes = torch.arange(w)[None, :] < tree.nchild[:, None]
    assert torch.equal(present, lanes)
    want = tree.boxes.view(torch.int32).view(-1, 6, w)
    got = boxes.reshape(-1, 6, w)
    assert torch.equal(got[lanes[:, None, :].expand(-1, 6, -1)],
                       want[lanes[:, None, :].expand(-1, 6, -1)])
    assert bool((got[~lanes[:, None, :].expand(-1, 6, -1)] == NAN_BITS).all())
    assert int((~lanes).sum()) == w * tree.num_nodes - int(tree.nchild.sum())
    rows = soft.pack_tris(tree.tris)
    assert rows.shape == (tree.num_tris, 12) and rows.is_contiguous()
    assert torch.equal(rows.view(-1, 3, 4)[..., :3].reshape(-1, 9).view(torch.int32),
                       tree.tris.view(torch.int32))
    assert not bool(rows.view(-1, 3, 4)[..., 3].any())
    return rec


@pytest.mark.parametrize("width", [2, 4, 8])
def test_pack_nodes_round_trips(width):
    _, bvh = cup_bvh()
    tree = b4.collapse_bvhw(bvh, width)
    assert_round_trip(tree)
    if width > 2:  # the collapse leaves nodes with fewer than W children
        assert int(tree.nchild.min()) < width


@pytest.mark.parametrize("width", [2, 4])  # the widths ops/refit.py refits
def test_pack_nodes_round_trips_after_refit(width):
    scene, bvh = cup_bvh()
    tree = b4.collapse_bvhw(bvh, width)
    rng = np.random.default_rng(width)
    moved = dataclasses.replace(scene, vertices=scene.vertices + torch.from_numpy(
        rng.normal(scale=0.02, size=tuple(scene.vertices.shape)).astype(np.float32)))
    refit = refit_accel(tree, moved)
    rec = assert_round_trip(refit)
    assert not torch.equal(rec, soft.pack_nodes(tree)), "the refit moved no box"
