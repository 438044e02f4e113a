"""PyTorch port: the host C++ library (``native.py``) against the JAX
package's binding of the same sources.

- The library builds here (``native.available()``), as it must on the card's
  machine (``chip_smoke.py`` asserts it there).
- The median tree of the lathed cup (1,154 triangles) at leaves 4, 14 and
  56: the port's native arrays equal the JAX package's native arrays bit
  for bit; against the numpy tree (which ``nth_element`` may order and
  tie-break otherwise) the hits agree to the backend contract
  (``tests/test_native.py:32``: t on >= 99.8% of rays, prim ids on >= 99.5%).
- An OBJ with an MTL written here (two material groups, quads, negative
  indices, given and generated normals) parses the same through the port's
  C++ parser, its Python parser and the JAX package's two (positions and
  triangles equal, normals within 1e-5, as ``tests/test_native.py``).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from cg_raytracer_tpu import native as jnative
from cg_raytracer_tpu.ops import bvh as jbvh
from cg_raytracer_tpu.scene import loader as jloader
from cg_raytracer_tpu_torch import native
from cg_raytracer_tpu_torch.interop import BVH_LEAVES
from cg_raytracer_tpu_torch.ops._build import build_dir
from cg_raytracer_tpu_torch.ops import bvh as tbvh
from cg_raytracer_tpu_torch.ops import intersect as tint
from cg_raytracer_tpu_torch.scene import loader as tloader
from tests.test_torch_bvh import assert_hits_agree, cup_pair, mesh_rays


def test_library_builds():
    assert native.available()
    path = native.library_path()
    assert os.path.dirname(path) == build_dir() and os.path.isfile(path)


@pytest.mark.parametrize("leaf", [4, 14, 56])
def test_native_tree_equals_jax_native_tree(leaf):
    j, t = cup_pair()
    assert jnative.available()
    want = jbvh.build_bvh(j, max_leaf=leaf, use_native=True)
    got = tbvh.build_bvh(t, max_leaf=leaf)  # the default: native where it builds
    for name in BVH_LEAVES:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.max_leaf == want.max_leaf == leaf


def test_native_tree_hits_equal_the_numpy_tree():
    _, t = cup_pair()
    nat, ref = tbvh.build_bvh(t), tbvh.build_bvh(t, use_native=False)
    assert sorted(nat.tri_order.tolist()) == list(range(t.num_triangles))
    o, d, ro, rd, tm = (torch.from_numpy(x) for x in mesh_rays())
    got = tbvh.intersect_bvh(t, nat, o, d)
    assert_hits_agree(got, tbvh.intersect_bvh(t, ref, o, d), "native vs numpy tree")
    assert_hits_agree(got, tint.intersect_brute(t, o, d), "native tree vs brute force")
    occ, want = tbvh.occluded_bvh(t, nat, ro, rd, tm), tbvh.occluded_bvh(t, ref, ro, rd, tm)
    assert (occ == want).float().mean().item() >= 0.995


def test_native_build_rejects_bad_input():
    empty = np.zeros((0, 3), np.float32)
    with pytest.raises(ValueError):
        native.native_build_bvh(empty, empty, empty, 20, 4)
    _, t = cup_pair()
    with pytest.raises(ValueError, match="empty"):
        tbvh.build_bvh(dataclasses.replace(t, triangles=torch.zeros((0, 3), dtype=torch.int32),
                                           tri_material=torch.zeros((0,), dtype=torch.int32)))


MTL = """newmtl red
Kd 0.8 0.1 0.1
Ks 0.2 0.2 0.2
Ns 32
newmtl glass
Kd 0.1 0.2 0.9
d 0.5
"""

OBJ = """# two groups, a quad, negative indices, given and generated normals
mtllib scene.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1
v -0.25 0.75 0.5
vn 0 0 1
vn 0 1 0
usemtl red
f 1//1 2//1 3//1 4//1
f 1//2 3//2 5//2
usemtl glass
f 2 3 5
f -1 -2 -3 -4
usemtl red
f 4//1 5//1 6//2
"""


def test_obj_parses_the_same_three_ways(tmp_path):
    (tmp_path / "scene.mtl").write_text(MTL)
    path = tmp_path / "scene.obj"
    path.write_text(OBJ)
    parses = {"port native": tloader.load_obj(str(path), use_native=True),
              "port python": tloader.load_obj(str(path), use_native=False),
              "jax": jloader.load_obj(str(path), use_native=False),
              "jax native": jloader.load_obj(str(path), use_native=True),
              "port default": tloader.load_obj(str(path))}
    want = parses.pop("jax")
    assert len(want) == 2 and want[0]["material"]["shininess"] == 32.0
    for label, meshes in parses.items():
        assert len(meshes) == len(want), label
        for a, b in zip(meshes, want):
            np.testing.assert_array_equal(a["triangles"], b["triangles"], err_msg=label)
            np.testing.assert_array_equal(a["vertices"], b["vertices"], err_msg=label)
            np.testing.assert_allclose(a["normals"], b["normals"], atol=1e-5, err_msg=label)
            assert set(a["material"]) == set(b["material"]), label
            for k in b["material"]:
                np.testing.assert_allclose(np.ravel(a["material"][k]), np.ravel(b["material"][k]),
                                           err_msg=(label, k))
    # normalize=True: the joint centre and scale of every path.
    np.testing.assert_allclose(
        tloader.load_obj(str(path), normalize=True)[1]["vertices"],
        jloader.load_obj(str(path), normalize=True, use_native=False)[1]["vertices"], atol=1e-6)


def test_obj_without_triangles(tmp_path):
    path = tmp_path / "empty.obj"
    path.write_text("v 0 0 0\nv 1 0 0\n")
    with pytest.raises(RuntimeError, match="native OBJ load failed"):
        tloader.load_obj(str(path), use_native=True)
    # The default hands the file the C++ parser refused to the Python one.
    with pytest.raises(ValueError, match="No triangles"):
        tloader.load_obj(str(path))
    with pytest.raises(FileNotFoundError):
        tloader.load_obj(str(tmp_path / "missing.obj"))
