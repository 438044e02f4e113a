"""Carry the JAX package's scene, camera, parameter dicts and BVH across as
numpy arrays.

The JAX ``Scene`` and ``Camera`` are pytrees; ``jax.tree_util.tree_leaves``
lists their arrays in field order.  These functions take exactly those leaves,
converted with ``numpy.asarray``, and build the port's containers, so a test
can feed both packages one scene without this package importing JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.bvh import BVH
from .scene.types import (Camera, Materials, PointLights, Scene, SphericalLights,
                          Spheres)

# Leaf order of the JAX Scene pytree (dataclass field order, nested).
SCENE_LEAVES = (
    "vertices", "normals", "triangles", "tri_material",
    "materials.kd", "materials.ks", "materials.shininess", "materials.transparency",
    "spheres.center", "spheres.radius", "spheres.kd", "spheres.ks", "spheres.shininess",
    "point_lights.position", "point_lights.color",
    "spherical_lights.position", "spherical_lights.radius", "spherical_lights.color",
)
CAMERA_LEAVES = ("look_at", "euler", "dist", "fovy", "aspect")
# Leaf order of the JAX BVH pytree (its max_leaf is static, not a leaf).
BVH_LEAVES = ("node_lo", "node_hi", "left", "right", "first", "count", "tri_order",
              "tv0", "tv1", "tv2")


def _tensors(fields, names, device):
    arrays = [np.asarray(a) for a in fields]
    if len(arrays) != len(names):
        raise ValueError(f"expected {len(names)} arrays ({', '.join(names)}), "
                         f"got {len(arrays)}")
    return [torch.from_numpy(np.array(a, copy=True, order="C")).to(device) for a in arrays]


def scene_from_numpy(fields, device="cpu") -> Scene:
    """``fields``: the JAX Scene's leaves as numpy arrays, in ``SCENE_LEAVES`` order."""
    (v, n, t, tm, kd, ks, shin, trans, sc, sr, skd, sks, sshin,
     lp, lc, slp, slr, slc) = _tensors(fields, SCENE_LEAVES, device)
    return Scene(
        vertices=v, normals=n, triangles=t.to(torch.int32),
        tri_material=tm.to(torch.int32),
        materials=Materials(kd=kd, ks=ks, shininess=shin, transparency=trans),
        spheres=Spheres(center=sc, radius=sr, kd=skd, ks=sks, shininess=sshin),
        point_lights=PointLights(position=lp, color=lc),
        spherical_lights=SphericalLights(position=slp, radius=slr, color=slc),
    )


def camera_from_numpy(fields, device="cpu") -> Camera:
    """``fields``: the JAX Camera's leaves as numpy arrays, in ``CAMERA_LEAVES`` order."""
    return Camera(*_tensors(fields, CAMERA_LEAVES, device))


def params_from_numpy(params, device="cpu") -> dict:
    """A parameter dict of the JAX package (``material_params``,
    ``vertex_params``), its values as numpy arrays, as the port's dict of
    float32 tensors on ``device`` under the same keys."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True, order="C")).to(device)
            for k, v in params.items()}


def bvh_from_numpy(fields, max_leaf: int, device="cpu") -> BVH:
    """``fields``: a JAX-built ``BVH``'s arrays as numpy, in ``BVH_LEAVES``
    order, and its ``max_leaf``: the same tree as the port's ``BVH``, so
    that the port's 4-wide collapse and traversals run on the JAX tree."""
    arrays = _tensors(fields, BVH_LEAVES, device)
    return BVH(*(a.to(torch.int32) if a.dtype != torch.float32 else a for a in arrays),
               max_leaf=int(max_leaf))
