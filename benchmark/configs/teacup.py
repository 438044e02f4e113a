"""Geometry of the ``teacup`` configuration, made by the benchmark.

A frozen copy of ``cg_raytracer_tpu_torch/scene/presets.py::_procedural_teacup``
(with ``_grid_mesh``) followed by ``scene/loader.py::center_and_scale_to_unit``
(commit bf9548d1bdfd): the stand-in for report.pdf Table 2's custom Teacup,
whose OBJ was never committed upstream.  A lathed cup profile (a flared bowl
with a lip) on a grid of 160 x 151 vertices, wrapped around the axis:
160 x 150 x 2 = 48,000 triangles with area-weighted smooth vertex normals,
moved to its vertices' centroid and scaled so that the farthest vertex lies
at distance 1.  Plain numpy: both the program and the plain reference take
these arrays.
"""
from __future__ import annotations

import numpy as np

CUP = {"kd": (0.85, 0.85, 0.9), "ks": (0.1, 0.1, 0.1), "shininess": 16.0, "transparency": 1.0}


def _grid_mesh(surface, nu: int, nv: int, wrap_u: bool, wrap_v: bool, material: dict) -> dict:
    """A triangulated parametric grid; ``surface(uu, vv)`` maps meshgrid
    parameters in [0, 1) x [0, 1] to x, y, z arrays."""
    u = np.linspace(0.0, 1.0, nu, endpoint=not wrap_u)
    v = np.linspace(0.0, 1.0, nv, endpoint=not wrap_v)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    x, y, z = surface(uu, vv)
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)

    def vid(i, j):
        return (i % nu) * nv + (j % nv)

    tris = []
    for i in range(nu if wrap_u else nu - 1):
        for j in range(nv if wrap_v else nv - 1):
            tris.append((vid(i, j), vid(i + 1, j), vid(i + 1, j + 1)))
            tris.append((vid(i, j), vid(i + 1, j + 1), vid(i, j + 1)))
    tris = np.asarray(tris, np.int32)

    p0, p1, p2 = pts[tris[:, 0]], pts[tris[:, 1]], pts[tris[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    normals = np.zeros_like(pts)
    for k in range(3):
        np.add.at(normals, tris[:, k], fn)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = (normals / np.maximum(lens, 1e-20)).astype(np.float32)
    return {"vertices": pts, "normals": normals, "triangles": tris, "material": dict(material)}


def _surface(uu, vv):
    """The cup's profile: radius as a function of height (0 the base, 1 the
    rim), turned around the y axis."""
    th = 2 * np.pi * uu
    h = vv
    r = 0.25 + 0.55 * np.sqrt(np.clip(h, 0.0, 1.0)) + 0.05 * np.sin(6 * np.pi * h)
    return r * np.cos(th), 1.4 * h - 0.7, r * np.sin(th)


def _center_and_scale_to_unit(meshes: list) -> None:
    """In place: less the centroid of every vertex, over the largest
    distance from it (upstream's ``centerAndScaleToUnitMesh``)."""
    all_pos = np.concatenate([m["vertices"] for m in meshes], axis=0)
    center = all_pos.mean(axis=0)
    max_d = float(np.max(np.linalg.norm(all_pos - center, axis=1)))
    for m in meshes:
        m["vertices"] = ((m["vertices"] - center) / max_d).astype(np.float32)


def cup(nu: int = 160, nv: int = 151) -> list:
    """The cup on a grid of ``nu`` x ``nv`` vertices (nu (nv - 1) 2
    triangles), scaled to unit size; the defaults are the configuration's."""
    meshes = [_grid_mesh(_surface, nu, nv, wrap_u=True, wrap_v=False, material=CUP)]
    _center_and_scale_to_unit(meshes)
    return meshes


def meshes() -> list:
    """Mesh dicts ('vertices', 'normals', 'triangles', 'material'), in order."""
    return cup()
