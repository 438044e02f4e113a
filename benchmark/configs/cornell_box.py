"""Geometry of the ``cornell_box`` configuration, made by the benchmark.

A frozen copy of ``cg_raytracer_tpu_torch/scene/standins.py::mirror_box_meshes``
(commit 3c561914e6c9): the 32-triangle stand-in for upstream's
CornellBox-Mirror-Rotated.obj, whose file is not in the repository.  A box
of half-side 0.6 open toward the default camera, turned by euler
(20, 20, 0) degrees, with a short and a tall block on the floor and a mirror
panel in front of the back wall.  Plain numpy: both the program and the
plain reference take these arrays.
"""
from __future__ import annotations

import numpy as np

WHITE = {"kd": (0.73, 0.71, 0.68), "ks": (0.0, 0.0, 0.0), "shininess": 1.0}
RED = {"kd": (0.63, 0.065, 0.05), "ks": (0.05, 0.0, 0.0), "shininess": 4.0}
GREEN = {"kd": (0.14, 0.45, 0.091), "ks": (0.0, 0.0, 0.0), "shininess": 1.0}
MIRROR = {"kd": (0.05, 0.05, 0.05), "ks": (0.9, 0.9, 0.9), "shininess": 100.0}


def _quad(p0, p1, p2, p3, material):
    v = np.asarray([p0, p1, p2, p3], np.float32)
    n = np.cross(v[1] - v[0], v[2] - v[0])
    n = (n / np.linalg.norm(n)).astype(np.float32)
    return {"vertices": v, "normals": np.tile(n, (4, 1)),
            "triangles": np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
            "material": dict(material)}


def _block(x0, x1, y0, y1, z0, z1, material):
    return [
        _quad((x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1), material),
        _quad((x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0), material),
        _quad((x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1), material),
        _quad((x0, y0, z0), (x0, y1, z0), (x0, y1, z1), (x0, y0, z1), material),
        _quad((x1, y0, z0), (x1, y1, z0), (x1, y1, z1), (x1, y0, z1), material),
    ]


def _rotate(points, euler_deg):
    half = np.radians(np.asarray(euler_deg, np.float64)) * 0.5
    (cx, cy, cz), (sx, sy, sz) = np.cos(half), np.sin(half)
    w = cx * cy * cz + sx * sy * sz
    q = np.asarray([sx * cy * cz - cx * sy * sz, cx * sy * cz + sx * cy * sz,
                    cx * cy * sz - sx * sy * cz])
    p = np.asarray(points, np.float64)
    return (p + 2.0 * np.cross(q, np.cross(q, p) + w * p)).astype(np.float32)


def meshes() -> list:
    """Mesh dicts ('vertices', 'normals', 'triangles', 'material'), in order."""
    h = 0.6
    walls = [
        _quad((-h, -h, -h), (h, -h, -h), (h, -h, h), (-h, -h, h), WHITE),
        _quad((-h, h, -h), (h, h, -h), (h, h, h), (-h, h, h), WHITE),
        _quad((-h, -h, h), (h, -h, h), (h, h, h), (-h, h, h), WHITE),
        _quad((h, -h, -h), (h, h, -h), (h, h, h), (h, -h, h), RED),
        _quad((-h, -h, -h), (-h, h, -h), (-h, h, h), (-h, -h, h), GREEN),
    ]
    blocks = (_block(-0.4, -0.05, -h, -0.25, -0.35, 0.0, WHITE)
              + _block(0.05, 0.4, -h, 0.1, 0.05, 0.4, WHITE))
    mirror = [_quad((-0.5, -0.3, 0.59), (0.0, -0.3, 0.59), (0.0, 0.4, 0.59),
                    (-0.5, 0.4, 0.59), MIRROR)]
    out = walls + blocks + mirror
    for m in out:
        m["vertices"] = _rotate(m["vertices"], (20.0, 20.0, 0.0))
        m["normals"] = _rotate(m["normals"], (20.0, 20.0, 0.0))
    return out
