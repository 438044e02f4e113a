"""In-process scenes with the shape of the repo's flagship scene, for tests
and on-card checks when the OBJ files are not present.

``mirror_box_meshes`` stands in for ``cornell_box`` (CornellBox-Mirror-Rotated
with one point light at (0, 0.58, 0)): 32 triangles, white/red/green walls,
two blocks, one mirror quad, and the light inside the box.  It is not a preset
and does not change what ``cornell_box`` means.  With ``SPHERICAL_BOX_LIGHTS``
in place of its point light it stands in for ``cornell_box_spherical_light``;
the procedural teacup with ``SPHERICAL_CUP_LIGHTS`` stands in for
``monkey_spherical_light`` (both lights as the presets have them).  ``mixed_meshes`` and
``mixed_spheres`` make a small triangles + spheres scene (12 triangles, two
spheres, one of them glossy).  ``dense_mirror_box_meshes`` with
``DENSE_BOX_LIGHTS`` is the mirror box at the brute kernels' caps: 256
triangles, 8 point lights.

Everything here is numpy and plain tuples, so both packages' ``make_scene``
accept it.
"""
from __future__ import annotations

import numpy as np

WHITE = {"kd": (0.73, 0.71, 0.68), "ks": (0.0, 0.0, 0.0), "shininess": 1.0}
# ks.x > 0.01 with ks.z <= 0.01: reflective under the fixed continue-test,
# not under the reference's ks.z-only quirk, so reference_quirks changes the image.
RED = {"kd": (0.63, 0.065, 0.05), "ks": (0.05, 0.0, 0.0), "shininess": 4.0}
GREEN = {"kd": (0.14, 0.45, 0.091), "ks": (0.0, 0.0, 0.0), "shininess": 1.0}
MIRROR = {"kd": (0.05, 0.05, 0.05), "ks": (0.9, 0.9, 0.9), "shininess": 100.0}

MIRROR_BOX_LIGHTS = (((0.0, 0.58, 0.0), (1.0, 1.0, 1.0)),)
MIXED_LIGHTS = (((0.5, 1.0, -1.0), (1.0, 1.0, 1.0)),)
# (position, radius, color), for SphericalLights.of.
SPHERICAL_BOX_LIGHTS = (((0.0, 0.45, 0.0), 0.1, (1.0, 1.0, 1.0)),)
SPHERICAL_CUP_LIGHTS = (((-1.0, 1.0, -1.0), 0.1, (1.0, 1.0, 1.0)),)


def quad(p0, p1, p2, p3, material) -> dict:
    """Two triangles (p0 p1 p2), (p0 p2 p3) with the flat face normal."""
    v = np.asarray([p0, p1, p2, p3], np.float32)
    n = np.cross(v[1] - v[0], v[2] - v[0])
    n = (n / np.linalg.norm(n)).astype(np.float32)
    return {"vertices": v, "normals": np.tile(n, (4, 1)),
            "triangles": np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
            "material": dict(material)}


def block(x0, x1, y0, y1, z0, z1, material) -> list:
    """Axis-aligned block standing on y0: top and four sides (10 triangles)."""
    return [
        quad((x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1), material),
        quad((x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0), material),
        quad((x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1), material),
        quad((x0, y0, z0), (x0, y1, z0), (x0, y1, z1), (x0, y0, z1), material),
        quad((x1, y0, z0), (x1, y1, z0), (x1, y1, z1), (x1, y0, z1), material),
    ]


def _rotate(points, euler_deg):
    """Rotate [..., 3] points by glm::quat(radians(euler_deg)), the rotation
    the default camera applies to its (0, 0, -dist) offset."""
    half = np.radians(np.asarray(euler_deg, np.float64)) * 0.5
    (cx, cy, cz), (sx, sy, sz) = np.cos(half), np.sin(half)
    w = cx * cy * cz + sx * sy * sz
    q = np.asarray([sx * cy * cz - cx * sy * sz, cx * sy * cz + sx * cy * sz,
                    cx * cy * sz - sx * sy * cz])
    p = np.asarray(points, np.float64)
    return (p + 2.0 * np.cross(q, np.cross(q, p) + w * p)).astype(np.float32)


def mirror_box_meshes() -> list:
    """32 triangles: a box of half-side 0.6 around the origin, open on one
    side and turned to face the default camera (euler (20, 20, 0) deg), so the
    camera looks straight in; the light at (0, 0.58, 0) then sits inside,
    just under the ceiling.  A short and a tall block stand on the floor and
    a mirror panel hangs in front of the back wall."""
    h = 0.6
    walls = [
        quad((-h, -h, -h), (h, -h, -h), (h, -h, h), (-h, -h, h), WHITE),  # floor
        quad((-h, h, -h), (h, h, -h), (h, h, h), (-h, h, h), WHITE),  # ceiling
        quad((-h, -h, h), (h, -h, h), (h, h, h), (-h, h, h), WHITE),  # back
        quad((h, -h, -h), (h, h, -h), (h, h, h), (h, -h, h), RED),  # image left
        quad((-h, -h, -h), (-h, h, -h), (-h, h, h), (-h, -h, h), GREEN),  # image right
    ]
    blocks = (block(-0.4, -0.05, -h, -0.25, -0.35, 0.0, WHITE)
              + block(0.05, 0.4, -h, 0.1, 0.05, 0.4, WHITE))
    mirror = [quad((-0.5, -0.3, 0.59), (0.0, -0.3, 0.59), (0.0, 0.4, 0.59),
                   (-0.5, 0.4, 0.59), MIRROR)]
    meshes = walls + blocks + mirror
    for m in meshes:
        m["vertices"] = _rotate(m["vertices"], (20.0, 20.0, 0.0))
        m["normals"] = _rotate(m["normals"], (20.0, 20.0, 0.0))
    return meshes


def split_quad(mesh: dict, rows: int, cols: int) -> dict:
    """A ``quad`` mesh (p0 p1 p2 p3) cut into rows x cols quads on the
    bilinear grid of its corners: 2 rows cols triangles, the same face
    normal and material."""
    p0, p1, p2, p3 = np.asarray(mesh["vertices"], np.float64)
    a = np.linspace(0.0, 1.0, cols + 1)[None, :, None]
    b = np.linspace(0.0, 1.0, rows + 1)[:, None, None]
    grid = ((1 - b) * ((1 - a) * p0 + a * p1) + b * ((1 - a) * p3 + a * p2)).reshape(-1, 3)
    k = np.arange(rows * cols)
    c00 = k // cols * (cols + 1) + k % cols
    c01, c10 = c00 + 1, c00 + cols + 1
    tris = np.stack([np.stack([c00, c01, c10 + 1], 1), np.stack([c00, c10 + 1, c10], 1)],
                    1).reshape(-1, 3)
    return {"vertices": grid.astype(np.float32),
            "normals": np.tile(np.asarray(mesh["normals"][0], np.float32), (len(grid), 1)),
            "triangles": tris.astype(np.int32), "material": dict(mesh["material"])}


def dense_mirror_box_meshes() -> list:
    """``mirror_box_meshes`` with each of its 16 quads cut into 2 x 4: 256
    triangles, the brute kernels' cap, in the same box."""
    return [split_quad(m, 2, 4) for m in mirror_box_meshes()]


# Eight point lights inside the (turned) mirror box, above both blocks.
DENSE_BOX_LIGHTS = tuple(
    (tuple(float(c) for c in _rotate(np.asarray([x, y, z], np.float32), (20.0, 20.0, 0.0))),
     (0.15, 0.15, 0.15))
    for y in (0.5, 0.25) for x in (-0.3, 0.3) for z in (-0.3, 0.3))


def mixed_meshes() -> list:
    """12 triangles: a floor quad and one red block."""
    floor = quad((-1, -0.5, -1), (1, -0.5, -1), (1, -0.5, 1), (-1, -0.5, 1),
                 {"kd": (0.7, 0.7, 0.7)})
    red = {"kd": (0.7, 0.1, 0.1), "ks": (0.05, 0.0, 0.0), "shininess": 4.0}
    return [floor] + block(-0.7, -0.3, -0.5, -0.1, -0.2, 0.2, red)


def mixed_spheres() -> dict:
    """Two spheres as numpy arrays: a glossy grey one and a small blue one."""
    return {
        "center": np.asarray([[0.4, -0.2, 0.0], [0.0, -0.35, -0.5]], np.float32),
        "radius": np.asarray([0.3, 0.15], np.float32),
        "kd": np.asarray([[0.2, 0.2, 0.2], [0.1, 0.1, 0.8]], np.float32),
        "ks": np.asarray([[0.6, 0.6, 0.6], [0.0, 0.0, 0.0]], np.float32),
        "shininess": np.asarray([32.0, 1.0], np.float32),
    }
