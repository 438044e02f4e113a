"""Built-in scene registry: the same preset names and parameters as
``cg_raytracer_tpu/scene/presets.py`` (the reference's ``loadScene``, scene.cpp:4-69).

OBJ presets read their files from ``data_dir`` (default: ``$CGRT_DATA_DIR``,
else the repository's ``data/``) and raise ``FileNotFoundError`` when a file is
absent.  ``dragon``, ``teacup`` and ``donut`` are procedural stand-ins and
``spheres`` has no mesh, so those four always load.

``load_standin`` builds the in-process stand-ins of ``standins.py``, which
are not presets: ``mirror_box`` (for ``cornell_box``), ``spherical_box``
(for ``cornell_box_spherical_light``) and ``spherical_teacup`` (the teacup
lit by ``monkey_spherical_light``'s spherical light, for that scene).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .loader import center_and_scale_to_unit, load_obj
from .types import PointLights, Scene, SphericalLights, Spheres, entry_device, make_scene

SCENE_NAMES = (
    "single_triangle",
    "cube",
    "cornell_box",
    "cornell_box_spherical_light",
    "monkey",
    "monkey_spherical_light",
    "dragon",
    "spheres",
    "custom",
    "teacup",
    "donut",
)


STANDIN_NAMES = ("mirror_box", "spherical_box", "spherical_teacup")


def default_data_dir() -> str:
    env = os.environ.get("CGRT_DATA_DIR")
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "data")


def _grid_mesh(surface, nu: int, nv: int, wrap_u: bool, wrap_v: bool,
               material: dict) -> dict:
    """Triangulated parametric grid with area-weighted smooth vertex normals.

    ``surface(uu, vv)`` maps meshgrid parameters in [0,1)x[0,1] to xyz arrays.
    """
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

    # Area-weighted smooth vertex normals.
    p0, p1, p2 = pts[tris[:, 0]], pts[tris[:, 1]], pts[tris[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    normals = np.zeros_like(pts)
    for k in range(3):
        np.add.at(normals, tris[:, k], fn)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = (normals / np.maximum(lens, 1e-20)).astype(np.float32)

    return {"vertices": pts, "normals": normals, "triangles": tris,
            "material": dict(material)}


def _procedural_dragon() -> dict:
    """High-poly stand-in for the stripped dragon.obj (87K tris per report.pdf):
    a bumpy UV sphere so the BVH has real structure to exploit."""

    def surface(uu, vv):
        th = 2 * np.pi * uu
        ph = 1e-3 + (np.pi - 2e-3) * vv
        r = 1.0 + 0.08 * np.sin(5 * th) * np.sin(7 * ph) + 0.05 * np.cos(11 * ph)
        return (r * np.sin(ph) * np.cos(th), r * np.cos(ph),
                r * np.sin(ph) * np.sin(th))

    # 210 * 209 * 2 = 87,780 triangles.
    return _grid_mesh(surface, 210, 210, wrap_u=True, wrap_v=False,
                      material={"kd": (0.8, 0.7, 0.5), "ks": (0.0, 0.0, 0.0),
                                "shininess": 1.0, "transparency": 1.0})


def _procedural_teacup() -> dict:
    """Stand-in for the reference report's custom Teacup scene (48K triangles,
    report.pdf Table 2; its .obj was never committed): a lathed cup profile."""

    def surface(uu, vv):
        th = 2 * np.pi * uu
        # Cup profile: flared bowl with a lip, radius as a function of height.
        h = vv  # 0 = base, 1 = rim
        r = 0.25 + 0.55 * np.sqrt(np.clip(h, 0.0, 1.0)) + 0.05 * np.sin(6 * np.pi * h)
        return r * np.cos(th), 1.4 * h - 0.7, r * np.sin(th)

    # 160 * 150 * 2 = 48,000 triangles.
    return _grid_mesh(surface, 160, 151, wrap_u=True, wrap_v=False,
                      material={"kd": (0.85, 0.85, 0.9), "ks": (0.1, 0.1, 0.1),
                                "shininess": 16.0, "transparency": 1.0})


def _procedural_donut() -> dict:
    """Stand-in for the reference report's custom Donut scene (320K triangles,
    report.pdf Table 2; its .obj was never committed): a torus, sized past the
    all-VMEM Pallas cap so it exercises the HBM-streaming BVH kernel."""

    def surface(uu, vv):
        th = 2 * np.pi * uu  # around the hole
        ph = 2 * np.pi * vv  # around the tube
        R, a = 1.0, 0.4
        return ((R + a * np.cos(ph)) * np.cos(th), a * np.sin(ph),
                (R + a * np.cos(ph)) * np.sin(th))

    # 400 * 400 * 2 = 320,000 triangles.
    return _grid_mesh(surface, 400, 400, wrap_u=True, wrap_v=True,
                      material={"kd": (0.9, 0.6, 0.3), "ks": (0.0, 0.0, 0.0),
                                "shininess": 1.0, "transparency": 1.0})


def load_scene(name: str, data_dir: str | None = None, device="cuda") -> Scene:
    """Load a preset scene by name onto ``device`` (the card unless asked for
    the CPU).  Parity table: scene.cpp:7-66."""
    device = entry_device(device)
    data_dir = data_dir or default_data_dir()
    name = name.lower()
    white = (1.0, 1.0, 1.0)

    def scene(meshes, **lights):
        return make_scene(meshes, device=device, **lights)

    if name == "single_triangle":
        meshes = load_obj(os.path.join(data_dir, "triangle.obj"))
        meshes[0]["material"] = dict(meshes[0]["material"], kd=(1.0, 1.0, 1.0))
        return scene(meshes, point_lights=PointLights.of(((-1, 1, -1), white)))
    if name == "cube":
        meshes = load_obj(os.path.join(data_dir, "cube.obj"))
        return scene(meshes, point_lights=PointLights.of(((-1, 1, -1), white)))
    if name == "cornell_box":
        meshes = load_obj(os.path.join(data_dir, "CornellBox-Mirror-Rotated.obj"), normalize=True)
        return scene(meshes, point_lights=PointLights.of(((0, 0.58, 0), white)))
    if name == "cornell_box_spherical_light":
        meshes = load_obj(os.path.join(data_dir, "CornellBox-Mirror-Rotated.obj"), normalize=True)
        return scene(meshes, spherical_lights=SphericalLights.of(((0, 0.45, 0), 0.1, white)))
    if name == "monkey":
        meshes = load_obj(os.path.join(data_dir, "monkey-rotated.obj"), normalize=True)
        return scene(meshes, point_lights=PointLights.of(((-1, 1, -1), white), ((1, -1, -1), white)))
    if name == "monkey_spherical_light":
        meshes = load_obj(os.path.join(data_dir, "monkey-rotated.obj"), normalize=True)
        return scene(meshes, spherical_lights=SphericalLights.of(((-1, 1, -1), 0.1, white)))
    if name == "dragon":
        path = os.path.join(data_dir, "dragon.obj")
        if os.path.exists(path):
            meshes = load_obj(path, normalize=True)
        else:
            meshes = [_procedural_dragon()]
            center_and_scale_to_unit(meshes)
        return scene(meshes, point_lights=PointLights.of(((-1, 1, -1), white)))
    if name == "spheres":
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        spheres = Spheres(
            center=f32([[3.0, -2.0, 10.2], [-2.0, 2.0, 4.0], [0.0, 0.0, 6.0]]),
            radius=f32([1.0, 2.0, 0.75]),
            kd=f32([[0.8, 0.2, 0.2], [0.6, 0.8, 0.2], [0.2, 0.2, 0.8]]),
            ks=torch.zeros((3, 3), dtype=torch.float32),
            shininess=torch.ones((3,), dtype=torch.float32),
        )
        return scene((), spheres=spheres,
                     point_lights=PointLights.of(((3, 0, 3), (15.0, 15.0, 15.0))))
    if name == "custom":
        meshes = load_obj(os.path.join(data_dir, "custom.obj"))
        return scene(meshes, point_lights=PointLights.of(((-1, 1, -1), white)))
    if name in ("teacup", "donut"):
        meshes = [_procedural_teacup() if name == "teacup" else _procedural_donut()]
        center_and_scale_to_unit(meshes)
        return scene(meshes, point_lights=PointLights.of(((-1, 1, -1), white)))
    raise ValueError(f"Unknown scene {name!r}; choose from {SCENE_NAMES}")


def load_standin(name: str, device="cuda") -> Scene:
    """One of ``STANDIN_NAMES`` on ``device`` (the card unless asked for the CPU)."""
    device = entry_device(device)
    from . import standins

    if name == "spherical_teacup":
        meshes = [_procedural_teacup()]
        center_and_scale_to_unit(meshes)
        return make_scene(meshes, device=device,
                          spherical_lights=SphericalLights.of(*standins.SPHERICAL_CUP_LIGHTS))
    if name in ("mirror_box", "spherical_box"):
        lights = (dict(point_lights=PointLights.of(*standins.MIRROR_BOX_LIGHTS))
                  if name == "mirror_box"
                  else dict(spherical_lights=SphericalLights.of(*standins.SPHERICAL_BOX_LIGHTS)))
        return make_scene(standins.mirror_box_meshes(), device=device, **lights)
    raise ValueError(f"Unknown stand-in {name!r}; choose from {STANDIN_NAMES}")
