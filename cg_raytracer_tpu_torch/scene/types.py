"""Scene data model: flattened structure-of-arrays tensors.

Counterpart of ``cg_raytracer_tpu/scene/types.py``.  Every mesh is merged into
one global buffer: ``vertices [V,3]``, ``normals [V,3]``, ``triangles [T,3]``
(int32) plus a per-triangle material id into a compact material table.  The
containers are dataclasses of tensors; a scene lives on one device, which code
reads from its tensors (``Scene.device``) and never guesses.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


class _Tensors:
    """``to(device)`` for a dataclass whose fields are tensors or such dataclasses."""

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)})


def _f32(x, device):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def entry_device(device) -> torch.device:
    """The device of an entry point (``make_scene``, ``Camera.default``,
    ``load_scene``, ``load_standin``), which defaults to the card: a CUDA
    device where there is none raises; nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: this machine has no CUDA device; pass "
                           f"device='cpu' for the CPU path")
    return dev


@dataclasses.dataclass
class Materials(_Tensors):
    """Compact material table: ``kd``/``ks`` [M,3], ``shininess`` [M],
    ``transparency`` [M] (carried, unused in shading, as in the reference)."""

    kd: torch.Tensor
    ks: torch.Tensor
    shininess: torch.Tensor
    transparency: torch.Tensor

    @staticmethod
    def single(kd=(1.0, 1.0, 1.0), ks=(0.0, 0.0, 0.0), shininess=1.0,
               transparency=1.0, device="cpu"):
        return Materials(kd=_f32([kd], device), ks=_f32([ks], device),
                         shininess=_f32([shininess], device),
                         transparency=_f32([transparency], device))


@dataclasses.dataclass
class PointLights(_Tensors):
    position: torch.Tensor  # [L,3]
    color: torch.Tensor  # [L,3]

    @staticmethod
    def empty(device="cpu"):
        return PointLights(position=_f32(np.zeros((0, 3)), device),
                           color=_f32(np.zeros((0, 3)), device))

    @staticmethod
    def of(*lights, device="cpu"):
        return PointLights(
            position=_f32(np.asarray([p for p, _ in lights], np.float32).reshape(-1, 3), device),
            color=_f32(np.asarray([c for _, c in lights], np.float32).reshape(-1, 3), device))


@dataclasses.dataclass
class SphericalLights(_Tensors):
    position: torch.Tensor  # [L,3]
    radius: torch.Tensor  # [L]
    color: torch.Tensor  # [L,3]

    @staticmethod
    def empty(device="cpu"):
        return SphericalLights(position=_f32(np.zeros((0, 3)), device),
                               radius=_f32(np.zeros((0,)), device),
                               color=_f32(np.zeros((0, 3)), device))

    @staticmethod
    def of(*lights, device="cpu"):
        return SphericalLights(
            position=_f32(np.asarray([p for p, _, _ in lights], np.float32).reshape(-1, 3), device),
            radius=_f32(np.asarray([r for _, r, _ in lights], np.float32).reshape(-1), device),
            color=_f32(np.asarray([c for _, _, c in lights], np.float32).reshape(-1, 3), device))


@dataclasses.dataclass
class Spheres(_Tensors):
    """Sphere primitives with inline materials."""

    center: torch.Tensor  # [S,3]
    radius: torch.Tensor  # [S]
    kd: torch.Tensor  # [S,3]
    ks: torch.Tensor  # [S,3]
    shininess: torch.Tensor  # [S]

    @staticmethod
    def empty(device="cpu"):
        z3, z1 = np.zeros((0, 3)), np.zeros((0,))
        return Spheres(center=_f32(z3, device), radius=_f32(z1, device),
                       kd=_f32(z3, device), ks=_f32(z3, device),
                       shininess=_f32(z1, device))


@dataclasses.dataclass
class Scene(_Tensors):
    """All meshes merged into global buffers; ``tri_material`` maps each
    triangle to a row of ``materials``."""

    vertices: torch.Tensor  # [V,3] f32
    normals: torch.Tensor  # [V,3] f32 (vertex normals)
    triangles: torch.Tensor  # [T,3] i32
    tri_material: torch.Tensor  # [T] i32
    materials: Materials
    spheres: Spheres
    point_lights: PointLights
    spherical_lights: SphericalLights

    @property
    def num_triangles(self) -> int:
        return self.triangles.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vertices.device


@dataclasses.dataclass
class Camera(_Tensors):
    """Trackball camera: ``look_at`` [3], ``euler`` [3] radians (glm::quat
    Euler convention), ``dist``, ``fovy`` (radians) and ``aspect`` scalars.
    Defaults match the reference: fovy 50 deg, dist 3, rotation (20, 20, 0) deg."""

    look_at: torch.Tensor
    euler: torch.Tensor
    dist: torch.Tensor
    fovy: torch.Tensor
    aspect: torch.Tensor

    @staticmethod
    def default(look_at=(0.0, 0.0, 0.0), euler_deg=(20.0, 20.0, 0.0), dist=3.0,
                fovy_deg=50.0, aspect=1.0, device="cuda"):
        # Radians are taken in float64 and rounded once to float32, as the
        # JAX package does, so both packages aim the same rays.
        device = entry_device(device)
        return Camera(
            look_at=_f32(look_at, device),
            euler=_f32(np.radians(np.asarray(euler_deg, np.float64)), device),
            dist=_f32(dist, device),
            fovy=_f32(np.radians(fovy_deg), device),
            aspect=_f32(aspect, device),
        )

    @property
    def device(self) -> torch.device:
        return self.look_at.device


def merge_meshes(meshes):
    """Flatten a list of mesh dicts ('vertices' [V,3], 'normals' [V,3],
    'triangles' [T,3], 'material' dict) into numpy buffers plus a CPU
    ``Materials`` table, one material row per mesh."""
    verts, norms, tris, tri_mat = [], [], [], []
    kd, ks, shin, trans = [], [], [], []
    v_off = 0
    for mi, m in enumerate(meshes):
        v = np.asarray(m["vertices"], np.float32)
        t = np.asarray(m["triangles"], np.int32)
        verts.append(v)
        norms.append(np.asarray(m["normals"], np.float32))
        tris.append(t + v_off)
        tri_mat.append(np.full((t.shape[0],), mi, np.int32))
        mat = m["material"]
        kd.append(mat.get("kd", (1.0, 1.0, 1.0)))
        ks.append(mat.get("ks", (0.0, 0.0, 0.0)))
        shin.append(mat.get("shininess", 1.0))
        trans.append(mat.get("transparency", 1.0))
        v_off += v.shape[0]
    if not meshes:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
                np.zeros((0, 3), np.int32), np.zeros((0,), np.int32),
                Materials.single())
    materials = Materials(kd=_f32(kd, "cpu"), ks=_f32(ks, "cpu"),
                          shininess=_f32(shin, "cpu"),
                          transparency=_f32(trans, "cpu"))
    return (np.concatenate(verts), np.concatenate(norms), np.concatenate(tris),
            np.concatenate(tri_mat), materials)


def make_scene(meshes=(), spheres=None, point_lights=None, spherical_lights=None,
               device="cuda") -> Scene:
    """Build a Scene on ``device`` (the card unless asked for the CPU) from
    mesh dicts and light/sphere containers (which are moved to ``device``)."""
    device = entry_device(device)
    v, n, t, tm, materials = merge_meshes(list(meshes))
    return Scene(
        vertices=torch.as_tensor(v, device=device),
        normals=torch.as_tensor(n, device=device),
        triangles=torch.as_tensor(t, device=device),
        tri_material=torch.as_tensor(tm, device=device),
        materials=materials.to(device),
        spheres=(spheres if spheres is not None else Spheres.empty()).to(device),
        point_lights=(point_lights if point_lights is not None
                      else PointLights.empty()).to(device),
        spherical_lights=(spherical_lights if spherical_lights is not None
                          else SphericalLights.empty()).to(device),
    )
