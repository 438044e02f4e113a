"""OBJ/MTL loader, as cg_raytracer_tpu/scene/loader.py: the C++ parser of
``native/obj_loader.cpp`` (``native.py``) where the host library builds, and
this module's Python parser, its specification, on a machine without a compiler.

Reference capability: assimp import with ``aiProcess_GenNormals | aiProcess_Triangulate``
(``src/mesh.cpp:58-141``).  This loader reproduces the semantics the
reference relies on without the assimp dependency:

- fan-triangulation of polygon faces (``aiProcess_Triangulate``),
- one output mesh per ``usemtl`` group (assimp splits OBJ meshes per material, which is
  why the Cornell box yields 8 meshes, each with its own ``Material``),
- flat per-face normals generated when the file provides none
  (``aiProcess_GenNormals`` generates face normals, *not* smoothed vertex normals),
- vertices deduplicated per unique (position-index, normal-index) pair within a
  material group (assimp builds a fresh vertex buffer per index combination),
- MTL ``Kd``/``Ks``/``Ns``/``d`` -> kd/ks/shininess/transparency
  (``mesh.cpp:124-127``),
- optional center-and-scale-to-unit-sphere over *all* meshes jointly
  (``centerAndScaleToUnitMesh``, ``mesh.cpp:143-166``).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from .. import native

DEFAULT_MATERIAL = {
    "kd": (0.6, 0.6, 0.6),
    "ks": (0.0, 0.0, 0.0),
    "shininess": 1.0,
    "transparency": 1.0,
}


def load_mtl(path: str) -> Dict[str, dict]:
    """Parse a .mtl file into {material_name: material_dict}."""
    materials: Dict[str, dict] = {}
    cur: Optional[dict] = None
    if not os.path.exists(path):
        return materials
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                cur = dict(DEFAULT_MATERIAL)
                materials[parts[1] if len(parts) > 1 else ""] = cur
            elif cur is None:
                continue
            elif key == "Kd" and len(parts) >= 4:
                cur["kd"] = tuple(float(x) for x in parts[1:4])
            elif key == "Ks" and len(parts) >= 4:
                cur["ks"] = tuple(float(x) for x in parts[1:4])
            elif key == "Ns" and len(parts) >= 2:
                cur["shininess"] = float(parts[1])
            elif key == "d" and len(parts) >= 2:
                cur["transparency"] = float(parts[1])
    return materials


def _parse_index(tok: str, count: int) -> int:
    """OBJ indices are 1-based; negative indices are relative to the end."""
    i = int(tok)
    return i - 1 if i > 0 else count + i


class _MeshGroup:
    """Accumulates one output mesh (per material group)."""

    def __init__(self, material: dict):
        self.material = material
        self.vert_map: Dict[tuple, int] = {}
        self.positions: List[np.ndarray] = []
        self.normals: List[np.ndarray] = []
        self.triangles: List[tuple] = []

    def add_vertex(self, pos, normal, key=None) -> int:
        if key is not None and key in self.vert_map:
            return self.vert_map[key]
        idx = len(self.positions)
        self.positions.append(pos)
        self.normals.append(normal)
        if key is not None:
            self.vert_map[key] = idx
        return idx

    def finish(self) -> Optional[dict]:
        if not self.triangles:
            return None
        return {
            "vertices": np.asarray(self.positions, np.float32).reshape(-1, 3),
            "normals": np.asarray(self.normals, np.float32).reshape(-1, 3),
            "triangles": np.asarray(self.triangles, np.int32).reshape(-1, 3),
            "material": self.material,
        }


def load_obj(path: str, normalize: bool = False,
             use_native: Optional[bool] = None) -> List[dict]:
    """Load an OBJ file into a list of mesh dicts (one per material group).

    Mirrors ``loadMesh(path, normalize)`` (``src/mesh.cpp:58``).
    Returns list of {vertices, normals, triangles, material}.

    ``use_native``: True parses in C++ (``native.native_load_obj``), False
    in Python, None (default) in C++ where the library builds, else in
    Python; a file the C++ parser refuses (unreadable, no triangles) then
    goes to the Python parser, which raises saying why.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(f"Mesh file {path} does not exist.")
    if use_native or (use_native is None and native.available()):
        try:
            meshes = native.native_load_obj(path)
            if normalize:
                center_and_scale_to_unit(meshes)
            return meshes
        except RuntimeError:
            if use_native:
                raise

    positions: List[tuple] = []
    file_normals: List[tuple] = []
    materials: Dict[str, dict] = {}
    groups: Dict[str, _MeshGroup] = {}
    order: List[str] = []

    def group_for(mat_name: str) -> _MeshGroup:
        if mat_name not in groups:
            mat = materials.get(mat_name, dict(DEFAULT_MATERIAL))
            groups[mat_name] = _MeshGroup(mat)
            order.append(mat_name)
        return groups[mat_name]

    cur_mat = ""
    objdir = os.path.dirname(os.path.abspath(path))

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v" and len(parts) >= 4:
                positions.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif key == "vn" and len(parts) >= 4:
                file_normals.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif key == "mtllib" and len(parts) >= 2:
                materials.update(load_mtl(os.path.join(objdir, " ".join(parts[1:]))))
            elif key == "usemtl":
                cur_mat = parts[1] if len(parts) > 1 else ""
            elif key == "f" and len(parts) >= 4:
                b = group_for(cur_mat)
                corners = []
                has_normals = True
                for tok in parts[1:]:
                    comps = tok.split("/")
                    vi = _parse_index(comps[0], len(positions))
                    vni = None
                    if len(comps) >= 3 and comps[2]:
                        vni = _parse_index(comps[2], len(file_normals))
                    else:
                        has_normals = False
                    corners.append((vi, vni))
                if has_normals:
                    idxs = [
                        b.add_vertex(positions[vi], file_normals[vni], key=(vi, vni))
                        for vi, vni in corners
                    ]
                else:
                    # aiProcess_GenNormals: flat face normal; fresh vertices so the
                    # flat normal never bleeds across faces.
                    p = [np.asarray(positions[vi], np.float32) for vi, _ in corners]
                    fn = np.cross(p[1] - p[0], p[2] - p[0])
                    ln = np.linalg.norm(fn)
                    fn = fn / ln if ln > 0 else np.array([0.0, 1.0, 0.0], np.float32)
                    idxs = [b.add_vertex(pi, fn, key=None) for pi in p]
                # Fan triangulation (aiProcess_Triangulate).
                for k in range(1, len(idxs) - 1):
                    b.triangles.append((idxs[0], idxs[k], idxs[k + 1]))

    meshes = [m for name in order if (m := groups[name].finish()) is not None]
    if not meshes:
        raise ValueError(f"No triangles found in {path}")

    if normalize:
        center_and_scale_to_unit(meshes)
    return meshes


def center_and_scale_to_unit(meshes: List[dict]) -> None:
    """In-place: subtract the joint vertex centroid, divide by max distance from it.

    Parity with ``centerAndScaleToUnitMesh`` (``src/mesh.cpp:143-166``):
    the center is the mean over *all* vertices of *all* meshes (duplicates included),
    and the scale is the max Euclidean distance from that center.
    """
    all_pos = np.concatenate([m["vertices"] for m in meshes], axis=0)
    center = all_pos.mean(axis=0)
    max_d = float(np.max(np.linalg.norm(all_pos - center, axis=1)))
    for m in meshes:
        m["vertices"] = ((m["vertices"] - center) / max_d).astype(np.float32)
