"""ctypes binding to the host C++ of ``native/``: the median BVH build
(``bvh_builder.cpp``) and the OBJ/MTL parser (``obj_loader.cpp``), the
entry points ``cg_raytracer_tpu/native.py`` binds.

The two sources compile with ``g++ -O3 -fPIC -std=c++17 -shared`` (``$CXX``
overrides the compiler) at first use into ``_build/`` beside this package
(``ops/_build.py::build_dir``), under a name keyed by a hash of the sources
and flags, so an edited source rebuilds.  ``ops/bvh.py::build_bvh`` and
``scene/loader.py::load_obj`` take this path where ``available()`` holds and
keep their numpy and Python versions for a machine without a compiler.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from .ops._build import build_dir

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
SOURCES = ("bvh_builder.cpp", "obj_loader.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_lib = None
_failure = None  # the build's or load's error, raised again on every later call


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(NATIVE_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(build_dir(), f"libcgrt_host_{h.hexdigest()[:16]}.so")


def _compile(path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX") or "g++", *CXX_FLAGS, "-o", tmp,
           *(os.path.join(NATIVE_DIR, name) for name in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed with exit code {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing


def _declare(lib) -> None:
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i32r = ctypes.POINTER(ctypes.c_int32)
    for name, restype, argtypes in (
            # tri_lo, tri_hi, centroids, num_tris, max_depth, max_leaf, then
            # node_lo, node_hi, left, right, first, count, order
            ("cgrt_build_bvh", ctypes.c_int,
             [f32p, f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              f32p, f32p, i32p, i32p, i32p, i32p, i32p]),
            ("cgrt_load_obj", ctypes.c_void_p, [ctypes.c_char_p]),
            ("cgrt_obj_num_meshes", ctypes.c_int, [ctypes.c_void_p]),
            ("cgrt_obj_mesh_sizes", ctypes.c_int, [ctypes.c_void_p, ctypes.c_int, i32r, i32r]),
            ("cgrt_obj_mesh_data", ctypes.c_int,
             [ctypes.c_void_p, ctypes.c_int, f32p, f32p, i32p, f32p]),
            ("cgrt_obj_free", None, [ctypes.c_void_p])):
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def load():
    """The loaded library, built first if this source hash has no build.
    Raises (OSError, RuntimeError, subprocess.TimeoutExpired) when it cannot
    be built or loaded, and again on every later call."""
    global _lib, _failure
    with _lock:
        if _lib is None and _failure is None:
            try:
                path = library_path()
                if not os.path.exists(path):
                    _compile(path)
                lib = ctypes.CDLL(path)
                _declare(lib)
                _lib = lib
            except (OSError, RuntimeError, subprocess.TimeoutExpired) as exc:
                _failure = exc
        if _failure is not None:
            raise _failure
    return _lib


def available() -> bool:
    """Whether the library builds and loads on this machine."""
    try:
        load()
    except (OSError, RuntimeError, subprocess.TimeoutExpired):
        return False
    return True


def native_build_bvh(tri_lo, tri_hi, centroids, max_depth: int, max_leaf: int):
    """The median build in C++: the same tuple as ``ops/bvh.py::_build_numpy``
    (node_lo, node_hi, left, right, first, count, order)."""
    lib = load()
    num_tris = int(tri_lo.shape[0])
    if num_tris <= 0 or max_leaf <= 0:
        raise ValueError(f"native BVH build of {num_tris} triangles, max_leaf {max_leaf}")
    max_nodes = 2 * num_tris + 1
    node_lo = np.zeros((max_nodes, 3), np.float32)
    node_hi = np.zeros((max_nodes, 3), np.float32)
    left = np.full((max_nodes,), -1, np.int32)
    right = np.full((max_nodes,), -1, np.int32)
    first = np.zeros((max_nodes,), np.int32)
    count = np.zeros((max_nodes,), np.int32)
    order = np.arange(num_tris, dtype=np.int32)
    n = lib.cgrt_build_bvh(
        np.ascontiguousarray(tri_lo, np.float32), np.ascontiguousarray(tri_hi, np.float32),
        np.ascontiguousarray(centroids, np.float32), num_tris, int(max_depth), int(max_leaf),
        node_lo, node_hi, left, right, first, count, order)
    if n <= 0:
        raise RuntimeError(f"native BVH build failed (rc={n})")
    return (node_lo[:n], node_hi[:n], left[:n], right[:n], first[:n], count[:n], order)


def native_load_obj(path: str):
    """The C++ OBJ/MTL parse: the list of {vertices, normals, triangles,
    material} dicts of ``scene/loader.py::load_obj``'s Python parser."""
    lib = load()
    handle = lib.cgrt_load_obj(os.fsencode(path))
    if not handle:
        raise RuntimeError(f"native OBJ load failed for {path}")
    try:
        meshes = []
        for i in range(lib.cgrt_obj_num_meshes(handle)):
            nv, nt = ctypes.c_int32(), ctypes.c_int32()
            if lib.cgrt_obj_mesh_sizes(handle, i, ctypes.byref(nv), ctypes.byref(nt)) != 0:
                raise RuntimeError(f"native OBJ mesh query failed for {path}")
            vertices = np.zeros((nv.value, 3), np.float32)
            normals = np.zeros((nv.value, 3), np.float32)
            triangles = np.zeros((nt.value, 3), np.int32)
            material = np.zeros((8,), np.float32)
            if lib.cgrt_obj_mesh_data(handle, i, vertices, normals, triangles, material) != 0:
                raise RuntimeError(f"native OBJ mesh read failed for {path}")
            meshes.append({"vertices": vertices, "normals": normals, "triangles": triangles,
                           "material": {"kd": tuple(float(x) for x in material[0:3]),
                                        "ks": tuple(float(x) for x in material[3:6]),
                                        "shininess": float(material[6]),
                                        "transparency": float(material[7])}})
        return meshes
    finally:
        lib.cgrt_obj_free(handle)
