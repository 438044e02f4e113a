"""Build and load the CUDA kernels of ``csrc/`` (the counterpart of
``cg_raytracer_tpu/native.py``).

The sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded with ``ctypes``: a build takes seconds, where one that
includes PyTorch's headers takes minutes.  Each source compiles to an object
in its own ``nvcc`` process, all started together, and one more ``nvcc``
links them.  The library is built at first use into ``_build/`` beside this
package's sources (``$CGRT_TORCH_BUILD_DIR`` overrides it), under a name
keyed by a hash of the sources and flags, so an edited source rebuilds and a
fresh checkout builds everything itself.  A failed build raises; nothing
falls back.

Flags: ``sm_90a`` (Hopper); no ``--use_fast_math``, which would change sqrt,
division and pow; ``-fmad=false``, so each multiply and add rounds as the
plain PyTorch versions' separate operations do and the kernels agree with
them to the bit outside of ``pow``.  ``-Xptxas=-v`` writes each kernel's
registers and spills to a ``.log`` beside the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCES = ("oracle.cu", "trace.cu", "record.cu", "shade.cu", "bvh4.cu", "soft.cu",
           "bloom.cu", "level.cu")
HEADERS = ("sweep.cuh", "bvh4.cuh")
# A check of the sample stream against the toolkit's curand Philox, built into
# a library of its own (``load_check``) that only on-card checks load.
CHECK_SOURCES = ("philox_check.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_check_lock = threading.Lock()
_lib = None
_check_lib = None


def build_dir() -> str:
    return os.environ.get("CGRT_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(CSRC_DIR), "_build")


def _nvcc() -> str:
    candidates = [os.path.join(os.environ[v], "bin", "nvcc")
                  for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for cand in candidates:
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, PATH and "
                       "/usr/local/cuda); the CUDA kernels cannot be built")


def library_path(sources=SOURCES, stem="libcgrt_kernels") -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sources + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(build_dir(), f"{stem}_{h.hexdigest()[:16]}.so")


def _run(procs) -> str:
    """Wait for every (cmd, Popen); raise on the first failure; the output."""
    out = []
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            for _, other in procs:
                other.kill()
            raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{stdout}{stderr}")
        out.append(stdout + stderr)
    return "".join(out)


def _compile(path: str, sources=SOURCES) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{name}.o" for name in sources]
    nvcc = _nvcc()
    try:
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC_DIR, name)]
                    for name, obj in zip(sources, objs)]
        log = _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True)) for cmd in compiles])
        link = [nvcc, "-shared", "-o", tmp, *objs]
        log += _run([(link, subprocess.Popen(link, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE, text=True))])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    with open(path[:-3] + ".log", "w") as f:
        f.write(log)
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing


_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
# The entry points' argtypes (pointers and the stream as c_void_p; all return int).
SIGNATURES = {
    "cgrt_closest": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P],
    "cgrt_anyhit": [_P, _P, _P, _I, _P, _I, _P, _P],
    "cgrt_bounce": [_P, _P, _P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P],
    "cgrt_trace": [_P, _P, _I, _P, _I, _P, _P, _I, _P, _I, _I, _I, _P, _P],
    "cgrt_record_trace": [_P, _P, _I, _P, _I, _P, _P, _I, _I, _I] + [_P] * 8 + [_P],
    "cgrt_bounce_refl": [_P, _P, _P, _I, _P, _I, _P, _P, _I, _I] + [_P] * 8 + [_P],
    "cgrt_shade_fwd": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _P, _I, _P, _I, _P, _I, _P]
    + [_P] * 4 + [_P],
    "cgrt_shade_bwd": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _P, _I, _P, _I, _P, _I, _P]
    + [_P] * 11 + [_P],
    "cgrt_shade_pre_fwd": [_P, _P, _P, _P, _I, _P, _I, _P, _I, _P, _I, _P, _I, _P, _I, _P]
    + [_P] * 4 + [_P],
    "cgrt_shade_pre_bwd": [_P, _P, _P, _P, _I, _P, _I, _P, _I, _P, _I, _P, _I, _P, _I, _P]
    + [_P] * 11 + [_P],
    "cgrt_bvh4_closest": [_P, _P, _P, _I, _I] + [_P] * 3 + [_P] * 4 + [_P],
    "cgrt_bvh4_anyhit": [_P, _P, _P, _I, _I] + [_P] * 3 + [_P] + [_P],
    "cgrt_bvh4_bounce": [_P, _P, _P, _I, _I] + [_P] * 3 + [_P, _I] + [_P] * 5 + [_P],
    "cgrt_soft_brute": [_P, _P, _P, _I, _P, _P, _I, _I, _P, _U, _P, _P] + [_P],
    "cgrt_soft_bvh4": [_P, _P, _P, _I, _P, _I, _P, _P, _I, _P, _U, _P, _P] + [_P],
    "cgrt_bloom_quirk": [_P, _I, _I] + [_P],
    "cgrt_bloom_quirk_adjoint": [_P, _P, _I, _I] + [_P],
    # csrc/level.cu: a pointer to its LevelArgs (ops/level.py::_Args), the stream.
    "cgrt_level": [_P, _P],
    "cgrt_level_surface": [_P, _P],
    "cgrt_level_shade": [_P, _P],
}


def declare(lib, signatures=SIGNATURES) -> None:
    """Set the argtypes and int return type of ``lib``'s entry points."""
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


def load():
    """The loaded kernel library, built first if this source hash has no build."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _compile(path)
            lib = ctypes.CDLL(path)
            declare(lib)
            lib.cgrt_error_string.argtypes = [ctypes.c_int]
            lib.cgrt_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def load_check():
    """The library of ``CHECK_SOURCES`` (``cgrt_check_philox``,
    ``cgrt_check_sincos``), built first
    if needed.  It has its own lock, so it builds beside ``load``'s build."""
    global _check_lib
    with _check_lock:
        if _check_lib is None:
            path = library_path(CHECK_SOURCES, "libcgrt_checks")
            if not os.path.exists(path):
                _compile(path, CHECK_SOURCES)
            lib = ctypes.CDLL(path)
            lib.cgrt_check_philox.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_void_p, ctypes.c_void_p]
            lib.cgrt_check_philox.restype = ctypes.c_int
            lib.cgrt_check_sincos.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.cgrt_check_sincos.restype = ctypes.c_int
            _check_lib = lib
    return _check_lib
