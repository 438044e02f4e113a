"""Build and load the CUDA kernels of ``csrc/`` (the counterpart of
``cg_raytracer_tpu/native.py``).

The sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded with ``ctypes``: a build takes seconds, where one that
includes PyTorch's headers takes minutes.  The library is built at first use
into ``_build/`` beside this package's sources (``$CGRT_TORCH_BUILD_DIR``
overrides it), under a name keyed by a hash of the sources and flags, so an
edited source rebuilds and a fresh checkout builds everything itself.  A
failed build raises; nothing falls back.

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
SOURCES = ("oracle.cu", "trace.cu", "record.cu", "shade.cu")
HEADERS = ("sweep.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_lib = None


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


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(build_dir(), f"libcgrt_kernels_{h.hexdigest()[:16]}.so")


def _compile(path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(os.path.join(CSRC_DIR, s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    with open(path[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    signatures = {
        "cgrt_closest": [p, p, p, i, p, i, p, p, p, p, p],
        "cgrt_anyhit": [p, p, p, i, p, i, p, p],
        "cgrt_bounce": [p, p, p, i, p, i, p, i, p, p, p, p, p, p],
        "cgrt_trace": [p, p, i, p, i, p, p, i, p, i, i, i, p, p],
        "cgrt_record_trace": [p, p, i, p, i, p, p, i, i, i] + [p] * 8 + [p],
        "cgrt_bounce_refl": [p, p, p, i, p, i, p, p, i, i] + [p] * 8 + [p],
        "cgrt_shade_fwd": [p, p, p, p, i, p, p, i, i, p, i, p, i] + [p] * 4 + [p],
        "cgrt_shade_bwd": [p, p, p, p, i, p, p, i, i, p, i, p, i] + [p] * 10 + [p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cgrt_error_string.argtypes = [i]
    lib.cgrt_error_string.restype = ctypes.c_char_p


def load():
    """The loaded kernel library, built first if this source hash has no build."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _compile(path)
            lib = ctypes.CDLL(path)
            _declare(lib)
            _lib = lib
    return _lib
