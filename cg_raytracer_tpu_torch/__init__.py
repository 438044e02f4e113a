"""cg_raytracer_tpu_torch: the PyTorch + CUDA port of ``cg_raytracer_tpu``.

The forward render with anti-aliasing, bloom and motion blur
(``ops/effects.py``), the training step (render, loss, backward through the
two-phase gradient structure) and inverse rendering (``optim/inverse.py``)
of scenes up to 113,025,455 triangles (a 4-wide BVH past 256, refit when
vertices move; ``ops/bvh4.py::MAX_TRIS``), point and spherical lights and up to 16 spheres run end to
end on an NVIDIA Hopper card through hand-written CUDA kernels (``csrc/``,
wrapped in ``ops/``).  The debug front ends (``utils/debug.py``: debug rays,
hit buffers, BVH levels) and the profiling helpers (``utils/profiling.py``)
sit beside them; trees and OBJ files are built and parsed on the host in C++
(``native.py``).  ``parallel/`` spreads renders and training over ranks of
``torch.distributed`` (rows, soft-shadow samples, or the triangles).  Public layouts follow the JAX package: rays are [N, 3]
float32, a ``Hit`` is (t, prim_id, u, v), images are [H, W, 3] float32.
This package imports no JAX.
"""

from .models.whitted import make_backend, render, render_image, trace_rays
from .ops.bvh import BVH, build_bvh
from .ops.camera import generate_ray, generate_rays
from .scene.presets import SCENE_NAMES, load_scene
from .scene.types import (Camera, Materials, PointLights, Scene, SphericalLights, Spheres,
                          make_scene)
from .utils.config import RenderConfig

__version__ = "0.1.0"

__all__ = [
    "render", "render_image", "make_backend", "trace_rays", "BVH", "build_bvh",
    "generate_ray", "generate_rays", "SCENE_NAMES", "load_scene", "Camera", "Materials",
    "PointLights", "Scene", "SphericalLights", "Spheres", "make_scene", "RenderConfig",
    "__version__",
]
