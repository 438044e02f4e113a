"""cg_raytracer_tpu_torch: the PyTorch + CUDA port of ``cg_raytracer_tpu``.

The forward render and the training step (render, loss, backward through
the two-phase gradient structure) of small scenes (up to 256 triangles,
point lights, up to 16 spheres) run end to end on an NVIDIA Hopper card
through eight hand-written CUDA kernels (``ops/cuda_kernels.py``,
``ops/shade.py``).  Public layouts follow the JAX package: rays are [N, 3]
float32, a ``Hit`` is (t, prim_id, u, v), images are [H, W, 3] float32.  This
package imports no JAX.
"""

from .models.whitted import make_backend, render, render_image, trace_rays
from .ops.camera import generate_ray, generate_rays
from .scene.presets import SCENE_NAMES, load_scene
from .scene.types import (Camera, Materials, PointLights, Scene, SphericalLights, Spheres,
                          make_scene)
from .utils.config import RenderConfig

__version__ = "0.1.0"

__all__ = [
    "render", "render_image", "make_backend", "trace_rays", "generate_ray",
    "generate_rays", "SCENE_NAMES", "load_scene", "Camera", "Materials", "PointLights",
    "Scene", "SphericalLights", "Spheres", "make_scene", "RenderConfig", "__version__",
]
