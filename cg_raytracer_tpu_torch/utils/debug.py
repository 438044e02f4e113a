"""Debug data, as ``cg_raytracer_tpu/utils/debug.py``: the headless stand-in
for the reference's interactive debug draw (the R-key debug ray,
main.cpp:742-762, draw.cpp:159-180; the per-level BVH view,
bounding_volume_hierarchy.cpp:469-525).  Each function returns numpy arrays
on the host.  ``debug_trace`` and ``hit_statistics`` query the backend's
closest-hit and any-hit oracles (on the card: the kernels); the BVH views
project the binary tree's boxes in numpy.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..models.whitted import Backend, make_backend, render
from ..ops import camera as cam_ops
from ..ops.bvh import build_bvh, node_depths
from ..ops.intersect import reconstruct_hit
from ..ops.linalg import dot, norm, safe_normalize
from ..scene.types import Camera, Scene
from .config import RenderConfig


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


@torch.no_grad()
def debug_trace(scene: Scene, camera: Camera, ndc, cfg: Optional[RenderConfig] = None,
                backend: Optional[Backend] = None) -> Dict:
    """One debug ray (or a batch: ``ndc`` [2] or [N, 2]) and its fate, per
    bounce level: origin, direction, hit mask, t, prim id, position, normal,
    and per point light whether the shadow ray is blocked; what the
    reference draws as coloured lines (main.cpp:747-753)."""
    cfg = cfg or RenderConfig()
    if backend is None:
        backend = make_backend(scene, cfg)
    ndc = torch.atleast_2d(torch.as_tensor(ndc, dtype=torch.float32, device=camera.device))
    origin, dirs = cam_ops.generate_ray(camera, ndc)
    o, d = origin.expand_as(dirs).contiguous(), dirs
    out = {"levels": []}
    for _ in range(cfg.max_depth):
        hit = backend.closest(o, d)
        surf = reconstruct_hit(scene, o, d, hit)
        info = {"origin": _np(o), "direction": _np(d), "hit": _np(surf.valid), "t": _np(hit.t),
                "prim_id": _np(hit.prim_id), "position": _np(surf.position),
                "normal": _np(surf.normal), "shadowed_by_light": []}
        for lpos in scene.point_lights.position:
            to_light = lpos - surf.position
            ldir = safe_normalize(to_light)
            blocked = backend.occluded((surf.position + 1e-3 * ldir).contiguous(),
                                       ldir.contiguous(), (norm(to_light) - 1e-3).contiguous())
            info["shadowed_by_light"].append(_np(blocked & surf.valid))
        out["levels"].append(info)
        refl = safe_normalize(d - 2.0 * dot(d, surf.normal)[:, None] * surf.normal)
        o, d = (surf.position + 1e-3 * refl).contiguous(), refl.contiguous()
    return out


@torch.no_grad()
def hit_statistics(scene: Scene, camera: Camera, cfg: RenderConfig,
                   backend: Optional[Backend] = None) -> Dict:
    """The camera rays' closest hits as [H, W] arrays: hit mask, t, prim id,
    u, v."""
    if backend is None:
        backend = make_backend(scene, cfg)
    origins, dirs = cam_ops.generate_rays(camera, cfg.height, cfg.width)
    hit = backend.closest(origins, dirs)
    shape = (cfg.height, cfg.width)
    return {"hit": _np(hit.prim_id >= 0).reshape(shape), "t": _np(hit.t).reshape(shape),
            "prim_id": _np(hit.prim_id).reshape(shape), "u": _np(hit.u).reshape(shape),
            "v": _np(hit.v).reshape(shape)}


_EDGES = ((0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6), (3, 7), (4, 5), (4, 6), (5, 7),
          (6, 7))


def render_bvh_levels(scene: Scene, camera: Camera, level: int, width: int = 400,
                      height: int = 400, bvh=None, base=None) -> np.ndarray:
    """One level of the binary BVH (``ops/bvh.py``; built when None) as
    wireframe boxes over a dimmed render (the reference's debugDraw slider,
    bvh.cpp:469-525, main.cpp:805-807) -> [H, W, 3] float32: inner nodes red,
    leaves green, over 0.5 x ``base`` (a render at width x height when
    None)."""
    if bvh is None:
        bvh = build_bvh(scene)
    lo, hi, is_leaf = bvh_level_boxes(bvh, level)
    if base is None:
        base = render(scene, camera, RenderConfig(width=width, height=height))
    if isinstance(base, torch.Tensor):
        base = _np(base)
    img = 0.5 * np.asarray(base, np.float32).copy()

    # Forward projection (the inverse of generate_ray): world -> camera space
    # by the conjugate quaternion, then ndc = (-x / (z half_w), y / (z half_h)).
    cam = camera.to("cpu")
    q = cam_ops.quat_from_euler(cam.euler)
    q_conj = q * torch.tensor([1.0, -1.0, -1.0, -1.0])
    cam_pos = cam_ops.camera_position(cam)
    half_h = float(np.tan(float(cam.fovy) / 2.0))
    half_w = float(cam.aspect) * half_h

    def project(pts):  # [K, 3] world -> (cols, rows, in_front) in pixels
        pc = _np(cam_ops.quat_rotate(q_conj, torch.from_numpy(pts) - cam_pos))
        z = np.maximum(pc[:, 2], 1e-6)
        cols = (-pc[:, 0] / (z * half_w) + 1.0) / 2.0 * width
        rows = height - 1 - (pc[:, 1] / (z * half_h) + 1.0) / 2.0 * height
        return cols, rows, pc[:, 2] > 1e-4

    for b_lo, b_hi, leaf in zip(lo, hi, is_leaf):
        corners = np.array([[b_hi[0] if k & 1 else b_lo[0], b_hi[1] if k & 2 else b_lo[1],
                             b_hi[2] if k & 4 else b_lo[2]] for k in range(8)], np.float32)
        cols, rows, ok = project(corners)
        color = np.array([0.1, 0.9, 0.2] if leaf else [0.9, 0.2, 0.1], np.float32)
        for a, b in _EDGES:
            if not (ok[a] and ok[b]):
                continue
            steps = int(max(abs(cols[b] - cols[a]), abs(rows[b] - rows[a]), 1))
            t = np.linspace(0.0, 1.0, min(steps + 1, 4 * max(width, height)))
            cs = np.clip(cols[a] + t * (cols[b] - cols[a]), 0, width - 1).astype(int)
            rs = np.clip(rows[a] + t * (rows[b] - rows[a]), 0, height - 1).astype(int)
            img[rs, cs] = 0.35 * img[rs, cs] + 0.65 * color
    return img


def bvh_level_boxes(bvh, level: int):
    """(lo [K, 3], hi [K, 3], is_leaf [K]) of the nodes at ``level`` of a
    binary BVH (the data of the reference's per-level view)."""
    sel = node_depths(bvh) == level
    return _np(bvh.node_lo)[sel], _np(bvh.node_hi)[sel], (_np(bvh.count) > 0)[sel]
