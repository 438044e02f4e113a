"""Camera: trackball orbit model + vectorized primary-ray generation, with the
conventions of ``cg_raytracer_tpu/ops/camera.py`` (the reference's
``Trackball::generateRay``, trackball.cpp:70-103):

- camera position = lookAt + quat(euler) * (0, 0, -dist),
- camera-space direction = normalize(-px*halfW, py*halfH, 1), note the negated x,
- world direction = quat(euler) * cameraDir,
- NDC of pixel (x, y) = (x/W*2-1, y/H*2-1) at pixel corners, y = 0 at the
  bottom; rays come out in image-row order (row 0 = top), so no flip later.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..scene.types import Camera
from .linalg import cross, normalize

ROTATION_SPEED_DEG_PER_PX = 0.3  # trackball.cpp:13
TRANSLATION_SPEED = 0.005  # trackball.cpp:14
ZOOM_SPEED = 0.5  # trackball.cpp:15


def quat_from_euler(euler):
    """glm::quat(vec3 euler) -> (w, x, y, z) on the last axis."""
    half = euler * 0.5
    c = torch.cos(half)
    s = torch.sin(half)
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]
    w = cx * cy * cz + sx * sy * sz
    x = sx * cy * cz - cx * sy * sz
    y = cx * sy * cz + sx * cy * sz
    z = cx * cy * sz - sx * sy * cz
    return torch.stack([w, x, y, z], dim=-1)


def quat_rotate(q, v):
    """v' = v + 2 * cross(q.xyz, cross(q.xyz, v) + w * v)."""
    w = q[..., :1]
    u = q[..., 1:]
    return v + 2.0 * cross(u, cross(u, v) + w * v)


def camera_position(cam: Camera):
    q = quat_from_euler(cam.euler)
    zero = torch.zeros_like(cam.dist)
    return cam.look_at + quat_rotate(q, torch.stack([zero, zero, -cam.dist]))


def orbit(cam: Camera, delta_px):
    """Left-drag orbit by (dx, dy) pixels (trackball.cpp:138-141): the pitch
    clamped to +-pi/2; a new camera."""
    dx, dy = delta_px
    ex = torch.clamp(cam.euler[0] - math.radians(dy * ROTATION_SPEED_DEG_PER_PX),
                     -math.pi / 2, math.pi / 2)
    ey = cam.euler[1] - math.radians(dx * ROTATION_SPEED_DEG_PER_PX)
    return dataclasses.replace(cam, euler=torch.stack([ex, ey, cam.euler[2]]))


def pan(cam: Camera, delta_px):
    """Right-drag pan by (dx, dy) pixels in the image plane
    (trackball.cpp:143-147)."""
    dx, dy = delta_px
    q = quat_from_euler(cam.euler)
    axes = torch.eye(3, dtype=cam.euler.dtype, device=cam.euler.device)
    left, up = quat_rotate(q, axes[0]), quat_rotate(q, axes[1])
    return dataclasses.replace(
        cam, look_at=cam.look_at + dx * TRANSLATION_SPEED * left - dy * TRANSLATION_SPEED * up)


def zoom(cam: Camera, scroll_y):
    """Scroll zoom (trackball.cpp:152-157): the distance clamped to [0.1, 100]."""
    return dataclasses.replace(cam, dist=torch.clamp(cam.dist - scroll_y * ZOOM_SPEED, 0.1, 100.0))


def generate_ray(cam: Camera, ndc):
    """ndc [..., 2] in [-1, 1]^2 -> (origin [3], dirs [..., 3])."""
    half_h = torch.tan(cam.fovy / 2.0)
    half_w = cam.aspect * half_h
    cam_dir = normalize(torch.stack([-ndc[..., 0] * half_w, ndc[..., 1] * half_h,
                                     torch.ones_like(ndc[..., 0])], dim=-1))
    direction = quat_rotate(quat_from_euler(cam.euler), cam_dir)
    return camera_position(cam), direction


def pixel_ndc(height: int, width: int, offset=(0.0, 0.0), device="cpu"):
    """NDC of each pixel in image-row order, [H, W, 2]: image row r is screen
    row H-1-r (the reference's setPixel y-flip) and pixels are sampled at
    their corners (no +0.5).  ``offset`` shifts by (x, y) pixels."""
    xs = (torch.arange(width, dtype=torch.float32, device=device) + offset[0]) / width * 2.0 - 1.0
    ys = (torch.arange(height - 1, -1, -1, dtype=torch.float32, device=device)
          + offset[1]) / height * 2.0 - 1.0
    px = xs[None, :].expand(height, width)
    py = ys[:, None].expand(height, width)
    return torch.stack([px, py], dim=-1)


def generate_rays(cam: Camera, height: int, width: int, offset=(0.0, 0.0)):
    """Ray grid on the camera's device: (origins [H*W, 3], dirs [H*W, 3])."""
    ndc = pixel_ndc(height, width, offset, device=cam.device).reshape(-1, 2)
    origin, dirs = generate_ray(cam, ndc)
    return origin.expand_as(dirs).contiguous(), dirs
