"""The one traffic generator: it reads a mix's data file
(``benchmark/traffic/<mix>.json``) and the seed, and makes the inputs of a
run: the camera path of an orbit, the frames and pixels checked, the
perturbed target of a fit.  Every input comes from the seed alone.

The orbit's drag rule is upstream's trackball (trackball.cpp:138-141; a
frozen copy of ``cg_raytracer_tpu_torch/ops/camera.py::orbit`` at commit
3c561914e6c9): a left drag of (dx, dy) pixels turns the pitch by -0.3 dy
degrees, clamped to +-90, and the yaw by -0.3 dx degrees.  The drags walk a
closed figure-eight around the start, yaw +-``yaw_deg`` and pitch
+-``pitch_deg``, in ``period`` steps of at most ``max_px`` pixels on each
axis; the seed picks where on the loop the walk starts and which way it
goes.  So every seed renders the same poses in another order, and a
window of many loops does the same work whatever the seed.
"""
from __future__ import annotations

import math

import numpy as np

DEG_PER_PX = 0.3  # trackball.cpp:13


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one purpose (``stream``) of a run's seed."""
    return np.random.Generator(np.random.PCG64([int(seed) % (1 << 64), int(stream)]))


def orbit_rule(euler_deg, drag_px):
    """One drag step: (pitch, yaw, roll) in degrees after a drag (dx, dy)."""
    dx, dy = drag_px
    pitch = min(max(euler_deg[0] - dy * DEG_PER_PX, -90.0), 90.0)
    return (pitch, euler_deg[1] - dx * DEG_PER_PX, euler_deg[2])


def loop_drags(path: dict) -> np.ndarray:
    """The drags [period, 2] (dx, dy) in pixels that walk the figure-eight
    once: yaw = Y sin(theta), pitch = P sin(2 theta)."""
    n = int(path["period"])
    theta = 2.0 * math.pi * np.arange(n + 1) / n
    yaw = path["yaw_deg"] * np.sin(theta)
    pitch = path["pitch_deg"] * np.sin(2.0 * theta)
    drags = np.stack([-np.diff(yaw), -np.diff(pitch)], axis=1) / DEG_PER_PX
    limit = float(path["max_px"])
    if np.abs(drags).max() > limit + 1e-9:
        raise ValueError(f"a drag step of {np.abs(drags).max():.3f} px exceeds {limit} px")
    return drags


def loop_poses(start_deg, path: dict) -> np.ndarray:
    """The Euler angles [period, 3] (radians, float32) of the loop's poses,
    each the drag rule applied to the one before, from ``start_deg``."""
    pose = tuple(float(x) for x in start_deg)
    poses = []
    for drag in loop_drags(path):
        poses.append(pose)
        pose = orbit_rule(pose, drag)
    return np.radians(np.asarray(poses, np.float64)).astype(np.float32)


class Orbit:
    """Frame i's pose is ``poses[(start + step * i) % period]``."""

    def __init__(self, start_deg, path: dict, seed: int):
        self.poses = loop_poses(start_deg, path)
        g = rng(seed, 1)
        self.period = self.poses.shape[0]
        self.start = int(g.integers(self.period))
        self.step = 1 if g.integers(2) else -1

    def index(self, i: int) -> int:
        return (self.start + self.step * i) % self.period


def checked_frames(compare: dict, seed: int) -> list:
    """The frame indices whose images are compared (drawn from the seed in
    [0, ``within``)); the window's last frame is compared as well."""
    g = rng(seed, 2)
    return sorted(int(i) for i in g.choice(int(compare["within"]), int(compare["frames"]),
                                           replace=False))


def checked_pixels(compare: dict, seed: int, frame: int, width: int, height: int,
                   num_tris: int, max_depth: int, shadow_rays: int = 0):
    """Raster indices of the pixels compared in a frame: as many as keep a
    brute-force pass over them (each level's ray, and each of its
    ``shadow_rays`` spherical-light samples, against every triangle) under
    ``full_frame_work`` triangle tests, and at least ``pixels``, drawn from
    the seed; None means every pixel."""
    per_pixel = num_tris * max_depth * (1 + shadow_rays)
    count = max(int(compare["pixels"]), int(float(compare["full_frame_work"]) // per_pixel))
    if count >= width * height:
        return None
    g = rng(seed, 1000 + frame)
    return np.sort(g.choice(width * height, count, replace=False))


def perturbed(values: np.ndarray, scale: float, seed: int) -> np.ndarray:
    """``values`` times (1 + scale u), u uniform in [-1, 1) from the seed,
    clamped to [0, 1]: the target of a fit."""
    u = rng(seed, 3).uniform(-1.0, 1.0, size=values.shape)
    return np.clip(values * (1.0 + scale * u), 0.0, 1.0).astype(np.float32)


def key_seed(seed: int) -> int:
    """The seed of the ``torch.Generator`` from which each frame draws its
    sample key."""
    return int(rng(seed, 4).integers(1 << 62))
