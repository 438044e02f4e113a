"""The orbit mix: an interactive user drags the trackball, and each frame
is one ``render()`` call of the program (its default route: a replay of
the frame's CUDA graph), waited for before the next (a closed loop, one
frame at a time, as upstream's window redraws).

The window renders frames until ``--seconds`` have passed.  Each frame is
timed by CUDA events from just before the ``render()`` call to just after
it returns, synchronised, so a frame's time runs from the call until its
image is complete on the card; the host's span of the call alone is kept
beside it.  The checked frames' images (drawn from the seed, and the
window's last) are held as the program returned them and compared with the
plain reference once the window has closed.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from . import tracing, traffic

TOL_ABS = 1e-4  # a pixel is off where a channel differs by more than this
TOL_REL = 1e-4  # ... plus this share of the reference's brightest channel there


def sync(device) -> None:
    """Wait for the card's queued work (nothing on the CPU)."""
    if str(device) != "cpu":
        import torch

        torch.cuda.synchronize()


def _lights(config):
    pl = tuple((tuple(p), tuple(c)) for p, c in config.get("point_lights", []))
    sl = tuple((tuple(p), float(r), tuple(c)) for p, r, c in config.get("spherical_lights", []))
    return pl, sl


class OrbitRun:
    def __init__(self, config: dict, mix: dict, limits: dict, seed: int, geometry,
                 device="cuda"):
        self.config, self.mix, self.seed, self.device = config, mix, int(seed), device
        self.limits = limits
        self.meshes = geometry()
        res = mix.get("resolution") or [config["width"], config["height"]]
        self.width, self.height = int(res[0]), int(res[1])
        fx = mix.get("effects", {})
        self.fx = {k: bool(fx.get(k, False))
                   for k in ("anti_aliasing", "bloom", "reference_quirks")}
        self.orbit = traffic.Orbit(config["camera"]["euler_deg"], mix["path"], self.seed)
        self.checked = traffic.checked_frames(mix["compare"], self.seed)
        self.kept: dict = {}
        self.frames = 0
        self.traces: list = []
        self.segment_frames: list = []

    # -- the program --------------------------------------------------------

    def setup(self) -> None:
        import torch

        from cg_raytracer_tpu_torch import RenderConfig
        from cg_raytracer_tpu_torch import render as port_render
        from cg_raytracer_tpu_torch.scene.types import (Camera, PointLights, SphericalLights,
                                                        make_scene)

        self.torch, self.render = torch, port_render
        pl, sl = _lights(self.config)
        self.scene = make_scene(self.meshes, point_lights=PointLights.of(*pl) if pl else None,
                                spherical_lights=SphericalLights.of(*sl) if sl else None,
                                device=self.device)
        self.cfg = RenderConfig(width=self.width, height=self.height,
                                max_depth=int(self.config["max_depth"]),
                                soft_shadow_samples=int(self.config["soft_shadow_samples"]),
                                **self.fx)
        cam = self.config["camera"]
        self.base = Camera.default(look_at=tuple(cam["look_at"]), euler_deg=tuple(cam["euler_deg"]),
                                   dist=float(cam["dist"]), fovy_deg=float(cam["fovy_deg"]),
                                   aspect=self.width / self.height, device=self.device)
        self.poses = torch.as_tensor(self.orbit.poses, device=self.device)
        self.cameras = [dataclasses.replace(self.base, euler=self.poses[k])
                        for k in range(self.orbit.period)]
        warm = torch.Generator().manual_seed(0)
        t_end = time.perf_counter() + float(self.mix["warmup_s"])
        i = 0
        while i < int(self.mix["warmup_frames"]) or time.perf_counter() < t_end:
            self.render(self.scene, self.camera(-1 - i), self.cfg, generator=warm)
            sync(self.device)
            i += 1
        self.keys = torch.Generator().manual_seed(traffic.key_seed(self.seed))

    def adopt(self, other: "OrbitRun") -> None:
        """Take the program's state from ``other``'s set-up (the same cell
        under another seed): its scene, config, camera and graph."""
        import torch

        for name in ("torch", "render", "scene", "cfg", "base", "poses", "cameras"):
            setattr(self, name, getattr(other, name))
        self.keys = torch.Generator().manual_seed(traffic.key_seed(self.seed))

    def frames_until(self, last: int) -> None:
        """Frames 0..``last`` of the window, untimed (the check's readings)."""
        checked = set(self.checked)
        for i in range(last + 1):
            img = self.render(self.scene, self.camera(i), self.cfg, generator=self.keys)
            if i in checked:
                self.kept[i] = img
        self.kept[last] = img
        self.frames = last + 1
        sync(self.device)

    def camera(self, i: int):
        """Frame i's camera (the loop's pose as a view of one device tensor)."""
        return self.cameras[self.orbit.index(i)]

    def window(self, seconds: float) -> dict:
        torch, render, scene, cfg, keys = self.torch, self.render, self.scene, self.cfg, self.keys
        checked = set(self.checked)
        events = self.device != "cpu"  # a CPU run (the tests) times by the host's clock
        if events:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        device_ms, host_s = [], []
        sync(self.device)
        t_start = time.perf_counter()
        deadline = t_start + seconds
        i = 0
        while True:
            cam = self.camera(i)
            t0 = time.perf_counter()
            if events:
                start.record()
            img = render(scene, cam, cfg, generator=keys)
            t1 = time.perf_counter()
            if events:
                end.record()
                end.synchronize()
            t2 = time.perf_counter()
            device_ms.append(start.elapsed_time(end) if events else 1e3 * (t2 - t0))
            host_s.append(t1 - t0)
            if i in checked:
                self.kept[i] = img
            i += 1
            if t2 >= deadline:
                break
        self.kept[i - 1] = img
        self.frames = i
        window_s = t2 - t_start
        return {"frames": i, "window_s": window_s, "frame_ms_each": device_ms,
                "host_s_each": host_s}

    def segment(self, frames: int) -> None:
        """``frames`` more frames under the profiler, each in spans."""
        torch, render, scene, cfg, keys = self.torch, self.render, self.scene, self.cfg, self.keys
        first = self.frames
        sync(self.device)
        with tracing.profiled(self.traces):
            with tracing.span("segment"):
                for i in range(first, first + frames):
                    with tracing.span("frame"):
                        cam = self.camera(i)
                        with tracing.span("render"):
                            render(scene, cam, cfg, generator=keys)
                        with tracing.span("wait"):
                            sync(self.device)
        self.segment_frames = list(range(first, first + frames))

    def release(self) -> None:
        """Free the program's state (graphs, scene, trees) before the
        reference runs."""
        from cg_raytracer_tpu_torch.utils import graphs

        graphs.clear()
        self.scene = self.poses = self.base = self.cameras = None
        if self.device != "cpu":
            self.torch.cuda.empty_cache()

    # -- the reference ------------------------------------------------------

    def reference_scene(self, dtype=None):
        from reference import render as R

        pl, sl = _lights(self.config)
        scene = R.make_scene(self.meshes, pl, sl, device=self.device)
        return R.with_dtype(scene, dtype) if dtype is not None else scene

    def reference_frame(self):
        from reference import render as R

        return R.Frame(self.width, self.height, int(self.config["max_depth"]),
                       self.fx["reference_quirks"], self.fx["anti_aliasing"], self.fx["bloom"],
                       int(self.config["soft_shadow_samples"]))

    def reference_camera(self, i: int, dtype=None):
        import torch

        from reference import render as R

        cam = self.config["camera"]
        return R.camera_dict(cam["look_at"], self.orbit.poses[self.orbit.index(i)],
                             cam["dist"], R.radians32(cam["fovy_deg"]),
                             self.width / self.height, self.device,
                             dtype or torch.float32)

    def frame_keys(self, frames) -> dict:
        """The sample key each of ``frames`` (window indices) drew."""
        import torch

        from reference import philox

        if not self.config.get("spherical_lights"):
            return {i: None for i in frames}
        g = torch.Generator().manual_seed(traffic.key_seed(self.seed))
        want, out = set(frames), {}
        for i in range(max(frames) + 1):
            key = philox.draw_key(g)
            if i in want:
                out[i] = key
        return out

    def pixels(self, i: int):
        shadow_rays = int(self.config["soft_shadow_samples"]) * len(
            self.config.get("spherical_lights", []))
        return traffic.checked_pixels(self.mix["compare"], self.seed, i, self.width,
                                      self.height, sum(len(m["triangles"]) for m in self.meshes),
                                      int(self.config["max_depth"]), shadow_rays)

    def reference_images(self, frames, dtype=None) -> dict:
        """The reference's image (or checked pixels [N, 3]) of each frame."""
        import torch

        from reference import render as R

        scene = self.reference_scene(dtype)
        frame = self.reference_frame()
        keys = self.frame_keys(frames)
        out = {}
        for i in frames:
            px = self.pixels(i)
            px = None if px is None else torch.as_tensor(px, device=self.device)
            out[i] = R.render_frame(scene, self.reference_camera(i, dtype), frame, keys[i], px,
                                    dtype or torch.float32).float()
        return out

    def program_pixels(self, i: int, img):
        px = self.pixels(i)
        flat = img.reshape(-1, 3)
        return flat if px is None else flat[self.torch.as_tensor(px, device=flat.device)]

    def check(self) -> list:
        """[(name, value, limit)]: the worst checked frame's share of pixels
        off the reference, and how many checked frames never came."""
        frames = sorted(self.kept)
        missing = [i for i in self.checked if i not in self.kept]
        refs = self.reference_images(frames)
        worst = 0.0
        for i in frames:
            worst = max(worst, off_share(self.program_pixels(i, self.kept[i]).float(), refs[i]))
        limit = float(self.limits["frame_off_pct"])
        return [("frame_off_pct", worst, limit), ("frames_missing", float(len(missing)), 0.0)]


    def frame_hits(self, i: int) -> tuple:
        """(stride, [(offset, [(prim, live) per level])]) of frame i: the
        reference's hits on every ``stride``-th pixel of each row and
        column, the stride the least that keeps a brute-force pass under
        the mix's ``full_frame_work``; one entry per anti-aliasing offset."""
        import math

        import torch

        from reference import render as R

        scene = self.reference_scene()
        frame = self.reference_frame()
        tris = sum(len(m["triangles"]) for m in self.meshes)
        work = self.width * self.height * tris * frame.max_depth
        stride = max(1, math.ceil(math.sqrt(work / float(self.mix["compare"]["full_frame_work"]))))
        ys = torch.arange(0, self.height, stride, device=self.device)
        xs = torch.arange(0, self.width, stride, device=self.device)
        pixels = (ys[:, None] * self.width + xs[None, :]).reshape(-1)
        offsets = R.AA_OFFSETS if frame.anti_aliasing else ((0.0, 0.0),)
        out = []
        for off in offsets:
            o, d = R.camera_rays(self.reference_camera(i), self.width, self.height, pixels, off)
            out.append((off, R.level_hits(scene, o, d, frame)))
        return stride, out


def off_share(program, reference) -> float:
    """Percent of pixels where a channel differs by more than TOL_ABS +
    TOL_REL x the reference's brightest channel (NaN counts as off)."""
    ref = reference.reshape(-1, 3)
    prog = program.reshape(-1, 3).to(ref.device)
    tol = TOL_ABS + TOL_REL * ref.abs().amax(dim=-1)
    diff = (prog - ref).abs().amax(dim=-1)
    off = ~(diff <= tol)
    return 100.0 * float(off.sum()) / max(1, off.numel())


def summary(stats: dict) -> dict:
    """frame_ms (window over frames) and frame_p95_ms (every frame's)."""
    each = np.asarray(stats["frame_ms_each"], np.float64)
    return {"frame_ms": 1e3 * stats["window_s"] / stats["frames"],
            "frame_p95_ms": float(np.percentile(each, 95.0))}
