"""The train mix: inverse rendering, one ``optimize()`` call of the program
fitting the scene's materials, point lights and vertices to a target frame,
as a user runs one fit.

Set-up renders the target (the scene with its diffuse colours perturbed
from the seed), then drives the parameters and a fresh optimizer from the
seed through the first chunk of ``steps_per_call`` (K) steps in one
``optimize()`` call: the same chunk graph the window replays, built by the
same code.  Its checkpoint holds the state after step K: the parameters'
change and the optimizer's first moment.  A second call, from the start
and without a checkpoint, times chunks to size the window.  The window is
one ``optimize()`` call that resumes at step K from set-up's checkpoint and
runs a multiple of K steps, its chunk graph's capture inside it;
``step_ms`` is the window over its steps.

The check holds set-up's chunk (the losses of steps 0 to K - 1, and the
first moment and the change after step K) against the plain reference's
fit from the seed, and the window's first two steps (the losses of steps K
and K + 1: the window's first forward and first update) against the
reference's one step from the state the window resumed from.  From the
seed the two sides part after some ten steps (rounding flips a pixel
between two moved triangles and Adam's step turns a near-zero vertex
gradient's sign into a full step), so the reference follows the window
from the program's state, and the start is checked from the seed.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import tempfile
import time

import numpy as np

from . import tracing, traffic
from .orbit import sync

BETA1 = 0.9  # torch.optim.Adam's default, which optimize() builds
SILENT_GRAD = 1e-3  # a leaf whose reference gradient is under this share of the median's


def _quiet(*_args, **_kw):
    return None


class FitRun:
    def __init__(self, config: dict, mix: dict, limits: dict, seed: int, geometry,
                 device="cuda"):
        self.config, self.mix, self.limits = config, mix, limits
        self.seed, self.device = int(seed), device
        self.meshes = geometry()
        self.width, self.height = (int(x) for x in mix["resolution"])
        self.k = int(mix["steps_per_call"])
        self.lr = float(mix["learning_rate"])
        self.kd = np.asarray([m["material"].get("kd", (1.0, 1.0, 1.0)) for m in self.meshes],
                             np.float32)
        self.kd_target = traffic.perturbed(self.kd, float(mix["perturb_kd"]), self.seed)
        self.traces: list = []
        self.tmp = tempfile.mkdtemp(prefix="fitbench-")
        self.ckpt = os.path.join(self.tmp, "fit.npz")
        self.segment_steps = 0

    def _lights(self):
        pl = tuple((tuple(p), tuple(c)) for p, c in self.config.get("point_lights", []))
        if self.config.get("spherical_lights"):
            raise NotImplementedError("the train mix fits point-lit scenes")
        return pl

    # -- the program --------------------------------------------------------

    def setup(self, size_window: bool = True) -> None:
        import torch

        from cg_raytracer_tpu_torch import RenderConfig, render
        from cg_raytracer_tpu_torch.optim import inverse
        from cg_raytracer_tpu_torch.scene.types import Camera, PointLights, make_scene

        self.torch, self.inverse = torch, inverse
        self.scene = make_scene(self.meshes, point_lights=PointLights.of(*self._lights()),
                                device=self.device)
        cam = self.config["camera"]
        self.camera = Camera.default(look_at=tuple(cam["look_at"]),
                                     euler_deg=tuple(cam["euler_deg"]), dist=float(cam["dist"]),
                                     fovy_deg=float(cam["fovy_deg"]),
                                     aspect=self.width / self.height, device=self.device)
        self.cfg = RenderConfig(width=self.width, height=self.height,
                                max_depth=int(self.config["max_depth"]))
        kd_t = torch.as_tensor(self.kd_target, device=self.device)
        target_scene = dataclasses.replace(
            self.scene, materials=dataclasses.replace(self.scene.materials, kd=kd_t))
        self.target = render(target_scene, self.camera, self.cfg)
        params = inverse.material_params(self.scene)
        params["vertices"] = self.scene.vertices
        self.params = params
        self.start = {k: v.detach().cpu().numpy().copy() for k, v in params.items()}
        # The first chunk, in the window's own chunk graph: warm-up and check.
        _, losses = self._fit(self.k, checkpoint=True, resume=False)
        self.after_k = dict(np.load(self.ckpt))
        self.losses = list(losses)
        if size_window:
            self._size()
        sync(self.device)

    def _size(self) -> None:
        """Time the chunks of a fit of five from the start (no checkpoint):
        the replays after the first give the seconds a step, the rest of the
        call its fixed cost."""
        log = os.path.join(self.tmp, "size.jsonl")
        t0 = time.perf_counter()
        self._fit(5 * self.k, checkpoint=False, resume=False, log=log)
        total = time.perf_counter() - t0
        with open(log) as f:
            each = [json.loads(line)["step_seconds"] for line in f][::self.k]
        os.remove(log)
        per_step = max(statistics.median(each[1:]), total / (5 * self.k) / 4)
        self.per_step_s, self.overhead_s = per_step, max(total - 5 * self.k * per_step, 0.0)

    def _fit(self, steps, checkpoint=False, resume=True, log=None):
        return self.inverse.optimize(
            self.scene, self.camera, self.target, self.cfg, steps=steps, learning_rate=self.lr,
            params=self.params, apply_params=_apply, steps_per_call=self.k,
            checkpoint_path=self.ckpt if checkpoint else None, checkpoint_every=10 ** 9,
            resume=resume, log_every=0, log_fn=_quiet, log_jsonl=log)

    def window_steps(self, seconds: float) -> int:
        steps = (seconds - self.overhead_s) / self.per_step_s
        return max(self.k, int(round(steps / self.k)) * self.k)

    def window(self, seconds: float, steps: int = 0) -> dict:
        """The window: ``seconds`` sized into steps, or ``steps`` if given
        (a multiple of K).  It resumes at step K; the losses of its first
        two steps are checked."""
        n = steps or self.window_steps(seconds)
        sync(self.device)
        t0 = time.perf_counter()
        _, losses = self._fit(self.k + n, checkpoint=True)
        sync(self.device)
        t1 = time.perf_counter()
        self.losses.extend(losses[:2])
        self.steps = n
        return {"steps": n, "window_s": t1 - t0}

    def segment(self, steps: int) -> None:
        """A fit of ``steps`` steps from the start under the profiler."""
        sync(self.device)
        with tracing.profiled(self.traces):
            with tracing.span("fit"):
                self._fit(steps, resume=False)
        self.segment_steps = steps

    def release(self) -> None:
        from cg_raytracer_tpu_torch.utils import graphs

        graphs.clear()
        self.scene = self.target = self.params = self.camera = None
        if self.device != "cpu" and hasattr(self, "torch"):
            self.torch.cuda.empty_cache()
        if os.path.exists(self.ckpt):
            os.remove(self.ckpt)
        os.rmdir(self.tmp)

    # -- the reference ------------------------------------------------------

    def _reference_fit(self, steps: int, dtype=None, fault=None, state=None) -> dict:
        import torch

        from reference import render as R
        from reference import train as T

        scene = R.make_scene(self.meshes, self._lights(), (), device=self.device)
        target = dataclasses.replace(scene, kd=torch.as_tensor(self.kd_target, device=self.device))
        cam = self.config["camera"]
        camera = R.camera_dict(cam["look_at"], R.radians32(cam["euler_deg"]), cam["dist"],
                               R.radians32(cam["fovy_deg"]), self.width / self.height,
                               self.device)
        frame = R.Frame(self.width, self.height, int(self.config["max_depth"]))
        return T.fit(scene, target, camera, frame, steps=steps, lr=self.lr,
                     dtype=dtype or torch.float32, at=min(steps, self.k), fault=fault,
                     state=state)

    def reference(self, dtype=None, fault=None) -> dict:
        """The plain reference's fit from the seed: the losses of steps 0
        to K, and after step K its state; ``fault`` as in
        ``reference/train.py::fit``."""
        return self._reference_fit(self.k, dtype, fault)

    def window_reference(self, state: dict, dtype=None, fault=None) -> list:
        """The reference's losses of steps K and K + 1: one step from
        ``state``, the state after step K of what stands in the program's
        place (the window resumes from it)."""
        return self._reference_fit(1, dtype, fault, state)["losses"]

    def program(self) -> dict:
        """The program's readings: the losses of set-up's chunk (steps 0 to
        K - 1) and of the window's first two steps (K, K + 1); after step K
        each leaf's change, the optimizer's first moment, bias-corrected
        (the gradients' running mean as Adam holds it), and the state the
        window resumed from."""
        names = [str(n) for n in self.after_k["param_names"]]
        zero = {n: np.zeros_like(self.start[n]) for n in names}  # an optimizer that kept no state
        m = {n: self.after_k.get(f"o{i}_exp_avg", zero[n]) for i, n in enumerate(names)}
        v = {n: self.after_k.get(f"o{i}_exp_avg_sq", zero[n]) for i, n in enumerate(names)}
        params = {n: self.after_k[f"p_{n}"] for n in names}
        t = int(self.after_k.get("o0_step", np.int64(0)))
        return {"losses": self.losses[:self.k], "window": self.losses[self.k:self.k + 2],
                "moment": {n: m[n] / (1.0 - BETA1 ** self.k) for n in names},
                "change": {n: params[n] - self.start[n] for n in names},
                "state": {"params": params, "m": m, "v": v, "t": t}}

    def stand_in(self, fit_out: dict, window: list) -> dict:
        """The readings of a reference fit (``reference()``) and its
        ``window`` losses put in the program's place: the control's and the
        planted faults'."""
        return {"losses": fit_out["losses"][:self.k], "window": window,
                "moment": fit_out["moment"], "change": fit_out["change"],
                "state": fit_out["state"]}

    def check(self) -> list:
        prog = self.program()
        return readings(prog, self.reference(), self.window_reference(prog["state"]),
                        self.limits)


def _apply(scene, params):
    from cg_raytracer_tpu_torch.optim import inverse

    return inverse.apply_vertex_params(inverse.apply_material_params(scene, params), params)


def _norms(tree: dict) -> dict:
    return {k: float(np.linalg.norm(np.asarray(_numpy(v), np.float64))) for k, v in tree.items()}


def _numpy(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def gaps(program: dict, reference: dict, window: list) -> dict:
    """The compared numbers.  loss_gap: |the first loss - the reference's|
    over the reference's; window_loss_gap: the worse of that gap at the
    window's first two steps (K, K + 1), against ``window``, the reference's
    losses one step from the state the window resumed from; moment_gap:
    the median leaf's gap between the program's norm of the optimizer's
    first moment after step K and the reference's, over the larger of that
    leaf's reference norm and the median leaf's; change_gap: that gap for
    the parameters' change after step K.  Leaves whose first reference
    gradient is under SILENT_GRAD of the median leaf's are left out.  The
    worst step's loss gap over set-up's chunk and the worst leaf's gaps are
    kept beside them (``*_worst``): rounding in the moved vertices flips
    pixels between triangles in later steps, so those are not steady from
    seed to seed and are not compared."""
    k = len(program["losses"])
    lp, lr = list(program["losses"]), list(reference["losses"])[:k]
    wp, wr = list(program["window"]), list(window)[:len(program["window"])]
    if len(lr) != k or len(wp) != 2 or len(wr) != 2:
        raise ValueError(f"losses: {k} and {len(wp)} against {len(lr)} and {len(wr)}")

    def rel(a, b):
        return abs(a - b) / abs(b) if b else abs(a)

    each = [rel(a, b) for a, b in zip(lp, lr)]
    win = [rel(a, b) for a, b in zip(wp, wr)]
    if not all(math.isfinite(a) for a in lp + wp):
        each, win = [math.inf] * len(each), [math.inf] * len(win)
    g_ref = _norms(reference["grad"])
    median = statistics.median(g_ref.values())
    kept = [n for n, v in g_ref.items() if v >= SILENT_GRAD * median]
    out = {"loss_gap": each[0], "window_loss_gap": max(win), "loss_gap_worst": max(each)}
    for tree in ("moment", "change"):
        p, r = _norms(program[tree]), _norms(reference[tree])
        med = statistics.median(r[n] for n in kept)
        vals = [abs(p[n] - r[n]) / max(r[n], med) for n in kept]
        if not all(math.isfinite(v) for v in vals):
            vals = [math.inf] * len(vals)
        out[f"{tree}_gap_worst"] = max(vals)
        out[f"{tree}_gap"] = statistics.median(vals)
    out["silent_leaves"] = sorted(set(g_ref) - set(kept))
    return out


COMPARED = ("loss_gap", "window_loss_gap", "moment_gap", "change_gap")


def detail(program: dict, reference: dict, window: list) -> dict:
    """Each step's loss and each leaf's norms, program against reference."""
    k = len(program["losses"])
    out = {"losses": [list(program["losses"]), list(reference["losses"])[:k]],
           "window": [list(program["window"]), list(window)]}
    for tree in ("moment", "change"):
        p, r = _norms(program[tree]), _norms(reference[tree])
        out[tree] = {n: [p[n], r[n]] for n in r}
    return out


def readings(program: dict, reference: dict, window: list, limits: dict) -> list:
    g = gaps(program, reference, window)
    return [(k, g[k], float(limits[k])) for k in COMPARED]
