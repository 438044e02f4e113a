"""Inverse rendering, as in ``cg_raytracer_tpu/optim/inverse.py``: optimize
scene parameters against a target image (differentiable render -> L2 loss
-> Adam), with npz checkpoints that resume to the same losses.

Parameter sets are dicts of tensors; ``apply_*`` rebuilds the scene with
``dataclasses.replace`` and leaves the given scene unchanged.

``optimize`` builds the scene's tree once, on the host, over the initial
geometry.  Materials and lights do not shape it; when ``"vertices"`` is among
the parameters, every step refits its boxes and triangle table from the
current vertices (``ops/refit.py``), so the kernels never walk a stale tree.
Step i's spherical-light samples come from the key folded with i
(``soft.SampleKey.fold_in``), as the JAX package folds its PRNG key with the
global step: the losses depend neither on the checkpoint cadence nor on a
resume.  A step is one render, one backward and one optimizer update; the
loop runs them in chunks of ``steps_per_call`` (the JAX package's K-step
dispatch): on the card each chunk is one replay of a CUDA graph of its K
steps (``parallel/sharding.py::make_train_loop``), and the host reads the
chunk's losses once.  With a ``mesh`` every rank renders its rows and the
gradients are summed across ranks, step by step.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..scene.types import Camera, PointLights, Scene


def vertex_params(scene: Scene) -> Dict:
    """Geometry parameter set: raw vertex positions."""
    return {"vertices": scene.vertices}


def apply_vertex_params(scene: Scene, params: Dict) -> Scene:
    return dataclasses.replace(scene, vertices=params["vertices"])


def material_params(scene: Scene) -> Dict:
    """Default parameter set: the material table, and the point lights' colors
    and positions when the scene has point lights."""
    params = {
        "kd": scene.materials.kd,
        "ks": scene.materials.ks,
        "shininess": scene.materials.shininess,
    }
    if scene.point_lights.position.shape[0] > 0:
        params["light_color"] = scene.point_lights.color
        params["light_position"] = scene.point_lights.position
    return params


def apply_material_params(scene: Scene, params: Dict) -> Scene:
    mats = dataclasses.replace(scene.materials, kd=params["kd"], ks=params["ks"],
                               shininess=params["shininess"])
    scene = dataclasses.replace(scene, materials=mats)
    if "light_color" in params:
        lights = PointLights(position=params["light_position"], color=params["light_color"])
        scene = dataclasses.replace(scene, point_lights=lights)
    return scene


def training_config(cfg, include_vertex_params: bool):
    """The training routing (``optimize``'s two auto flips,
    inverse.py:126-138 of the JAX package): the two-phase structure on, and
    phase 2 on the recorded rays when no vertex is differentiated (the
    reflected-origin vertex term is then zero)."""
    if cfg.grad_two_phase == "auto":
        cfg = dataclasses.replace(cfg, grad_two_phase="on")
    if cfg.two_phase_rays == "auto" and not include_vertex_params:
        cfg = dataclasses.replace(cfg, two_phase_rays="recorded")
    return cfg


def render_params(params: Dict, scene: Scene, camera: Camera, cfg,
                  apply_params: Callable = apply_material_params, generator=None, accel=None,
                  refit_plan=None, plain: bool = False):
    """The image of ``apply_params(scene, params)``, differentiable in
    ``params``.  ``accel``: the scene's tree (``build_accel``); with
    ``refit_plan`` it is refit from the current vertices first.
    ``plain=True`` routes the kernels through their plain twins."""
    from ..models.whitted import make_backend, render_image
    from ..ops.refit import refit_accel

    scene_p = apply_params(scene, params)
    if refit_plan is not None and accel is not None:
        accel = refit_accel(accel, scene_p, refit_plan)
    return render_image(scene_p, camera, cfg, generator=generator,
                        backend=make_backend(scene_p, cfg, plain=plain, accel=accel))


def render_loss(params: Dict, scene: Scene, camera: Camera, target, cfg, **render_kw):
    """L2 image loss, mean((render(scene <- params) - target)^2)
    (``parallel/sharding.py::render_loss`` on one device); ``render_kw`` as
    ``render_params``."""
    return torch.mean((render_params(params, scene, camera, cfg, **render_kw) - target) ** 2)


def loss_and_grads(loss_fn: Callable, params: Dict):
    """One step's forward and backward: ``loss_fn`` on fresh leaves of
    ``params``, then backward.  Returns (loss, {name: gradient}); a
    parameter the loss does not depend on has None.  The training step of
    ``optimize`` and ``utils/bench.py::fwd_bwd_step``."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves)
    loss.backward()
    return loss.detach(), {k: v.grad for k, v in leaves.items()}


def save_checkpoint(path: str, step: int, params: Dict, optimizer) -> None:
    """(step, params, optimizer state) into one npz at ``path`` (the name as
    given: no ``.npz`` is appended)."""
    arrays = {"step": np.int64(step), "param_names": np.asarray(list(params))}
    arrays.update({f"p_{k}": v.detach().cpu().numpy() for k, v in params.items()})
    for i, state in optimizer.state_dict()["state"].items():
        for name, value in state.items():
            arrays[f"o{i}_{name}"] = torch.as_tensor(value).detach().cpu().numpy()
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_checkpoint(path: str, params: Dict, optimizer) -> int:
    """Restore ``params`` (in place) and the optimizer's state from
    ``save_checkpoint``'s file; returns the step it was saved at.  The
    optimizer must be built as the saved one was (its parameter groups and
    rates come from its constructor, its moments from the file)."""
    with np.load(path) as data:
        names = [str(n) for n in data["param_names"]]
        if names != list(params):
            raise ValueError(f"checkpoint {path} holds parameters {names}, not {list(params)}")
        with torch.no_grad():
            for k, v in params.items():
                v.copy_(torch.from_numpy(data[f"p_{k}"]))
        state: dict = {}
        for key in data.files:
            if key.startswith("o"):
                index, name = key[1:].split("_", 1)
                state.setdefault(int(index), {})[name] = torch.from_numpy(data[key])
        saved = optimizer.state_dict()
        saved["state"] = state
        optimizer.load_state_dict(saved)
        return int(data["step"])


def _base_key(key):
    from ..ops import soft

    if key is None or isinstance(key, int):
        return soft.draw_key(torch.Generator().manual_seed(key or 0))
    return soft.as_key(key)


def optimize(scene: Scene, camera: Camera, target, cfg, steps: int = 100,
             learning_rate: float = 1e-2, params: Optional[Dict] = None,
             apply_params: Callable = apply_material_params, mesh=None,
             checkpoint_path: Optional[str] = None, checkpoint_every: int = 50,
             resume: bool = True, log_every: int = 10, log_fn: Callable = print,
             log_jsonl: Optional[str] = None, key=None, steps_per_call: int = 8,
             optimizer: Optional[Callable] = None, plain: bool = False, jit: bool = True):
    """Run the inverse-rendering loop on the scene's device; returns (params,
    losses), the params detached, one loss per step run.

    - ``params`` (default ``material_params(scene)``) are copied; the scene
      is left as it is.  ``apply_params(scene, params) -> scene``.
    - ``optimizer``: a function from the parameter dict to a torch optimizer
      (default ``torch.optim.Adam`` at ``learning_rate``, optax.adam's
      update; ``capturable=True`` on the card, in the eager path too, so that
      both round alike); per-group learning rates are its parameter groups.
    - ``steps_per_call`` (the JAX package's, default 8): the steps of one
      chunk.  On the card (without ``mesh``, ``plain`` or ``jit=False``) a
      chunk of K steps is one replay of a CUDA graph captured once per chunk
      length (a tail chunk and a chunk cut at a checkpoint get their own);
      the loop reads the chunk's losses once.  Step i samples under the
      key's fold with i whatever the chunking, so the losses do not depend
      on K.  A graphed step needs a capturable optimizer: one built with
      ``capturable=False`` raises.
    - ``checkpoint_path``: an npz of (step, params, optimizer state) written
      every ``checkpoint_every`` steps (chunks end there) and at the end;
      with ``resume`` an existing one is loaded and the loop continues from
      its step.
    - ``log_every``: a ``log_fn`` line every that many steps (0: none);
      ``log_jsonl``: one JSON line per step (loss, the parameter norm at the
      chunk's end, the chunk's seconds / K as step seconds, rays/s).
    - ``key``: the spherical lights' sample stream: a seed (default 0), a
      ``torch.Generator`` or a ``soft.SampleKey``; step i samples under its
      fold with i.
    - ``plain=True`` routes the kernels through their plain twins, eagerly
      (the reference an on-card run is checked against).
    - ``mesh`` (``parallel/sharding.py::make_mesh``): every rank runs this
      loop on its own device with the same arguments, renders its row block
      and takes the same step on gradients summed across ranks; rank 0
      alone logs and writes the checkpoint, every rank resumes from it.
    """
    from ..models.whitted import build_accel, needs_bvh
    from ..ops.refit import make_refit_plan
    from ..parallel.sharding import Mesh, make_train_loop
    from ..utils.profiling import JsonlLogger

    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh: a parallel.sharding.Mesh (make_mesh), got {type(mesh)}")
    lead = mesh is None or mesh.rank == 0
    if not lead:
        log_fn, log_jsonl = (lambda *a: None), None
    if params is None:
        params = material_params(scene)
    cfg = training_config(cfg, "vertices" in params)
    device = scene.device
    params = {k: v.detach().to(device).clone().requires_grad_(True) for k, v in params.items()}
    target = torch.as_tensor(target).to(device=device, dtype=torch.float32)
    if optimizer is None:
        capturable = device.type == "cuda"
        optimizer = lambda p: torch.optim.Adam(list(p.values()), lr=learning_rate,  # noqa: E731
                                               capturable=capturable)
    opt = optimizer(params)
    base = _base_key(key)
    accel = build_accel(scene, cfg) if needs_bvh(cfg, scene.num_triangles, device) else None
    refit_plan = (make_refit_plan(accel) if accel is not None and "vertices" in params
                  else None)
    steps_per_call = max(1, int(steps_per_call))
    loops = {}  # chunk length -> its loop (on the card: its graph, captured at first use)

    def run_chunk(k, first):
        if k not in loops:
            loops[k] = make_train_loop(cfg, opt, apply_params, k, mesh=mesh, accel=accel,
                                       refit_plan=refit_plan, plain=plain, jit=jit)
        return loops[k](params, scene, camera, target, base, first)

    start = 0
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        start = load_checkpoint(checkpoint_path, params, opt)
        log_fn(f"resumed from {checkpoint_path} at step {start}")
    logger = JsonlLogger(log_jsonl, echo=False) if log_jsonl else None
    losses = []
    i = start
    while i < steps:
        k = min(steps_per_call, steps - i)
        if checkpoint_path and checkpoint_every:
            k = min(k, checkpoint_every - i % checkpoint_every)  # end on the boundary
        t0 = time.perf_counter()
        chunk = run_chunk(k, i).tolist()  # the chunk's one wait for the card
        dt = (time.perf_counter() - t0) / k
        losses.extend(chunk)
        if logger:
            with torch.no_grad():
                norm = float(torch.sqrt(sum((p.double() ** 2).sum() for p in params.values())))
            for j, loss_f in enumerate(chunk):
                logger.log(step=i + j, loss=loss_f, param_norm=norm, step_seconds=dt,
                           rays_per_s=cfg.width * cfg.height / max(dt, 1e-9))
        for j, loss_f in enumerate(chunk):
            if log_every and ((i + j) % log_every == 0 or i + j == steps - 1):
                log_fn(f"step {i + j}: loss {loss_f:.6e}")
        i += k
        if lead and checkpoint_path and checkpoint_every and i % checkpoint_every == 0 \
                and i < steps:
            save_checkpoint(checkpoint_path, i, params, opt)
    if logger:
        logger.close()
    from ..utils import graphs

    for loop in loops.values():
        graphs.forget(loop)  # no later call replays this loop's graphs: free their pools
    if lead and checkpoint_path:
        save_checkpoint(checkpoint_path, steps, params, opt)
    if mesh is not None:
        mesh.barrier()  # the checkpoint is on disk before any rank returns
    return {k: v.detach() for k, v in params.items()}, losses
