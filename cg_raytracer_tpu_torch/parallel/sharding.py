"""Ray- and sample-parallel rendering and the data-parallel training step, as
in ``cg_raytracer_tpu/parallel/sharding.py``, over ``torch.distributed``.

Ranks are processes with one device each.  A ``Mesh`` lays them out on a
grid: a 1-D ('rays',) mesh (``make_mesh``) or a 2-D ('rays', 'samples') one
(``make_mesh2``), with one process group per axis (the ranks that differ
from this one only along it).  A world of one rank needs no process group.

- ``sharded_render``: ray rank r renders row block r (the ceil split of
  ``row_block``) through ``models/whitted.py::render_rows`` with the frame's
  one sample key, and every rank assembles the frame.  A row tile is the
  frame's rows bit for bit, so the frame is ``render()``'s.  Bloom gathers a
  21x21 window across tiles, so it runs on the assembled frame, as the JAX
  package's jitted whole-frame render does; on the reference's AA + bloom
  path the per-pixel buffers are assembled and blurred whole.
- ``sample_sharded_render``: rank (r, s) of a 2-D mesh renders row block r
  and only chunks s, s + S, ... of each light's soft-shadow scan; the
  integer visible counts are summed over the 'samples' group before the
  division (``ops/shading.py::SampleSplit``).  A (point, sample) pair draws
  its own place in the counter-based stream, so the render equals the
  unsplit scan's bit for bit.  As in the JAX package this path runs the scan
  over the any-hit oracle, not a sampler kernel.
- ``render_loss``, ``make_train_step``, ``make_train_loop``: the parameters
  are replicated; each rank's loss covers its rows, divided by the frame's
  H W 3 elements, so the terms add up to the mean; after ``backward()`` the
  gradients are summed over the 'rays' group (the psum XLA inserts for the
  JAX package) and every rank takes the same optimizer step.  The sum
  changes the order of float additions: gradients match a single-device
  step to float tolerance, not bit for bit.  With vertices among the
  parameters every rank refits its own tree replica each step.  Without a
  mesh the step and the K-step loop replay CUDA graphs on the card
  (``utils/graphs.py``); with one they run eagerly, and so do the sharded
  renders: their collectives go through the host.

Collectives: every cross-rank operation here and in ``geometry.py`` is an
``all_reduce``.  Gloo takes CUDA tensors only for ``broadcast`` and
``all_reduce`` (PyTorch's backend table), so the frame is assembled as the
SUM of row tiles on zero frames (exact: the other ranks add zeros), and two
ranks can share one card over gloo; NCCL, one rank per card, runs the same
calls.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models import whitted
from ..ops import effects, shading, soft
from ..scene.types import Camera, Scene
from ..utils.config import RenderConfig

RAY_AXIS = "rays"
SAMPLE_AXIS = "samples"
SUM, MIN, MAX = dist.ReduceOp.SUM, dist.ReduceOp.MIN, dist.ReduceOp.MAX


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on a row-major grid of ranks (``shape`` over
    ``axis_names``), its device, and per axis the process group of the ranks
    that differ from it only along that axis (empty in a world of one)."""

    axis_names: tuple
    shape: tuple
    rank: int
    device: torch.device
    groups: dict

    @property
    def world(self) -> int:
        return math.prod(self.shape)

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)] if axis in self.axis_names else 1

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (0 on a mesh without it)."""
        if axis not in self.axis_names:
            return 0
        k = self.axis_names.index(axis)
        return self.rank // math.prod(self.shape[k + 1:]) % self.shape[k]

    def all_reduce(self, x, op=SUM, axis: Optional[str] = None):
        """``x`` reduced in place over ``axis``'s group (every rank when
        None), and returned."""
        if self.world == 1 or (axis is not None and self.size(axis) == 1):
            return x
        dist.all_reduce(x, op=op, group=self.groups[axis] if axis is not None else None)
        return x

    def barrier(self) -> None:
        """Wait for every rank (an all-reduce, which gloo and NCCL both take
        on the mesh's device)."""
        self.all_reduce(torch.zeros((1,), device=self.device))


def world() -> tuple:
    """(rank, world size) of the initialized process group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device(device=None, rank: int = 0) -> torch.device:
    """A rank's device: ``device`` (default 'cuda'); a card without an index
    is card LOCAL_RANK (else ``rank``) modulo the cards present, so ranks
    may share one.  Raises where a card is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a sharded entry point was asked for 'cuda' but "
                               "torch.cuda.is_available() is False; pass device='cpu'")
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def _mesh(shape, axis_names, device) -> Mesh:
    rank, size = world()
    if math.prod(shape) != size:
        raise ValueError(f"a {tuple(shape)} mesh needs {math.prod(shape)} ranks; the world "
                         f"has {size}")
    groups = {}
    if size > 1:
        grid = np.arange(size).reshape(shape)
        for k, axis in enumerate(axis_names):
            if len(shape) == 1:
                groups[axis] = dist.group.WORLD
                continue
            # Every rank creates every group, in the same order.
            for ranks in np.moveaxis(grid, k, -1).reshape(-1, shape[k]).tolist():
                group = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = group
    return Mesh(tuple(axis_names), tuple(shape), rank, rank_device(device, rank), groups)


def make_mesh(num_devices: Optional[int] = None, device=None, axis: str = RAY_AXIS) -> Mesh:
    """1-D mesh over every rank of the world (one rank without a process
    group); ``num_devices``, if given, must be the world's size."""
    size = world()[1]
    if num_devices is not None and num_devices != size:
        raise ValueError(f"make_mesh({num_devices}): the world has {size} ranks")
    return _mesh((size,), (axis,), device)


def make_mesh2(ray_devices: int, sample_devices: int, device=None,
               axes=(RAY_AXIS, SAMPLE_AXIS)) -> Mesh:
    """2-D mesh ('rays', 'samples'): pixel rows over one axis, soft-shadow
    sample chunks over the other (pass ``axes`` for another second axis,
    e.g. ``geometry.PRIM_AXIS``)."""
    return _mesh((ray_devices, sample_devices), tuple(axes), device)


def row_block(height: int, index: int, count: int) -> tuple:
    """Rows [start, stop) of block ``index`` of ``count``: ceil(H / count)
    rows each (``multihost.host_local_rows``); stop <= start is empty."""
    per = -(-height // count)
    return index * per, min((index + 1) * per, height)


def _check_devices(scene: Scene, camera: Camera, mesh: Mesh) -> None:
    if scene.device != mesh.device or camera.device != mesh.device:
        raise ValueError(f"scene on {scene.device}, camera on {camera.device}, but this "
                         f"rank's device is {mesh.device}")


def _tile(scene, camera, cfg, backend, key, rows):
    """Rows (start, stop) before the whole-frame pass: ``render_rows``'s
    pixels, or on the reference's AA + bloom path its per-pixel buffers
    ([k, W, 6])."""
    if effects.is_bloom_quirk_aa(cfg):
        return effects.bloom_quirk_aa_parts(lambda off: whitted._render_flat(
            scene, camera, cfg, backend, key, off, rows=rows))
    return whitted.render_rows(scene, camera, dataclasses.replace(cfg, bloom=False),
                               slice(*rows), backend=backend, generator=key)


def _finish(frame, cfg: RenderConfig):
    """The whole-frame pass: bloom (or the reference's AA + bloom blur)."""
    if effects.is_bloom_quirk_aa(cfg):
        return effects.bloom_quirk_aa_finish(frame)
    return effects.bloom(frame, cfg) if cfg.bloom else frame


def _channels(cfg: RenderConfig) -> int:
    return 6 if effects.is_bloom_quirk_aa(cfg) else 3


def assemble_rows(mesh: Mesh, tile, rows, height: int, width: int, channels: int = 3,
                  axis: str = RAY_AXIS):
    """The frame [H, W, C] on every rank from each rank's row tile (None for
    an empty block): the SUM over ``axis``'s group of the tiles on zero
    frames."""
    if mesh.size(axis) == 1:
        return tile
    frame = torch.zeros((height, width, channels), dtype=torch.float32, device=mesh.device)
    if tile is not None:
        frame[rows[0]:rows[1]] = tile
    return mesh.all_reduce(frame, axis=axis)


def render_on_mesh(scene: Scene, camera: Camera, cfg: RenderConfig, mesh: Mesh, backend,
                   generator=None, ray_axis: Optional[str] = RAY_AXIS):
    """The frame through ``backend`` on every rank, each rank tracing row
    block ``mesh.index(ray_axis)`` (every row when ``ray_axis`` is None),
    the tiles assembled over ``ray_axis``'s group, then the whole-frame
    pass."""
    _check_devices(scene, camera, mesh)
    key = whitted._frame_key(scene, generator)
    rows = (row_block(cfg.height, mesh.index(ray_axis), mesh.size(ray_axis))
            if ray_axis is not None else (0, cfg.height))
    tile = _tile(scene, camera, cfg, backend, key, rows) if rows[1] > rows[0] else None
    if ray_axis is not None:
        tile = assemble_rows(mesh, tile, rows, cfg.height, cfg.width, _channels(cfg), ray_axis)
    return _finish(tile, cfg)


def _render(scene, camera, cfg, mesh, generator, accel, sample_split=None):
    cfg, accel = whitted.resolve_render(scene, cfg, accel)
    backend = whitted.make_backend(scene, cfg, accel=accel)
    if sample_split is not None:
        backend = backend._replace(soft_vis=None, sample_split=sample_split)
    return render_on_mesh(scene, camera, cfg, mesh, backend, generator)


def sharded_render(scene: Scene, camera: Camera, cfg: RenderConfig, mesh: Mesh,
                   generator=None, accel=None):
    """``render()``'s frame [H, W, 3] on every rank, each ray rank tracing
    only its row block.  ``generator`` and ``accel`` as ``render``'s; every
    rank must pass the same seed (or the same ``soft.SampleKey``)."""
    return _render(scene, camera, cfg, mesh, generator, accel)


def sample_sharded_render(scene: Scene, camera: Camera, cfg: RenderConfig, mesh: Mesh,
                          generator=None, accel=None):
    """The scan-path render (``soft_shadow_kernel='off'``) on a 2-D mesh:
    rows over 'rays', each light's soft-shadow sample chunks over 'samples'.
    Equal to the unsharded scan-path render bit for bit."""
    if SAMPLE_AXIS not in mesh.axis_names:
        raise ValueError(f"sample_sharded_render needs a mesh with a {SAMPLE_AXIS!r} axis "
                         f"(make_mesh2), got {mesh.axis_names}")
    split = shading.SampleSplit(mesh.index(SAMPLE_AXIS), mesh.size(SAMPLE_AXIS),
                                lambda counts: mesh.all_reduce(counts, axis=SAMPLE_AXIS))
    cfg = dataclasses.replace(cfg, soft_shadow_kernel="off")
    return _render(scene, camera, cfg, mesh, generator, accel, sample_split=split)


def render_loss(params: Dict, scene: Scene, camera: Camera, target, cfg: RenderConfig,
                generator, apply_params: Callable, mesh: Optional[Mesh] = None, accel=None,
                refit_plan=None, plain: bool = False):
    """This rank's term of the L2 image loss: the sum over its rows of
    (render(scene <- params) - target)^2 over H W 3, so the ranks' terms add
    up to the mean; the whole mean (``optim/inverse.py::render_loss``)
    without a mesh or with one ray rank.  With ``refit_plan`` the tree is
    refit from the current vertices first.  Under bloom the tiles are
    assembled by a differentiable all-reduce and bloomed whole, and each
    rank takes its rows of the result (the all-reduce's backward sums the
    ranks' cotangents of the frame)."""
    from ..ops.refit import refit_accel
    from ..optim import inverse

    if mesh is None or mesh.size(RAY_AXIS) == 1:
        return inverse.render_loss(params, scene, camera, target, cfg,
                                   apply_params=apply_params, generator=generator, accel=accel,
                                   refit_plan=refit_plan, plain=plain)
    scene_p = apply_params(scene, params)
    _check_devices(scene_p, camera, mesh)
    if refit_plan is not None and accel is not None:
        accel = refit_accel(accel, scene_p, refit_plan)
    backend = whitted.make_backend(scene_p, cfg, plain=plain, accel=accel)
    key = whitted._frame_key(scene_p, generator)
    start, stop = rows = row_block(cfg.height, mesh.index(RAY_AXIS), mesh.size(RAY_AXIS))
    if stop <= start:
        raise ValueError(f"ray rank {mesh.index(RAY_AXIS)} of {mesh.size(RAY_AXIS)} has no "
                         f"row of a {cfg.height}-row frame to train on")
    img = _tile(scene_p, camera, cfg, backend, key, rows)
    if cfg.bloom:
        frame = torch.nn.functional.pad(img, (0, 0, 0, 0, start, cfg.height - stop))
        img = _finish(_AllSum.apply(frame, mesh), cfg)[start:stop]
    return ((img - target[start:stop]) ** 2).sum() / float(cfg.height * cfg.width * 3)


class _AllSum(torch.autograd.Function):
    """SUM over the mesh's 'rays' group; its backward sums the cotangents
    the same way (the loss is the sum of every rank's term)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(x.clone(), axis=RAY_AXIS)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.contiguous().clone(), axis=RAY_AXIS), None


def sum_grads(grads: Dict, mesh: Optional[Mesh]) -> Dict:
    """The gradients summed over the mesh's 'rays' group, in one all-reduce
    (a parameter without a gradient keeps None: the graph, and so which
    parameters have one, is the same on every rank)."""
    names = [k for k, g in grads.items() if g is not None]
    if mesh is None or mesh.size(RAY_AXIS) == 1 or not names:
        return grads
    flat = mesh.all_reduce(torch.cat([grads[k].reshape(-1) for k in names]), axis=RAY_AXIS)
    out, at = dict(grads), 0
    for k in names:
        n = grads[k].numel()
        out[k] = flat[at:at + n].view_as(grads[k])
        at += n
    return out


def make_train_step(cfg: RenderConfig, optimizer, apply_params: Callable,
                    mesh: Optional[Mesh] = None, accel=None, refit_plan=None,
                    plain: bool = False, jit: bool = True):
    """The inverse-rendering step: ``step(params, scene, camera, target,
    generator) -> loss`` (the global loss, a detached scalar).  ``params``
    is the dict of leaf tensors that ``optimizer`` (a torch optimizer)
    updates in place: render, backward on fresh leaves, the gradients
    summed over the mesh's 'rays' group, one ``optimizer.step()``.  Without
    a mesh, ``optim/inverse.py::optimize``'s step exactly: on the card (and
    ``jit``) the whole step, the refit and the optimizer's update included,
    is one replay of a CUDA graph (``make_train_loop`` with K = 1), which
    needs a capturable optimizer (``torch.optim.Adam(..., capturable=True)``;
    else it raises).  With a mesh, with ``plain`` (the twins sync with the
    host) or with ``jit=False`` it runs eagerly."""
    loop = make_train_loop(cfg, optimizer, apply_params, 1, mesh=mesh, accel=accel,
                           refit_plan=refit_plan, plain=plain, jit=jit)

    def step(params, scene, camera, target, generator):
        return loop.run(params, scene, camera, target, [generator])[0]

    return step


class _TrainLoop:
    """``make_train_loop``'s chunk: K steps eagerly, or as one graph."""

    def __init__(self, cfg, optimizer, apply_params, steps_per_call, mesh, accel, refit_plan,
                 plain, jit):
        if steps_per_call < 1:
            raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
        self.cfg, self.optimizer, self.apply_params = cfg, optimizer, apply_params
        self.k, self.mesh, self.accel, self.refit_plan = steps_per_call, mesh, accel, refit_plan
        self.plain = plain
        self.graphed = jit and mesh is None and not plain

    def step(self, params, scene, camera, target, generator):
        """One eager step -> loss."""
        from ..optim.inverse import loss_and_grads

        mesh = self.mesh
        loss, grads = loss_and_grads(
            lambda p: render_loss(p, scene, camera, target, self.cfg, generator,
                                  self.apply_params, mesh=mesh, accel=self.accel,
                                  refit_plan=self.refit_plan, plain=self.plain),
            params)
        grads = sum_grads(grads, mesh)
        if mesh is not None:
            loss = mesh.all_reduce(loss.clone(), axis=RAY_AXIS)
        for k, p in params.items():
            p.grad = grads[k]
        self.optimizer.step()
        return loss

    def run(self, params, scene, camera, target, generators):
        """The steps of ``generators`` (each step's generator or sample key)
        -> losses [K]."""
        if len(generators) != self.k:
            raise ValueError(f"a chunk of {self.k} steps got {len(generators)} keys")
        if self.graphed and scene.device.type == "cuda":
            from ..utils import graphs

            spherical = scene.spherical_lights.position.shape[0] > 0
            keys = [soft.as_key(g) if spherical else None for g in generators]
            return graphs.train_chunk(self.step, params, self.optimizer,
                                      (scene, camera, target), keys, owner=self,
                                      hold=(self.accel, self.refit_plan))
        return torch.stack([self.step(params, scene, camera, target, g) for g in generators])

    def __call__(self, params, scene, camera, target, key, start_step: int = 0):
        key = soft.as_key(key)
        return self.run(params, scene, camera, target,
                        [key.fold_in(start_step + j) for j in range(self.k)])


def make_train_loop(cfg: RenderConfig, optimizer, apply_params: Callable, steps_per_call: int,
                    mesh: Optional[Mesh] = None, accel=None, refit_plan=None,
                    plain: bool = False, jit: bool = True):
    """K = ``steps_per_call`` steps per call (the JAX package's K-step
    ``lax.scan``): ``loop(params, scene, camera, target, key, start_step)
    -> losses [K]``; step j samples under ``key.fold_in(start_step + j)``
    (``key`` a ``soft.SampleKey`` or a generator to draw one from), the
    stream of K calls of the step with ``fold_in(i)``.  Without a mesh, on
    the card and with ``jit``, the K steps are captured once as one CUDA
    graph (``utils/graphs.py::train_chunk``) and every call is one replay:
    the host's launches are paid once per chunk length, not per step, and
    the losses stay on the card until the caller reads them.  With a mesh
    (collectives through the host), ``plain`` or ``jit=False`` the K steps
    run eagerly, one after another; the losses are the same."""
    return _TrainLoop(cfg, optimizer, apply_params, steps_per_call, mesh, accel, refit_plan,
                      plain, jit)
