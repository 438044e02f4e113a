"""Rank bodies of the port's multi-process tests (``test_torch_parallel.py``,
``test_torch_geometry.py``), started by ``parallel/multihost.py::spawn`` in
a gloo world on the CPU.  No JAX here: the parent test saves the scenes
(``torch.save``), the ranks compute, rank 0 saves what they return, and the
parent compares it with the single-process port and with the JAX package."""
import dataclasses

import torch

from cg_raytracer_tpu_torch.ops.camera import generate_rays
from cg_raytracer_tpu_torch.optim import inverse
from cg_raytracer_tpu_torch.parallel import geometry, sharding
from cg_raytracer_tpu_torch.scene.types import Camera
from cg_raytracer_tpu_torch.utils.config import RenderConfig

BOX_CFG = RenderConfig(width=32, height=32)
SPH_CFG = RenderConfig(width=16, height=16, soft_shadow_samples=8, soft_shadow_chunk=4)
# 32^2: the stand-in's two tie pixels (equal t on a shared edge, another
# triangle) are 0.2% of the frame, where at 16^2 they were 0.8%.
SPH_GEO_CFG = dataclasses.replace(SPH_CFG, width=32, height=32)
EFFECT_CFGS = {  # the row split of each frame-level effect path
    "aa+bloom": dataclasses.replace(BOX_CFG, anti_aliasing=True, bloom=True),
    "quirks aa+bloom": dataclasses.replace(BOX_CFG, anti_aliasing=True, bloom=True,
                                           reference_quirks=True),
    "motion blur": dataclasses.replace(BOX_CFG, width=16, height=13, motion_blur=True),
}
TRAIN_CFG = RenderConfig(width=32, height=32)
LR = 1e-2


def train_step(scene, mesh, target):
    """One ``make_train_step`` on the scene's material parameters (Adam at LR)
    -> (loss, params)."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in inverse.material_params(scene).items()}
    opt = torch.optim.Adam(list(params.values()), lr=LR)
    step = sharding.make_train_step(TRAIN_CFG, opt, inverse.apply_material_params, mesh=mesh)
    loss = step(params, scene, Camera.default(device="cpu"), target, None)
    return loss, {k: v.detach() for k, v in params.items()}


def optimize_resumed(scene, mesh, target, ckpt):
    """``optimize`` for 2 steps with a checkpoint every step, then resumed to
    3 -> (the 3 losses, the final params)."""
    cam = Camera.default(device="cpu")
    kw = dict(steps=2, learning_rate=LR, checkpoint_path=ckpt, checkpoint_every=1, mesh=mesh,
              log_fn=lambda *a: None)
    _, first = inverse.optimize(scene, cam, target, TRAIN_CFG, **kw)
    params, rest = inverse.optimize(scene, cam, target, TRAIN_CFG, **dict(kw, steps=3))
    return first + rest, params


def parallel_cases(rank, scenes_path, out_path, ckpt):
    """Every case of ``test_torch_parallel.py`` in this world (2 or 4 ranks)."""
    torch.set_num_threads(1)
    box, sph, tris, target = torch.load(scenes_path, weights_only=False)
    cam = Camera.default(device="cpu")
    mesh = sharding.make_mesh(device="cpu")
    out = {"world": mesh.world, "box": sharding.sharded_render(box, cam, BOX_CFG, mesh),
           "spherical": sharding.sharded_render(sph, cam, SPH_CFG, mesh)}
    for name, cfg in EFFECT_CFGS.items():
        out[name] = sharding.sharded_render(box, cam, cfg, mesh)
    mesh2 = sharding.make_mesh2(2, mesh.world // 2, device="cpu")
    out["sample_split"] = sharding.sample_sharded_render(sph, cam, SPH_CFG, mesh2)
    out["step"] = train_step(tris, mesh, target)
    bloom_cfg = dataclasses.replace(TRAIN_CFG, bloom=True)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in inverse.material_params(tris).items()}
    loss, grads = inverse.loss_and_grads(lambda p: sharding.render_loss(
        p, tris, cam, target, bloom_cfg, None, inverse.apply_material_params, mesh=mesh), params)
    out["bloom_grads"] = (mesh.all_reduce(loss.clone()), sharding.sum_grads(grads, mesh))
    if mesh.world == 2:
        out["optimize"] = optimize_resumed(tris, mesh, target, ckpt)
    if rank == 0:
        torch.save(out, out_path)


def geometry_cases(rank, scenes_path, out_path):
    """Every multi-rank case of ``test_torch_geometry.py``, in a world of 4:
    a ('rays', 'prims') 2 x 2 mesh and a 4-shard 'prims' mesh."""
    torch.set_num_threads(1)
    cup, box, sph, mixed = torch.load(scenes_path, weights_only=False)
    cam = Camera.default(device="cpu")
    o, d = generate_rays(cam, 32, 32)
    mesh2 = sharding.make_mesh2(2, 2, device="cpu", axes=("rays", geometry.PRIM_AXIS))
    prim_index = mesh2.index(geometry.PRIM_AXIS)
    out = {"rank": rank}
    for label, cfg in (("auto", BOX_CFG), ("cuda", dataclasses.replace(BOX_CFG,
                                                                        backend="cuda"))):
        shards = geometry.build_geometry_shards(cup, 2, cfg, shard=prim_index)
        out[f"cup hits {label}"] = geometry.geometry_sharded_intersect(cup, cfg, mesh2, shards,
                                                                       o, d)
        out[f"cup 2x2 {label}"] = geometry.geometry_sharded_render(cup, cam, cfg, mesh2,
                                                                   shards=shards, ray_axis="rays")
    shards = geometry.build_geometry_shards(mixed, 2, BOX_CFG, shard=prim_index)
    out["mixed hits"] = geometry.geometry_sharded_intersect(mixed, BOX_CFG, mesh2, shards, o, d)
    mesh4 = sharding.make_mesh(device="cpu", axis=geometry.PRIM_AXIS)
    out["cup 4"] = geometry.geometry_sharded_render(cup, cam, BOX_CFG, mesh4)
    out["box 4"] = geometry.geometry_sharded_render(box, cam, BOX_CFG, mesh4)
    out["spherical 4"] = geometry.geometry_sharded_render(sph, cam, SPH_GEO_CFG, mesh4)
    out["box 4 aa+bloom"] = geometry.geometry_sharded_render(box, cam,
                                                             EFFECT_CFGS["aa+bloom"], mesh4)
    gathered = torch.zeros((4,) + out["cup hits auto"].t.shape)
    gathered[rank] = out["cup hits auto"].t
    out["every rank's t"] = mesh4.all_reduce(gathered)
    if rank == 0:
        torch.save(out, out_path)


def failing(rank):
    """Rank 1 raises: the spawned world must report it."""
    if rank == 1:
        raise RuntimeError("rank 1 failed on purpose")
