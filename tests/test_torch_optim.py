"""PyTorch port: the inverse-rendering loop (``optim/inverse.py::optimize``),
its npz checkpoints and resume, its logging and the ``cgrt-torch optimize``
and ``bench`` commands, on the CPU.

The losses are held to the JAX package's ``optimize`` on the same scene and
target (its XLA path on the CPU, ``optax.adam``; the port's
``torch.optim.Adam``, the same update) to rtol 1e-4; a resume and a
different checkpoint cadence give the port's own losses bit for bit.
Scenes: the stand-in mirror box (32 triangles, brute force) and the lathed
cup of ``tests/test_torch_bvh.py`` through the CPU BVH (``backend='bvh'``)
with the tree refit every step.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cg_raytracer_tpu as jrt
import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu.optim import inverse as jinv
from cg_raytracer_tpu_torch import cli
from cg_raytracer_tpu_torch.ops import refit
from cg_raytracer_tpu_torch.optim import inverse as tinv
from cg_raytracer_tpu_torch.utils.image import read_image, write_png
from tests.test_torch_bvh import cup_pair
from tests.test_torch_scene import scene_pair

SIZE = 16
LOSS = dict(rtol=1e-4, atol=0.0)
# A view of the box without coincident-edge ties at 16^2 (at the default
# (20, 20, 0) three pixels resolve to another triangle in each package, and
# the loss would differ by them alone).
EULER = (18.0, 22.0, 0.0)


def _apply_kd(scene, params):
    """Replace only the material table's kd (works on both packages' scenes)."""
    return dataclasses.replace(scene, materials=dataclasses.replace(scene.materials,
                                                                    kd=params["kd"]))


def _box_problem():
    """The box, its 16^2 render as the target, and kd moved off it."""
    j, t = scene_pair("mirror_box")
    cfg = dict(width=SIZE, height=SIZE)
    target = trt.render(t, trt.Camera.default(euler_deg=EULER, device="cpu"), trt.RenderConfig(**cfg)).numpy()
    kd0 = t.materials.kd.numpy() * 0.5 + 0.2
    return j, t, cfg, target, kd0


def test_optimize_matches_jax_on_the_box():
    j, t, cfg, target, kd0 = _box_problem()
    _, j_losses = jinv.optimize(j, jrt.Camera.default(euler_deg=EULER), target,
                                jrt.RenderConfig(**cfg), steps=3, learning_rate=1e-2,
                                params={"kd": jnp.asarray(kd0)}, apply_params=_apply_kd,
                                log_every=0)
    params, losses = tinv.optimize(t, trt.Camera.default(euler_deg=EULER, device="cpu"), target,
                                   trt.RenderConfig(**cfg),
                                   steps=3, learning_rate=1e-2,
                                   params={"kd": torch.from_numpy(kd0)}, apply_params=_apply_kd,
                                   log_every=0)
    np.testing.assert_allclose(losses, j_losses, **LOSS)
    assert losses[-1] < losses[0]
    assert not torch.equal(params["kd"], torch.from_numpy(kd0))
    assert torch.equal(t.materials.kd, torch.from_numpy(np.array(j.materials.kd)))  # untouched


def test_checkpoint_roundtrip(tmp_path):
    _, t = scene_pair("mirror_box")
    params = {k: v.clone().requires_grad_(True) for k, v in tinv.material_params(t).items()}
    opt = torch.optim.Adam(list(params.values()), lr=1e-2)
    for p in params.values():
        p.grad = torch.randn_like(p)
    opt.step()
    path = str(tmp_path / "ckpt")  # no .npz suffix: written and read under this name
    tinv.save_checkpoint(path, 17, params, opt)
    params2 = {k: torch.zeros_like(v).requires_grad_(True) for k, v in params.items()}
    opt2 = torch.optim.Adam(list(params2.values()), lr=1e-2)
    assert tinv.load_checkpoint(path, params2, opt2) == 17
    for k in params:
        assert torch.equal(params[k], params2[k]), k
    s1, s2 = opt.state_dict()["state"], opt2.state_dict()["state"]
    assert s1.keys() == s2.keys()
    for i in s1:
        for name in s1[i]:
            assert torch.equal(torch.as_tensor(s1[i][name]), torch.as_tensor(s2[i][name])), name
    with pytest.raises(ValueError, match="holds parameters"):
        tinv.load_checkpoint(path, {"kd": params2["kd"]}, opt2)


def test_resume_and_cadence_give_the_same_losses(tmp_path):
    _, t, cfg, target, kd0 = _box_problem()
    run = dict(learning_rate=5e-2, params={"kd": torch.from_numpy(kd0)}, apply_params=_apply_kd,
               log_every=0)
    cam, rc = trt.Camera.default(euler_deg=EULER, device="cpu"), trt.RenderConfig(**cfg)
    p_full, l_full = tinv.optimize(t, cam, target, rc, steps=6, **run)
    ck = str(tmp_path / "resume.npz")
    _, l_a = tinv.optimize(t, cam, target, rc, steps=3, checkpoint_path=ck, checkpoint_every=3,
                           resume=False, **run)
    p_res, l_b = tinv.optimize(t, cam, target, rc, steps=6, checkpoint_path=ck,
                               checkpoint_every=100, resume=True, **run)
    assert len(l_b) == 3 and l_a + l_b == l_full  # bit for bit
    assert torch.equal(p_full["kd"], p_res["kd"])
    _, l_cad = tinv.optimize(t, cam, target, rc, steps=6, checkpoint_path=str(tmp_path / "c2"),
                             checkpoint_every=2, resume=False, **run)
    assert l_cad == l_full


def test_vertex_translation_on_the_cup_with_the_refit(monkeypatch):
    # tests/test_optim.py:107's case on the cup, through the CPU BVH: the
    # tree is built once over the perturbed geometry and refit every step.
    j, t = cup_pair()
    cfg = dict(width=24, height=24, backend="bvh")
    target = trt.render(t, trt.Camera.default(device="cpu"), trt.RenderConfig(**cfg)).numpy()
    shift = np.asarray([0.0, 0.0, 0.08], np.float32)
    v0 = np.asarray(j.vertices) + shift
    jp = dataclasses.replace(j, vertices=jnp.asarray(v0))
    tp = dataclasses.replace(t, vertices=torch.from_numpy(v0))
    _, j_losses = jinv.optimize(jp, jrt.Camera.default(), target, jrt.RenderConfig(**cfg),
                                steps=3, learning_rate=2e-3, params=jinv.vertex_params(jp),
                                apply_params=jinv.apply_vertex_params, log_every=0)
    refits = []
    real = refit.refit_accel
    monkeypatch.setattr(refit, "refit_accel", lambda *a, **k: refits.append(1) or real(*a, **k))
    params, losses = tinv.optimize(tp, trt.Camera.default(device="cpu"), target, trt.RenderConfig(**cfg),
                                   steps=6, learning_rate=2e-3, params=tinv.vertex_params(tp),
                                   apply_params=tinv.apply_vertex_params, log_every=0)
    assert len(refits) == 6
    np.testing.assert_allclose(losses[:3], j_losses, **LOSS)
    assert losses[-1] < losses[0]
    assert not torch.equal(params["vertices"], tp.vertices)


def test_per_group_learning_rates_and_the_jsonl_log(tmp_path):
    _, t, cfg, target, kd0 = _box_problem()
    params = {"kd": torch.from_numpy(kd0), "ks": t.materials.ks, "shininess": t.materials.shininess}

    def groups(p):
        return torch.optim.Adam([{"params": [p["kd"]], "lr": 0.1},
                                 {"params": [p["ks"], p["shininess"]], "lr": 0.0}])

    log = str(tmp_path / "steps.jsonl")
    out, losses = tinv.optimize(t, trt.Camera.default(device="cpu"), target, trt.RenderConfig(**cfg),
                                steps=3, params=params, optimizer=groups, log_every=0,
                                log_jsonl=log, apply_params=lambda s, p: dataclasses.replace(
                                    s, materials=dataclasses.replace(
                                        s.materials, kd=p["kd"], ks=p["ks"],
                                        shininess=p["shininess"])))
    assert torch.equal(out["ks"], t.materials.ks) and torch.equal(out["shininess"],
                                                                   t.materials.shininess)
    moved = (out["kd"] - torch.from_numpy(kd0)).abs()
    assert moved.max() > 0.05  # Adam moves a rate-0.1 parameter ~0.1 per step
    lines = [json.loads(line) for line in open(log)]
    assert [r["step"] for r in lines] == [0, 1, 2]
    assert {"step", "loss", "param_norm", "step_seconds", "rays_per_s"} <= set(lines[0])
    assert [r["loss"] for r in lines] == losses
    # Multi-device training is ported (parallel/sharding.py): a one-rank
    # mesh runs the same steps; a mesh of another kind raises.
    from cg_raytracer_tpu_torch.parallel.sharding import make_mesh

    cam = trt.Camera.default(device="cpu")
    one = [tinv.optimize(t, cam, target, trt.RenderConfig(**cfg), steps=2, log_every=0,
                         mesh=mesh)[1] for mesh in (None, make_mesh(device="cpu"))]
    assert one[0] == one[1]
    with pytest.raises(TypeError, match="Mesh"):
        tinv.optimize(t, cam, target, trt.RenderConfig(**cfg), steps=1, mesh=object())


def test_cli_optimize_and_bench(tmp_path, capsys):
    _, t, cfg, target, _ = _box_problem()
    target_png, ck, out = tmp_path / "target.png", tmp_path / "ck.npz", tmp_path / "fit.png"
    write_png(str(target_png), torch.from_numpy(target) * 0.8)
    base = ["optimize", "--scene", "mirror_box", "--device", "cpu", "--width", str(SIZE),
            "--height", str(SIZE), "--target", str(target_png), "--checkpoint", str(ck)]
    assert cli.main([*base, "--steps", "2"]) == 0
    assert ck.exists() and "final loss" in capsys.readouterr().out
    assert cli.main([*base, "--steps", "3", "-o", str(out)]) == 0
    text = capsys.readouterr().out
    assert "resumed from" in text and "at step 2" in text and f"wrote {out}" in text
    assert read_image(str(out)).shape == (SIZE, SIZE, 3)
    with np.load(str(ck)) as data:
        assert int(data["step"]) == 3
    assert cli.main([*base, "--width", "8"]) == 2  # the target's size differs
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["bench", "--scene", "mirror_box", "--device", "cpu"])
