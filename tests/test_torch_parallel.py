"""PyTorch port, the multi-device slice: ray- and sample-parallel renders,
the data-parallel training step and ``optimize(mesh=...)``
(``parallel/sharding.py``), and the launch, row split and tile recovery
(``parallel/multihost.py``).

Ranks are processes: one gloo world of 2 ranks and one of 4 on the CPU are
spawned once for this file (``multihost.spawn``), and each runs every case
(``tests/torch_parallel_worker.py``).  What is held, and to what:

- the sharded renders (the mirror-box stand-in at 32^2, every frame-level
  effect path, the spherical stand-in at 16^2 with 8 samples in chunks of
  4, sharded by rows and, on a ('rays', 'samples') mesh, by sample chunks)
  equal the port's single-process render bit for bit; the box's is within
  ``assert_images_close`` of JAX's ``sharded_render`` on 2 and 4 virtual
  devices (the spherical stand-in is not held to JAX: the streams differ);
- training on ``mixed_tris`` (12 triangles, two point lights, one
  reflective material: no tie pixel between the two packages at 32^2):
  one ``make_train_step`` on 2 and 4 ranks matches the port's single step
  (loss rtol 1e-6, params atol 1e-6: the gradient sum adds in another
  order) and JAX's ``make_train_step`` on a 2-device mesh (loss rtol 1e-5,
  params atol 1e-5: two renderers' float32 images, same hits); the bloom loss's
  gradients (bloomed whole through a differentiable all-reduce) match the
  single-process ones (rtol 1e-5, atol 1e-7);
- ``optimize(mesh=...)`` over 3 steps, checkpointed every step and resumed
  after 2, matches ``optimize()`` (losses rtol 1e-6, params atol 1e-6);
- ``host_local_rows`` equals JAX's for several (H, world, rank);
  ``render_with_recovery`` with an injected tile fault equals JAX's on the
  same renderer, failures list included; ``initialize_distributed`` does
  nothing without the environment; a failing rank fails the spawn; a mesh
  asked for the card raises without one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as tmp

import cg_raytracer_tpu as jrt
import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu.models.whitted import render_rows as j_render_rows
from cg_raytracer_tpu.optim.inverse import apply_material_params as j_apply
from cg_raytracer_tpu.optim.inverse import material_params as j_material_params
from cg_raytracer_tpu.parallel import multihost as jmh
from cg_raytracer_tpu.parallel import sharding as jsh
from cg_raytracer_tpu_torch.models.whitted import render_rows
from cg_raytracer_tpu_torch.optim import inverse
from cg_raytracer_tpu_torch.parallel import multihost, sharding
from cg_raytracer_tpu_torch.scene import standins
from tests import torch_parallel_worker as worker
from tests.conftest import assert_images_close
from tests.test_torch_scene import scene_pair

CAM = trt.Camera.default(device="cpu")
STEP = dict(rtol=1e-6, atol=1e-6)


def _box(pkg):
    kw = {"device": "cpu"} if pkg is trt else {}
    return pkg.make_scene(standins.mirror_box_meshes(),
                          point_lights=pkg.PointLights.of(*standins.MIRROR_BOX_LIGHTS), **kw)


def _spherical_box():
    return trt.make_scene(standins.mirror_box_meshes(),
                          spherical_lights=trt.SphericalLights.of(
                              *standins.SPHERICAL_BOX_LIGHTS), device="cpu")


def _tris():
    return scene_pair("mixed_tris")[1]


def _target(cfg):
    return torch.full((cfg.height, cfg.width, 3), 0.25)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world size: what rank 0 of that spawned world returned}."""
    d = tmp_path_factory.mktemp("parallel")
    box = _box(trt)
    torch.save((box, _spherical_box(), _tris(), _target(worker.TRAIN_CFG)), d / "scenes.pt")
    out = {}
    for n in (2, 4):
        multihost.spawn(worker.parallel_cases, n, args=(str(d / "scenes.pt"),
                                                        str(d / f"out{n}.pt"),
                                                        str(d / f"ckpt{n}.npz")))
        out[n] = torch.load(d / f"out{n}.pt", weights_only=False)
        assert out[n]["world"] == n
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_render_equals_single_render_and_jax(worlds, n):
    got = worlds[n]
    box = _box(trt)
    assert torch.equal(got["box"], trt.render(box, CAM, worker.BOX_CFG))
    for name, cfg in worker.EFFECT_CFGS.items():
        assert torch.equal(got[name], trt.render(box, CAM, cfg)), name
    jcfg = jrt.RenderConfig(width=32, height=32)
    j_img = np.asarray(jsh.sharded_render(_box(jrt), jrt.Camera.default(), jcfg,
                                          jsh.make_mesh(n)))
    assert_images_close(got["box"].numpy(), j_img, msg=f"{n} ranks vs JAX sharded_render")
    assert (j_img.max(axis=-1) > 0.02).mean() > 0.2


@pytest.mark.parametrize("n", [2, 4])
def test_spherical_sharded_renders_are_bit_equal(worlds, n):
    single = trt.render(_spherical_box(), CAM, worker.SPH_CFG)
    assert single.amax() > 0.02
    assert torch.equal(worlds[n]["spherical"], single)
    # 2 x (n / 2) ('rays', 'samples'): each rank scans half the chunks.
    assert torch.equal(worlds[n]["sample_split"], single)


def _single_step():
    return worker.train_step(_tris(), None, _target(worker.TRAIN_CFG))


@pytest.mark.parametrize("n", [2, 4])
def test_train_step_matches_single_step(worlds, n):
    loss, params = worlds[n]["step"]
    want_loss, want = _single_step()
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=0)
    for k in want:
        torch.testing.assert_close(params[k], want[k], **STEP, msg=k)
    # Bloom: the frame assembled by a differentiable all-reduce.
    loss, grads = worlds[n]["bloom_grads"]
    tris, cfg = _tris(), dataclasses.replace(worker.TRAIN_CFG, bloom=True)
    want_loss, want = inverse.loss_and_grads(lambda p: inverse.render_loss(
        p, tris, CAM, _target(cfg), cfg, apply_params=inverse.apply_material_params),
        inverse.material_params(tris))
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=0)
    for k in want:
        torch.testing.assert_close(grads[k], want[k], rtol=1e-5, atol=1e-7, msg=k)


def test_train_step_matches_jax_on_a_mesh(worlds):
    jscene = scene_pair("mixed_tris")[0]
    jcfg = jrt.RenderConfig(width=32, height=32)
    opt = optax.adam(worker.LR)
    params = j_material_params(jscene)
    mesh = jsh.make_mesh(2)
    rep = jsh.replicated(mesh)
    step = jsh.make_train_step(jcfg, opt, j_apply, mesh=mesh)
    with mesh:
        j_params, _, j_loss = step(
            jax.device_put(params, rep), jax.device_put(opt.init(params), rep),
            jax.device_put(jscene, rep), jax.device_put(jrt.Camera.default(), rep),
            jax.device_put(jnp.full((32, 32, 3), 0.25, jnp.float32), jsh.row_sharded(mesh)),
            jax.random.PRNGKey(0))
    loss, got = worlds[2]["step"]
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    for k, v in j_params.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), atol=1e-5, err_msg=k)


def test_optimize_on_a_mesh_matches_optimize(worlds, tmp_path):
    losses, params = worlds[2]["optimize"]
    want_params, want = inverse.optimize(_tris(), CAM, _target(worker.TRAIN_CFG), worker.TRAIN_CFG,
                                         steps=3, learning_rate=worker.LR,
                                         log_fn=lambda *a: None)
    assert len(losses) == 3 and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, want, rtol=1e-6)
    for k in want_params:
        torch.testing.assert_close(params[k], want_params[k], **STEP, msg=k)


def test_train_loop_is_steps_of_the_folded_key():
    """K steps of ``make_train_loop`` from ``start_step`` are ``optimize``'s
    steps start..start+K-1 (each under ``fold_in`` of its index)."""
    tris, target = _tris(), _target(worker.TRAIN_CFG)
    cfg = inverse.training_config(worker.TRAIN_CFG, False)
    want = inverse.optimize(tris, CAM, target, worker.TRAIN_CFG, steps=3,
                            learning_rate=worker.LR, log_fn=lambda *a: None)[1]
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in inverse.material_params(tris).items()}
    opt = torch.optim.Adam(list(params.values()), lr=worker.LR)
    loop = sharding.make_train_loop(cfg, opt, inverse.apply_material_params, 2)
    key = inverse._base_key(0)
    losses = torch.cat([loop(params, tris, CAM, target, key, 0),
                        loop(params, tris, CAM, target, key, 2)[:1]])
    assert losses.tolist() == want


def test_single_rank_mesh_needs_no_process_group():
    assert not torch.distributed.is_initialized()
    mesh = sharding.make_mesh(device="cpu")
    assert (mesh.world, mesh.rank, mesh.index(sharding.RAY_AXIS)) == (1, 0, 0)
    box = _box(trt)
    assert torch.equal(sharding.sharded_render(box, CAM, worker.BOX_CFG, mesh),
                       trt.render(box, CAM, worker.BOX_CFG))
    with pytest.raises(ValueError, match="samples"):
        sharding.sample_sharded_render(box, CAM, worker.BOX_CFG, mesh)
    with pytest.raises(ValueError, match="ranks"):
        sharding.make_mesh(2, device="cpu")


def test_entry_points_ask_for_the_card_and_raise_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        sharding.make_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        multihost.global_mesh()


def test_host_local_rows_matches_jax(monkeypatch):
    for height in (1, 5, 13, 32, 800):
        for n in (1, 2, 3, 4, 8):
            monkeypatch.setattr(jax, "process_count", lambda n=n: n)
            for rank in range(n):
                monkeypatch.setattr(jax, "process_index", lambda rank=rank: rank)
                want = jmh.host_local_rows(height)
                got = multihost.host_local_rows(height, (rank, n))
                assert (got.start, got.stop) == (want.start, want.stop), (height, n, rank)
    assert multihost.host_local_rows(7) == slice(0, 7)  # one process


def test_initialize_distributed_is_a_no_op_without_the_environment(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize_distributed() is None
    assert not torch.distributed.is_initialized()


def _faulty(render_fn):
    """A tile renderer that fails the first attempt at rows 8:16."""
    tried = set()

    def tile(rows):
        if rows.start == 8 and rows.start not in tried:
            tried.add(rows.start)
            raise RuntimeError(f"injected fault at rows {rows.start}:{rows.stop}")
        return render_fn(rows)

    return tile


def test_render_with_recovery_matches_jax():
    cfg = trt.RenderConfig(width=24, height=16)
    box = _box(trt)
    img, failures = multihost.render_with_recovery(
        box, CAM, cfg, tile_rows=8,
        render_tile=_faulty(lambda rows: render_rows(box, CAM, cfg, rows)))
    jbox, jcfg = _box(jrt), jrt.RenderConfig(width=24, height=16)
    j_img, j_failures = jmh.render_with_recovery(
        jbox, jrt.Camera.default(), jcfg, tile_rows=8,
        render_tile=_faulty(lambda rows: j_render_rows(jbox, jrt.Camera.default(), jcfg, rows)))
    assert failures == j_failures == [(slice(8, 16), 0,
                                       "RuntimeError('injected fault at rows 8:16')")]
    assert img.dtype == j_img.dtype == np.float32
    assert_images_close(img, j_img, msg="recovered frame vs JAX")
    assert np.array_equal(img, trt.render(box, CAM, cfg).numpy())
    # The default tile renderer, and a tile that keeps failing.
    got, none = multihost.render_with_recovery(box, CAM, cfg, tile_rows=10)
    assert none == [] and np.array_equal(got, img)
    with pytest.raises(RuntimeError, match="always"):
        multihost.render_with_recovery(box, CAM, cfg, max_retries=1,
                                       render_tile=lambda rows: (_ for _ in ()).throw(
                                           RuntimeError("always")))


def test_a_failing_rank_fails_the_spawned_world():
    with pytest.raises(tmp.ProcessRaisedException, match="rank 1 failed on purpose"):
        multihost.spawn(worker.failing, 2)
