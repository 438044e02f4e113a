"""PyTorch port: compiled dispatch (``utils/graphs.py``, ``render(jit=...)``,
``optimize(steps_per_call=...)``), the sample keys on the card
(``ops/soft.py::KeyTable``), the quirk blur's adjoint, and the small module
gaps it closes (``utils/roofline.py``'s headline, ``utils/bench.py::time_fn``,
``scene/lights.py::num_lights``), on the CPU.

CPU scenes never reach a CUDA graph, so these tests hold what the graphs
rest on, as far as a CPU run can show it:

- ``optimize`` in chunks of K = 1 or 3 steps (a 3 + 3 + 1 tail; a
  checkpoint boundary inside a chunk, and a resume from it) gives the
  losses and final parameters of K = 1 bit for bit; on the box, K = 3
  matches the JAX package's ``optimize(steps_per_call=3)`` to
  ``test_torch_optim.py``'s rtol 1e-4 (``tests/test_optim.py:73-95``'s
  case);
- ``render(jit=True)`` on a CPU scene equals ``jit=False`` bit for bit and
  captures nothing;
- the cache key (``graphs.render_key``) separates configs, shapes, trees
  and spherical lights, and merges scenes that differ only in values;
- the plain sampler reading its keys from a ``KeyTable`` equals the one
  given host ints, and after ``fill`` with other roots it samples those;
- the quirk blur's plain adjoint equals ``torch.autograd`` through the plain
  forward (rtol 1e-5, atol 1e-6: the two add the same terms, grouped
  differently) and, at 24 x 20, ``jax.vjp`` of the JAX package's
  ``_bloom_quirk_blur`` (the same tolerance).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cg_raytracer_tpu as jrt
import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu.ops import effects as je
from cg_raytracer_tpu.optim import inverse as jinv
from cg_raytracer_tpu.scene import lights as jlights
from cg_raytracer_tpu.utils import roofline as jroof
from cg_raytracer_tpu_torch.ops import effects as te
from cg_raytracer_tpu_torch.ops import soft
from cg_raytracer_tpu_torch.optim import inverse as tinv
from cg_raytracer_tpu_torch.scene import lights as tlights
from cg_raytracer_tpu_torch.scene.presets import load_standin
from cg_raytracer_tpu_torch.utils import bench as tbench
from cg_raytracer_tpu_torch.utils import graphs
from cg_raytracer_tpu_torch.utils import roofline as troof
from tests.test_torch_optim import EULER, LOSS, _apply_kd, _box_problem
from tests.test_torch_scene import scene_pair

FN = dict(rtol=1e-5, atol=1e-6)


def _cam():
    return trt.Camera.default(euler_deg=EULER, device="cpu")


def _run(t, cfg, target, kd0, **kw):
    return tinv.optimize(t, _cam(), target, trt.RenderConfig(**cfg), learning_rate=5e-2,
                         params={"kd": torch.from_numpy(kd0)}, apply_params=_apply_kd,
                         log_every=0, **kw)


@pytest.mark.parametrize("k", [1, 3])
def test_optimize_chunks_equal_one_step_per_call(k, tmp_path):
    _, t, cfg, target, kd0 = _box_problem()
    p_ref, l_ref = _run(t, cfg, target, kd0, steps=7, steps_per_call=1)
    p_k, l_k = _run(t, cfg, target, kd0, steps=7, steps_per_call=k)  # 3 + 3 + 1
    assert len(l_k) == 7 and l_k == l_ref
    assert torch.equal(p_k["kd"], p_ref["kd"])
    # A checkpoint every 4 steps cuts the second chunk (3 + 1 + 3), and a
    # run stopped there resumes to the same losses and parameters.
    ck = str(tmp_path / f"k{k}.npz")
    p_cut, l_cut = _run(t, cfg, target, kd0, steps=7, steps_per_call=k, checkpoint_path=ck,
                        checkpoint_every=4, resume=False)
    assert l_cut == l_ref and torch.equal(p_cut["kd"], p_ref["kd"])
    ck2 = str(tmp_path / f"k{k}_resume.npz")
    _, l_a = _run(t, cfg, target, kd0, steps=4, steps_per_call=k, checkpoint_path=ck2,
                  checkpoint_every=4, resume=False)
    p_b, l_b = _run(t, cfg, target, kd0, steps=7, steps_per_call=k, checkpoint_path=ck2,
                    checkpoint_every=4, resume=True)
    assert l_a + l_b == l_ref and torch.equal(p_b["kd"], p_ref["kd"])


def test_optimize_steps_per_call_matches_jax():
    j, t, cfg, target, kd0 = _box_problem()
    _, j_losses = jinv.optimize(j, jrt.Camera.default(euler_deg=EULER), target,
                                jrt.RenderConfig(**cfg), steps=4, learning_rate=1e-2,
                                params={"kd": jnp.asarray(kd0)}, apply_params=_apply_kd,
                                log_every=0, steps_per_call=3)
    _, losses = tinv.optimize(t, _cam(), target, trt.RenderConfig(**cfg), steps=4,
                              learning_rate=1e-2, params={"kd": torch.from_numpy(kd0)},
                              apply_params=_apply_kd, log_every=0, steps_per_call=3)
    np.testing.assert_allclose(losses, j_losses, **LOSS)


@pytest.mark.parametrize("name,flags", [
    ("mirror_box", {}),
    ("mirror_box", dict(anti_aliasing=True, bloom=True, reference_quirks=True)),
    ("spherical_box", dict(soft_shadow_samples=8)),
])
def test_render_jit_on_the_cpu_is_the_eager_render(name, flags):
    scene = load_standin(name, device="cpu")
    cfg = trt.RenderConfig(width=16, height=12, **flags)
    graphs.clear()
    got = trt.render(scene, trt.Camera.default(device="cpu"), cfg)
    want = trt.render(scene, trt.Camera.default(device="cpu"), cfg, jit=False)
    assert torch.equal(got, want)
    assert len(graphs.CACHE) == 0


def test_render_key_separates_what_a_graph_bakes_in():
    box = load_standin("mirror_box", device="cpu")
    cam = trt.Camera.default(device="cpu")
    cfg = trt.RenderConfig(width=16, height=16)
    key = graphs.render_key(box, cam, cfg)
    # Values do not enter the key: the replay copies them in.
    moved = dataclasses.replace(box, materials=dataclasses.replace(
        box.materials, kd=box.materials.kd * 0.5), vertices=box.vertices + 0.1)
    assert graphs.render_key(moved, trt.Camera.default(dist=2.0, device="cpu"), cfg) == key
    assert graphs.render_key(box, cam, trt.RenderConfig(width=16, height=16)) == key
    # Each of these is another graph.
    tree_a, tree_b = object(), object()
    others = [
        graphs.render_key(box, cam, dataclasses.replace(cfg, width=17)),
        graphs.render_key(box, cam, dataclasses.replace(cfg, bloom=True)),
        graphs.render_key(tlights.add_point_light(box), cam, cfg),
        graphs.render_key(dataclasses.replace(box, vertices=box.vertices[:-1]), cam, cfg),
        graphs.render_key(box, cam, cfg, accel=tree_a),
        graphs.render_key(box, cam, cfg, accel=tree_b),
        graphs.render_key(tlights.add_spherical_light(box), cam, cfg),
        graphs.graph_key("render", cfg, "cpu", (box, cam), True),
    ]
    assert len(set(others + [key])) == len(others) + 1
    assert graphs.render_key(box, cam, cfg, accel=tree_a) == graphs.render_key(
        box, cam, cfg, accel=tree_a)


def test_graph_inputs_flatten_and_rebuild():
    box = load_standin("spherical_box", device="cpu")
    tree = (box, trt.Camera.default(device="cpu"), {"a": torch.ones(2), "b": None})
    flat = graphs.leaves(tree)
    back = graphs.rebuild(tree, iter([x + 1 for x in flat]))
    assert graphs.structure(back) == graphs.structure(tree)
    for x, y in zip(flat, graphs.leaves(back)):
        assert torch.equal(x + 1, y)
    assert back[2]["b"] is None and isinstance(back[0], type(box))


def test_capturable_optimizers_only():
    p = [torch.zeros(3, requires_grad=True)]
    graphs.check_capturable(torch.optim.Adam(p, capturable=True))
    graphs.check_capturable(torch.optim.SGD(p, lr=0.1))  # keeps no host state
    with pytest.raises(ValueError, match="capturable"):
        graphs.check_capturable(torch.optim.Adam(p))


def test_restore_puts_back_params_and_optimizer_state():
    params = {"x": torch.ones(4, requires_grad=True)}
    opt = torch.optim.Adam(list(params.values()), lr=0.1)
    for fresh in (True, False):
        saved, p0 = graphs._snapshot(params, opt), params["x"].detach().clone()
        before = {n: (v.clone() if torch.is_tensor(v) else v)
                  for n, v in opt.state[params["x"]].items()}
        params["x"].grad = torch.full((4,), 0.5)
        opt.step()
        graphs._restore(params, opt, saved)
        assert torch.equal(params["x"], p0)
        state = opt.state[params["x"]]
        for n, v in state.items():
            want = torch.zeros_like(v) if fresh else before[n]
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(want)), n
        opt.step()  # the state the next test round starts from


def _sampler_case():
    """The spherical box's hit points of a 24 x 24 frame, one in five
    unmarked."""
    from cg_raytracer_tpu_torch.ops import cuda_kernels as ck
    from cg_raytracer_tpu_torch.ops.camera import generate_rays

    scene = load_standin("spherical_box", device="cpu")
    o, d = generate_rays(trt.Camera.default(device="cpu"), 24, 24)
    hit = ck.intersect_plain(scene, o, d)
    ok = hit.prim_id >= 0
    pos = (o + d * torch.where(ok, hit.t, 0.0)[:, None])[ok]
    valid = torch.arange(pos.shape[0]) % 5 != 0
    lights = scene.spherical_lights
    return scene, pos, lights.position[0], lights.radius[0], valid


def test_plain_sampler_reads_its_keys_from_the_table():
    scene, pos, lpos, lrad, valid = _sampler_case()
    key, other = soft.SampleKey(2026, 16, 5), soft.SampleKey(7, 99, 5)

    def counts(k):
        return soft.soft_prng_plain(scene, pos, lpos, lrad, k.fold_in(1).fold_in(0), 24, valid)

    want, want_other = counts(key), counts(other)
    assert not torch.equal(want, want_other)
    table = soft.KeyTable("cpu")
    with table:
        got = counts(table.root(0, key))
    assert torch.equal(got, want) and table.paths == [(0, 1, 0)]
    table.fill([other])  # a replay's keys: the slots now hold other's derivations
    with table:
        assert torch.equal(counts(table.root(0, key)), want_other)
    with table, pytest.raises(RuntimeError, match="baked"):
        counts(key)  # a key no root derives


@pytest.mark.parametrize("hw", [(24, 20), (37, 53), (3, 40)])
def test_quirk_blur_adjoint_matches_autograd(hw):
    rng = np.random.default_rng(sum(hw))
    x = torch.from_numpy(rng.uniform(0.0, 2.0, (*hw, 3)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((*hw, 3)).astype(np.float32))
    leaf = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(te.bloom_quirk_plain(leaf), leaf, g)
    np.testing.assert_allclose(te.bloom_quirk_adjoint_plain(g).numpy(), want.numpy(), **FN)
    # The autograd Function the effects call takes the same adjoint.
    leaf2 = x.clone().requires_grad_(True)
    te._bloom_quirk_blur(leaf2).backward(g)
    np.testing.assert_allclose(leaf2.grad.numpy(), want.numpy(), **FN)


def test_quirk_blur_adjoint_matches_jax_vjp():
    rng = np.random.default_rng(24)
    x = rng.uniform(0.0, 2.0, (24, 20, 3)).astype(np.float32)
    g = rng.standard_normal((24, 20, 3)).astype(np.float32)
    y, vjp = jax.vjp(je._bloom_quirk_blur, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(te.bloom_quirk_plain(torch.from_numpy(x)).numpy(),
                               np.asarray(y), **FN)
    np.testing.assert_allclose(te.bloom_quirk_adjoint_plain(torch.from_numpy(g)).numpy(),
                               np.asarray(want), **FN)


def test_headline_roofline_counts_match_jax():
    for args in ((1024, 1024, 32, 1, 2, True), (800, 800, 256, 8, 1, False)):
        got, want = troof.headline_roofline(*args), jroof.headline_roofline(*args)
        assert got["rays"] == want["rays"]
        assert got["gflops_per_frame"] == pytest.approx(want["gflops_per_frame"], rel=1e-12)
        assert got["mbytes_per_frame"] == pytest.approx(want["mbytes_per_frame"], rel=1e-12)
        t_ops = got["gflops_per_frame"] * 1e9 / troof.F32_FLOPS
        t_bytes = got["mbytes_per_frame"] * 1e6 / troof.HBM_BYTES_PER_S
        assert got["ideal_seconds"] == pytest.approx(max(t_ops, t_bytes), rel=1e-12)
        assert got["bound"] == ("operations" if t_ops >= t_bytes else "bytes")
    info = troof.headline_roofline(1024, 1024, 32, 1, 2, True)
    pct = troof.pct_of_roofline(2 * info["ideal_seconds"], info["gflops_per_frame"] * 1e9,
                                info["mbytes_per_frame"] * 1e6)
    assert pct == pytest.approx(50.0)


def test_num_lights_and_time_fn():
    j, t = scene_pair("mirror_box")
    for js, ts in ((j, t), (jlights.add_spherical_light(j), tlights.add_spherical_light(t))):
        assert tlights.num_lights(ts) == jlights.num_lights(js)
    calls = []
    s = tbench.time_fn(lambda a: calls.append(a), 1, iters=3, warmup=1)
    assert calls == [1] * 4 and s >= 0.0


def test_cache_evicts_least_recently_used_and_forgets_an_owner():
    released = []

    class Entry:
        def __init__(self, name):
            self.name = name

        def release(self):
            released.append(self.name)

    cache, saved = graphs.GraphCache(capacity=3), graphs.CACHE
    graphs.CACHE = cache
    try:
        a, b = object(), object()
        cache.put((("train", id(a)), 1), Entry("a1"))
        cache.put((("fwd_bwd", id(b)), 1), Entry("b1"))
        cache.put(("render", 1), Entry("r1"))
        assert cache.get((("train", id(a)), 1)).name == "a1"  # now the most recent
        cache.put((("train", id(a)), 2), Entry("a2"))
        assert released == ["b1"] and len(cache) == 3
        graphs.forget(a)
        assert sorted(released) == ["a1", "a2", "b1"] and list(cache.entries) == [("render", 1)]
        graphs.clear()
        assert released[-1] == "r1" and len(cache) == 0
    finally:
        graphs.CACHE = saved
