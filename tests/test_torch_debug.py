"""PyTorch port: the debug front ends (``utils/debug.py``) against the JAX
package's.

``debug_trace`` and ``hit_statistics`` on the stand-in mirror box, the port
through the CPU brute force and the card's route (the kernels' plain twins),
JAX through its brute force: prim ids, hit masks and shadow bits equal
(the debug rays avoid shared edges; the hit buffer allows the contract's
0.5% of tie pixels), t, positions, normals and u, v within 1e-5.  The BVH
views on the lathed cup's median tree (numpy builders in both packages, the
same arrays): the level boxes equal, the wireframe over the same base image
within ``assert_images_close``.  The profiling helpers against the JAX
package's: the same report, metrics and efficiency; a Chrome trace.
"""
import json
import time

import numpy as np
import pytest
import torch

import cg_raytracer_tpu as jrt
import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu.ops import bvh as jbvh
from cg_raytracer_tpu.utils import debug as jdebug
from cg_raytracer_tpu.utils import profiling as jprof
from cg_raytracer_tpu_torch.interop import camera_from_numpy
from cg_raytracer_tpu_torch.ops import bvh as tbvh
from cg_raytracer_tpu_torch.utils import debug as tdebug
from cg_raytracer_tpu_torch.utils import profiling as tprof
from tests.conftest import assert_images_close
from tests.test_torch_bvh import cup_pair
from tests.test_torch_scene import jax_leaves, scene_pair

CLOSE = dict(rtol=1e-5, atol=1e-5)
NDC = [[0.0, 0.0], [0.31, -0.22], [-0.47, 0.38], [0.6, 0.55], [-0.93, -0.9]]


def cameras():
    jc = jrt.Camera.default()
    return jc, camera_from_numpy(jax_leaves(jc))


@pytest.mark.parametrize("backend", ["brute", "cuda"])
def test_debug_trace_matches_jax(backend):
    j, t = scene_pair("mirror_box")
    jc, tc = cameras()
    want = jdebug.debug_trace(j, jc, NDC, cfg=jrt.RenderConfig(backend="brute"))
    got = tdebug.debug_trace(t, tc, NDC, cfg=trt.RenderConfig(backend=backend))
    assert len(got["levels"]) == len(want["levels"]) == 2
    for level, (g, w) in enumerate(zip(got["levels"], want["levels"])):
        np.testing.assert_array_equal(g["prim_id"], w["prim_id"], err_msg=f"level {level}")
        np.testing.assert_array_equal(g["hit"], w["hit"])
        hit = w["hit"]
        for name in ("origin", "direction"):
            np.testing.assert_allclose(g[name], w[name], **CLOSE, err_msg=name)
        for name in ("t", "position", "normal"):
            np.testing.assert_allclose(g[name][hit], w[name][hit], **CLOSE, err_msg=name)
        assert len(g["shadowed_by_light"]) == len(w["shadowed_by_light"]) == 1
        np.testing.assert_array_equal(g["shadowed_by_light"][0], w["shadowed_by_light"][0])
    assert got["levels"][0]["hit"][:3].all() and not got["levels"][0]["hit"].all()
    # One ray as a bare [2] point.
    one = tdebug.debug_trace(t, tc, NDC[1], cfg=trt.RenderConfig(backend=backend))
    assert one["levels"][0]["prim_id"].tolist() == [got["levels"][0]["prim_id"][1]]


@pytest.mark.parametrize("backend", ["brute", "cuda"])
def test_hit_statistics_matches_jax(backend):
    j, t = scene_pair("mirror_box")
    jc, tc = cameras()
    want = jdebug.hit_statistics(j, jc, jrt.RenderConfig(width=24, height=24, backend="brute"))
    got = tdebug.hit_statistics(t, tc, trt.RenderConfig(width=24, height=24, backend=backend))
    assert set(got) == set(want)
    for name in got:
        assert got[name].shape == want[name].shape == (24, 24), name
    same = got["prim_id"] == want["prim_id"]
    assert same.mean() >= 0.995
    np.testing.assert_array_equal(got["hit"], want["hit"])
    for name in ("t", "u", "v"):
        np.testing.assert_allclose(got[name][same & want["hit"]], want[name][same & want["hit"]],
                                   **CLOSE, err_msg=name)
    assert 0.2 < want["hit"].mean() < 0.9


def cup_trees():
    j, t = cup_pair()
    return j, t, jbvh.build_bvh(j, use_native=False), tbvh.build_bvh(t, use_native=False)


def test_bvh_level_boxes_match_jax():
    _, _, jt, tt = cup_trees()
    levels = tbvh.bvh_num_levels(tt)
    assert levels == jbvh.bvh_num_levels(jt) > 5
    for level in range(levels + 1):
        got, want = tdebug.bvh_level_boxes(tt, level), jdebug.bvh_level_boxes(jt, level)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=f"level {level}")
    assert tdebug.bvh_level_boxes(tt, 0)[0].shape == (1, 3)
    assert tdebug.bvh_level_boxes(tt, levels)[0].shape == (0, 3)


def test_render_bvh_levels_matches_jax():
    j, t, jt, tt = cup_trees()
    jc, tc = cameras()
    base = np.random.default_rng(7).uniform(0.0, 1.0, (48, 40, 3)).astype(np.float32)
    for level in (2, 6):
        want = jdebug.render_bvh_levels(j, jc, level, width=40, height=48, bvh=jt, base=base)
        got = tdebug.render_bvh_levels(t, tc, level, width=40, height=48, bvh=tt, base=base)
        assert got.shape == (48, 40, 3) and got.dtype == np.float32
        assert_images_close(got, want, msg=f"level {level}")
        drawn = np.abs(got - 0.5 * base).max(axis=-1) > 1e-6
        assert drawn.mean() > 0.02, level
    # No base: a render of the scene at the given size.
    img = tdebug.render_bvh_levels(t, tc, 1, width=24, height=24, bvh=tt)
    assert img.shape == (24, 24, 3) and np.isfinite(img).all()


def test_profiling_helpers_match_jax(tmp_path):
    timers = []
    for mod in (tprof, jprof):
        timer = mod.StageTimer()
        for name in ("build", "render", "build"):
            with timer.stage(name, fence=None):
                time.sleep(0.002)
        timers.append(timer)
    assert set(timers[0].stages) == {"build", "render"}
    # Summed per name: two sleeps under "build", one under "render".
    assert timers[0].stages["build"] >= 0.004 and timers[0].stages["render"] >= 0.002
    timers[1].stages = dict(timers[0].stages)
    assert timers[0].report() == timers[1].report()
    with timers[0].stage("fenced", fence={"img": torch.ones(3), "rows": [torch.zeros(2)]}):
        pass
    assert "fenced" in timers[0].stages
    for args in ((1_000_000, 0.25), (1_000_000, 0.25, 4)):
        assert tprof.throughput_metrics(*args) == jprof.throughput_metrics(*args)
    assert tprof.scaling_efficiency(3.2e8, 1e8, 4) == jprof.scaling_efficiency(3.2e8, 1e8, 4)
    with tprof.profiler_trace(None):
        pass
    with tprof.profiler_trace(str(tmp_path / "trace")):
        torch.ones(64).sum()
    (path,) = (tmp_path / "trace").glob("trace_*.json")
    assert json.loads(path.read_text())["traceEvents"]
