"""The metric arithmetic on synthetic inputs: the 95th percentile over
every frame, the idle share from a union of overlapping intervals, the
labelled gaps, each roofline count, and the traffic generator's path."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from rtbench import orbit, tracing, traffic, yard


def test_frame_ms_and_p95_take_every_frame():
    each = [1.0] * 95 + [10.0] * 5
    out = orbit.summary({"frames": 100, "window_s": 0.5, "frame_ms_each": each})
    assert out["frame_ms"] == pytest.approx(5.0)
    assert out["frame_p95_ms"] == pytest.approx(np.percentile(each, 95))
    each[-1] = 1000.0  # a stall in the window moves the tail, not a median
    assert orbit.summary({"frames": 100, "window_s": 0.5,
                          "frame_ms_each": each})["frame_p95_ms"] >= 1.0


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_idle_share_from_union_of_overlapping_intervals():
    events = [
        _ev("user_annotation", "bench.segment", 0.0, 100.0),
        _ev("user_annotation", "bench.render", 0.0, 30.0),
        _ev("user_annotation", "bench.wait", 60.0, 40.0),
        _ev("cuda_runtime", "cudaGraphLaunch", 5.0, 10.0, 7),
        _ev("kernel", "a", 10.0, 20.0, 7),
        _ev("kernel", "b", 20.0, 20.0, 7),  # overlaps a: union [10, 40)
        _ev("gpu_memcpy", "copy", 70.0, 10.0),
        _ev("kernel", "c", 95.0, 10.0),  # clipped at the window's end
    ]
    t = tracing.Trace(events)
    lo, hi = t.span("bench.segment")[0]
    s = t.summary(lo, hi)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((30.0 + 10.0 + 5.0) * 1e-6)
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert gaps["bench.render>cudaGraphLaunch"] == pytest.approx(10e-6)
    assert gaps["bench.segment"] == pytest.approx(30e-6)
    assert gaps["bench.wait"] == pytest.approx(15e-6)
    assert sum(gaps.values()) == pytest.approx(s["window_s"] - s["busy_s"])
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["a"] == pytest.approx(20e-6) and ops["gpu_memcpy"] == pytest.approx(10e-6)
    assert len(t.kernels(lo, hi)) == 3
    g0, g1, _ = t.graph_window()
    assert (g0, g1) == (pytest.approx(5e-6), pytest.approx(40e-6))
    assert len(t.kernels(g0, g1)) == 2


def test_bound_adds_integer_and_float_time():
    s, by = yard.bound_s(67e12, 0.0, 16.7e12 * 0 + yard.INT32_OPS)
    assert s == pytest.approx(2.0) and by == "operations"
    s, by = yard.bound_s(0.0, 3.35e12)
    assert s == pytest.approx(1.0) and by == "bytes"


def test_level_work_matches_the_port_count():
    from cg_raytracer_tpu_torch.scene import standins
    from cg_raytracer_tpu_torch.scene.types import PointLights, make_scene
    from cg_raytracer_tpu_torch.utils import roofline

    scene = make_scene(standins.mirror_box_meshes(),
                       point_lights=PointLights.of(*standins.MIRROR_BOX_LIGHTS), device="cpu")
    prim = torch.tensor([-1, 0, 0, 5, 31, -1, 17], dtype=torch.int64)
    for kw in (dict(kind="level", bits=True, state=False, last=False),
               dict(kind="level", bits=True, state=True, last=True)):
        ours = yard.level_work(scene.num_triangles, scene.triangles.long(),
                               scene.tri_material.long(), 1, 0, prim, **kw)
        assert ours == roofline.level_work(scene, prim.to(torch.int32), **kw)
    flops, byts = yard.level_work(32, scene.triangles.long(), scene.tri_material.long(), 1, 0,
                                  prim, "level", True, False, False)
    assert flops == 5 * yard.RECON_FLOPS + 5 * yard.SHADE_FLOPS + 7 * yard.BOUNCE_MISC_FLOPS


def test_headline_matches_the_port_closed_form():
    from cg_raytracer_tpu_torch.utils import roofline

    ours = yard.headline_roofline(1024, 1024, 32, 1, 2, True)
    theirs = roofline.headline_roofline(1024, 1024, 32, 1, 2, True)
    assert ours["seconds"] == pytest.approx(theirs["ideal_seconds"])
    assert ours["bound"] == theirs["bound"] == "bytes"
    assert ours["bytes"] / 2 ** 20 == pytest.approx(1848 * 1024 * 1024 / 2 ** 20)


def test_sampler_and_blur_counts():
    flops, ints, byts = yard.sampler_work(1000, 200)
    assert flops == 1000 * 200 * 65 and ints == 1000 * 200 * 104 and byts == 1000 * 16
    assert yard.blur_bytes(800, 800) == 2 * 800 * 800 * 12


def test_orbit_drags_and_seeds():
    path = {"yaw_deg": 45.0, "pitch_deg": 15.0, "period": 96, "max_px": 10.0}
    drags = traffic.loop_drags(path)
    assert np.abs(drags).max() <= 10.0
    assert np.allclose(drags.sum(axis=0), 0.0, atol=1e-9)  # a closed loop
    poses = traffic.loop_poses((20.0, 20.0, 0.0), path)
    deg = np.degrees(poses.astype(np.float64))
    assert deg[:, 1].max() <= 20 + 45 + 1e-3 and deg[:, 1].min() >= 20 - 45 - 1e-3
    assert deg[:, 0].max() <= 20 + 15 + 1e-3 and deg[:, 0].min() >= 20 - 15 - 1e-3
    a, b = traffic.Orbit((20.0, 20.0, 0.0), path, 7), traffic.Orbit((20.0, 20.0, 0.0), path,
                                                                     2 ** 31 + 11)
    # Every seed renders the same poses over whole loops, in another order.
    seq_a = sorted(a.index(i) for i in range(96))
    seq_b = sorted(b.index(i) for i in range(96))
    assert seq_a == seq_b == list(range(96))
    assert traffic.checked_frames({"frames": 4, "within": 400}, 5) == traffic.checked_frames(
        {"frames": 4, "within": 400}, 5)
    with pytest.raises(ValueError):
        traffic.loop_drags(dict(path, period=20))


def test_perturbed_target_is_seeded_and_clamped():
    kd = np.full((16, 3), 0.9, np.float32)
    a, b = traffic.perturbed(kd, 0.2, 3), traffic.perturbed(kd, 0.2, 3)
    assert np.array_equal(a, b) and a.max() <= 1.0 and a.min() >= 0.72 - 1e-6
    assert not np.array_equal(a, traffic.perturbed(kd, 0.2, 4))
