"""PyTorch port: the program's spans (``utils/profiling.py::span``).

On the CPU: without a profiler a ``render()`` and an ``optimize()`` log
nothing and enter no ``record_function``; under a CPU ``torch.profiler``
they log ``cgrt.render`` -> ``cgrt.render.resolve`` and ``cgrt.fit`` ->
``cgrt.fit.chunk`` with their parents and one call id per root, and the
exported Chrome trace holds the same names at the same times (the clock
contract: ``t0_ns`` within 50 µs of the event's ``ts`` +
``baseTimeNanoseconds``); the ring keeps the last ``SPAN_LOG_SIZE`` spans.

The tree route (a lathed cup of 1,200 triangles, the benchmark's teacup
surface on a coarse grid, under ``backend="cuda"``): ``cgrt.render.accel``
inside ``cgrt.render.resolve`` on every frame of a tree scene and on none of
the box; a first render's ``cgrt.accel.build`` with ``cgrt.accel.binary``
and ``cgrt.accel.collapse`` inside; the tree-shape counters against the
built tree and its binary tree; the rays counter carried through a
capture's own tally and its replays.

On the card (marker ``cuda``, skipped here): the ``cgrt.graph.*`` spans of a
graphed frame, one ``cgrt.graph.capture`` on its first call and none on the
second, the parts of a warm frame covering at least 90% of its
``cgrt.render``, and the rays counter after N replays N times one eager
frame's.  This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_tracing.py
"""
import importlib.util
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu_torch.models import whitted
from cg_raytracer_tpu_torch.ops import bvh4
from cg_raytracer_tpu_torch.ops.bvh import build_bvh
from cg_raytracer_tpu_torch.optim import inverse
from cg_raytracer_tpu_torch.scene.presets import load_standin
from cg_raytracer_tpu_torch.scene.types import PointLights, make_scene
from cg_raytracer_tpu_torch.utils import counters, graphs, profiling

SIZE = 16
CLOCK_NS = 50_000
PARTS = ("cgrt.render.resolve", "cgrt.graph.inputs", "cgrt.graph.key_fill",
         "cgrt.graph.replay", "cgrt.graph.outputs")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graphed route runs only on the card)")
    return torch.device("cuda")


def _box(device="cpu"):
    scene = load_standin("mirror_box", device=device)
    return scene, trt.Camera.default(device=device), trt.RenderConfig(width=SIZE, height=SIZE)


def _cup(device="cpu"):
    """A fresh 1,200-triangle cup (new tensors: its tree is not memoized
    yet) and a config whose route walks a tree on any device."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "benchmark", "configs", "teacup.py")
    spec = importlib.util.spec_from_file_location("tracing_test_teacup", path)
    cup = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cup)
    scene = make_scene(cup.cup(24, 26), point_lights=PointLights.of(((-1, 1, -1), (1, 1, 1))),
                       device=device)
    return scene, trt.Camera.default(device=device), trt.RenderConfig(width=SIZE, height=SIZE,
                                                                      backend="cuda")


def _fit(scene, cam, cfg, target):
    return inverse.optimize(scene, cam, target, cfg, steps=2, learning_rate=1e-2, log_every=0,
                            steps_per_call=1)


def test_off_logs_nothing(monkeypatch):
    """PyTorch's own ``record_function``s (the optimizer's step) still
    enter; a ``cgrt.*`` one raises."""
    scene, cam, cfg = _box()
    target = trt.render(scene, cam, cfg)
    profiling.clear_span_log()
    record_function = torch.autograd.profiler.record_function

    def guarded(name, *args, **kwargs):
        if name.startswith(profiling.SPAN_PREFIX):
            raise AssertionError(f"{name} entered with no profiler recording")
        return record_function(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", guarded)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", guarded)
    trt.render(scene, cam, cfg)
    _fit(scene, cam, cfg, target)
    assert profiling.span("render") is profiling.span("fit")  # the one null context
    assert profiling.span_log() == []


def test_on_logs_nested_spans_and_the_trace_holds_them(tmp_path):
    scene, cam, cfg = _box()
    target = trt.render(scene, cam, cfg)
    profiling.clear_span_log()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trt.render(scene, cam, cfg)
        _fit(scene, cam, cfg, target)
    log = profiling.span_log()
    profiling.clear_span_log()
    by_name = {}
    for r in log:
        by_name.setdefault(r.name, []).append(r)
        assert r.t0_ns <= r.t1_ns
    (render,), (fit,) = by_name["cgrt.render"], by_name["cgrt.fit"]
    assert render.parent is None and fit.parent is None and render.call != fit.call
    (resolve,) = [r for r in by_name["cgrt.render.resolve"] if r.call == render.call]
    assert resolve.parent == "cgrt.render"
    assert render.t0_ns <= resolve.t0_ns <= resolve.t1_ns <= render.t1_ns
    chunks = by_name["cgrt.fit.chunk"]
    assert len(chunks) == 2
    for c in chunks:
        assert c.parent == "cgrt.fit" and c.call == fit.call
        assert fit.t0_ns <= c.t0_ns <= c.t1_ns <= fit.t1_ns
    assert not any(n.startswith("cgrt.graph.") for n in by_name)  # CPU scenes run eagerly
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    assert set(by_name) <= names


def _event_starts(trace: dict, name: str) -> list:
    base = int(trace["baseTimeNanoseconds"])
    return [base + round(float(e["ts"]) * 1e3) for e in trace["traceEvents"]
            if e.get("name") == name and e.get("cat") == "user_annotation"]


def test_span_clock_is_the_trace_clock(tmp_path):
    """Each span's ``t0_ns`` lies within 50 µs of its Chrome trace event's
    ``ts`` + ``baseTimeNanoseconds``.  The first ``record_function`` of a
    process costs milliseconds, so a render warms it first; of three
    renders, one must hold for every span (a preemption of this process
    between the event's start and the clock read is not the clock)."""
    scene, cam, cfg = _box()
    trt.render(scene, cam, cfg)
    path = os.path.join(tmp_path, "trace.json")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trt.render(scene, cam, cfg)
        profiling.clear_span_log()
        calls = []
        for _ in range(3):
            trt.render(scene, cam, cfg)
            calls.append(profiling.span_log())
            profiling.clear_span_log()
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    worst = []
    for records in calls:
        assert {r.name for r in records} == {"cgrt.render", "cgrt.render.resolve"}
        worst.append(max(min(abs(s - r.t0_ns) for s in _event_starts(trace, r.name))
                         for r in records))
    assert min(worst) <= CLOCK_NS, worst


def test_ring_is_bounded():
    profiling.clear_span_log()
    extra = 10
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(profiling.SPAN_LOG_SIZE + extra):
            with profiling.span("ring"):
                pass
    log = profiling.span_log()
    profiling.clear_span_log()
    assert len(log) == profiling.SPAN_LOG_SIZE == 65536
    assert all(r.name == "cgrt.ring" and r.parent is None for r in log)
    calls = [r.call for r in log]
    assert calls == sorted(calls) and calls[-1] - calls[0] == profiling.SPAN_LOG_SIZE - 1
    assert profiling.span_log() == []


def test_accel_span_on_tree_scenes_only():
    cup, cam, cfg = _cup()
    box = load_standin("mirror_box", device="cpu")
    trt.render(cup, cam, cfg)
    trt.render(box, cam, cfg)
    profiling.clear_span_log()
    with profile(activities=[ProfilerActivity.CPU]):
        trt.render(cup, cam, cfg)
        cup_log = profiling.span_log()
        profiling.clear_span_log()
        trt.render(box, cam, cfg)
        box_log = profiling.span_log()
        profiling.clear_span_log()
    (resolve,) = [r for r in cup_log if r.name == "cgrt.render.resolve"]
    (accel,) = [r for r in cup_log if r.name == "cgrt.render.accel"]
    assert accel.parent == "cgrt.render.resolve" and accel.call == resolve.call
    assert resolve.t0_ns <= accel.t0_ns <= accel.t1_ns <= resolve.t1_ns
    assert not any(r.name.startswith("cgrt.accel.") for r in cup_log)  # the memo's tree
    assert "cgrt.render.resolve" in {r.name for r in box_log}
    assert not any("accel" in r.name for r in box_log)


def test_accel_build_records_its_parts():
    cup, cam, cfg = _cup()
    profiling.clear_span_log()
    with profile(activities=[ProfilerActivity.CPU]):
        trt.render(cup, cam, cfg)
    log = profiling.span_log()
    profiling.clear_span_log()
    (accel,) = [r for r in log if r.name == "cgrt.render.accel"]
    (build,) = [r for r in log if r.name == "cgrt.accel.build"]
    (binary,) = [r for r in log if r.name == "cgrt.accel.binary"]
    (collapse,) = [r for r in log if r.name == "cgrt.accel.collapse"]
    assert build.parent == "cgrt.render.accel" and build.call == accel.call
    assert accel.t0_ns <= build.t0_ns <= build.t1_ns <= accel.t1_ns
    for part in (binary, collapse):
        assert part.parent == "cgrt.accel.build" and part.call == build.call
        assert build.t0_ns <= part.t0_ns <= part.t1_ns <= build.t1_ns
    assert binary.t1_ns <= collapse.t0_ns


def test_tree_counts_match_the_built_tree():
    cup, _, cfg = _cup()
    tree = whitted.build_accel(cup, cfg)
    counts = bvh4.tree_counts()
    assert counts == bvh4.tree_shape(tree)
    leaf = cfg.resolve_bvh_max_leaf()
    binary = build_bvh(cup, max_leaf=leaf, builder=cfg.resolve_bvh_builder(1200, cup.device))
    sizes = binary.count[binary.count > 0]
    assert counts["width"] == tree.width == 4 and counts["triangles"] == 1200
    assert counts["nodes"] == tree.num_nodes and counts["depth"] == tree.depth
    assert counts["leaves"] == sizes.numel() and counts["leaf_max"] == int(sizes.max()) <= leaf
    assert counts["leaf_mean"] == pytest.approx(1200 / sizes.numel())
    assert counts["bytes"] == sum(x.numel() * x.element_size() for x in
                                  (tree.boxes, tree.meta, tree.nchild, tree.tris,
                                   tree.slot_to_prim, tree.nodes, tree.rows))


def test_rays_counter_carried_through_a_capture(monkeypatch):
    """A capture's launches and rays go into the graph's own tally and not
    the totals, and each replay adds that tally: N replays count N times
    the captured rays, and ``replay_rays`` gives one replay's."""
    monkeypatch.setattr(counters, "_LAST", [counters.Tally()])
    bvh4.reset_launch_counts()
    tally = counters.Tally()
    try:
        with counters.recording(tally):
            counters.count("bounce_bvh4_cuda", 4, 640)
            counters.count("bounce_bvh4_cuda", 4, 640)
            counters.count("occluded_bvh4_cuda", 2, 100)
        assert all(n == 0 for n in bvh4.ray_counts().values())
        for _ in range(3):
            counters.replayed(tally)
        rays = bvh4.ray_counts()
        assert rays["bounce_bvh4_cuda:w4"] == 3 * 1280 and rays["occluded_bvh4_cuda:w2"] == 300
        assert bvh4.launch_counts()["bounce_bvh4_cuda"] == 6
        assert graphs.replay_rays() == {"bounce_bvh4_cuda": {2: 0, 4: 1280, 8: 0},
                                        "occluded_bvh4_cuda": {2: 100, 4: 0, 8: 0}}
    finally:
        bvh4.reset_launch_counts()


@pytest.mark.cuda
def test_rays_counter_after_replays(cuda_device):
    """N graphed frames hand the walks N times the rays of one eager frame
    (every level's rays, live or not), and ``replay_rays`` gives one."""
    cup, cam, cfg = _cup(cuda_device)
    cfg = trt.RenderConfig(width=64, height=64)
    graphs.clear()
    bvh4.reset_launch_counts()
    trt.render(cup, cam, cfg, jit=False)
    torch.cuda.synchronize()
    eager = bvh4.ray_counts()
    assert eager["bounce_bvh4_cuda:w4"] == 2 * 64 * 64  # depth 2: a level's rays each
    trt.render(cup, cam, cfg)
    bvh4.reset_launch_counts()
    for _ in range(3):
        trt.render(cup, cam, cfg)
    torch.cuda.synchronize()
    assert bvh4.ray_counts() == {k: 3 * n for k, n in eager.items()}
    assert graphs.replay_rays() == {"bounce_bvh4_cuda": {2: 0, 4: 2 * 64 * 64, 8: 0}}
    graphs.clear()


@pytest.mark.cuda
def test_graphed_frame_spans(cuda_device):
    scene, cam, cfg = _box(cuda_device)
    cfg = trt.RenderConfig(width=64, height=64)
    from cg_raytracer_tpu_torch.utils import graphs

    graphs.clear()
    profiling.clear_span_log()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        trt.render(scene, cam, cfg)
        torch.cuda.synchronize()
        first = profiling.span_log()
        profiling.clear_span_log()
        trt.render(scene, cam, cfg)
        torch.cuda.synchronize()
        second = profiling.span_log()
        profiling.clear_span_log()
    graphs.clear()
    names = [r.name for r in first]
    assert names.count("cgrt.graph.capture") == 1
    (capture,) = [r for r in first if r.name == "cgrt.graph.capture"]
    assert capture.parent == "cgrt.graph.inputs"
    assert "cgrt.graph.capture" not in {r.name for r in second}
    for records in (first, second):
        (root,) = [r for r in records if r.name == "cgrt.render"]
        for name in ("cgrt.render.resolve", "cgrt.graph.inputs", "cgrt.graph.replay",
                     "cgrt.graph.outputs"):
            (r,) = [x for x in records if x.name == name]
            assert r.parent == "cgrt.render" and r.call == root.call
            assert root.t0_ns <= r.t0_ns <= r.t1_ns <= root.t1_ns


@pytest.mark.cuda
def test_graphed_parts_cover_the_call(cuda_device):
    """The parts of a warm graphed frame cover at least 90% of
    ``cgrt.render`` over 20 frames, the box and the spherical box."""
    from cg_raytracer_tpu_torch.utils import graphs

    for name in ("mirror_box", "spherical_box"):
        scene = load_standin(name, device=cuda_device)
        cam = trt.Camera.default(device=cuda_device)
        cfg = trt.RenderConfig(width=256, height=256, soft_shadow_samples=8)
        gen = torch.Generator().manual_seed(1)
        graphs.clear()
        trt.render(scene, cam, cfg, generator=gen)
        torch.cuda.synchronize()
        profiling.clear_span_log()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            for _ in range(20):
                trt.render(scene, cam, cfg, generator=gen)
                torch.cuda.synchronize()
        log = profiling.span_log()
        profiling.clear_span_log()
        graphs.clear()
        total = sum(r.t1_ns - r.t0_ns for r in log if r.name == "cgrt.render")
        parts = sum(r.t1_ns - r.t0_ns for r in log if r.name in PARTS)
        assert sum(r.name == "cgrt.render" for r in log) == 20
        assert (name == "spherical_box") == any(r.name == "cgrt.graph.key_fill" for r in log)
        assert parts >= 0.9 * total, (name, parts, total)
