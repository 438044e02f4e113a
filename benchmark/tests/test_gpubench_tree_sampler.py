"""The tree sampler's part of the benchmark (``teacup_spherical.orbit``):
the readers ``tree_sampler_visits_per_sample`` and
``tree_sampler_tests_per_sample`` on given tallies of the program
(``cg_raytracer_tpu_torch/ops/soft.py::tree_sampler_counts``), None where
they do not apply or the program keeps no tally (as before it), the cell
declared in every list it reports, its run with a broken timed path (a
wrong sample count among them) coming out not correct, and on the card a
launch's tally against the plain walk's ``stats=`` on the same points."""
from __future__ import annotations

import dataclasses

import pytest

import test_gpubench_reference as ref
import test_gpubench_spans as sp

CELL = "teacup_spherical.orbit"
READERS = {"tree_sampler_visits_per_sample": "visits", "tree_sampler_tests_per_sample": "tests"}
LIGHT = {"spherical_lights": [[[-1.0, 1.0, -1.0], 0.1, [1.0, 1.0, 1.0]]]}
# Every list of BENCHMARK.json that names the cell: the orbit cells' end-to-end
# metrics, dispatch and device metrics, the tree route's and the sampler's.
LISTS = ("frame_ms", "frame_p95_ms", "host_ms.render", "idle_pct.render", "kernels_per_frame",
         "host_ms.resolve", "host_ms.graph_inputs", "host_ms.key_fill", "host_ms.graph_replay",
         "host_ms.graph_outputs", "idle_pct.render.dispatch", "plan_hit_pct",
         "walk_roofline_pct", "walk_ns_per_ray", "host_ms.accel", "sampler_roofline_pct")


def _soft():
    from cg_raytracer_tpu_torch.ops import soft

    return soft


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("counts, per_sample", [
    ({"samples": 200, "visits": 9000, "tests": 3100}, {"visits": 45.0, "tests": 15.5}),
    ({"samples": 7, "visits": 7, "tests": 0}, {"visits": 1.0, "tests": 0.0}),
    ({"samples": 0, "visits": 0, "tests": 0}, None)])
def test_per_sample_ratio(name, counts, per_sample, monkeypatch):
    ctx, _ = sp.orbit_case()
    ctx.run.config = dict(LIGHT)
    monkeypatch.setattr(_soft(), "tree_sampler_counts", lambda: dict(counts))
    got = sp._read(name, ctx)
    want = None if per_sample is None else per_sample[READERS[name]]
    assert got == (None if want is None else pytest.approx(want, rel=1e-12))


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("why", ["no_tally", "no_tree_sampler", "point_lights", "train"])
def test_none_where_it_does_not_apply(name, why, monkeypatch):
    """A program without the tally (the parent of it), a run in which no
    tree sampler ran (the spherical box's brute sampler), a point-lit cell,
    and a fit."""
    ctx, _ = sp.orbit_case() if why != "train" else sp.train_case()
    ctx.run.config = {"point_lights": [[[-1, 1, -1], [1, 1, 1]]]} if why == "point_lights" \
        else dict(LIGHT)
    if why == "no_tally":
        monkeypatch.delattr(_soft(), "tree_sampler_counts")
    else:
        samples = 0 if why == "no_tree_sampler" else 400
        monkeypatch.setattr(_soft(), "tree_sampler_counts",
                            lambda: {"samples": samples, "visits": 9 * samples, "tests": 1})
    assert sp._read(name, ctx) is None


def test_the_program_keeps_the_tally_and_resets_it(monkeypatch):
    """``tree_sampler_counts`` sums every device's triple; the reset zeroes
    it in place (a captured graph keeps adding into the same tensor)."""
    import torch

    soft = _soft()
    monkeypatch.setattr(soft, "_TREE_TALLY", {})
    assert soft.tree_sampler_counts() == {"samples": 0, "visits": 0, "tests": 0}
    tally = soft._tree_tally(torch.device("cpu"))
    tally.add_(torch.tensor([5, 60, 20]))
    assert soft.tree_sampler_counts() == {"samples": 5, "visits": 60, "tests": 20}
    soft.reset_tree_sampler_counts()
    assert soft.tree_sampler_counts()["samples"] == 0
    assert soft._tree_tally(torch.device("cpu")) is tally


def test_declared_in_every_list():
    from rtbench import spec

    bench = spec.load()
    (cell,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("teacup_spherical", "orbit", 1)
    (config,) = [c for c in bench["configs"] if c["name"] == "teacup_spherical"]
    assert config["reduced"] == [] and len(config["source"]) <= 200
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    for name in LISTS:
        assert CELL in metrics[name]["workloads"], name
    for name, what in READERS.items():
        m = metrics[name]
        assert m["workloads"] == [CELL] and m["unit"] == f"{what}/sample"
        assert (m["layer"], m["moves"], m["better"], m["source"]) == (
            "kernels", "frame_ms", "lower", "program_counter")
    # Nothing else reports it: the lists that name the cell are those above.
    named = {n for n, m in metrics.items() if CELL in m.get("workloads", ())}
    assert named == set(LISTS) | set(READERS)


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
def test_orbit_fault_is_not_correct(kind, monkeypatch):
    assert not ref.correct(ref._orbit_fault(CELL, kind, monkeypatch))


def test_wrong_sample_count_is_not_correct():
    """The program's frames drawn with half the configuration's samples
    (the same stream's first half), every pixel of the small frame checked."""
    run = ref.small_cell(CELL)
    run.mix["compare"]["pixels"] = run.width * run.height
    run.setup()
    run.cfg = dataclasses.replace(run.cfg, soft_shadow_samples=run.cfg.soft_shadow_samples // 2)
    run.frames_until(5)
    run.release()
    checks = run.check()
    assert not ref.correct(checks), checks


def _cup_points(card, size=48):
    """The spherical teacup on the card, its tree, and the hit points of a
    ``size``² frame of its default camera with every fifth left unmarked."""
    import torch

    from cg_raytracer_tpu_torch.models import whitted
    from cg_raytracer_tpu_torch.ops import bvh4
    from cg_raytracer_tpu_torch.ops.camera import generate_rays
    from cg_raytracer_tpu_torch.scene.presets import load_standin
    from cg_raytracer_tpu_torch.scene.types import Camera
    from cg_raytracer_tpu_torch.utils.config import RenderConfig

    scene = load_standin("spherical_teacup", card)
    tree = whitted.build_accel(scene, RenderConfig())
    o, d = generate_rays(Camera.default(device=card), size, size)
    hit = bvh4.intersect_bvh4_cuda(scene, tree, o, d)
    valid = hit.prim_id >= 0
    pos = torch.where(valid[:, None], o + d * torch.where(valid, hit.t, 0.0)[:, None], 0.0)
    marked = valid & (torch.arange(valid.shape[0], device=card) % 5 != 0)
    return scene, tree, pos.contiguous(), marked


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["table", "philox"])
def test_tally_of_a_launch_against_the_plain_walk(card, source):
    """One cone-sampler launch at 200 samples over the teacup's 4-wide tree:
    its live samples are the marked points' samples, and its walks' visits
    and tests are the plain walk's on the same rays.  With a table the rays
    are bit for bit the twin's, so the counts are equal; with the key the
    kernel's logf / sincosf and PyTorch's log / cos may differ in the last
    bit, which moves a sample point by an ulp and can change that ray's
    walk, so they agree within 1e-3 of the plain walk's."""
    import torch

    soft = _soft()
    scene, tree, pos, marked = _cup_points(card)
    num = 200
    lp, lr = scene.spherical_lights.position[0], scene.spherical_lights.radius[0]
    light = soft.light_row(lp, lr)
    key, g_nsc = soft.SampleKey(2026, 4, 777), None
    soft.reset_tree_sampler_counts()
    if source == "table":
        g = torch.randn((num, pos.shape[0], 3), generator=torch.Generator().manual_seed(5))
        g = g.to(card)
        g_nsc = g.permute(1, 0, 2).contiguous()
        got = soft.soft4_table_cuda(scene, tree, pos, lp, lr, g, valid=marked)
    else:
        got = soft.soft4_prng_cuda(scene, tree, pos, lp, lr, key, num, valid=marked)
    torch.cuda.synchronize()
    tally = soft.tree_sampler_counts()
    stats = {}
    want = soft._counts_plain(soft._tree_anyhit(tree, stats), pos, light, num,
                              marked.to(torch.uint8), key=None if g_nsc is not None else key,
                              gauss_nsc=g_nsc)
    assert tally["samples"] == int(marked.sum()) * num
    assert stats["visits"] > tally["samples"] and stats["tests"] > 0
    if source == "table":
        assert torch.equal(got, want.to(torch.float32))
        assert (tally["visits"], tally["tests"]) == (stats["visits"], stats["tests"])
    else:
        for what in ("visits", "tests"):
            assert abs(tally[what] - stats[what]) <= 1e-3 * stats[what], (what, tally, stats)


@pytest.mark.cuda
def test_tally_of_graphed_frames(card):
    """Two graphed frames of the spherical teacup add their replays' walks
    to the tally, and the sampler's rays stay out of the walk rays."""
    import torch

    from cg_raytracer_tpu_torch.models.whitted import render
    from cg_raytracer_tpu_torch.scene.presets import load_standin
    from cg_raytracer_tpu_torch.scene.types import Camera
    from cg_raytracer_tpu_torch.utils import graphs
    from cg_raytracer_tpu_torch.utils.config import RenderConfig

    soft = _soft()
    scene = load_standin("spherical_teacup", card)
    cfg = RenderConfig(width=64, height=64)
    gen = torch.Generator().manual_seed(1)
    render(scene, Camera.default(device=card), cfg, generator=gen)
    torch.cuda.synchronize()
    soft.reset_tree_sampler_counts()
    for _ in range(2):
        render(scene, Camera.default(device=card), cfg, generator=gen)
    torch.cuda.synchronize()
    counts = soft.tree_sampler_counts()
    assert counts["samples"] > 0 and counts["samples"] % (2 * cfg.soft_shadow_samples) == 0
    assert counts["visits"] > counts["samples"] and counts["tests"] > 0
    assert set(graphs.replay_rays()) == {"bounce_bvh4_cuda"}
