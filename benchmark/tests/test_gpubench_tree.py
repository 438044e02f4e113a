"""The tree route's part of the benchmark (``teacup.orbit``): the walk
count's arithmetic on a hand-made frame, the readers ``host_ms.accel``,
``walk_ns_per_ray`` and ``walk_roofline_pct`` on synthetic traces with
known answers and without their span, counter or kernels, and the cell's
run with a broken timed path coming out not correct."""
from __future__ import annotations

import pytest
import torch

import test_gpubench_reference as ref
import test_gpubench_spans as sp
from rtbench import walk, yard

TREE_READERS = ("host_ms.accel", "walk_ns_per_ray", "walk_roofline_pct")
WALK = "void cgrt::bvh_bounce_kernel<4>(float const*, float const*, float const*, int, cgrt::Tree)"


def walk_case():
    """``test_gpubench_spans``' orbit case with its one kernel a walk."""
    ctx, log = sp.orbit_case()
    ctx.trace.device = [(t0, t1, cat, WALK, corr) for t0, t1, cat, _, corr in ctx.trace.device]
    return ctx, log


def test_walk_count_on_a_hand_made_frame():
    """Two levels on a 2 x 2 grid of a stride-3 frame, two point lights:
    level 0 every camera ray live, 3 hits; level 1 the 2 reflected rays,
    1 hit."""
    prim0, live0 = torch.tensor([5, -1, 7, 9]), torch.ones(4, dtype=torch.bool)
    prim1, live1 = torch.tensor([-1, -1, 2, -1]), torch.tensor([True, False, True, False])
    assert walk.level_rays(prim0, live0, 2, 9) == (36, 27, 54)
    assert walk.level_rays(prim1, live1, 2, 9) == (18, 9, 18)
    flops, byts = walk.walk_work(36, 27, 54)
    assert flops == 27 * (64 + 6) + 54 * 21
    assert byts == 36 * (24 + 8) + 27 * 36 + 54 * 1
    want = (yard.bound_s(*walk.walk_work(36, 27, 54))[0]
            + yard.bound_s(*walk.walk_work(18, 9, 18))[0])
    got = walk.frame_bound_s([(prim0, live0), (prim1, live1)], 2, 3)
    assert got == pytest.approx(want, rel=1e-12)
    assert got == pytest.approx(((36 + 18) * 32 + (27 + 9) * 36 + 72) / yard.HBM_BYTES_PER_S)
    assert walk.is_walk("void cgrt::bvh_bounce_kernel<4>(float const*, ...)")
    assert walk.is_walk("void cgrt::bvh_kernel<4, true>(float const*, ...)")
    assert not walk.is_walk("void cgrt::soft_kernel<false, 4>(cgrt::SoftArgs, cgrt::SoftScene)")


def test_tree_readers(with_log, monkeypatch):
    """``host_ms.accel`` from ``cgrt.render.accel``, ``walk_ns_per_ray``
    from the walks' kernels and the program's rays per replay,
    ``walk_roofline_pct`` from the walks' kernels and the reference's hits."""
    from cg_raytracer_tpu_torch.utils import graphs

    ctx, log = sp.orbit_case()
    with_log(log)
    assert sp._read("host_ms.accel", ctx) is None  # the box walks no tree
    with_log(log + [sp._rec("cgrt.render.accel", t, t + 0.02, "cgrt.render.resolve", c)
                    for t, c in ((0.55, 1), (5.55, 2))])
    assert sp._read("host_ms.accel", ctx) == pytest.approx(0.02, rel=1e-9)
    monkeypatch.setattr(graphs, "replay_rays", lambda: {"bounce_bvh4_cuda": {2: 0, 4: 1_500_000}})
    assert sp._read("walk_ns_per_ray", ctx) is None  # no walk kernel in the segment
    assert sp._read("walk_roofline_pct", ctx) is None
    ctx, _ = walk_case()
    assert sp._read("walk_ns_per_ray", ctx) == pytest.approx(1.0, rel=1e-9)  # 1.5 ms, 1.5M rays
    prim, live = torch.tensor([0, -1]), torch.ones(2, dtype=torch.bool)
    ctx.run.config = {"point_lights": [[[-1, 1, -1], [1, 1, 1]]]}
    ctx.run.frame_hits = lambda i: (1, [((0.0, 0.0), [(prim, live)])])
    # each frame: 2 rays x 32 B, one hit's triangle 36 B, one shadow bit
    want = 100.0 * (2 * 32 + 36 + 1) / 3.35e12 / 1.5e-3
    assert sp._read("walk_roofline_pct", ctx) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("counter", ["empty", "absent"])
def test_walk_ns_per_ray_without_the_counter(counter, monkeypatch):
    """A replay that walks no tree, and a program that keeps no ray count."""
    from cg_raytracer_tpu_torch.utils import graphs

    ctx, _ = walk_case()
    if counter == "empty":
        monkeypatch.setattr(graphs, "replay_rays", lambda: {})
    else:
        monkeypatch.delattr(graphs, "replay_rays", raising=False)
    assert sp._read("walk_ns_per_ray", ctx) is None


@pytest.mark.parametrize("name", TREE_READERS)
def test_tree_readers_give_none_where_they_do_not_apply(name, with_log):
    orbit, orbit_log = sp.orbit_case()
    train, train_log = sp.train_case()
    with_log(train_log)
    assert sp._read(name, train) is None
    with_log(None)  # a program that keeps no span log
    assert sp._read(name, orbit) is None
    with_log([r for r in orbit_log if r.name != "cgrt.graph.replay"])  # nothing to map by
    assert sp._read(name, orbit) is None


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
def test_tree_orbit_fault_is_not_correct(kind, monkeypatch):
    assert not ref.correct(ref._orbit_fault("teacup.orbit", kind, monkeypatch))


@pytest.fixture
def with_log(monkeypatch):
    def use(log):
        monkeypatch.setattr(sp.spans, "program_log", lambda: log)
    return use
