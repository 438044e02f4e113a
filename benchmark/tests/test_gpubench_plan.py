"""``plan_hit_pct``: the share of the graphed ``render()`` calls that
replayed their frame plan, read from the program's counts
(``cg_raytracer_tpu_torch/models/whitted.py::plan_counts``): its value on an
orbit, None where the program keeps no such count (as before the plan),
made no graphed call, or the run is a fit."""
from __future__ import annotations

import pytest

import test_gpubench_spans as sp

NAME = "plan_hit_pct"


def _whitted():
    from cg_raytracer_tpu_torch.models import whitted

    return whitted


@pytest.mark.parametrize("counts, want", [((1000, 999), 99.9), ((4, 0), 0.0),
                                          ((7, 7), 100.0), ((0, 0), None)])
def test_hit_share(counts, want, monkeypatch):
    ctx, _ = sp.orbit_case()
    calls, hits = counts
    monkeypatch.setattr(_whitted(), "plan_counts", lambda: {"calls": calls, "hits": hits})
    got = sp._read(NAME, ctx)
    assert got == (None if want is None else pytest.approx(want, rel=1e-12))


@pytest.mark.parametrize("why", ["no_counts", "train"])
def test_none_where_it_does_not_apply(why, monkeypatch):
    """A program without the counts (the parent of the plan), and a fit."""
    ctx, _ = sp.orbit_case() if why != "train" else sp.train_case()
    if why == "no_counts":
        monkeypatch.delattr(_whitted(), "plan_counts")
    else:
        monkeypatch.setattr(_whitted(), "plan_counts", lambda: {"calls": 10, "hits": 9})
    assert sp._read(NAME, ctx) is None


def test_declared_for_the_orbit_cells():
    from rtbench import spec

    bench = spec.load()
    (entry,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    orbits = [w["name"] for w in bench["workloads"] if w["traffic"].startswith("orbit")]
    assert sorted(entry["workloads"]) == sorted(orbits)
    assert entry["layer"] == "dispatch" and entry["moves"] == "frame_ms"
    assert entry["better"] == "higher" and entry["unit"] == "%"
    assert entry["source"] == "program_counter"


def test_the_program_counts_graphed_calls_and_hits():
    # The counts are the registry's, read after the graphs are released.
    from cg_raytracer_tpu_torch.utils import graphs

    whitted = _whitted()
    before = whitted.plan_counts()
    whitted.counters.count("render_graphed")
    whitted.counters.count("render_graphed")
    whitted.counters.count("render_plan_hit")
    graphs.clear()
    after = whitted.plan_counts()
    assert after["calls"] - before["calls"] == 2 and after["hits"] - before["hits"] == 1
