"""``sampler_kept_pct``: the share of triangle tests the brute soft-shadow
sampler's per-point culling keeps, read from the program's tally
(``cg_raytracer_tpu_torch/ops/soft.py::cull_counts``): its value on an
orbit of a scene with a spherical light, None where it does not apply or
the program keeps no tally (as before the culling), and on the card a
spherical frame's tally against the tests its launches swept."""
from __future__ import annotations

import pytest

import test_gpubench_spans as sp

NAME = "sampler_kept_pct"
LIGHT = {"spherical_lights": [[[0.0, 0.45, 0.0], 0.1, [1.0, 1.0, 1.0]]]}


def _soft():
    from cg_raytracer_tpu_torch.ops import soft

    return soft


@pytest.mark.parametrize("counts, want", [((17, 100), 17.0), ((0, 64), 0.0),
                                          ((5, 5), 100.0), ((0, 0), None)])
def test_kept_share(counts, want, monkeypatch):
    ctx, _ = sp.orbit_case()
    ctx.run.config = dict(LIGHT)
    monkeypatch.setattr(_soft(), "cull_counts", lambda: counts)
    got = sp._read(NAME, ctx)
    assert got == (None if want is None else pytest.approx(want, rel=1e-12))


@pytest.mark.parametrize("why", ["point_lights", "no_tally", "train"])
def test_none_where_it_does_not_apply(why, monkeypatch):
    """A scene without a spherical light, a program without the tally (the
    parent of the culling), and a fit."""
    ctx, _ = sp.orbit_case() if why != "train" else sp.train_case()
    ctx.run.config = {} if why == "point_lights" else dict(LIGHT)
    if why == "no_tally":
        monkeypatch.delattr(_soft(), "cull_counts")
    else:
        monkeypatch.setattr(_soft(), "cull_counts", lambda: (3, 10))
    assert sp._read(NAME, ctx) is None


def test_declared_for_the_spherical_box():
    from rtbench import spec

    bench = spec.load()
    (entry,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert entry["workloads"] == ["cornell_box_spherical.orbit"]
    assert entry["layer"] == "kernels" and entry["moves"] == "frame_ms"
    assert entry["better"] == "lower" and entry["unit"] == "%"


@pytest.mark.cuda
def test_tally_of_a_spherical_frame(card):
    """Two graphed frames of the spherical box: every live sample counts
    the box's 32 triangles as swept, and the masks keep fewer."""
    import torch

    from cg_raytracer_tpu_torch.models.whitted import render
    from cg_raytracer_tpu_torch.scene.presets import load_standin
    from cg_raytracer_tpu_torch.scene.types import Camera
    from cg_raytracer_tpu_torch.utils.config import RenderConfig

    soft = _soft()
    scene = load_standin("spherical_box", card)
    cfg = RenderConfig(width=64, height=64)
    gen = torch.Generator().manual_seed(1)
    render(scene, Camera.default(device=card), cfg, generator=gen)
    soft.reset_cull_counts()
    for _ in range(2):
        render(scene, Camera.default(device=card), cfg, generator=gen)
    torch.cuda.synchronize()
    kept, swept = soft.cull_counts()
    assert swept > 0 and swept % (32 * cfg.soft_shadow_samples) == 0
    assert 0 < kept < swept
