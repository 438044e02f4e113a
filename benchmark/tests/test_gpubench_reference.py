"""The plain reference against the program at a tiny size on the CPU, the
precision control failing the check, and a run whose timed path is broken
underneath coming out not correct (one test per fault the cell can have).

Each run here is the harness's own driver with the look for a card left
out: the program renders on the CPU (its kernels' plain twins), the
reference checks it as a run on the card does."""
from __future__ import annotations

import copy

import pytest
import torch

from rtbench import fit, main, orbit, spec

SEED = 2 ** 31 + 12345
BENCH = spec.load()


def small_cell(name, size=24):
    cell = spec.cell(name, BENCH)
    config = dict(cell.config, width=size, height=size)
    mix = copy.deepcopy(cell.mix)
    geometry = cell.geometry()
    if config["spherical_lights"]:
        config["soft_shadow_samples"] = 40  # a multiple of the CPU scan's chunk of 20
    if mix["kind"] == "orbit":
        mix.update(warmup_frames=1, warmup_s=0.0)
        mix["compare"].update(frames=2, within=4, pixels=48, full_frame_work=4e5)
        return orbit.OrbitRun(config, mix, cell.limits, SEED, geometry, "cpu")
    mix["resolution"] = [size, size]
    return fit.FitRun(config, mix, cell.limits, SEED, geometry, "cpu")


def drive(run, frames=5):
    """Set-up, a short window, release, the check -> [(name, value, limit)]."""
    if isinstance(run, orbit.OrbitRun):
        run.setup()
        run.frames_until(frames)
    else:
        run.setup(size_window=False)
        run.window(0.0, steps=run.k)
    run.release()
    return run.check()


def correct(checks) -> bool:
    return all(main.finite(v) and v <= lim for _, v, lim in checks)


CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_program_agrees_with_reference(name):
    checks = drive(small_cell(name))
    assert correct(checks), checks


@pytest.mark.parametrize("name", [n for n in CELLS if spec.cell(n, BENCH).mix["kind"] == "orbit"])
def test_precision_control_fails(name):
    run = small_cell(name)
    frames = [0, 1, 2]
    ref = run.reference_images(frames)
    low = run.reference_images(frames, torch.bfloat16)
    worst = max(orbit.off_share(low[i], ref[i]) for i in frames)
    assert worst > run.limits["frame_off_pct"], worst


def test_fit_precision_control_fails():
    run = small_cell("cornell_box.train")
    ref = run.reference()
    low = run.reference(torch.bfloat16)
    window = run.window_reference(low["state"], torch.bfloat16)
    g = fit.gaps(run.stand_in(low, window), ref, run.window_reference(low["state"]))
    assert any(g[k] > run.limits[k] for k in fit.COMPARED), g


# -- a broken timed path ------------------------------------------------------

def _orbit_fault(name, kind, monkeypatch):
    run = small_cell(name)
    run.setup()
    render = run.render
    first = []

    def stale(*a, **k):  # a step that returns its state unchanged: the first frame again
        img = render(*a, **k)
        if not first:
            first.append(img)
        return first[0].clone()

    def half(*a, **k):  # half of the rows left out
        img = render(*a, **k).clone()
        img[img.shape[0] // 2:] = 0.0
        return img

    if kind == "stale":
        run.render = stale
    elif kind == "half":
        run.render = half
    else:  # an answer altered where it is produced: one light's Phong term
        from cg_raytracer_tpu_torch.ops import shading

        phong = shading.phong_one_light

        def altered(*a, **k):
            d, s = phong(*a, **k)
            return d * 1.01, s

        monkeypatch.setattr(shading, "phong_one_light", altered)
    run.frames_until(5)
    run.release()
    return run.check()


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
@pytest.mark.parametrize("name", ["cornell_box.orbit", "cornell_box_spherical.orbit",
                                  "cornell_box.orbit_fx"])
def test_orbit_fault_is_not_correct(name, kind, monkeypatch):
    assert not correct(_orbit_fault(name, kind, monkeypatch))


def _plant_fit_fault(kind, monkeypatch):
    from cg_raytracer_tpu_torch.ops import shading
    from cg_raytracer_tpu_torch.optim import inverse

    if kind == "unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif kind == "half":
        render_params = inverse.render_params

        def half_loss(params, scene, camera, target, cfg, **kw):
            img = render_params(params, scene, camera, cfg, **kw)
            rows = img.shape[0] // 2
            return torch.mean((img[:rows] - target[:rows]) ** 2)

        monkeypatch.setattr(inverse, "render_loss", half_loss)
    else:
        phong = shading.phong_one_light

        def altered(*a, **k):
            d, s = phong(*a, **k)
            return d * 1.01, s

        monkeypatch.setattr(shading, "phong_one_light", altered)


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_fit_fault_is_not_correct(kind, monkeypatch):
    _plant_fit_fault(kind, monkeypatch)
    assert not correct(drive(small_cell("cornell_box.train")))


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_fit_window_fault_is_not_correct(kind, monkeypatch):
    """Set-up's chunk sound, the fault in the window's chunks alone."""
    run = small_cell("cornell_box.train")
    run.setup(size_window=False)
    _plant_fit_fault(kind, monkeypatch)
    run.window(0.0, steps=run.k)
    run.release()
    checks = run.check()
    assert not correct(checks), checks


@pytest.mark.cuda
def test_a_run_on_the_card_is_correct(card):
    """One short run of the first cell through ``run.py`` on the card."""
    import json
    import subprocess
    import sys

    out = subprocess.run([sys.executable, spec.os.path.join(spec.BENCH_DIR, "run.py"),
                          "--workload", CELLS[0], "--seed", str(SEED), "--seconds", "2",
                          "--trace", "0"], capture_output=True, text=True, timeout=1200,
                         cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
