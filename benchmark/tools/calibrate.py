"""The readings that a cell's check limits are set from, on the card, in one
process: the program's readings on many seeds (the lower readings), the
precision control's (the plain reference computed in bfloat16, put in the
program's place) and, for a fit, the readings of planted faults (the upper
readings).  The benchmark's own runs never run this.

    python3 benchmark/tools/calibrate.py --workload <cell> --seeds 1,2,...,12 \\
        --control-seeds 21,22,23 [--fault-seeds 31,32,33] --out cal.jsonl

An orbit cell renders, for each seed, the window's frames up to its last
checked one (untimed, through the same ``render()`` calls) and compares
them as a run does.  A fit runs, for each seed, set-up's first chunk and
the window's first steps; its faults are planted in the reference put in
the program's place, from the start and in the window's steps alone.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

from rtbench import fit, main, orbit, spec  # noqa: E402


def emit(out: str, record: dict) -> None:
    print(json.dumps(record), flush=True)
    with open(out, "a") as f:
        f.write(json.dumps(record) + "\n")


def orbit_cell(cell, seeds, control_seeds, out) -> None:
    import torch

    base = orbit.OrbitRun(cell.config, cell.mix, cell.limits, seeds[0], cell.geometry())
    base.setup()
    for kind, group in (("program", seeds), ("control", control_seeds)):
        for seed in group:
            t0 = time.time()
            run = orbit.OrbitRun(cell.config, cell.mix, cell.limits, seed, cell.geometry())
            run.adopt(base)
            run.frames_until(max(run.checked) + 1)
            frames = sorted(run.kept)
            refs = run.reference_images(frames)
            if kind == "program":
                got = {i: run.program_pixels(i, run.kept[i]).float() for i in frames}
            else:
                got = run.reference_images(frames, torch.bfloat16)
            worst = max(orbit.off_share(got[i], refs[i]) for i in frames)
            emit(out, {"cell": cell.name, "kind": kind, "seed": seed,
                       "frame_off_pct": worst, "frames": frames, "s": time.time() - t0})


def fit_faults(run, first: int) -> dict:
    """The planted faults' ``reference/train.py::fit`` hooks, from step
    ``first`` on: half of the batch left out (the mean over the top half of
    the rows), the image altered where it is produced (x 1.01)."""
    rows = run.height // 2

    def half(step, img, target):
        if step < first:
            return img, target
        shape = (run.height, run.width, 3)
        return img.reshape(shape)[:rows], target.reshape(shape)[:rows]

    def altered(step, img, target):
        return (img * 1.01 if step >= first else img), target

    return {"half_batch": half, "altered_image": altered}


def fault_readings(run, ref: dict, first: int) -> dict:
    """Each fault's gaps, planted from step ``first`` on (0: every step;
    K: the window's steps alone), in the reference put in the program's
    place; the window is held against the sound reference's step from the
    state the faulted fit reached."""
    out = {}
    for name, hook in fit_faults(run, first).items():
        faulty = run.reference(fault=hook)
        window = run.window_reference(faulty["state"], fault=hook)
        g = fit.gaps(run.stand_in(faulty, window), ref, run.window_reference(faulty["state"]))
        out[name] = g
    # A step that returns its state unchanged: from ``first`` on every loss
    # is that step's, and the window is held against one step from there.
    if first == 0:
        zeros = {k: np.zeros_like(fit._numpy(v)) for k, v in ref["grad"].items()}
        prog = {"losses": [ref["losses"][0]] * run.k, "window": [ref["losses"][0]] * 2,
                "moment": zeros, "change": zeros}
        out["state_unchanged"] = fit.gaps(prog, ref, ref["losses"][:2])
    else:
        win = run.window_reference(ref["state"])
        prog = run.stand_in(ref, [win[0], win[0]])
        out["state_unchanged"] = fit.gaps(prog, ref, win)
    return out


def fit_cell(cell, seeds, control_seeds, fault_seeds, out) -> None:
    import torch

    for kind, group in (("program", seeds), ("control", control_seeds),
                        ("fault", fault_seeds)):
        for seed in group:
            t0 = time.time()
            run = fit.FitRun(cell.config, cell.mix, cell.limits, seed, cell.geometry())
            ref = run.reference()
            rec = {"cell": cell.name, "kind": kind, "seed": seed}
            if kind == "program":
                run.setup(size_window=False)
                run.window(0.0, steps=run.k)
                prog = run.program()
                win = run.window_reference(prog["state"])
                rec.update(fit.gaps(prog, ref, win))
                rec["detail"] = fit.detail(prog, ref, win)
            elif kind == "control":
                low = run.reference(torch.bfloat16)
                window = run.window_reference(low["state"], torch.bfloat16)
                rec.update(fit.gaps(run.stand_in(low, window), ref,
                                    run.window_reference(low["state"])))
            else:
                for where, first in (("all", 0), ("window", run.k)):
                    for name, g in fault_readings(run, ref, first).items():
                        rec[f"{name}.{where}"] = {k: v for k, v in g.items()
                                                  if k != "silent_leaves"}
            rec["s"] = time.time() - t0
            emit(out, rec)
            run.release()


def parse_seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def cli(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    main.set_cache_dirs()
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    cell = spec.cell(a.workload)
    if cell.mix["kind"] == "orbit":
        orbit_cell(cell, parse_seeds(a.seeds), parse_seeds(a.control_seeds), a.out)
    else:
        fit_cell(cell, parse_seeds(a.seeds), parse_seeds(a.control_seeds),
                 parse_seeds(a.fault_seeds), a.out)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
