"""One run of one cell: set-up, the measured window, with ``--trace 1`` a
profiled segment after it, then the check against the plain reference, and
the result as the last line of standard output.

With ``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (read by ``benchmark/metrics/<name>.py``
from the window's spans and the segment's trace).  The check's numbers,
each beside its limit, are the last lines of standard error and the last
key of the result.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time

from . import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "cg_raytracer_tpu")
CACHE_DIR = os.path.join(spec.ROOT, ".benchcache")


def steady_host() -> None:
    """Few threads: PyTorch's CPU work on one (the run's host work is one
    Python thread driving the card)."""
    import torch

    torch.set_num_threads(1)


def parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def set_cache_dirs() -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout."""
    os.environ["CGRT_TORCH_BUILD_DIR"] = os.path.join(CACHE_DIR, "cgrt-build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR, "torch-extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def driver(cell: spec.Cell, seed: int, device: str = "cuda"):
    from . import fit, orbit

    kinds = {"orbit": orbit.OrbitRun, "train": fit.FitRun}
    kind = cell.mix["kind"]
    if kind not in kinds:
        raise ValueError(f"traffic {cell.traffic_name!r}: unknown kind {kind!r}")
    return kinds[kind](cell.config, cell.mix, cell.limits, seed, cell.geometry(), device)


def end_to_end(run, stats: dict, setup_s: float) -> dict:
    from . import orbit

    if run.mix["kind"] == "orbit":
        out = orbit.summary(stats)
    else:
        out = {"step_ms": 1e3 * stats["window_s"] / stats["steps"]}
    out["setup_s"] = setup_s
    return out


class Context:
    """What a per-layer metric's reader reads."""

    def __init__(self, cell, run, stats, e2e, trace, window):
        self.cell, self.run, self.stats, self.e2e = cell, run, stats, e2e
        self.trace, self.window = trace, window
        self.kind = run.mix["kind"]

    def frames(self) -> list:
        """The segment's frames: (start, end, window frame index)."""
        spans = self.trace.span("bench.frame")
        return [(a, b, i) for (a, b), i in zip(spans, self.run.segment_frames)]

    def kernels(self, lo=None, hi=None) -> list:
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        return self.trace.kernels(lo, hi)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def main(argv=None, t_start: float = None) -> int:
    t_start = time.time() if t_start is None else t_start
    args = parse(argv)
    bench = spec.load()
    cell = spec.cell(args.workload, bench)
    set_cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"this cell needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    steady_host()
    run = driver(cell, args.seed)
    run.setup()
    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's later passes
    setup_s = time.time() - t_start
    stats = run.window(args.seconds)
    found = forbidden_modules()
    if found:
        print(f"modules loaded in this process: {found}", file=sys.stderr)
        return 4
    e2e = end_to_end(run, stats, setup_s)
    trace = window = None
    if args.trace:
        orbit_kind = run.mix["kind"] == "orbit"
        run.segment(int(run.mix["trace_frames" if orbit_kind else "trace_steps"]))
        trace = run.traces[-1]
        if orbit_kind:
            (lo, hi), = trace.span("bench.segment")
        else:
            lo, hi, _ = trace.graph_window()
        window = (lo, hi)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}
    run.release()
    checks = run.check()
    breakdown = None
    if args.trace:
        summary = trace.summary(*window)
        device["busy_s"], device["window_s"] = summary["busy_s"], summary["window_s"]
        breakdown = summary["breakdown"]
        ctx = Context(cell, run, stats, e2e, trace, window)
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    found = forbidden_modules()
    if found:
        print(f"modules loaded in this process: {found}", file=sys.stderr)
        return 4
    failed = [(n, v, lim) for n, v, lim in checks if not (finite(v) and v <= lim)]
    device["power"] = power_limit()
    attempted = stats.get("frames", stats.get("steps"))
    result = {"correct": not failed, "attempted": attempted, "failed": len(failed),
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if "frame_ms_each" in stats:
        import numpy as np

        each = np.asarray(stats["frame_ms_each"])
        result["frame_stats"] = {"median": float(np.median(each)), "min": float(each.min()),
                                 "p5": float(np.percentile(each, 5)),
                                 "host_median_ms": 1e3 * float(np.median(stats["host_s_each"]))}
    result["checks"] = {n: {"value": v if finite(v) else str(v), "limit": lim}
                        for n, v, lim in checks}
    for n, v, lim in checks:
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
