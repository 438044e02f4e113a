"""What the traced part of a run reads: the CUPTI trace of a bounded
segment (``torch.profiler``, exported as a Chrome trace and parsed here)
and the benchmark's own spans around its calls into the program.

Device operations are the kernels, copies and fills of the trace.  The
segment's window is the benchmark's span around it (or, where the program
runs the segment inside one call, from the first graph launch to the end
of the last kernel it launched); the device is busy where the union of its
operations covers the window.  Each idle gap is labelled with what the host
was doing at its middle: the innermost benchmark span and the CUDA runtime
call then under way.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from typing import List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BENCH_PREFIX = "bench."


class Trace:
    """The events of one profiled segment, times in seconds on the trace's
    clock."""

    def __init__(self, events: list):
        self.device: List[Tuple[float, float, str, str, Optional[int]]] = []
        self.spans: List[Tuple[float, float, str]] = []
        self.runtime: List[Tuple[float, float, str, Optional[int]]] = []
        for e in events:
            if e.get("ph") != "X" or "ts" not in e:
                continue
            t0 = float(e["ts"]) * 1e-6
            t1 = t0 + float(e.get("dur", 0.0)) * 1e-6
            cat, name = e.get("cat", ""), e.get("name", "")
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((t0, t1, cat, name, corr))
            elif cat == "user_annotation" and name.startswith(BENCH_PREFIX):
                self.spans.append((t0, t1, name))
            elif cat == "cuda_runtime":
                self.runtime.append((t0, t1, name, corr))
        self.device.sort()
        self.spans.sort(key=lambda s: (s[0], -s[1]))  # an outer span before its first child
        self.runtime.sort()
        self._span_starts = [a for a, _, _ in self.spans]
        self._call_starts = [a for a, _, _, _ in self.runtime]

    def span(self, name: str) -> List[Tuple[float, float]]:
        return [(a, b) for a, b, n in self.spans if n == name]

    def kernels(self, lo: float, hi: float) -> list:
        """Kernels (start, end, name) that start in [lo, hi)."""
        return [(a, b, n) for a, b, c, n, _ in self.device if c == "kernel" and lo <= a < hi]

    def graph_launches(self) -> set:
        return {corr for _, _, n, corr in self.runtime if n.startswith("cudaGraphLaunch")}

    def graph_window(self) -> Tuple[float, float, set]:
        """From the first graph launch to the end of the last kernel any
        graph launched, and those launches' correlation ids."""
        launches = self.graph_launches()
        starts = [a for a, _, n, _ in self.runtime if n.startswith("cudaGraphLaunch")]
        ends = [b for _, b, c, _, corr in self.device if c == "kernel" and corr in launches]
        if not starts or not ends:
            raise RuntimeError("the traced segment launched no CUDA graph")
        return min(starts), max(ends), launches

    def busy(self, lo: float, hi: float) -> List[Tuple[float, float]]:
        """The union of device operations clipped to [lo, hi)."""
        merged: List[List[float]] = []
        for a, b, _, _, _ in self.device:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def label(self, t: float) -> str:
        span = "host"
        j = bisect.bisect_right(self._span_starts, t)
        for a, b, n in reversed(self.spans[max(0, j - 4):j]):
            if a <= t < b:
                span = n  # the latest-starting span that holds t: the innermost
                break
        else:
            for a, b, n in self.spans:
                if a <= t < b:
                    span = n
        call = ""
        j = bisect.bisect_right(self._call_starts, t)
        for a, b, n, _ in reversed(self.runtime[max(0, j - 4):j]):
            if a <= t < b:
                call = n
                break
        return f"{span}>{call}" if call else span

    def summary(self, lo: float, hi: float, top: int = 10) -> dict:
        """busy_s, window_s and the breakdown over [lo, hi)."""
        busy = self.busy(lo, hi)
        busy_s = sum(b - a for a, b in busy)
        by_name: dict = {}
        for a, b, c, n, _ in self.device:
            if lo <= a < hi:
                key = n if c == "kernel" else c
                by_name[key] = by_name.get(key, 0.0) + (min(b, hi) - a)
        gaps: dict = {}
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 > g0:
                label = self.label(0.5 * (g0 + g1))
                gaps[label] = gaps.get(label, 0.0) + (g1 - g0)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"busy_s": busy_s, "window_s": hi - lo,
                "breakdown": {"device_ops": [[n[:160], s] for n, s in ops],
                              "idle_gaps": [[n[:160], s] for n, s in idle]}}


@contextlib.contextmanager
def profiled(result: list):
    """Profile the block (host and CUPTI); on exit, append its ``Trace``
    to ``result``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            yield
            torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    result.append(Trace(events))


def span(name: str):
    """A benchmark span the trace records (``record_function``)."""
    import torch

    return torch.profiler.record_function(BENCH_PREFIX + name)
