"""Profiling, tracing and metrics, as ``cg_raytracer_tpu/utils/profiling.py``:
where the time of a call goes on the card (``device_breakdown``:
``torch.profiler`` (CUPTI) kernel times against the host's wall clock),
stage timers fenced on the card (``StageTimer``), a Chrome trace of a region
(``profiler_trace``, the CLI's ``render --profile DIR``), throughput metrics
and per-step JSONL logging (``JsonlLogger``)."""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch


def _fence(value) -> None:
    """Wait for the CUDA devices of the tensors in ``value`` (a tensor, or
    a list, tuple or dict of them) to finish their queued work."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            torch.cuda.synchronize(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _fence(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _fence(v)


class StageTimer:
    """Named stage wall times, summed over calls; a stage given a ``fence``
    (its tensors) waits for their devices before it stops the clock."""

    def __init__(self):
        self.stages: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, fence=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                _fence(fence)
            self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.stages.values())
        lines = [f"{k}: {v * 1e3:.1f} ms ({v / total:.0%})"
                 for k, v in sorted(self.stages.items(), key=lambda kv: -kv[1])]
        return " | ".join(lines)


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Profile a region with ``torch.profiler`` (the host, and the card's
    kernels where there is one) and write its Chrome trace into
    ``log_dir`` as ``trace_<pid>_<ns>.json``; nothing when ``log_dir`` is
    None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}_{time.time_ns()}.json"))


def throughput_metrics(num_rays: int, seconds: float,
                       num_devices: Optional[int] = None) -> Dict[str, float]:
    m = {"rays": float(num_rays), "seconds": seconds, "rays_per_s": num_rays / seconds}
    if num_devices:
        m["rays_per_s_per_device"] = m["rays_per_s"] / num_devices
    return m


def scaling_efficiency(rays_per_s_n: float, rays_per_s_1: float, n: int) -> float:
    """Linear-scaling efficiency of an n-device run against the 1-device run."""
    return rays_per_s_n / (rays_per_s_1 * n)


def device_breakdown(fn, iters: int = 5) -> dict:
    """Run ``fn`` ``iters`` times under the profiler, after one warm-up call.

    Returns per call: ``wall_ms`` (host clock, ending in a synchronize),
    ``device_ms`` (sum of CUDA kernel times; None when the profiler recorded
    no kernel), ``busy`` (device_ms / wall_ms) and ``kernels``, a list of
    (name, ms, launches) by descending time.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    kernels = [(e.key, e.self_device_time_total / 1e3 / iters, e.count / iters)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    device_ms = sum(k[1] for k in kernels) if kernels else None
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy": device_ms / wall_ms if device_ms is not None else None,
            "kernels": kernels}


class JsonlLogger:
    """Structured per-step records (``optimize``'s loss, parameter norm,
    step seconds, rays/s): one JSON object per line, to stdout (``echo``)
    and, with ``path``, appended to a file."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh = open(path, "a") if path else None

    def log(self, **fields):
        rec = json.dumps(fields)
        if self.echo:
            print(rec)
        if self._fh:
            self._fh.write(rec + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
