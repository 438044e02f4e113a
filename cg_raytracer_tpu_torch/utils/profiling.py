"""Where the time of a call goes on the card: ``torch.profiler`` (CUPTI)
kernel times against the host's wall clock; and per-step JSONL logging
(``JsonlLogger``, as ``cg_raytracer_tpu/utils/profiling.py``)."""
from __future__ import annotations

import json
import time
from typing import Optional

import torch


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
