"""Profiling, tracing and metrics, as ``cg_raytracer_tpu/utils/profiling.py``:
where the time of a call goes on the card (``device_breakdown``:
``torch.profiler`` (CUPTI) kernel times against the host's wall clock),
a Chrome trace of a region (``profiler_trace``, the CLI's ``render
--profile DIR``), the program's spans (``span``), throughput metrics and
per-step JSONL logging (``JsonlLogger``).  ``StageTimer`` is the JAX
package's API, kept for parity; it is not the program's tracing.

**Spans.** ``span(name)`` marks one part of the host's dispatch:

- ``cgrt.render`` (``models/whitted.py::render``, the whole call) holds
  ``cgrt.render.resolve`` (``resolve_render``: the host reads of ``ks``,
  ``fwd_shade_kernel``'s resolution, and on a scene that walks a tree
  ``cgrt.render.accel``: ``build_accel``'s routing and memo look-up; on the
  graphed route the frame plan's check first, and where the plan holds
  that check alone, with ``cgrt.render.accel`` around taking the plan's
  tree) and, on the card's graphed route
  (``utils/graphs.py``), ``cgrt.graph.inputs`` (the frame's key; on a
  plan's miss the no-grad check and the cache key; the cache look-up; the
  copy of the changed inputs into the graph's), ``cgrt.graph.key_fill``
  (``ops/soft.py::KeyTable.fill``:
  the keys derived on the host and copied from pinned memory; only where
  the graph samples), ``cgrt.graph.replay`` (``CUDAGraph.replay``, one
  ``cudaGraphLaunch``) and ``cgrt.graph.outputs`` (the launch counts and
  the outputs' clones).
- ``cgrt.graph.capture`` (``Graph.__init__``: the eager warm-up and the
  capture) nests inside ``cgrt.graph.inputs`` on a cache miss: a capture
  inside a frame means that the frame's key missed the cache.
- ``cgrt.accel.build`` (``models/whitted.py::_wide_tree``, a wide tree's
  build on a memo miss: inside ``cgrt.render.accel`` on a scene's first
  ``render()``) holds ``cgrt.accel.binary`` (``ops/bvh.py::build_bvh``, native
  or numpy, or the binary tree's memo) and ``cgrt.accel.collapse``
  (``ops/bvh4.py::collapse_bvhw`` and the copy to the card).  Like the
  capture, these record at set-up.
- ``cgrt.fit`` (``optim/inverse.py::optimize``, the whole call) holds one
  ``cgrt.fit.chunk`` per chunk (its launch, without the read of its losses,
  which waits for the card), and each chunk the ``cgrt.graph.*`` spans of
  its replay.

No span lies inside a CUDA graph's capture but ``cgrt.graph.capture``,
which wraps one: a frame's levels run only inside captures on the card, so
a span there would record once.

**On and off.** A span records only while a ``torch.profiler`` session
records (``torch.autograd.profiler._is_profiler_enabled``, read once per
span).  Off, ``span`` returns a shared null context: no
``record_function``, no clock, no log.  On, a span enters
``torch.profiler.record_function("cgrt.<name>")``, so the profiler's
Chrome trace nests it with the kernels it launches, and on its exit
appends ``(name, t0_ns, t1_ns, parent, call)`` to a ring of the last
``SPAN_LOG_SIZE`` spans, read as ``SpanRecord``s (``span_log``,
``clear_span_log``; a plain tuple, so that little of a span's own
bookkeeping falls after its end and outside it): ``parent``
is the name of the span it opened in (None for a root), ``call`` the id
each root takes anew and its spans share.  One host thread's spans nest;
each thread keeps its own stack.

**The clock.**  ``t0_ns`` and ``t1_ns`` are ``time.time_ns()``, read just
before the span enters its ``record_function`` and just after it leaves
it, so a span's time holds its own cost under the profiler, and a parent's
time outside its children is its own work.  ``time.time_ns()`` is the
clock of the profiler's Chrome trace: an event's ``ts`` (µs) plus the
trace's ``baseTimeNanoseconds`` is ``time.time_ns()`` at its start, which
trails ``t0_ns`` by the ``record_function``'s entry (4.1-16.4 µs, median
4.7, over 200 spans under CPU and CUDA activity, torch 2.11 on an H100's
host; the first ``record_function`` of a process takes milliseconds).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_PREFIX = "cgrt."
SPAN_LOG_SIZE = 65536


class SpanRecord(NamedTuple):
    name: str
    t0_ns: int
    t1_ns: int
    parent: Optional[str]
    call: int


_SPAN_LOG: collections.deque = collections.deque(maxlen=SPAN_LOG_SIZE)
_CALL_IDS = itertools.count(1)
_STACKS = threading.local()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "parent", "call", "fn", "t0")

    def __init__(self, name: str):
        self.name = SPAN_PREFIX + name

    def __enter__(self):
        self.t0 = time.time_ns()
        stack = getattr(_STACKS, "stack", None)
        if stack is None:
            stack = _STACKS.stack = []
        if stack:
            self.parent, self.call = stack[-1].name, stack[-1].call
        else:
            self.parent, self.call = None, next(_CALL_IDS)
        stack.append(self)
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        return self

    def __exit__(self, *exc):
        self.fn.__exit__(*exc)
        _STACKS.stack.pop()
        _SPAN_LOG.append((self.name, self.t0, time.time_ns(), self.parent, self.call))
        return False


def span(name: str):
    """The span ``cgrt.<name>`` around a ``with`` block: recorded while a
    ``torch.profiler`` session records, else nothing (the module's
    docstring)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def span_log() -> list:
    """The ring's ``SpanRecord``s, oldest first (in the order they ended)."""
    return [SpanRecord(*r) for r in _SPAN_LOG]


def clear_span_log() -> None:
    _SPAN_LOG.clear()


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
    (its tensors) waits for their devices before it stops the clock.  The
    JAX package's API, kept for parity; the program's own tracing is
    ``span``."""

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
