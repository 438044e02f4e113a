"""Compiled dispatch on the card: CUDA graphs captured once and replayed, the
counterpart of the JAX package's jit cache (``render(..., jit=True)``,
cg_raytracer_tpu/models/whitted.py:1051-1079) and of its K-step
``lax.scan`` (``optimize(..., steps_per_call=K)``,
cg_raytracer_tpu/optim/inverse.py:112-123).

Run eagerly, a frame makes ~50-350 small launches from Python and a training
step more; replayed, it is one ``torch.cuda.CUDAGraph.replay()``.

- **Key** (``graph_key``): the kind of call, the resolved ``RenderConfig`` (a
  frozen dataclass; the caller resolves it first, since ``render()``'s
  resolution reads scene values on the host), the device, the shape and
  type of every input tensor, whether the scene has spherical lights, and
  the identity of the tree (``accel``), whose buffers the graph reads by
  address (an entry holds the tree, so its identity is not reused while the
  entry lives).
- **Static inputs**: the first call's input tensors are cloned into the
  graph's inputs; before each replay the call's tensors are copied into
  them (one ``torch._foreach_copy_``), so another scene of the same
  structure replays the same graph, as a jitted JAX function takes new
  arrays of the same shapes.  A render's graph records, for each input
  slot, the tensor and the ``_version`` it last copied in, and copies only
  the slots whose tensor or version differs (``Graph.load_changed``: an
  orbit's frame copies the camera's moved leaf alone); a training chunk
  and ``fwd_bwd`` copy every input (``Graph.load``).  A replay returns
  clones of the graph's outputs.
- **The contract of the record**: a scene or camera changes between
  calls through PyTorch's in-place ops (which bump the tensor's
  ``_version``) or new tensors.  A write PyTorch does not see (through
  ``.data``, or a raw pointer handed to a kernel) is not seen here either;
  the port's kernels write only their outputs, and a training chunk's
  replay, which moves its parameters in place, bumps their versions.
  ``models/whitted.py::render``'s frame plan rests on the same contract.
- **The caller's plan** (``GraphCache.plan``): one object the caller keeps
  beside its graphs (``models/whitted.py::FramePlan``), dropped with them by
  ``clear()``.
- **Spans** (``utils/profiling.py::span``, recorded only under a profiler):
  ``cgrt.graph.inputs`` (opened by the caller, ``models/whitted.py``,
  around the frame's key, ``render_graph``'s look-up and the input copy,
  with ``cgrt.graph.capture`` inside it on a miss), ``cgrt.graph.key_fill``,
  ``cgrt.graph.replay``, ``cgrt.graph.outputs``.
- **Sample keys**: a graph freezes every kernel scalar, so the spherical
  lights' keys reach the samplers through the device buffer of an
  ``ops/soft.py::KeyTable``: the capture records how each slot's key
  derives from the call's root keys, and before each replay ``fill`` writes
  this call's keys into it with one copy from pinned host memory.
- **Warm-up**: one eager run on a side stream before the capture, as
  PyTorch's graph documentation prescribes: it builds what is made at first
  use (the kernel library, ``ops/_build.py::load``; a tree's walk records;
  ``models/whitted.py::_cached_accel``; autograd's and the optimizer's
  state), none of which may happen during a capture.
- **Launch counts** (``utils/counters.py``): a capture records its
  kernels without running them, so their launches (and the rays the tree
  walks were handed) go into the graph's own tally, which every replay
  adds to the totals (``replay_rays``: the last replay's rays).
- **Memory**: each graph holds a private memory pool with its
  intermediates and outputs (hundreds of MB for a 1024^2 frame or a step's
  saved tensors).  The cache keeps at most ``MAX_GRAPHS`` = 8 graphs; the
  least recently used goes first, and its pool is released to PyTorch's
  allocator (``clear()`` releases every one).  A render's graph also holds
  the tensors it last copied in (its record), and the cache its caller's
  plan, until the next call or ``clear()``.
- **No fallback**: on the card a capture that fails raises.  CPU tensors
  never reach this module: a caller on the CPU asked for the CPU and runs
  eagerly.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Optional, Sequence

import torch

from ..ops import soft
from . import counters
from .profiling import span

MAX_GRAPHS = 8


# --------------------------------------------------------------------------
# Inputs as trees of dataclasses, dicts, tuples and lists of tensors.
# --------------------------------------------------------------------------

def leaves(tree) -> list:
    """The tensors of ``tree`` in a fixed order."""
    if torch.is_tensor(tree):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree) for x in leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return []


def rebuild(tree, tensors):
    """``tree`` with its tensors replaced, in ``leaves`` order, by ``tensors``
    (an iterator)."""
    if torch.is_tensor(tree):
        return next(tensors)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: rebuild(getattr(tree, f.name), tensors)
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: rebuild(v, tensors) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(rebuild(v, tensors) for v in tree)
    return tree


def structure(tree) -> tuple:
    """The types, fields, shapes and dtypes of ``tree``: equal for two trees
    one graph can take."""
    if torch.is_tensor(tree):
        return ("tensor", tuple(tree.shape), str(tree.dtype))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return (type(tree).__name__,) + tuple((f.name, structure(getattr(tree, f.name)))
                                              for f in dataclasses.fields(tree))
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, structure(v)) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__,) + tuple(structure(v) for v in tree)
    return ("value", tree)


def graph_key(kind: str, cfg, device, inputs, spherical: bool, accel=None) -> tuple:
    """A graph's cache key: equal keys replay one graph."""
    return (kind, cfg, str(torch.device(device)), structure(inputs), bool(spherical), id(accel))


def render_key(scene, camera, cfg, accel=None) -> tuple:
    """The key of ``render(scene, camera, cfg, accel=accel)``'s graph, for a
    config ``render()`` has resolved."""
    return graph_key("render", cfg, scene.device, (scene, camera),
                     scene.spherical_lights.position.shape[0] > 0, accel)


def _versions(tensors) -> Optional[list]:
    """Each tensor's ``_version``; None where one keeps none (a tensor made
    under ``torch.inference_mode``), so that it is copied every time."""
    try:
        return [x._version for x in tensors]
    except RuntimeError:
        return None


def replay_rays() -> dict:
    """The rays one replay of the last graph replayed hands each tree walk
    ({wrapper name: {node width: rays}}, the walks it launches; {} before
    the first replay).  Kept after ``clear()``, so it can be read once the
    graphs are released."""
    return counters.last_replay().walk_rays()


# --------------------------------------------------------------------------
# One graph.
# --------------------------------------------------------------------------

class Graph:
    """``fn(*inputs, roots) -> outputs`` captured on ``inputs``' device.
    ``roots``: the call's root sample keys (``soft.SampleKey``s, a list;
    empty without spherical lights).  ``warmup(*static_inputs)`` replaces the
    eager warm-up run of ``fn`` (a training chunk warms up on one step and
    restores what it moved).  ``hold``: objects whose buffers the graph reads
    by address, kept alive with it.  ``tally``: the launches its capture
    recorded, which each replay adds to the counts
    (``utils/counters.py``)."""

    def __init__(self, fn: Callable, inputs: tuple, roots: Sequence, device,
                 warmup: Optional[Callable] = None, hold=()):
        with span("graph.capture"):
            device = torch.device(device)
            self.hold = hold
            src = leaves(inputs)
            self.static = [x.detach().clone() for x in src]
            self.sources, self.versions = src, _versions(src)  # what each slot holds
            static = rebuild(inputs, iter(self.static))
            t0 = time.perf_counter()
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                if warmup is not None:
                    warmup(*static)
                else:
                    fn(*static, list(roots))
            torch.cuda.current_stream(device).wait_stream(side)
            torch.cuda.synchronize(device)
            self.warmup_s = time.perf_counter() - t0
            self.keys = soft.KeyTable(device)
            self.graph = torch.cuda.CUDAGraph()
            torch.cuda.empty_cache()  # as torch.cuda.graph does on entry: the pool's MB below
            reserved = torch.cuda.memory_reserved(device)
            self.tally = counters.Tally()
            t0 = time.perf_counter()
            with self.keys, counters.recording(self.tally), torch.cuda.graph(self.graph):
                self.out = fn(*static, [self.keys.root(j, k) for j, k in enumerate(roots)])
            self.capture_s = time.perf_counter() - t0  # capture and instantiation
            self.pool_mb = (torch.cuda.memory_reserved(device) - reserved) / 2 ** 20
            # A function that wrote its own inputs (in place, so their versions
            # moved) leaves them unlike their sources: copy every slot then.
            written = _versions(self.static)
            self.writes_inputs = written is None or any(written)

    @property
    def live(self) -> bool:
        """Not yet released."""
        return self.graph is not None

    def load(self, inputs) -> None:
        """Copy every leaf of ``inputs`` into the graph's."""
        src = [x.detach() for x in leaves(inputs)]
        if len(src) != len(self.static):
            raise ValueError("graph inputs of another structure")
        torch._foreach_copy_(self.static, src)
        self.sources = None  # unrecorded: the next load_changed copies every slot

    def load_changed(self, src: list) -> list:
        """Copy into the graph's inputs each of ``src`` (the inputs' leaves,
        in ``leaves`` order) that is not the tensor, at the same
        ``_version``, that the last load copied into its slot -> the slots
        copied."""
        if len(src) != len(self.static):
            raise ValueError("graph inputs of another structure")
        versions = _versions(src)
        if self.sources is None or versions is None or self.writes_inputs:
            stale = list(range(len(src)))
        else:
            stale = [i for i, (x, v, y, w) in enumerate(zip(src, versions, self.sources,
                                                            self.versions))
                     if x is not y or v != w]
        for i in stale:  # a copy each, as the full load's mixed dtypes take: no kernel
            self.static[i].copy_(src[i].detach())
        self.sources, self.versions = (src, versions) if versions is not None else (None, None)
        return stale

    def replay(self, roots: Sequence):
        """Write the keys of ``roots``, replay -> clones of the outputs."""
        self.keys.fill(list(roots))
        with span("graph.replay"):
            self.graph.replay()
        with span("graph.outputs"):
            counters.replayed(self.tally)
            return rebuild(self.out, (x.clone() for x in leaves(self.out)))

    def release(self) -> None:
        """Free the graph and its pool (outputs and inputs included)."""
        self.graph.reset()
        self.graph = self.out = self.static = self.hold = self.sources = None


class GraphCache:
    """Graphs by key, at most ``capacity``, least recently used out first;
    and the plan its caller keeps beside them (``plan``)."""

    def __init__(self, capacity: int = MAX_GRAPHS):
        self.capacity = capacity
        self.entries: collections.OrderedDict = collections.OrderedDict()
        self.plan = None

    def get(self, key) -> Optional[Graph]:
        graph = self.entries.get(key)
        if graph is not None:
            self.entries.move_to_end(key)
        return graph

    def put(self, key, graph: Graph) -> Graph:
        self.entries[key] = graph
        while len(self.entries) > self.capacity:
            self.entries.popitem(last=False)[1].release()
        return graph

    def clear(self) -> None:
        self.plan = None
        while self.entries:
            self.entries.popitem(last=False)[1].release()

    def __len__(self) -> int:
        return len(self.entries)


CACHE = GraphCache()


def clear() -> None:
    """Release every cached graph and its memory pool."""
    CACHE.clear()


def forget(owner) -> None:
    """Release the graphs ``owner`` captured (``train_chunk``, ``fwd_bwd``):
    a caller done with its loop frees their pools at once."""
    for key in [k for k in CACHE.entries if isinstance(k[0], tuple) and k[0][1] == id(owner)]:
        CACHE.entries.pop(key).release()


def _no_grad_inputs(tensors, what: str) -> None:
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        raise ValueError(f"{what} replays a CUDA graph, which autograd does not differentiate; "
                         f"pass jit=False to differentiate the render")


# --------------------------------------------------------------------------
# The graphed calls.
# --------------------------------------------------------------------------

def render_graph(frame: Callable, scene, camera, cfg, accel, roots) -> tuple:
    """The cached graph of ``frame(scene, camera, keys)``, a render of the
    resolved ``cfg`` with the tree ``accel`` (``models/whitted.py``),
    captured on a miss, with the call's inputs copied into it
    (``Graph.load_changed``) -> (its key, the graph)."""
    src = leaves((scene, camera))
    _no_grad_inputs(src, "render(jit=True)")
    k = render_key(scene, camera, cfg, accel)
    graph = CACHE.get(k)
    if graph is None:
        graph = CACHE.put(k, Graph(frame, (scene, camera), roots, scene.device,
                                   hold=(accel,)))
    graph.load_changed(src)
    return k, graph


def check_capturable(optimizer) -> None:
    """Raise unless every parameter group of ``optimizer`` can be captured
    (``torch.optim.Adam(..., capturable=True)``; an optimizer without the
    flag, such as SGD, keeps no host state and passes)."""
    if any(group.get("capturable") is False for group in optimizer.param_groups):
        raise ValueError(
            f"{type(optimizer).__name__} was built with capturable=False: a CUDA graph replays "
            f"its update, which then needs capturable=True (e.g. torch.optim.Adam(..., "
            f"capturable=True)); or run the steps eagerly with jit=False")


def _snapshot(params: dict, optimizer):
    """Copies of the parameters and of the optimizer's tensor state."""
    saved_p = {k: p.detach().clone() for k, p in params.items()}
    saved_s = {p: {n: (v.detach().clone() if torch.is_tensor(v) else v) for n, v in st.items()}
               for p, st in optimizer.state.items()}
    return saved_p, saved_s


@torch.no_grad()
def _restore(params: dict, optimizer, saved) -> None:
    """Put back ``_snapshot``'s values in place (the graph reads these
    tensors by address); a state the optimizer made since is zeroed, which
    is a fresh state for Adam and AdamW."""
    saved_p, saved_s = saved
    for k, p in params.items():
        p.copy_(saved_p[k])
    for p, st in optimizer.state.items():
        old = saved_s.get(p)
        for n, v in st.items():
            if torch.is_tensor(v) and old is not None:
                v.copy_(old[n])
            elif torch.is_tensor(v):
                v.zero_()
            elif old is not None:
                st[n] = old[n]


def train_chunk(step: Callable, params: dict, optimizer, inputs: tuple, keys: Sequence,
                owner, hold=()) -> torch.Tensor:
    """``len(keys)`` steps ``step(params, *inputs, key) -> loss`` (each one
    render, backward and ``optimizer.step()``) replayed as one graph ->
    losses [K].  ``keys``: each step's sample key (None without spherical
    lights).  The graph reads ``params`` and the optimizer's state by
    address; ``owner`` (the loop that calls this, held by the entry) and
    the parameters' identities key it.  Its warm-up runs one step eagerly
    and restores the parameters and the optimizer's state, so the
    optimization does not advance."""
    k_steps = len(keys)
    with span("graph.inputs"):
        roots = [k for k in keys if k is not None]
        if roots and len(roots) != k_steps:
            raise ValueError("every step of a chunk samples, or none does")
        device = leaves(inputs)[0].device
        k = (("train", id(owner)), k_steps, str(device), structure(inputs),
             tuple(id(p) for p in params.values()), bool(roots))
        graph = CACHE.get(k)
        if graph is None:
            check_capturable(optimizer)

            def chunk(*args):
                *ins, ks = args
                ks = ks if ks else [None] * k_steps
                return torch.stack([step(params, *ins, kj) for kj in ks])

            def warmup(*ins):
                saved = _snapshot(params, optimizer)
                step(params, *ins, keys[0])
                _restore(params, optimizer, saved)

            graph = CACHE.put(k, Graph(chunk, inputs, roots, device, warmup=warmup,
                                       hold=(owner, params, optimizer, *hold)))
        graph.load(inputs)
    losses = graph.replay(roots)
    # The replay moved the parameters in place, which their versions do not
    # show: bump them, so that a frame plan or a graph holding one copies it.
    torch.autograd.graph.increment_version(list(params.values()))
    return losses


def fwd_bwd(fn: Callable, inputs: tuple, key, cfg, accel, owner) -> tuple:
    """``fn(*inputs, key) -> (loss, grads)`` (one training step's forward and
    backward, no optimizer; ``inputs[0]`` the scene) replayed as a graph:
    the benchmark's step.  ``key``: the step's sample key (None: the key
    a generator seeded 0 draws, as the eager step's default).  ``owner``
    (held by the entry) keys the graph with ``cfg`` and the tree."""
    scene = inputs[0]
    with span("graph.inputs"):
        spherical = scene.spherical_lights.position.shape[0] > 0
        if spherical and key is None:
            key = soft.draw_key(None)  # the eager step's default: a generator seeded 0
        roots = [key] if spherical else []
        k = graph_key(("fwd_bwd", id(owner)), cfg, scene.device, inputs, spherical, accel)
        graph = CACHE.get(k)
        if graph is None:
            graph = CACHE.put(k, Graph(lambda *a: fn(*a[:-1], a[-1][0] if a[-1] else None),
                                       inputs, roots, scene.device, hold=(owner, accel)))
        graph.load(inputs)
    return graph.replay(roots)
