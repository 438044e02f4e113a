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
  arrays of the same shapes.  A replay returns clones of the graph's
  outputs.
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
- **Launch counts**: a capture records its kernels' launches without
  running them, so the counts it added to the wrappers are taken back;
  every replay adds them again.
- **Memory**: each graph holds a private memory pool with its
  intermediates and outputs (hundreds of MB for a 1024^2 frame or a step's
  saved tensors).  The cache keeps at most ``MAX_GRAPHS`` = 8 graphs; the
  least recently used goes first, and its pool is released to PyTorch's
  allocator (``clear()`` releases every one).
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


def _tree_ids(accel):
    """The identities of the trees in ``accel`` (a tree, or an
    ``AccelBundle`` of two)."""
    from ..models.whitted import AccelBundle

    if accel is None:
        return None
    if isinstance(accel, AccelBundle):
        return tuple(id(t) for t in accel)
    return id(accel)


def graph_key(kind: str, cfg, device, inputs, spherical: bool, accel=None) -> tuple:
    """A graph's cache key: equal keys replay one graph."""
    return (kind, cfg, str(torch.device(device)), structure(inputs), bool(spherical),
            _tree_ids(accel))


def render_key(scene, camera, cfg, accel=None) -> tuple:
    """The key of ``render(scene, camera, cfg, accel=accel)``'s graph, for a
    config ``render()`` has resolved."""
    return graph_key("render", cfg, scene.device, (scene, camera),
                     scene.spherical_lights.position.shape[0] > 0, accel)


# --------------------------------------------------------------------------
# Launch counts.
# --------------------------------------------------------------------------

def _wrappers() -> list:
    from ..ops import bvh4, cuda_kernels, effects, level, shade

    return [*cuda_kernels.KERNEL_WRAPPERS, *shade.KERNEL_WRAPPERS, *bvh4.KERNEL_WRAPPERS,
            *soft.KERNEL_WRAPPERS, *effects.KERNEL_WRAPPERS, *level.KERNEL_WRAPPERS]


def _counts() -> dict:
    return {w: (w.launches, dict(getattr(w, "launches_by_width", {}))) for w in _wrappers()}


def _set_counts(counts: dict) -> None:
    for w, (n, by_width) in counts.items():
        w.launches = n
        if hasattr(w, "launches_by_width"):
            w.launches_by_width = dict(by_width)


def _delta(before: dict, after: dict) -> dict:
    out = {}
    for w, (n, by_width) in after.items():
        n0, w0 = before[w]
        if n != n0:
            out[w] = (n - n0, {k: v - w0.get(k, 0) for k, v in by_width.items()})
    return out


def _add_counts(delta: dict) -> None:
    for w, (n, by_width) in delta.items():
        w.launches += n
        for k, v in by_width.items():
            w.launches_by_width[k] += v


# --------------------------------------------------------------------------
# One graph.
# --------------------------------------------------------------------------

class Graph:
    """``fn(*inputs, roots) -> outputs`` captured on ``inputs``' device.
    ``roots``: the call's root sample keys (``soft.SampleKey``s, a list;
    empty without spherical lights).  ``warmup(*static_inputs)`` replaces the
    eager warm-up run of ``fn`` (a training chunk warms up on one step and
    restores what it moved).  ``hold``: objects whose buffers the graph reads
    by address, kept alive with it."""

    def __init__(self, fn: Callable, inputs: tuple, roots: Sequence, device,
                 warmup: Optional[Callable] = None, hold=()):
        device = torch.device(device)
        self.hold = hold
        self.static = [x.detach().clone() for x in leaves(inputs)]
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
        before, reserved = _counts(), torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        with self.keys, torch.cuda.graph(self.graph):
            self.out = fn(*static, [self.keys.root(j, k) for j, k in enumerate(roots)])
        self.capture_s = time.perf_counter() - t0  # capture and instantiation
        after = _counts()
        self.launches = _delta(before, after)
        _set_counts(before)
        self.pool_mb = (torch.cuda.memory_reserved(device) - reserved) / 2 ** 20

    def __call__(self, inputs, roots: Sequence):
        """Copy ``inputs`` into the graph's, write the keys of ``roots``,
        replay -> clones of the outputs."""
        src = [x.detach() for x in leaves(inputs)]
        if len(src) != len(self.static):
            raise ValueError("graph inputs of another structure")
        torch._foreach_copy_(self.static, src)
        self.keys.fill(list(roots))
        self.graph.replay()
        _add_counts(self.launches)
        return rebuild(self.out, (x.clone() for x in leaves(self.out)))

    def release(self) -> None:
        """Free the graph and its pool (outputs and inputs included)."""
        self.graph.reset()
        self.graph = self.out = self.static = self.hold = None


class GraphCache:
    """Graphs by key, at most ``capacity``, least recently used out first."""

    def __init__(self, capacity: int = MAX_GRAPHS):
        self.capacity = capacity
        self.entries: collections.OrderedDict = collections.OrderedDict()

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


def _no_grad_inputs(inputs, what: str) -> None:
    if torch.is_grad_enabled() and any(x.requires_grad for x in leaves(inputs)):
        raise ValueError(f"{what} replays a CUDA graph, which autograd does not differentiate; "
                         f"pass jit=False to differentiate the render")


# --------------------------------------------------------------------------
# The graphed calls.
# --------------------------------------------------------------------------

def render(scene, camera, cfg, accel, key) -> torch.Tensor:
    """``models/whitted.py::render_image`` of a resolved ``cfg`` through the
    cache: [H, W, 3].  ``key``: the frame's sample key (None without
    spherical lights)."""
    from ..models import whitted

    roots = [] if key is None else [key]
    _no_grad_inputs((scene, camera), "render(jit=True)")
    k = render_key(scene, camera, cfg, accel)
    graph = CACHE.get(k)
    if graph is None:
        def frame(s, c, keys):
            backend = whitted.make_backend(s, cfg, accel=accel)
            return whitted.render_image(s, c, cfg, backend=backend,
                                        generator=keys[0] if keys else None)

        graph = CACHE.put(k, Graph(frame, (scene, camera), roots, scene.device, hold=(accel,)))
    return graph((scene, camera), roots)


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
    return graph(inputs, roots)


def fwd_bwd(fn: Callable, inputs: tuple, key, cfg, accel, owner) -> tuple:
    """``fn(*inputs, key) -> (loss, grads)`` (one training step's forward and
    backward, no optimizer; ``inputs[0]`` the scene) replayed as a graph:
    the benchmark's step.  ``key``: the step's sample key (None: the key
    a generator seeded 0 draws, as the eager step's default).  ``owner``
    (held by the entry) keys the graph with ``cfg`` and the tree."""
    scene = inputs[0]
    spherical = scene.spherical_lights.position.shape[0] > 0
    if spherical and key is None:
        key = soft.draw_key(None)  # the eager step's default: a generator seeded 0
    roots = [key] if spherical else []
    k = graph_key(("fwd_bwd", id(owner)), cfg, scene.device, inputs, spherical, accel)
    graph = CACHE.get(k)
    if graph is None:
        graph = CACHE.put(k, Graph(lambda *a: fn(*a[:-1], a[-1][0] if a[-1] else None),
                                   inputs, roots, scene.device, hold=(owner, accel)))
    return graph(inputs, roots)
