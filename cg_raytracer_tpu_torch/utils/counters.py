"""The host's launch counters: one registry for the kernel wrappers of
``ops/`` (``cuda_kernels``, ``shade``, ``bvh4``, ``soft``, ``effects``,
``level``), and for ``models/whitted.py``'s graphed ``render()`` calls and
their frame plan's hits (``plan_counts``).

A wrapper counts each launch of its kernel with ``count``, by its name and,
for a walk of a tree, the tree's node width and the rays it was handed.
Each module declares its wrappers once as a ``Group``, whose views are the
module's ``launch_counts`` and ``reset_launch_counts``.

A CUDA graph's capture (``utils/graphs.py``) records its kernels without
running them, so its launches go into the graph's own ``Tally``
(``recording``) and not into the totals; every replay adds that tally to
the totals (``replayed``), and the last replayed tally stays readable
(``last_replay``) after its graph is released.
"""
from __future__ import annotations

import contextlib


class Tally:
    """Launches and rays by (wrapper name, node width); width 0 for a
    wrapper that walks no tree."""

    def __init__(self):
        self.launches = {}
        self.rays = {}

    def add(self, other: "Tally") -> None:
        # On every replay: plain dict updates, the cheapest on the host.
        for key, n in other.launches.items():
            self.launches[key] = self.launches.get(key, 0) + n
        for key, n in other.rays.items():
            self.rays[key] = self.rays.get(key, 0) + n

    def by_name(self) -> dict:
        """Launches by wrapper name, every width summed."""
        out = {}
        for (name, _), n in self.launches.items():
            out[name] = out.get(name, 0) + n
        return out

    def walk_rays(self) -> dict:
        """{wrapper name: {node width: rays}} of the wrappers handed rays
        (the tree walks), every width of the wrapper's group included."""
        walks = dict.fromkeys(name for (name, _), n in self.rays.items() if n)
        return {name: {w: self.rays.get((name, w), 0) for w in _WIDTHS[name]}
                for name in walks}


TOTAL = Tally()
_SINKS = [TOTAL]  # where count() adds: the totals, or the capture that records
_LAST = [Tally()]  # the last replayed graph's tally
_WIDTHS: dict = {}  # wrapper name -> the node widths its group counts


def count(name: str, width: int = 0, rays: int = 0) -> None:
    """One launch of wrapper ``name``'s kernel, at node ``width`` (a tree
    walk), handed ``rays`` rays."""
    sink, key = _SINKS[-1], (name, width)
    sink.launches[key] = sink.launches.get(key, 0) + 1
    if rays:
        sink.rays[key] = sink.rays.get(key, 0) + rays


@contextlib.contextmanager
def recording(tally: Tally):
    """Count into ``tally`` instead of the totals (a graph's capture)."""
    _SINKS.append(tally)
    try:
        yield tally
    finally:
        _SINKS.pop()


def replayed(tally: Tally) -> None:
    """A replay of the graph whose capture recorded ``tally``."""
    TOTAL.add(tally)
    _LAST[0] = tally


def last_replay() -> Tally:
    """The last replayed graph's tally (empty before the first replay)."""
    return _LAST[0]


class Group:
    """One module's wrappers, read and reset together; ``widths``: the node
    widths of the tree walks among them (each name then also counts under
    ``name:wW``)."""

    def __init__(self, *names: str, widths: tuple = ()):
        self.names, self.widths = names, tuple(widths)
        _WIDTHS.update(dict.fromkeys(names, self.widths))

    def launch_counts(self) -> dict:
        """Each wrapper's launches; with ``widths``, also by node width."""
        out = {}
        for name in self.names:
            if not self.widths:
                out[name] = TOTAL.launches.get((name, 0), 0)
                continue
            by_width = {w: TOTAL.launches.get((name, w), 0) for w in self.widths}
            out[name] = sum(by_width.values())
            out.update({f"{name}:w{w}": n for w, n in by_width.items()})
        return out

    def ray_counts(self) -> dict:
        """The rays each wrapper was handed at each node width, under ``name:wW``."""
        return {f"{name}:w{w}": TOTAL.rays.get((name, w), 0) for name in self.names
                for w in self.widths}

    def reset(self) -> None:
        for counter in (TOTAL.launches, TOTAL.rays):
            for key in [k for k in counter if k[0] in self.names]:
                del counter[key]
