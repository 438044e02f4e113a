"""The least work of an orbit frame's tree walks (``csrc/bvh4.cu``'s
``bvh_kernel`` and ``bvh_bounce_kernel``): what any walk must do for the
frame's rays, whatever tree it walks, from the plain reference's hits.

Per level, a closest-hit query for each live ray (every camera ray at the
first level, each reflected ray after): the ray read once (origin and
direction, 24 B) and its record written once (t and the hit's id, 8 B);
for a ray that hits, its triangle read once (three vertices, 36 B) and one
Moller-Trumbore test with its closest-hit update.  Then for each hit and
each point light a shadow ray: its set-up, and its bit written (1 B).  No
node visit is counted, nor any test beyond the one that finds the hit: a
miss need read no triangle, and the rest depends on the tree and the walk,
not on the inputs (``tree_anyhit_flops`` of the program counts the port's
own walk, so it is no yardstick).  Uses ``rtbench/yard.py``'s constants
and peaks.
"""
from __future__ import annotations

from . import yard

RAY_BYTES = 24
TRI_BYTES = 36
RECORD_BYTES = 8
SHADOW_BYTES = 1
NAMES = ("bvh_kernel", "bvh_bounce_kernel")


def is_walk(kernel_name: str) -> bool:
    """Whether a CUPTI kernel name is one of the tree walks."""
    return any(n in kernel_name for n in NAMES)


def level_rays(prim, live, num_lights: int, scale: int = 1) -> tuple:
    """(closest-hit rays, hits, shadow rays) of one level from the
    reference's hit ids ``prim`` (-1 a miss) and live mask ``live``, each
    on a grid of every stride-th pixel: ``scale`` = stride squared."""
    closest = int(live.sum()) * scale
    hits = int((prim >= 0).sum()) * scale
    return closest, hits, hits * num_lights


def walk_work(closest: int, hits: int, shadow: int) -> tuple:
    """(float operations, bytes) that any walk must do for these rays."""
    flops = hits * (yard.MT_FLOPS + yard.CLOSEST_UPDATE) + shadow * yard.SHADOW_SETUP
    byts = closest * (RAY_BYTES + RECORD_BYTES) + hits * TRI_BYTES + shadow * SHADOW_BYTES
    return float(flops), float(byts)


def frame_bound_s(levels, num_lights: int, stride: int = 1) -> float:
    """The least seconds of a frame's walks: one launch a level, each at
    ``yard.bound_s`` of its rays' work; ``levels``: the reference's
    [(prim, live)] of ``reference/render.py::level_hits``."""
    total = 0.0
    for prim, live in levels:
        total += yard.bound_s(*walk_work(*level_rays(prim, live, num_lights, stride * stride)))[0]
    return total
