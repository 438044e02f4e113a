#!/usr/bin/env python3
"""On-card check of the PyTorch + CUDA port: the forward render path, the
training path, the mesh slice (the 4-wide BVH and the pregathered shade),
the soft-shadow slice (spherical lights: the brute and cone samplers, and
the shade kernels' spherical fractions), the scale slice (the 4-wide
kernels past 200,000 triangles, ``optimize()`` with the refit), the
tree-width slice (the walk and the samplers at node widths 2 and 8), the
redesigned kernels measured against their earlier versions, and the
effects and front-end slice (AA, bloom, motion blur, ``render_rows``, the
CLI's effects and ``--profile``, the debug front ends, the native host
builds), the multi-device slice, compiled dispatch (frames, steps and
``optimize()`` chunks replayed as CUDA graphs; the quirk blur's kernel),
and the default route's bounce level as one kernel.

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases, each printing its own lines:
 1. the card's name and power limit (nvidia-smi);
 2. build the CUDA kernels from cg_raytracer_tpu_torch/csrc (ptxas report),
    and beside them the check library of the sample stream (curand's Philox);
 3. each kernel against its plain PyTorch twin on the card, on the stand-in
    mirror box and on a triangles + spheres scene, at 1024x1024 primary rays
    plus one set of secondary rays;
 4. the main path: ``render`` of the stand-in box at 800x800 and 1024x1024,
    forward-only (trace kernel, what ``cgrt-torch render`` runs) and default
    (bounce kernel + PyTorch shading), plus the triangles + spheres scene
    (closest-hit and any-hit kernels);
 5. ``cli.main(["render", "--scene", "spheres", ...])`` once;
 6. every kernel's launch count from phases 4-5 is > 0, and every image
    agrees with the plain path on the card and is not trivial;
 7. each kernel's median time against its twin at 1024x1024 (CUDA events),
    and the main path's end-to-end rays/s;
 8. the training kernels (record-trace, bounce-refl, shade forward and
    backward) against their plain twins on the card at 1024x1024 primary
    rays: the records on the stand-in box, the shade on the triangles +
    spheres scene and the box, and at 256x256 on a scene at the shade
    kernel's caps (256 triangles, 8 spheres, 16 lights);
 9. the training main path: ``run_bench(include_bwd=True)`` on the stand-in
    box at 1024x1024 under the full-gradient and the materials-only
    contract, whose record-trace and shade launch counts are > 0; then, with
    the counts set to 0 again, one step whose records come level by level
    from the bounce-refl kernel, whose count is > 0; and one step's gradients
    agree with the same step through the plain path and are finite and
    non-zero;
10. each training kernel's time against its twin, and per contract ms/step,
    rays/s, the device-busy share and the plain path's ms/step;
11. the mesh slice: the host build of the 4-wide BVH of the procedural
    teacup (48,000 triangles) and dragon (87,780), with node and leaf counts;
12. the 4-wide BVH kernels (closest hit and any hit, and the fused bounce)
    against their plain twins on the teacup at 1024x1024: primary rays,
    their level-1 reflections and shadow rays with random t_max, exactly;
    and against brute force on a 64K-ray subsample;
13. the pregathered shade kernels, forward and backward, against their twin
    on the teacup's level-0 and level-1 records;
14. the mesh main path, with every count set to 0 first: ``render`` of the
    teacup at 800x800 and 1024x1024 (default route: the bounce kernel; and
    forward-only: the records and the pregathered shade), the dragon
    forward-only, the teacup with two sphere primitives (the closest-hit
    and any-hit kernel, spheres merged after it), ``run_bench(include_bwd=
    True)`` on the teacup at 1024x1024 under both contracts and
    ``cgrt-torch render --scene teacup``; the four new kernels' counts are
    > 0; every image agrees with the plain path, one step's loss and
    gradients per contract with the plain step's;
15. each new kernel's time against its twin at 1024x1024, the teacup's
    end-to-end rays/s, and leaf 4 against leaf 56;
16. the soft-shadow slice on the spherical stand-ins (the box lit by
    cornell_box_spherical_light's light, the teacup by
    monkey_spherical_light's, 200 samples): the table samplers exactly and
    the PRNG samplers on the same Philox stream against their twins on 4,096
    hit points of each 1024x1024 frame (one in eight unmarked, the stream
    not starting at point 0), through the wrappers the backend calls, the
    twin's Philox words against
    curand_Philox4x32_10, the penumbra of each frame, and the shade kernels
    with the recorded fractions (forward and backward) against their twins;
17. the soft-shadow main path, every count set to 0 first: ``render`` of
    both stand-ins at 800x800 and 1024x1024, default and forward-only,
    ``run_bench(include_bwd=True)`` under both contracts, and
    ``cgrt-torch render --scene teacup --add-spherical-light ...``; the
    samplers' and the shade kernels' counts are > 0 and the any-hit kernels
    (the scan's oracle) never launched; images agree with the plain path at
    256x256, and one 256x256 step's loss and gradients with the plain step's;
18. the PRNG samplers' counts on every hit point of both 1024x1024 frames
    equal to their twins', the samplers' times against their twins,
    ms/frame, ms/step, rays/s and the device-busy share of both stand-ins,
    and the cone sampler over the port's tree (SAH, leaf 4) against a median
    leaf-14 tree;
19. the large tier's trees, built on the host: the donut (320,000
    triangles; the auto past 200,000: median, leaf 4) and a torus of
    1,280,000 triangles built here (not a preset) whose tree exceeds the
    50 MB L2: nodes, levels, bytes, seconds;
20. the 4-wide kernels on that tier (closest hit, any hit, the fused bounce;
    the JAX package's streaming kernels B8) exactly equal to their twins on
    the donut's 1024x1024 primary rays, shadow rays with a random t_max and
    a live mask, and on every 16th ray of the torus's frame;
21. the donut main path, every count set to 0 first: ``render`` at 800x800
    and 1024x1024, default and forward-only, the donut with two sphere
    primitives, ``run_bench(include_bwd=True)`` under both contracts,
    ``cgrt-torch render --scene donut`` with its point light and with a
    spherical light (the scan over the any-hit kernel: no sampler past
    200,000 triangles); the 4-wide and pregathered-shade counts are > 0;
    images agree with the plain path, one step per contract with the plain
    step;
22. ``optimize()`` on the card: vertex steps at 1024x1024 on the teacup
    (depth 2) and the donut with the tree refit in every step, the
    teacup's losses equal to the plain path's to rtol 1e-4 and its refit
    tree's hits equal to a fresh build's on the moved vertices up to ties;
    ``cgrt-torch optimize`` on the stand-in box writing and resuming a
    checkpoint;
23. the large tier's kernel times against their twins and bounds, ms per
    million camera rays on the teacup, the donut and the torus, the donut's
    ms/frame, ms/step and device-busy share, refit and optimize ms per step,
    and the donut's tree: median against SAH, leaf 4 against leaf 28;
24. the walk at node widths 2 (the JAX package's binary kernels, B13) and 8
    (B15), collapsed from the memoized binary trees of the teacup, dragon,
    donut and torus: closest hit, any hit (level-0 shadow rays, random
    t_max) and the fused bounce (a live mask) exactly equal to their twins
    on the teacup's 1024x1024 camera rays;
25. width 2 on the large tier (B14): the same on the donut's frame and on
    every 16th ray of the torus's;
26. the tree samplers at width 2 (the 'sample' route, B12, and the 'cone'
    route, B11, both over the scene's one tree made binary) and
    8: table and PRNG kernels exactly equal to their twins on the 4,096-
    point subsample of both spherical stand-ins, and each route's PRNG
    counts on every hit point of both 1024x1024 frames equal to the 4-wide
    kernel's;
27. the width routes end to end, every count set to 0 first: ``render`` at
    1024x1024 and ``run_bench(include_bwd=True)`` under bvh_wide='2' and '8'
    (teacup, dragon, teacup + spheres), soft_shadow_tile='sample' and the
    cone at widths 2 and 8 (spherical teacup), then bvh_wide_hbm='2' (donut,
    donut + spheres); each width's counts are > 0 and the 4-wide kernels
    never ran; images agree with the plain path (the spherical ones at
    256x256), one full-contract step's gradients with the plain step's;
28. per width: closest-hit ms per million camera rays and bounce ms on the
    teacup, dragon, donut and torus, the default-route frame and the
    full-contract step at 1024x1024 (run_bench, two alternating rounds), and
    the new rows' kernel times against their twins and bounds;
29. the samplers measured: each instantiation's registers, stack frame,
    spills and occupancy (ptxas) and its SASS (cuobjdump, where the toolkit
    has it; ncu is looked for), the table variant on every hit point of
    each 1024x1024 frame against the PRNG variant on the same points (the
    sample stage's cost beside the table's read time), sample rays/s and
    the share of the bound; then the ablations: csrc/soft.cu rebuilt with
    one lever of its design taken out again, or another block size, each
    exact against the built kernel and timed beside it.  With ``--parent
    DIR`` (an unpacked checkout of an earlier commit whose samplers take
    the compacted points and the packed records), that commit's soft.cu
    takes part in the same turns, and its spherical frames and steps are
    timed against this tree's (run_bench in a process per tree: parent,
    this, this, parent);
30. the shade backward and the walk measured: each instantiation's
    registers, stack frame and spills (ptxas); csrc/bvh4.cu rebuilt with one
    lever of the walk taken out again (or another block size or a register
    cap) and csrc/shade.cu with the warp aggregation taken out (or another
    threshold, or vector atomics), each timed in turns with this tree's
    kernel on the same inputs: the walk's closest hit, any hit and bounce at
    widths 2, 4 and 8 on the teacup, 2 and 4 on the donut and the torus, all
    exactly equal to this tree's; the shade backward on the stand-in box's
    and the teacup's 1024x1024 records, d_o and d_d bit-equal to this
    tree's and the tables within utils/checks.py's rule; each row's time
    against its bound.  With ``--parent DIR``, that commit's bvh4.cu and
    shade.cu take part in the same turns under the same checks, and the
    box's fwd+bwd steps (both contracts), the teacup's and the donut's
    default-route frames and full steps, and the box step's busy share run
    in a process per tree (parent, this, this, parent), the box's
    forward-only frame (the trace kernel's route) with them;
31. the brute sweeps measured: registers, stack frame and spills of the six
    brute kernels (ptxas; none may spill), their SASS per triangle test
    (cuobjdump: shared loads and float instructions in the hottest loop),
    and csrc/oracle.cu, trace.cu and record.cu rebuilt with one lever of
    the sweep taken out again (16-byte rows, the any-hit early exits, the
    unrolled closest sweep, the one-wave grid), with the closest sweep's
    early exits, or another block size: each variant's outputs bit-equal to
    this tree's and timed in turns with it on the stand-in box (phase 3's
    and phase 8's rays) and on the box cut to 256 triangles with 8 lights;
    each row's time against its bound on these rays, and the share of
    record-trace's warps partly active at level 1.  With ``--parent DIR``,
    that commit's three sources take part in the same turns under the same
    check;
32. the effects and front ends: ``render`` of the stand-in box (the CLI's
    route: the trace kernel) and the spherical box at 800x800 and
    1024x1024 and of the teacup at 800x800 under AA, bloom, motion blur,
    AA + bloom, all three, and each quirk path (``EFFECTS``), each with
    exactly 4, 16, 64 (15, 60 under quirks) times a plain frame's kernel
    launches, timed beside a plain frame (ms and cost factor), and held to
    the plain twins at 128x128 (all on the box, the box also at 800x800
    without motion blur; those without motion blur on the spherical box;
    AA + bloom and its quirk path on the teacup); the clean and the quirk
    bloom post-pass alone; ``render_rows``
    tiles of the box and the spherical box equal to the frame bit for bit;
    ``cgrt-torch render --aa --bloom --motion-blur --profile DIR`` (an
    image, a trace with the card's kernels); ``debug_trace`` and
    ``hit_statistics`` on the box and the teacup through the kernels, prim
    ids and shadow bits equal to the twin backend's; a training step with
    AA + bloom on the box and the teacup against the plain path, and one
    ``optimize()`` step; the native median builds of the teacup, the donut
    and the torus against numpy (seconds), their arrays equal to the same
    sources built with native/Makefile's flags, their hits through the
    4-wide walk equal to the numpy tree's;
33. ray- and sample-parallel on the card (``parallel/sharding.py``): in a
    one-rank NCCL group, ``sharded_render`` of the stand-in box at 1024x1024
    equal to ``render()`` bit for bit, ``sample_sharded_render`` of the
    spherical box (200 samples) at 256x256 equal to the scan-path render bit
    for bit, one ``make_train_step`` equal to the single-device step (loss
    to 8 digits, parameters within ``checks.TABLE_GRAD``); then two spawned
    ranks sharing the card over gloo give the same frames and step; ms per
    frame of each beside the single-device frame, and each path's launches;
34. past the JAX package's ``HBM_MAX_TRIS``: a 2,880,000-triangle torus
    built on the card's autos (median, leaf 4, width 4; MB and seconds),
    its closest-hit and any-hit walks exact against their twins on every
    16th ray of a 1024x1024 camera, its walk's ms per million camera rays
    beside the 1,280,000-triangle torus's, and a 1024x1024 ``render()``;
35. geometry sharding (``parallel/geometry.py``) on two ranks sharing the
    card over gloo: ``geometry_sharded_intersect`` of the teacup equal to
    the replicated walk's global prim ids, t, u and v but for ties (<= 0.5%),
    ``geometry_sharded_render`` of the teacup at 512x512 and of the torus
    past the cap at 256x256 within ``IMG_MAX_BAD`` of the replicated render,
    and the per-shard kernels' launches;
36. compiled dispatch (``utils/graphs.py``): every route of PERF.md's kernel
    table rendered through ``render()``'s CUDA graph (counts from 0: the
    warm-up and the replays) and eagerly, bit-equal, then replayed once
    more with a material scaled, the camera moved and (spherical lights)
    a new key, bit-equal to a fresh eager render; eager and graphed ms and
    busy share of each, the first call's capture and instantiation
    seconds and the graph's pool; three graphed training steps (the box,
    the teacup, the box with the quirk bloom) against the eager step: the
    loss bit-equal, the gradients within ``checks.TABLE_GRAD``;
    ``optimize(steps_per_call=8)`` over 16 teacup vertex steps against the
    eager loop; ``csrc/bloom.cu``'s forward and adjoint against their twins
    at 1024x1024, 800x800 and 37x53 (two launches bit-equal), timed against
    the twins and their bound, with the variants of ``BLOOM_ABLATIONS``
    (one block, a cluster of 8, spinning polls, acquire polls) and
    ``bloom_full_window`` (full windows) and, with ``--parent DIR``, that
    commit's ``bloom.cu``, each bit-equal to this tree's kernel at the three
    sizes (the full windows', to the twin) and timed in turns at 1024x1024,
    the cluster that ran, a lone row's pixel step, the derived lag a row
    adds and the cycles of a step's parts (``BLOOM_CLOCKS``); and the
    teacup's motion-blur sets against the plain twins (run on the CPU in
    processes started with the script);
37. the default route's bounce level (``csrc/level.cu``): on nine default
    routes (``LEVEL_ROUTES``: the box, the box under ``reference_quirks``,
    the triangles + spheres scene, the ``spheres`` preset, the spherical
    box, the teacup, the teacup at width 2 at 512x512, the donut, the donut
    with two spheres) every level of the frame through ``level_cuda`` and
    through the chain (``level_plain``) on the same inputs, every output bit
    for bit (and ``level_surface_cuda`` against ``reconstruct_hit``; an
    output that is not is named with its ulp gap and held to
    ``utils/checks.py``'s rule), the frame too; then, the counts from 0,
    every route's graphed frame (``render()``) bit-equal to the chain's eager
    frame, each level kernel launched; each route's graphed frame timed
    against the chain's graphed frame in turns, with its busy share and
    kernels per frame; the three kernels' times against the chain on the
    box's and the spherical box's first level and their bounds.  With
    ``--parent DIR``, each route's graphed frame in a process per tree
    (parent, this, this, parent).

Every kernel's entry has its bound: the larger of its operations over 67
TFLOP/s (integer ones over 16.7 Tops/s) and its bytes over 3.35 TB/s
(utils/roofline.py), its work counted on this run's inputs.  Then one JSON line with the kernels' results and,
last, ``{"ok": true, "device": ...}``.  Any failure raises and exits non-zero; so does a machine
without CUDA.  Images and a results file go to ``--out`` (default
``chip_smoke_out/`` beside this script).
"""
import argparse
import concurrent.futures
import dataclasses
import faulthandler
import json
import os
import subprocess
import sys
import time
from functools import partial

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNELS = {  # wrapper -> (name, source, Pallas kernel replaced), forward path first
    "intersect_cuda": ("closest", "cg_raytracer_tpu_torch/csrc/oracle.cu",
                       "cg_raytracer_tpu/ops/pallas_kernels.py:88"),
    "occluded_cuda": ("anyhit", "cg_raytracer_tpu_torch/csrc/oracle.cu",
                      "cg_raytracer_tpu/ops/pallas_kernels.py:131"),
    "bounce_cuda": ("bounce", "cg_raytracer_tpu_torch/csrc/oracle.cu",
                    "cg_raytracer_tpu/ops/pallas_kernels.py:176"),
    "trace_cuda": ("trace", "cg_raytracer_tpu_torch/csrc/trace.cu",
                   "cg_raytracer_tpu/ops/pallas_kernels.py:877"),
    "record_trace_cuda": ("record_trace", "cg_raytracer_tpu_torch/csrc/record.cu",
                          "cg_raytracer_tpu/ops/pallas_kernels.py:378"),
    "bounce_refl_cuda": ("bounce_refl", "cg_raytracer_tpu_torch/csrc/record.cu",
                         "cg_raytracer_tpu/ops/pallas_kernels.py:357"),
    "shade_fwd_cuda": ("shade_fwd", "cg_raytracer_tpu_torch/csrc/shade.cu",
                       "cg_raytracer_tpu/ops/pallas_shade.py:323"),
    "shade_bwd_cuda": ("shade_bwd", "cg_raytracer_tpu_torch/csrc/shade.cu",
                       "cg_raytracer_tpu/ops/pallas_shade.py:510"),
    # The mesh slice; bvh4 counts the closest-hit and any-hit wrappers' launches.
    "intersect_bvh4_cuda": ("bvh4", "cg_raytracer_tpu_torch/csrc/bvh4.cu",
                            "cg_raytracer_tpu/ops/pallas_bvh4.py:439"),
    "bounce_bvh4_cuda": ("bvh4_bounce", "cg_raytracer_tpu_torch/csrc/bvh4.cu",
                         "cg_raytracer_tpu/ops/pallas_bvh4.py:534"),
    "shade_pre_fwd_cuda": ("shade_pre_fwd", "cg_raytracer_tpu_torch/csrc/shade.cu",
                           "cg_raytracer_tpu/ops/pallas_shade.py:363"),
    "shade_pre_bwd_cuda": ("shade_pre_bwd", "cg_raytracer_tpu_torch/csrc/shade.cu",
                           "cg_raytracer_tpu/ops/pallas_shade.py:548"),
    # The soft-shadow slice.
    "soft_prng_cuda": ("soft_prng", "cg_raytracer_tpu_torch/csrc/soft.cu",
                       "cg_raytracer_tpu/ops/pallas_kernels.py:690"),
    "soft_table_cuda": ("soft_table", "cg_raytracer_tpu_torch/csrc/soft.cu",
                        "cg_raytracer_tpu/ops/pallas_kernels.py:717"),
    "soft4_prng_cuda": ("soft4_prng", "cg_raytracer_tpu_torch/csrc/soft.cu",
                        "cg_raytracer_tpu/ops/pallas_bvh4.py:732"),
    "soft4_table_cuda": ("soft4_table", "cg_raytracer_tpu_torch/csrc/soft.cu",
                         "cg_raytracer_tpu/ops/pallas_bvh4.py:778"),
    # The scale slice: the same wrappers and kernel body past 200,000
    # triangles, where the JAX package ran its streaming kernels (B8).
    "intersect_bvh4_cuda:large": ("bvh4_large", "cg_raytracer_tpu_torch/csrc/bvh4.cu",
                                  "cg_raytracer_tpu/ops/pallas_bvh4.py:1197"),
    "bounce_bvh4_cuda:large": ("bvh4_bounce_large", "cg_raytracer_tpu_torch/csrc/bvh4.cu",
                               "cg_raytracer_tpu/ops/pallas_bvh4.py:1222"),
    # The tree-width slice: the same wrappers and walk at node width 2 (the
    # JAX package's binary kernels, both tiers, and its binary samplers) and 8.
    "intersect_bvh4_cuda:w2": ("bvh_w2", "cg_raytracer_tpu_torch/csrc/bvh4.cu",
                               "cg_raytracer_tpu/ops/pallas_bvh.py:262"),
    "bounce_bvh4_cuda:w2": ("bvh_bounce_w2", "cg_raytracer_tpu_torch/csrc/bvh4.cu",
                            "cg_raytracer_tpu/ops/pallas_bvh.py:276"),
    "intersect_bvh4_cuda:w2:large": ("bvh_w2_large", "cg_raytracer_tpu_torch/csrc/bvh4.cu",
                                     "cg_raytracer_tpu/ops/pallas_bvh.py:732"),
    "bounce_bvh4_cuda:w2:large": ("bvh_bounce_w2_large", "cg_raytracer_tpu_torch/csrc/bvh4.cu",
                                  "cg_raytracer_tpu/ops/pallas_bvh.py:747"),
    # The 'sample' route: the same wrappers and kernel as the cone's at
    # width 2 (one tree), in the table as the JAX package's per-sample rows.
    "soft4_prng_cuda:w2:sample": ("soft_bvh_prng", "cg_raytracer_tpu_torch/csrc/soft.cu",
                                  "cg_raytracer_tpu/ops/pallas_bvh.py:1008"),
    "soft4_table_cuda:w2:sample": ("soft_bvh_table", "cg_raytracer_tpu_torch/csrc/soft.cu",
                                   "cg_raytracer_tpu/ops/pallas_bvh.py:1036"),
    "soft4_prng_cuda:w2": ("soft_bvh_cone_prng", "cg_raytracer_tpu_torch/csrc/soft.cu",
                           "cg_raytracer_tpu/ops/pallas_bvh.py:1109"),
    "soft4_table_cuda:w2": ("soft_bvh_cone_table", "cg_raytracer_tpu_torch/csrc/soft.cu",
                            "cg_raytracer_tpu/ops/pallas_bvh.py:1158"),
    "intersect_bvh4_cuda:w8": ("bvh4_w8", "cg_raytracer_tpu_torch/csrc/bvh4.cu",
                               "cg_raytracer_tpu/ops/pallas_bvh4.py:439"),
    "bounce_bvh4_cuda:w8": ("bvh4_bounce_w8", "cg_raytracer_tpu_torch/csrc/bvh4.cu",
                            "cg_raytracer_tpu/ops/pallas_bvh4.py:534"),
    "soft4_prng_cuda:w8": ("soft4_prng_w8", "cg_raytracer_tpu_torch/csrc/soft.cu",
                           "cg_raytracer_tpu/ops/pallas_bvh4.py:732"),
    "soft4_table_cuda:w8": ("soft4_table_w8", "cg_raytracer_tpu_torch/csrc/soft.cu",
                            "cg_raytracer_tpu/ops/pallas_bvh4.py:778"),
    # The default route's bounce level: the JAX package's jit-compiled
    # one-phase level (XLA fusions, not Pallas), one kernel or two.
    "level_cuda": ("level", "cg_raytracer_tpu_torch/csrc/level.cu",
                   "cg_raytracer_tpu/models/whitted.py:697"),
    "level_surface_cuda": ("level_surface", "cg_raytracer_tpu_torch/csrc/level.cu",
                           "cg_raytracer_tpu/models/whitted.py:600"),
    "level_shade_cuda": ("level_shade", "cg_raytracer_tpu_torch/csrc/level.cu",
                         "cg_raytracer_tpu/models/whitted.py:600"),
}
FORWARD_KERNELS = ("intersect_cuda", "occluded_cuda", "bounce_cuda", "trace_cuda")
TRAIN_KERNELS = ("record_trace_cuda", "bounce_refl_cuda", "shade_fwd_cuda", "shade_bwd_cuda")
MESH_KERNELS = ("intersect_bvh4_cuda", "bounce_bvh4_cuda", "shade_pre_fwd_cuda",
                "shade_pre_bwd_cuda")
SOFT_KERNELS = ("soft_prng_cuda", "soft_table_cuda", "soft4_prng_cuda", "soft4_table_cuda")
SCALE_KERNELS = ("intersect_bvh4_cuda:large", "bounce_bvh4_cuda:large")
WIDTH_KERNELS = tuple(k for k in KERNELS if ":w" in k)
TORUS_GRID = 800  # the donut's surface on an 800 x 800 grid: 1,280,000 triangles
L2_BYTES = 50 * 1024 * 1024  # the H100's L2
SOFT_SUB = 4096  # hit points of the samplers' checks against their twins
SOFT_KEY_OFFSET = 777_777  # global index of the checks' first point
TOL = 1e-5  # t/u/v where prim ids match
MIN_MATCH = 0.995  # prim ids, shadow bits, booleans
IMG_ATOL, IMG_MAX_BAD = 1e-4, 0.005  # assert_images_close
SHADE_FWD = dict(rtol=1e-5, atol=1e-6)


_CLOCK = {"start": time.perf_counter(), "last": None}


def phase(title):
    """Print a phase's title with the script's seconds so far and the
    seconds the phase before it took."""
    now = time.perf_counter()
    took = "" if _CLOCK["last"] is None else f", the phase before {now - _CLOCK['last']:.1f} s"
    _CLOCK["last"] = now
    print(f"{title}  [{now - _CLOCK['start']:.1f} s{took}]")


def images_close(a, b, what, max_bad=IMG_MAX_BAD):
    bad = ((a - b).abs().amax(dim=-1) > IMG_ATOL).float().mean().item()
    err = (a - b).abs().max().item()
    print(f"  {what}: {bad:.5%} of pixels off by > {IMG_ATOL}, max abs diff {err:.3g}")
    assert bad <= max_bad, f"{what}: {bad:.4%} of pixels differ"
    return bad, err


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="On-card check of the PyTorch + CUDA port.")
    parser.add_argument("--out", default=os.path.join(ROOT, "chip_smoke_out"),
                        help="directory for the renders and results.json")
    parser.add_argument("--parent", default=None,
                        help="an unpacked checkout of an earlier commit whose samplers, walk, "
                             "shade backward and brute sweeps phases 29-31, whose quirk "
                             "blur phase 36, and whose graphed default frames phase 37 time "
                             "beside this tree's")
    args = parser.parse_args(argv)
    out = args.out
    faulthandler.enable()  # a fatal signal prints every thread's Python stack to stderr
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from cg_raytracer_tpu_torch import cli
    from cg_raytracer_tpu_torch.models.whitted import make_backend, render, render_image
    from cg_raytracer_tpu_torch.models import whitted
    from cg_raytracer_tpu_torch.ops import _build
    from cg_raytracer_tpu_torch.ops import cuda_kernels as ck
    from cg_raytracer_tpu_torch.ops import shade
    from cg_raytracer_tpu_torch.ops.camera import generate_rays
    from cg_raytracer_tpu_torch.scene import standins
    from cg_raytracer_tpu_torch.scene.types import Camera, PointLights, Spheres, make_scene
    from cg_raytracer_tpu_torch.utils import bench, checks, roofline
    from cg_raytracer_tpu_torch.utils.bench import median, run_bench, time_frames
    from cg_raytracer_tpu_torch.utils.config import RenderConfig
    from cg_raytracer_tpu_torch.utils.image import read_image, write_png
    from cg_raytracer_tpu_torch.utils.profiling import device_breakdown

    os.makedirs(out, exist_ok=True)
    mb_twins = start_mb_twins(out)  # phase 36's CPU twins, in the background from now
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}

    phase("phase 1: nvidia-smi --query-gpu=name,power.limit --format=csv,noheader")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    phase("phase 2: build the kernels")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for job in [pool.submit(_build.load), pool.submit(_build.load_check)]:
            job.result()
    results["build_s"] = time.perf_counter() - t0
    log = _build.library_path()[:-3] + ".log"
    print(f"  built {os.path.relpath(_build.library_path(), ROOT)} in {results['build_s']:.1f} s")
    with open(log) as f:
        print("".join(f"  ptxas: {line}" for line in f
                      if any(k in line for k in ("registers", "spill", "entry function"))))

    box = make_scene(standins.mirror_box_meshes(),
                     point_lights=PointLights.of(*standins.MIRROR_BOX_LIGHTS), device=device)
    mixed = make_scene(standins.mixed_meshes(),
                       spheres=Spheres(**{k: torch.as_tensor(v)
                                          for k, v in standins.mixed_spheres().items()}),
                       point_lights=PointLights.of(*standins.MIXED_LIGHTS), device=device)
    cam = Camera.default(device=device)

    phase("phase 3: kernels against their plain twins, 1024^2 primary + secondary rays")
    o1, d1 = generate_rays(cam, 1024, 1024)

    def hit_diff(got, want):
        same = got.prim_id == want.prim_id
        match = same.float().mean().item()
        finite = same & torch.isfinite(want.t)
        err = max((a[finite] - b[finite]).abs().max().item() if finite.any() else 0.0
                  for a, b in ((got.t, want.t), (got.u, want.u), (got.v, want.v)))
        for a, b in ((got.t, want.t), (got.u, want.u), (got.v, want.v)):
            torch.testing.assert_close(a[finite], b[finite], rtol=TOL, atol=TOL)
        assert match >= MIN_MATCH, f"prim ids agree on {match:.4%}"
        return match, err

    check = {k: {"mismatch": 0.0, "err": 0.0} for k in KERNELS}

    def note(wrapper, mismatch, err):
        check[wrapper]["mismatch"] = max(check[wrapper]["mismatch"], mismatch)
        check[wrapper]["err"] = max(check[wrapper]["err"], err)

    sets = {}
    for label, scene in (("box", box), ("mixed", mixed)):
        o, d, valid1, shadow = sets[label] = ray_sets(scene, o1, d1)
        match, err = hit_diff(ck.intersect_cuda(scene, o, d), ck.intersect_plain(scene, o, d))
        print(f"  closest {label}: prim ids agree on {match:.5%}, max |dt|,|du|,|dv| {err:.3g}")
        note("intersect_cuda", 1 - match, err)
        got = ck.occluded_cuda(scene, *shadow)
        want = ck.occluded_plain(scene, *shadow)
        match = (got == want).float().mean().item()
        err = (got.float() - want.float()).abs().max().item()
        print(f"  anyhit {label}: agree on {match:.5%} of {got.numel()} shadow rays "
              f"({want.float().mean().item():.2%} occluded)")
        assert match >= MIN_MATCH
        note("occluded_cuda", 1 - match, err)
        for quirks in (False, True):
            bad, err = images_close(ck.trace_cuda(scene, o1, d1, 2, quirks),
                                    ck.trace_plain(scene, o1, d1, 2, quirks),
                                    f"trace {label} depth 2 quirks={quirks}")
            note("trace_cuda", bad, err)
    o, d, valid1, _ = sets["box"]
    live = torch.cat([torch.ones_like(valid1), valid1])
    (gh, gb), (wh, wb) = ck.bounce_cuda(box, o, d, live), ck.bounce_plain(box, o, d, live)
    match, err = hit_diff(gh, wh)
    bits = (gb == wb).float().mean().item()
    print(f"  bounce box: prim ids agree on {match:.5%}, shadow bits on {bits:.5%}, "
          f"max |dt|,|du|,|dv| {err:.3g}")
    assert bits >= MIN_MATCH
    note("bounce_cuda", max(1 - match, 1 - bits), err)
    torch.cuda.synchronize()

    phase("phase 4: main path (render) on the stand-in box and the triangles + spheres scene")
    ck.reset_launch_counts()
    renders = {}
    for size in (800, 1024):
        for fo in (True, False):
            cfg = RenderConfig(width=size, height=size, forward_only=fo)
            renders[("box", size, fo)] = (box, cfg, render(box, cam, cfg))
    for fo in (True, False):
        cfg = RenderConfig(width=800, height=800, forward_only=fo)
        renders[("mixed", 800, fo)] = (mixed, cfg, render(mixed, cam, cfg))
    phase("phase 5: cgrt-torch render --scene spheres --device cuda")
    cli_png = os.path.join(out, "cli_spheres.png")
    assert cli.main(["render", "--scene", "spheres", "--device", "cuda", "--width", "800",
                     "--height", "800", "-o", cli_png]) == 0
    torch.cuda.synchronize()
    counts = {k: ck.launch_counts()[k] for k in FORWARD_KERNELS}

    phase(f"phase 6: launch counts of the main path {counts}")
    for wrapper, n in counts.items():
        assert n > 0, f"{wrapper} never launched its kernel on the main path"
    for (label, size, fo), (scene, cfg, img) in renders.items():
        what = f"{label} {size}^2 forward_only={fo}"
        assert img.shape == (size, size, 3) and bool(torch.isfinite(img).all()), what
        plain = render_image(scene, cam, cfg, backend=make_backend(scene, cfg, plain=True))
        images_close(img, plain, f"{what} vs plain path")
        write_png(os.path.join(out, f"{label}_{size}_{'trace' if fo else 'bounce'}.png"), img)
        lit = (img.amax(dim=-1) > 0.02).float().mean().item()
        print(f"  {what}: lit fraction {lit:.3f}, mean {img.mean().item():.4f}")
        assert lit > 0.15, what
        if label == "box":
            r, g, b = img[..., 0], img[..., 1], img[..., 2]
            red = ((r > 0.05) & (r > 3 * g) & (r > 3 * b)).float().mean().item()
            green = ((g > 0.05) & (g > 1.5 * r) & (g > 1.5 * b)).float().mean().item()
            print(f"  {what}: red wall {red:.3f}, green wall {green:.3f} of pixels")
            assert red > 0.02 and green > 0.02, what
    for label, size in (("box", 800), ("box", 1024), ("mixed", 800)):
        images_close(renders[(label, size, True)][2], renders[(label, size, False)][2],
                     f"{label} {size}^2 trace kernel vs bounce/oracle path")
    # An independent reference: the CPU brute-force path, at 64^2.
    cpu_cfg = RenderConfig(width=64, height=64, backend="brute")
    for label, scene in (("box", box), ("mixed", mixed)):
        ref = render(scene.to("cpu"), Camera.default(device="cpu"), cpu_cfg)
        for fo in (True, False):
            img = render(scene, cam, RenderConfig(width=64, height=64, forward_only=fo))
            images_close(img.cpu(), ref, f"{label} 64^2 forward_only={fo} vs CPU brute force")
    spheres_img = read_image(cli_png)
    assert spheres_img.shape == (800, 800, 3) and (spheres_img.max(axis=-1) > 0.02).mean() > 0.05

    phase("phase 7: times at 1024^2 on the stand-in box")
    _, _, _, (so, sd, st) = sets["box"]
    tri, aux, sph, lt = (ck._tri_table(box), ck._aux_table(box), ck._sphere_table(box),
                         ck._light_table(box))
    lpos = box.point_lights.position.contiguous()
    calls = {  # wrapper: (wrapper call, the bare kernel launch, its plain twin)
        "intersect_cuda": (lambda: ck.intersect_cuda(box, o1, d1),
                           lambda: ck._closest_kernel(tri, o1, d1, None),
                           lambda: ck._closest_plain(tri, o1, d1, None)),
        "occluded_cuda": (lambda: ck.occluded_cuda(box, so, sd, st),
                          lambda: ck._anyhit_kernel(tri, so, sd, st),
                          lambda: ck._anyhit_plain(tri, so, sd, st)),
        "bounce_cuda": (lambda: ck.bounce_cuda(box, o1, d1),
                        lambda: ck._bounce_kernel(tri, lpos, o1, d1, None),
                        lambda: ck._bounce_plain(tri, lpos, o1, d1, None)),
        "trace_cuda": (lambda: ck.trace_cuda(box, o1, d1, 2),
                       lambda: ck._trace_kernel(tri, aux, sph, lt, o1, d1, 2, False),
                       lambda: ck._trace_plain(tri, aux, sph, lt, o1, d1, 2, False)),
    }
    # The work of these inputs (utils/roofline.py), for each kernel's bound.
    tb, n1 = roofline.table_bytes, o1.shape[0]
    closest_f, _ = roofline.brute_bounce_flops(tri, lpos[:0], o1, d1)
    bounce_f, hit0 = roofline.brute_bounce_flops(tri, lpos, o1, d1)
    rec_tables = ck._record_tables(box, "record")
    _, slot2, _, _, _, o_next, d_next, active2 = ck._record_plain(*rec_tables, o1, d1, 2, False)
    level1_f, hit1 = roofline.brute_bounce_flops(tri, lpos, o_next[0], d_next[0], active2[0])
    hits, n_l = int(hit0.sum()) + int(hit1.sum()), lpos.shape[0]
    work = {
        "intersect_cuda": (closest_f, n1 * (24 + 16) + tb(tri)),
        "occluded_cuda": (float(roofline.anyhit_tests(tri, so, sd, st).sum())
                          * (roofline.MT_FLOPS + roofline.ANYHIT_UPDATE), n1 * (28 + 1) + tb(tri)),
        "bounce_cuda": (bounce_f, n1 * (24 + 20) + tb(tri, lpos)),
        "trace_cuda": (bounce_f + level1_f
                       + hits * (roofline.RECON_FLOPS + n_l * roofline.SHADE_FLOPS
                                 + roofline.BOUNCE_MISC_FLOPS),
                       n1 * (24 + 12) + tb(tri, aux, sph, lt)),
        "record_trace_cuda": (bounce_f + level1_f + hits * roofline.RECON_FLOPS,
                              n1 * (24 + 2 * 20 + 24 + 1) + tb(*rec_tables)),
        "bounce_refl_cuda": (bounce_f + int(hit0.sum()) * roofline.RECON_FLOPS,
                             n1 * (24 + 20 + 24 + 1) + tb(*rec_tables)),
    }
    print("  ms = kernel time on the device (profiler); launch_ms = one bare launch between "
          "CUDA events; wrapper_ms = the wrapper call; plain_ms = the plain twin (events); "
          "bound_ms = the least time for this work at 67 TFLOP/s and 3.35 TB/s")
    kernels = []
    for wrapper, (wrapper_fn, kernel_fn, plain_fn) in calls.items():
        wrapper_ms = median(time_frames(wrapper_fn, iters=20))
        launch_ms = median(time_frames(kernel_fn, iters=20))
        device_ms = device_breakdown(kernel_fn, iters=20)["device_ms"]
        plain_ms = median(time_frames(plain_fn, iters=5, warmup=1))
        ms = device_ms if device_ms is not None else launch_ms
        name, source, replaces = KERNELS[wrapper]
        b_ms, b_by = roofline.bound_ms(*work[wrapper])
        print(f"  {name}: ms {ms:.5f} ({1024 * 1024 / ms / 1e3:.5g} M rays/s), launch_ms "
              f"{launch_ms:.5f}, wrapper_ms {wrapper_ms:.5f}, plain_ms {plain_ms:.4f} "
              f"(x{plain_ms / ms:.1f}), bound_ms {b_ms:.5f} by {b_by} ({b_ms / ms:.1%} of it); "
              f"device time {'measured' if device_ms is not None else 'not measured'}")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": counts[wrapper], "max_abs_err": check[wrapper]["err"],
                        "mismatch_frac": check[wrapper]["mismatch"], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None, "launch_ms": launch_ms, "wrapper_ms": wrapper_ms})
    e2e = {}
    for size in (800, 1024):
        for fo in (True, False):
            path = "trace" if fo else "bounce"
            r = run_bench(box, width=size, height=size, cfg_overrides={"forward_only": fo})
            cfg = RenderConfig(width=size, height=size, forward_only=fo)
            kernel_be, plain_be = make_backend(box, cfg), make_backend(box, cfg, plain=True)
            prof = device_breakdown(lambda: render_image(box, cam, cfg, backend=kernel_be))
            plain_ms = median(time_frames(lambda: render_image(box, cam, cfg, backend=plain_be),
                                          iters=3, warmup=1))
            e2e[f"box_{size}_{path}"] = {"ms": r["seconds_per_frame"] * 1e3,
                                         "rays_per_s": r["value"], "plain_ms": plain_ms,
                                         "profile": prof}
            busy = f"{prof['busy']:.3f}" if prof["busy"] is not None else "not measured"
            print(f"  render box {size}^2 {path} path: {r['seconds_per_frame'] * 1e3:.5f} "
                  f"ms/frame (CUDA events), {r['value']:.5g} primary rays/s; plain path "
                  f"{plain_ms:.3f} ms; profiled wall {prof['wall_ms']:.4f} ms, device busy {busy}")
            for kname, kms, n in prof["kernels"][:6]:
                print(f"    {kms:.5f} ms x{n:g}  {kname[:90]}")

    phase("phase 8: training kernels against their plain twins, 1024^2 primary rays")
    rec_tables = ck._record_tables(box, "record")
    for quirks in (False, True):
        got, want = ck.record_trace_cuda(box, o1, d1, 2, quirks), ck.record_trace_plain(
            box, o1, d1, 2, quirks)
        for level, ((go, gd, gh, gb, ga), (wo, wd, wh, wb, wa)) in enumerate(zip(got, want)):
            match, err = hit_diff(gh, wh)
            same_bits = (gb == wb).float().mean().item()
            same_active = (ga == wa).float().mean().item()
            both = ga & wa & (gh.prim_id == wh.prim_id)
            for a, b in ((go, wo), (gd, wd)):
                torch.testing.assert_close(a[both], b[both], rtol=TOL, atol=TOL)
                err = max(err, (a[both] - b[both]).abs().max().item() if both.any() else 0.0)
            assert min(same_bits, same_active) >= MIN_MATCH
            print(f"  record_trace level {level} quirks={quirks}: prim ids agree on "
                  f"{match:.5%}, bits {same_bits:.5%}, active {same_active:.5%} "
                  f"({ga.float().mean().item():.2%} active), max |d t,u,v,o,d| {err:.3g}")
            note("record_trace_cuda", 1 - min(match, same_bits, same_active), err)
    live = torch.arange(o1.shape[0], device=device) % 5 != 0
    got, want = ck.bounce_refl_cuda(box, o1, d1, live), ck.bounce_refl_plain(box, o1, d1, live)
    match, err = hit_diff(got[0], want[0])
    same = got[0].prim_id == want[0].prim_id
    for a, b in ((got[2], want[2]), (got[3], want[3])):
        torch.testing.assert_close(a[same], b[same], rtol=TOL, atol=TOL)
        err = max(err, (a[same] - b[same]).abs().max().item())
    agree = min((got[1] == want[1]).float().mean().item(),
                (got[4] == want[4]).float().mean().item())
    assert agree >= MIN_MATCH
    print(f"  bounce_refl box: prim ids agree on {match:.5%}, bits and reflective flags on "
          f"{agree:.5%}, max |d t,u,v,position,reflection| {err:.3g}")
    note("bounce_refl_cuda", 1 - min(match, agree), err)
    gen = torch.Generator(device).manual_seed(8)
    o_cap, d_cap = generate_rays(Camera.default(dist=4.0, device=device), 256, 256)
    cap = checks.cap_scene(device)
    for label, scene, so, sd in (("mixed", mixed, o1, d1), ("box", box, o1, d1),
                                 ("256-triangle cap scene at 256^2", cap, o_cap, d_cap)):
        hit = ck.intersect_plain(scene, so, sd)
        prim = hit.prim_id.contiguous()
        bits = torch.randint(0, 1 << scene.point_lights.position.shape[0], prim.shape,
                             device=device, dtype=torch.int32, generator=gen)
        tri, aux, lights, spheres, num_tris = shade._shade_tables(scene)
        tables = (tri.detach(), aux.detach(), lights.detach(), spheres.detach())
        got = shade.shade_fwd_cuda(*tables, so, sd, prim, bits, num_tris)
        want = shade.shade_plain(*tables, so, sd, prim, bits, num_tris=num_tris)
        err = 0.0
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **SHADE_FWD)
            err = max(err, (a - b).abs().max().item())
        print(f"  shade_fwd {label}: max |d direct,ks,normal,position| {err:.3g} "
              f"({(prim >= 0).float().mean().item():.2%} of rays hit)")
        note("shade_fwd_cuda", 0.0, err)
        cts = [torch.randn(so.shape, device=device, generator=gen) for _ in range(4)]
        got = shade.shade_bwd_cuda(*tables, so, sd, prim, bits, num_tris, cts)
        twin, exact = checks.twin_grads(tables, so, sd, prim, bits, num_tris, cts)
        report = checks.shade_grads_close(got, twin, exact, so.shape[0])
        for name, a, b in zip(checks.GRAD_NAMES, got, twin):
            err = (a - b).abs().max().item() if b.numel() else 0.0
            scale = b.abs().max().item() if b.numel() else 0.0
            ratio, past = report[name]
            print(f"  shade_bwd {label} {name}: max |kernel - twin| {err:.3g} (max |twin| "
                  f"{scale:.3g}), at most {ratio:.3g} of the (widened) tolerance; {past:.5%} of "
                  f"elements past the tolerance before the float32 widening")
            note("shade_bwd_cuda", past, err)
    torch.cuda.synchronize()

    phase("phase 9: training main path, run_bench(include_bwd=True) on the stand-in box 1024^2")
    contracts = {"full": True, "materials": False}
    ck.reset_launch_counts()
    shade.reset_launch_counts()
    train = {c: run_bench(box, width=1024, height=1024, include_bwd=True, iters=10,
                          include_vertex_params=v, scene_name="stand-in mirror box")
             for c, v in contracts.items()}
    torch.cuda.synchronize()
    train_counts = {**ck.launch_counts(), **shade.launch_counts()}
    print(f"  launch counts of run_bench(include_bwd=True) {train_counts}")
    for wrapper in ("record_trace_cuda", "shade_fwd_cuda", "shade_bwd_cuda"):
        assert train_counts[wrapper] > 0, f"{wrapper} never launched its kernel on the main path"
    # The by-level record path: one step whose records come level by level
    # from the bounce-refl kernel (a backend without record_trace).
    cfg_full = bench.training_config(RenderConfig(width=1024, height=1024), True)
    scn = dataclasses.replace(box, vertices=box.vertices.detach().requires_grad_(True))
    by_level = whitted.make_backend(scn, cfg_full)._replace(record_trace=None)
    ck.reset_launch_counts()
    shade.reset_launch_counts()
    render_image(scn, cam, cfg_full, backend=by_level).mean().backward()
    torch.cuda.synchronize()
    level_counts = {**ck.launch_counts(), **shade.launch_counts()}
    print(f"  launch counts of one step through the by-level records {level_counts}")
    assert level_counts["bounce_refl_cuda"] > 0, "bounce_refl_cuda never launched its kernel"
    train_counts["bounce_refl_cuda"] = level_counts["bounce_refl_cuda"]
    for c, r in train.items():
        print(f"  {r['metric']}: {r['seconds_per_frame'] * 1e3:.5f} ms/step, "
              f"{r['value']:.6g} rays/s")
    jitter = bench.camera_jitter(torch.Generator(device).manual_seed(9), device)
    steps = {}
    for c, v in contracts.items():
        cfg = bench.training_config(RenderConfig(width=1024, height=1024), v)
        params = bench.training_params(box, v)
        (lk, gk), (lp, gp) = (bench.fwd_bwd_step(box, cam, cfg, params, jitter, plain=plain)
                              for plain in (False, True))
        steps[c] = (cfg, params)
        print(f"  {c} contract, one step: loss {lk.item():.8g} (plain path {lp.item():.8g})")
        torch.testing.assert_close(lk, lp, rtol=1e-5, atol=1e-7)
        for k in gk:
            tol = dict(checks.TABLE_GRAD, atol=2e-5) if k == "vertices" else checks.TABLE_GRAD
            assert bool(torch.isfinite(gk[k]).all()), k
            torch.testing.assert_close(gk[k], gp[k], **tol, msg=f"{c} d/d{k}")
            print(f"    d/d{k}: max |kernel - plain| {(gk[k] - gp[k]).abs().max().item():.3g}, "
                  f"max |grad| {gp[k].abs().max().item():.3g}")
        for k in ("kd", "ks", "light_color", "light_position") + (("vertices",) if v else ()):
            assert gk[k].abs().sum().item() > 0, f"{c}: d/d{k} is zero"

    phase("phase 10: training kernel times at 1024^2 on the stand-in box")
    recs = ck.record_trace_cuda(box, o1, d1, 2)
    ro, rd, rhit, rbits, _ = recs[0]
    s_tables = tuple(x.detach() for x in shade._shade_tables(box)[:4])
    num_t = box.num_triangles
    cts = [torch.full_like(o1, 1.0 / o1.numel()) for _ in range(4)]

    def shade_bwd_plain():
        leaves = [x.detach().requires_grad_(True) for x in (*s_tables, ro, rd)]
        outs = shade.shade_plain(*leaves, rhit.prim_id, rbits, num_tris=num_t)
        return torch.autograd.grad(outs, leaves, cts, allow_unused=True)

    train_calls = {
        "record_trace_cuda": (lambda: ck._record_kernel(*rec_tables, o1, d1, 2, False),
                              lambda: ck._record_plain(*rec_tables, o1, d1, 2, False)),
        "bounce_refl_cuda": (lambda: ck._bounce_refl_kernel(*rec_tables, o1, d1, None, False),
                             lambda: ck._bounce_refl_plain(*rec_tables, o1, d1, None, False)),
        "shade_fwd_cuda": (lambda: shade.shade_fwd_cuda(*s_tables, ro, rd, rhit.prim_id, rbits,
                                                        num_t),
                           lambda: shade.shade_plain(*s_tables, ro, rd, rhit.prim_id, rbits,
                                                     num_tris=num_t)),
        "shade_bwd_cuda": (lambda: shade.shade_bwd_cuda(*s_tables, ro, rd, rhit.prim_id, rbits,
                                                        num_t, cts),
                           shade_bwd_plain),
    }
    n_live = int((rhit.prim_id >= 0).sum())
    work.update({
        "shade_fwd_cuda": (roofline.shade_flops(n_live, n_l), n1 * (24 + 8 + 48) + tb(*s_tables)),
        "shade_bwd_cuda": (roofline.shade_flops(n_live, n_l, backward=True),
                           n1 * (24 + 8 + 48 + 24) + 2 * tb(*s_tables)),
    })
    print("  ms = kernel time on the device (profiler); launch_ms = one bare launch between "
          "CUDA events; plain_ms = the plain twin (events; for shade_bwd the twin's forward "
          "and autograd backward)")
    for wrapper, (kernel_fn, plain_fn) in train_calls.items():
        launch_ms = median(time_frames(kernel_fn, iters=20))
        device_ms = device_breakdown(kernel_fn, iters=20)["device_ms"]
        plain_ms = median(time_frames(plain_fn, iters=5, warmup=1))
        ms = device_ms if device_ms is not None else launch_ms
        name, source, replaces = KERNELS[wrapper]
        b_ms, b_by = roofline.bound_ms(*work[wrapper])
        print(f"  {name}: ms {ms:.5f}, launch_ms {launch_ms:.5f}, plain_ms {plain_ms:.4f} "
              f"(x{plain_ms / ms:.1f}), bound_ms {b_ms:.5f} by {b_by} ({b_ms / ms:.1%} of it); "
              f"device time {'measured' if device_ms is not None else 'not measured'}")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": train_counts[wrapper],
                        "max_abs_err": check[wrapper]["err"],
                        "mismatch_frac": check[wrapper]["mismatch"], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None, "launch_ms": launch_ms})
    for c, (cfg, params) in steps.items():
        step = lambda: bench.fwd_bwd_step(box, cam, cfg, params, jitter)  # noqa: E731
        prof = device_breakdown(step, iters=5)
        plain_ms = median(time_frames(lambda: bench.fwd_bwd_step(box, cam, cfg, params, jitter,
                                                                 plain=True),
                                      iters=2, warmup=1))
        r = train[c]
        busy = f"{prof['busy']:.3f}" if prof["busy"] is not None else "not measured"
        e2e[f"box_1024_train_{c}"] = {"ms": r["seconds_per_frame"] * 1e3,
                                      "rays_per_s": r["value"], "plain_ms": plain_ms,
                                      "profile": prof}
        print(f"  train {c} contract 1024^2: {r['seconds_per_frame'] * 1e3:.5f} ms/step (CUDA "
              f"events), {r['value']:.6g} primary rays/s fwd+bwd; plain path {plain_ms:.3f} "
              f"ms/step; profiled wall {prof['wall_ms']:.4f} ms, device busy {busy}")
        for kname, kms, n in prof["kernels"][:8]:
            print(f"    {kms:.5f} ms x{n:g}  {kname[:90]}")
    counts.update({k: train_counts[k] for k in TRAIN_KERNELS})

    scenes = {}  # the scenes and trees later phases reuse (their trees memoized)
    counts.update(mesh_phases(out, device, check, note, kernels, e2e, results, scenes))
    counts.update(soft_phases(out, device, check, note, kernels, e2e, results, scenes))
    counts.update(scale_phases(out, device, check, note, kernels, e2e, results, scenes))
    counts.update(width_phases(out, device, check, note, kernels, e2e, results, scenes))
    sampler_phase(out, device, kernels, e2e, results, scenes, args.parent)
    scenes["box"] = box
    walk_shade_phase(out, device, kernels, e2e, results, scenes, args.parent)
    sweep_phase(out, device, kernels, e2e, results, scenes, args.parent)
    effects_phase(out, device, e2e, results, scenes)
    parallel_phases(out, device, e2e, results, scenes)
    counts.update(dispatch_phase(out, device, kernels, e2e, results, scenes, mb_twins,
                                 args.parent))
    counts.update(level_phase(out, device, kernels, e2e, results, scenes, args.parent))

    results.update(card=smi, counts=counts, kernels=kernels, end_to_end=e2e)
    with open(os.path.join(out, "results.json"), "w") as f:
        json.dump(results, f, indent=1)

    phase("done")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def ray_sets(scene, o1, d1):
    """Primary rays + their reflections, and shadow rays toward light 0."""
    import torch

    from cg_raytracer_tpu_torch.ops import cuda_kernels as ck
    from cg_raytracer_tpu_torch.ops.intersect import reconstruct_hit
    from cg_raytracer_tpu_torch.ops.linalg import norm, reflect, safe_normalize

    surf = reconstruct_hit(scene, o1, d1, ck.intersect_plain(scene, o1, d1))
    refl = safe_normalize(reflect(d1, surf.normal))
    o2 = surf.position + 1e-3 * refl
    d2 = torch.where(surf.valid[:, None], refl, d1)
    to_light = scene.point_lights.position[0] - surf.position
    ldir = safe_normalize(to_light)
    shadow = (surf.position + 1e-3 * ldir, ldir, norm(to_light) - 1e-3)
    return torch.cat([o1, o2]), torch.cat([d1, d2]), surf.valid, shadow


def two_spheres(device):
    """Two sphere primitives beside a mesh (the closest-hit and any-hit
    kernels then run instead of the fused bounce)."""
    import torch

    from cg_raytracer_tpu_torch.scene.types import Spheres

    return Spheres(center=torch.tensor([[0.55, -0.35, -0.45], [-0.6, 0.45, 0.3]]),
                   radius=torch.tensor([0.2, 0.15]),
                   kd=torch.tensor([[0.9, 0.2, 0.2], [0.2, 0.3, 0.9]]),
                   ks=torch.tensor([[0.3, 0.3, 0.3], [0.0, 0.0, 0.0]]),
                   shininess=torch.tensor([20.0, 1.0])).to(device)


def mesh_phases(out, device, check, note, kernels, e2e, results, scenes) -> dict:
    """Phases 11-15: the mesh slice on the teacup and the dragon.  Returns
    the new kernels' launch counts from the main path (phase 14)."""
    import torch

    from cg_raytracer_tpu_torch import cli
    from cg_raytracer_tpu_torch.models.whitted import (build_accel, effective_max_depth,
                                                       make_backend, render, render_image,
                                                       resolve_fwd_shade_kernel)
    from cg_raytracer_tpu_torch.ops import bvh4 as b4
    from cg_raytracer_tpu_torch.ops import cuda_kernels as ck
    from cg_raytracer_tpu_torch.ops import shade
    from cg_raytracer_tpu_torch.ops.camera import generate_rays
    from cg_raytracer_tpu_torch.ops.intersect import intersect_brute, reconstruct_hit
    from cg_raytracer_tpu_torch.ops.linalg import norm, reflect, safe_normalize
    from cg_raytracer_tpu_torch.scene.presets import load_scene
    from cg_raytracer_tpu_torch.scene.types import Camera
    from cg_raytracer_tpu_torch.utils import bench, checks, roofline
    from cg_raytracer_tpu_torch.utils.bench import median, run_bench, time_frames
    from cg_raytracer_tpu_torch.utils.config import RenderConfig
    from cg_raytracer_tpu_torch.utils.image import read_image, write_png
    from cg_raytracer_tpu_torch.utils.profiling import device_breakdown

    cam = Camera.default(device=device)
    gen = torch.Generator(device).manual_seed(11)

    phase("phase 11: host build of the 4-wide BVH (SAH, leaf 4: the card's autos)")
    teacup, dragon = load_scene("teacup", device=device), load_scene("dragon", device=device)
    cup_spheres = dataclasses.replace(teacup, spheres=two_spheres(device))
    scenes.update(teacup=teacup, dragon=dragon, teacup_spheres=cup_spheres)
    trees, builds = {}, {}
    for label, scene in (("teacup", teacup), ("dragon", dragon)):
        t0 = time.perf_counter()
        trees[label] = build_accel(scene, RenderConfig())
        torch.cuda.synchronize()
        builds[label] = time.perf_counter() - t0
        tree = trees[label]
        leaves = int((tree.meta[:, 4:8] > 0).sum())
        print(f"  {label}: {scene.num_triangles} triangles, built in {builds[label]:.3f} s: "
              f"{tree.num_nodes} 4-wide nodes, {leaves} leaves, {tree.depth} levels")
    results["bvh_build_s"] = builds
    tree = trees["teacup"]

    phase("phase 12: the 4-wide BVH kernels against their plain twins, teacup 1024^2")
    o1, d1 = generate_rays(cam, 1024, 1024)
    surf = reconstruct_hit(teacup, o1, d1, b4.intersect_bvh4_plain(teacup, tree, o1, d1))
    refl = safe_normalize(reflect(d1, surf.normal))
    o2 = surf.position + 1e-3 * refl
    d2 = torch.where(surf.valid[:, None], refl, d1)
    rays_o, rays_d = torch.cat([o1, o2]).contiguous(), torch.cat([d1, d2]).contiguous()
    live = torch.cat([torch.ones_like(surf.valid), surf.valid])
    to_light = teacup.point_lights.position[0] - surf.position
    ldir = safe_normalize(to_light)
    so = (surf.position + 1e-3 * ldir).contiguous()
    st = torch.where(surf.valid, norm(to_light) - 1e-3, -1.0)
    st = (st * torch.rand(st.shape, device=device, generator=gen) * 1.5).contiguous()
    exact = {}
    got, want = b4._closest_kernel(tree, rays_o, rays_d, None), b4._closest_plain(tree, rays_o,
                                                                                  rays_d, None)
    exact["closest"] = all(torch.equal(a, b) for a, b in zip(got, want))
    got_a, want_a = b4._anyhit_kernel(tree, so, ldir, st), b4._anyhit_plain(tree, so, ldir, st)
    exact["anyhit"] = torch.equal(got_a, want_a)
    tml = torch.where(live, float("inf"), -1.0).contiguous()
    lpos = teacup.point_lights.position.contiguous()
    (gh, gb), (wh, wb) = (b4._bounce_kernel(tree, lpos, rays_o, rays_d, tml),
                          b4._bounce_plain(tree, lpos, rays_o, rays_d, tml))
    exact["bounce"] = all(torch.equal(a, b) for a, b in zip(gh, wh)) and torch.equal(gb, wb)
    print(f"  bit-exact against the twins: {exact} ({(got.prim_id >= 0).float().mean():.2%} of "
          f"{rays_o.shape[0]} primary + reflected rays hit, {want_a.float().mean():.2%} of the "
          f"shadow rays occluded, {(gb > 0).float().mean():.2%} bounce rays shadowed)")
    assert all(exact.values()), exact
    for wrapper in ("intersect_bvh4_cuda", "bounce_bvh4_cuda"):
        note(wrapper, 0.0, 0.0)
    sub = torch.arange(0, rays_o.shape[0], 32, device=device)[: 1 << 16]
    brute = intersect_brute(teacup, rays_o[sub], rays_d[sub], tri_chunk=1024)
    k = got._replace(**{f: x[sub] for f, x in zip(got._fields, got)})
    big = lambda t: torch.where(torch.isinf(t), 1e9, t)  # noqa: E731
    t_ok = torch.isclose(big(k.t), big(brute.t), atol=1e-4, rtol=1e-5).float().mean().item()
    p_ok = (k.prim_id == brute.prim_id).float().mean().item()
    print(f"  against brute force on {sub.numel()} rays: t agrees on {t_ok:.5%}, prim ids on "
          f"{p_ok:.5%} (the rest are coincident-t ties)")
    assert t_ok >= 0.998 and p_ok >= 0.995

    phase("phase 13: the pregathered shade kernels against their twin, teacup records")
    payload, mats, lights6, sph, num_t = shade._pre_tables(teacup)
    tables = tuple(x.detach().contiguous() for x in (payload, mats, lights6, sph))
    records = []
    for label, o_, d_, lv in (("level 0", o1, d1, None), ("level 1", o2, d2, surf.valid)):
        hit, bits = b4.bounce_bvh4_cuda(teacup, tree, o_, d_, live=lv)
        records.append((o_.contiguous(), d_.contiguous(), hit.prim_id.contiguous(), bits))
        o_, d_, prim, bits = records[-1]
        got = shade.shade_pre_fwd_cuda(*tables, o_, d_, prim, bits)
        want = shade.shade_plain_pre(*tables, o_, d_, prim, bits)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **SHADE_FWD)
        print(f"  shade_pre_fwd {label}: max |d direct,ks,normal,position| {err:.3g} "
              f"({(prim >= 0).float().mean().item():.2%} of rays hit)")
        note("shade_pre_fwd_cuda", 0.0, err)
        cts = [torch.randn(o_.shape, device=device, generator=gen) for _ in range(4)]
        got = shade.shade_pre_bwd_cuda(*tables, o_, d_, prim, bits, cts)
        twin, exact64 = checks.twin_grads(tables, o_, d_, prim, bits, num_t, cts,
                                          plain=shade.shade_plain_pre)
        report = checks.shade_grads_close(got, twin, exact64, o_.shape[0],
                                          names=checks.PRE_GRAD_NAMES)
        for name, a, b in zip(checks.PRE_GRAD_NAMES, got, twin):
            err = (a - b).abs().max().item() if b.numel() else 0.0
            ratio, past = report[name]
            print(f"  shade_pre_bwd {label} {name}: max |kernel - twin| {err:.3g} (max |twin| "
                  f"{b.abs().max().item() if b.numel() else 0.0:.3g}), at most {ratio:.3g} of "
                  f"the tolerance; {past:.5%} past it before the float32 widening")
            note("shade_pre_bwd_cuda", past, err)
        assert not got[0][:, 18].any(), "the material-id column got a cotangent"
    torch.cuda.synchronize()

    phase("phase 14: the mesh main path (teacup, dragon, teacup + spheres; counts from 0)")
    ck.reset_launch_counts()
    shade.reset_launch_counts()
    b4.reset_launch_counts()
    renders = {}
    for size in (800, 1024):
        for fo in (False, True):
            cfg = RenderConfig(width=size, height=size, forward_only=fo)
            renders[("teacup", size, fo)] = (teacup, cfg, render(teacup, cam, cfg))
    for label, scene in (("dragon", dragon), ("teacup+spheres", cup_spheres)):
        for fo in ((True,) if label == "dragon" else (False, True)):
            cfg = RenderConfig(width=800, height=800, forward_only=fo)
            renders[(label, 800, fo)] = (scene, cfg, render(scene, cam, cfg))
    contracts = {"full": True, "materials": False}
    train = {c: run_bench(teacup, width=1024, height=1024, include_bwd=True, iters=5,
                          include_vertex_params=v, scene_name="teacup")
             for c, v in contracts.items()}
    cli_png = os.path.join(out, "cli_teacup.png")
    assert cli.main(["render", "--scene", "teacup", "--device", "cuda", "-o", cli_png]) == 0
    torch.cuda.synchronize()
    all_counts = {**ck.launch_counts(), **shade.launch_counts(), **b4.launch_counts()}
    print(f"  launch counts of the mesh main path {all_counts}")
    mesh_counts = {w: all_counts[w] for w in MESH_KERNELS}
    mesh_counts["intersect_bvh4_cuda"] += all_counts["occluded_bvh4_cuda"]
    for wrapper in (*MESH_KERNELS, "occluded_bvh4_cuda"):
        assert all_counts[wrapper] > 0, f"{wrapper} never launched its kernel on the main path"
    for key, (scene, cfg, img) in renders.items():
        label, size, fo = key
        what = f"{label} {size}^2 forward_only={fo}"
        assert img.shape == (size, size, 3) and bool(torch.isfinite(img).all()), what
        # The plain path on the config render() resolved (depth, route).
        cfg = resolve_fwd_shade_kernel(scene, dataclasses.replace(
            cfg, max_depth=effective_max_depth(scene, cfg)))
        plain = render_image(scene, cam, cfg, backend=make_backend(
            scene, cfg, plain=True, accel=build_accel(scene, cfg)))
        images_close(img, plain, f"{what} vs plain path ({cfg.fwd_shade_kernel=})")
        write_png(os.path.join(out, f"{label}_{size}_{'fwd_only' if fo else 'default'}.png"), img)
        lit = (img.amax(dim=-1) > 0.02).float().mean().item()
        print(f"  {what}: lit fraction {lit:.3f}, mean {img.mean().item():.4f}")
        assert lit > 0.1, what
    for size in (800, 1024):
        images_close(renders[("teacup", size, False)][2], renders[("teacup", size, True)][2],
                      f"teacup {size}^2 default route vs forward-only route")
    # An independent reference: the CPU BVH traversal (ops/bvh.py), at 64^2.
    cpu_img = render(teacup.to("cpu"), Camera.default(device="cpu"),
                     RenderConfig(width=64, height=64))
    for fo in (False, True):
        img = render(teacup, cam, RenderConfig(width=64, height=64, forward_only=fo))
        images_close(img.cpu(), cpu_img, f"teacup 64^2 forward_only={fo} vs the CPU BVH path")
    cli_img = read_image(cli_png)
    assert cli_img.shape == (800, 800, 3) and (cli_img.max(axis=-1) > 0.02).mean() > 0.1
    jitter = bench.camera_jitter(torch.Generator(device).manual_seed(9), device)
    steps = {}
    for c, v in contracts.items():
        cfg = bench.training_config(RenderConfig(width=1024, height=1024), v)
        params = bench.training_params(teacup, v)
        (lk, gk), (lp, gp) = (bench.fwd_bwd_step(teacup, cam, cfg, params, jitter, plain=plain,
                                                 accel=tree) for plain in (False, True))
        steps[c] = (cfg, params)
        print(f"  {c} contract, one teacup step: loss {lk.item():.8g} (plain path "
              f"{lp.item():.8g})")
        torch.testing.assert_close(lk, lp, rtol=1e-5, atol=1e-7)
        for name in gk:
            assert bool(torch.isfinite(gk[name]).all()), name
            tol = dict(checks.TABLE_GRAD, atol=2e-5) if name == "vertices" else checks.TABLE_GRAD
            torch.testing.assert_close(gk[name], gp[name], **tol, msg=f"{c} d/d{name}")
            print(f"    d/d{name}: max |kernel - plain| "
                  f"{(gk[name] - gp[name]).abs().max().item():.3g}, max |grad| "
                  f"{gp[name].abs().max().item():.3g}")
        for name in ("kd", "ks", "light_color", "light_position") + (("vertices",) if v else ()):
            assert gk[name].abs().sum().item() > 0, f"{c}: d/d{name} is zero"

    phase("phase 15: mesh kernel times at 1024^2 on the teacup")
    o0, d0, prim0, bits0 = records[0]
    cts = [torch.full_like(o0, 1.0 / o0.numel()) for _ in range(4)]

    def pre_bwd_plain():
        leaves = [x.detach().requires_grad_(True) for x in (*tables, o0, d0)]
        outs = shade.shade_plain_pre(*leaves, prim0, bits0)
        return torch.autograd.grad(outs, leaves, cts, allow_unused=True)

    calls = {  # wrapper: (the bare kernel launch, its plain twin)
        "intersect_bvh4_cuda": (lambda: b4._closest_kernel(tree, o1, d1, None),
                                lambda: b4._closest_plain(tree, o1, d1, None)),
        "occluded_bvh4_cuda": (lambda: b4._anyhit_kernel(tree, so, ldir, st),
                               lambda: b4._anyhit_plain(tree, so, ldir, st)),
        "bounce_bvh4_cuda": (lambda: b4._bounce_kernel(tree, lpos, o1, d1, None),
                             lambda: b4._bounce_plain(tree, lpos, o1, d1, None)),
        "shade_pre_fwd_cuda": (lambda: shade.shade_pre_fwd_cuda(*tables, o0, d0, prim0, bits0),
                               lambda: shade.shade_plain_pre(*tables, o0, d0, prim0, bits0)),
        "shade_pre_bwd_cuda": (lambda: shade.shade_pre_bwd_cuda(*tables, o0, d0, prim0, bits0,
                                                                cts),
                               pre_bwd_plain),
    }
    tb, n1, n_l = roofline.table_bytes, o1.shape[0], lpos.shape[0]
    n_hit = int((prim0 >= 0).sum())
    work = {
        "intersect_bvh4_cuda": (roofline.tree_bounce_flops(tree, lpos[:0], o1, d1)[0],
                                n1 * (24 + 16) + roofline.tree_bytes(tree)),
        "occluded_bvh4_cuda": (roofline.tree_anyhit_flops(tree, so, ldir, st),
                               n1 * (28 + 1) + roofline.tree_bytes(tree)),
        "bounce_bvh4_cuda": (roofline.tree_bounce_flops(tree, lpos, o1, d1)[0],
                             n1 * (24 + 20) + roofline.tree_bytes(tree) + tb(lpos)),
        "shade_pre_fwd_cuda": (roofline.shade_flops(n_hit, n_l), n1 * (24 + 8 + 48) + tb(*tables)),
        "shade_pre_bwd_cuda": (roofline.shade_flops(n_hit, n_l, backward=True),
                               n1 * (24 + 8 + 48 + 24) + 2 * tb(*tables)),
    }
    print("  ms = kernel time on the device (profiler); launch_ms = one bare launch between "
          "CUDA events; plain_ms = the plain twin (events); bound_ms = the least time for this "
          "work (node visits and tests counted by the twin on these rays)")
    timed = {}
    for wrapper, (kernel_fn, plain_fn) in calls.items():
        launch_ms = median(time_frames(kernel_fn, iters=20))
        device_ms = device_breakdown(kernel_fn, iters=10)["device_ms"]
        plain_ms = median(time_frames(plain_fn, iters=3, warmup=1))
        ms = device_ms if device_ms is not None else launch_ms
        b_ms, b_by = roofline.bound_ms(*work[wrapper])
        timed[wrapper] = (ms, plain_ms, launch_ms, b_ms, b_by)
        print(f"  {wrapper}: ms {ms:.5f}, launch_ms {launch_ms:.5f}, plain_ms {plain_ms:.4f} "
              f"(x{plain_ms / ms:.1f}), bound_ms {b_ms:.5f} by {b_by} ({b_ms / ms:.1%} of it); "
              f"device time {'measured' if device_ms is not None else 'not measured'}")
    for wrapper in MESH_KERNELS:
        name, source, replaces = KERNELS[wrapper]
        ms, plain_ms, launch_ms, b_ms, b_by = timed[wrapper]
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": mesh_counts[wrapper], "max_abs_err": check[wrapper]["err"],
                 "mismatch_frac": check[wrapper]["mismatch"], "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "launch_ms": launch_ms}
        if wrapper == "intersect_bvh4_cuda":
            entry.update(anyhit_ms=timed["occluded_bvh4_cuda"][0],
                         anyhit_plain_ms=timed["occluded_bvh4_cuda"][1],
                         anyhit_bound_ms=timed["occluded_bvh4_cuda"][3])
        kernels.append(entry)
    for size in (800, 1024):
        for fo in (False, True):
            route = "fwd_only" if fo else "default"
            r = run_bench(teacup, width=size, height=size, cfg_overrides={"forward_only": fo})
            cfg = RenderConfig(width=size, height=size, forward_only=fo)
            prof = device_breakdown(lambda: render(teacup, cam, cfg, accel=tree))
            e2e[f"teacup_{size}_{route}"] = {"ms": r["seconds_per_frame"] * 1e3,
                                             "rays_per_s": r["value"], "profile": prof}
            busy = f"{prof['busy']:.3f}" if prof["busy"] is not None else "not measured"
            print(f"  render teacup {size}^2 {route}: {r['seconds_per_frame'] * 1e3:.5f} "
                  f"ms/frame (CUDA events), {r['value']:.6g} primary rays/s; profiled wall "
                  f"{prof['wall_ms']:.4f} ms, device busy {busy}")
            for kname, kms, n in prof["kernels"][:5]:
                print(f"    {kms:.5f} ms x{n:g}  {kname[:90]}")
    r = run_bench(dragon, width=800, height=800, cfg_overrides={"forward_only": True})
    e2e["dragon_800_fwd_only"] = {"ms": r["seconds_per_frame"] * 1e3, "rays_per_s": r["value"]}
    print(f"  render dragon 800^2 fwd_only: {r['seconds_per_frame'] * 1e3:.5f} ms/frame, "
          f"{r['value']:.6g} primary rays/s")
    for c, (cfg, params) in steps.items():
        prof = device_breakdown(lambda: bench.fwd_bwd_step(teacup, cam, cfg, params, jitter,
                                                           accel=tree), iters=3)
        plain_ms = median(time_frames(lambda: bench.fwd_bwd_step(teacup, cam, cfg, params, jitter,
                                                                 plain=True, accel=tree),
                                      iters=2, warmup=1))
        r = train[c]
        busy = f"{prof['busy']:.3f}" if prof["busy"] is not None else "not measured"
        e2e[f"teacup_1024_train_{c}"] = {"ms": r["seconds_per_frame"] * 1e3,
                                         "rays_per_s": r["value"], "plain_ms": plain_ms,
                                         "profile": prof}
        print(f"  train teacup {c} contract 1024^2: {r['seconds_per_frame'] * 1e3:.5f} ms/step "
              f"(CUDA events), {r['value']:.6g} primary rays/s fwd+bwd; plain path "
              f"{plain_ms:.3f} ms/step; profiled wall {prof['wall_ms']:.4f} ms, busy {busy}")
        for kname, kms, n in prof["kernels"][:6]:
            print(f"    {kms:.5f} ms x{n:g}  {kname[:90]}")
    # The leaf size: the card's auto 4 against the JAX package's TPU auto 56.
    leaf = {}
    for max_leaf in (4, 56):
        t0 = time.perf_counter()
        tree_l = b4.build_bvh4(teacup, max_leaf=max_leaf, builder="sah")[1]
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        cfg = RenderConfig(width=1024, height=1024, bvh_max_leaf=max_leaf)
        bounce_ms = median(time_frames(lambda: b4._bounce_kernel(tree_l, lpos, o1, d1, None),
                                       iters=20))
        frame_ms = median(time_frames(lambda: render(teacup, cam, cfg, accel=tree_l), iters=5))
        leaf[max_leaf] = {"build_s": build_s, "bounce_ms": bounce_ms, "frame_ms": frame_ms,
                          "nodes": tree_l.num_nodes}
        print(f"  leaf {max_leaf}: build {build_s:.3f} s, {tree_l.num_nodes} nodes, bounce "
              f"kernel {bounce_ms:.5f} ms (events), default-route frame {frame_ms:.4f} ms")
    results["leaf_ab"] = leaf
    return mesh_counts


def soft_phases(out, device, check, note, kernels, e2e, results, scenes) -> dict:
    """Phases 16-18: the soft-shadow slice on the spherical stand-ins (the
    box through the brute sampler, the teacup through the cone sampler).
    Returns the new kernels' launch counts from the main path (phase 17)."""
    import torch

    from cg_raytracer_tpu_torch import cli
    from cg_raytracer_tpu_torch.models.whitted import (build_accel, make_backend, render,
                                                       render_image)
    from cg_raytracer_tpu_torch.ops import bvh4 as b4
    from cg_raytracer_tpu_torch.ops import cuda_kernels as ck
    from cg_raytracer_tpu_torch.ops import shade, soft
    from cg_raytracer_tpu_torch.ops.camera import generate_rays
    from cg_raytracer_tpu_torch.scene.presets import load_standin
    from cg_raytracer_tpu_torch.scene.types import Camera
    from cg_raytracer_tpu_torch.utils import bench, checks, roofline
    from cg_raytracer_tpu_torch.utils.bench import median, run_bench, time_frames
    from cg_raytracer_tpu_torch.utils.config import RenderConfig
    from cg_raytracer_tpu_torch.utils.image import read_image, write_png
    from cg_raytracer_tpu_torch.utils.profiling import device_breakdown

    cam = Camera.default(device=device)
    gen = torch.Generator(device).manual_seed(16)
    num = RenderConfig().soft_shadow_samples  # 200, the reference's count
    # A batch that does not start at point 0, as a later ray chunk's.
    key = soft.SampleKey(2026, 16).at(SOFT_KEY_OFFSET)

    phase("phase 16: the soft-shadow kernels against their twins, spherical box and teacup 1024^2")
    box = load_standin("spherical_box", device)
    cup = load_standin("spherical_teacup", device)
    t0 = time.perf_counter()
    accel = build_accel(cup, RenderConfig())
    torch.cuda.synchronize()
    results["soft_accel_build_s"] = time.perf_counter() - t0
    tree = accel
    print(f"  spherical teacup: tree built in {results['soft_accel_build_s']:.3f} s; the walks "
          f"and the cone sampler share it: width {tree.width}, {tree.num_nodes} nodes")
    o1, d1 = generate_rays(cam, 1024, 1024)
    frames = {}
    for label, scene, hit in (("box", box, ck.intersect_cuda(box, o1, d1)),
                              ("teacup", cup, b4.intersect_bvh4_cuda(cup, tree, o1, d1))):
        valid = hit.prim_id >= 0
        pos = torch.where(valid[:, None], o1 + d1 * torch.where(valid, hit.t, 0.0)[:, None], 0.0)
        light = soft.light_row(scene.spherical_lights.position[0],
                               scene.spherical_lights.radius[0])
        frames[label] = (scene, pos.contiguous(), valid, light, hit.prim_id.contiguous())
    tri = ck._tri_table(box).detach()
    # label: the wrappers the backend calls and their twins, each with the
    # scene (and tree) bound: (prng, prng twin, table, table twin), then the
    # bare launch that phase 18 times.
    sampler = {
        "box": (*(partial(f, box) for f in (soft.soft_prng_cuda, soft.soft_prng_plain,
                                            soft.soft_table_cuda, soft.soft_table_plain)),
                lambda *a: soft._brute_kernel(tri, *a)),
        "teacup": (*(partial(f, cup, tree) for f in (soft.soft4_prng_cuda, soft.soft4_prng_plain,
                                                     soft.soft4_table_cuda,
                                                     soft.soft4_table_plain)),
                   lambda *a: soft._tree_kernel(tree, *a)),
    }
    wrapper_names = {"box": ("soft_prng_cuda", "soft_table_cuda"),
                     "teacup": ("soft4_prng_cuda", "soft4_table_cuda")}
    subsample, work = {}, {}
    for label, (scene, pos, valid, light, _) in frames.items():
        prng, prng_plain, table, table_plain, _ = sampler[label]
        prng_w, table_w = wrapper_names[label]
        lights = (scene.spherical_lights.position[0], scene.spherical_lights.radius[0])
        rows = torch.nonzero(valid).squeeze(1)
        pick = rows[torch.linspace(0, rows.numel() - 1, SOFT_SUB, device=device).long()]
        p_sub = pos[pick].contiguous()
        v_sub = torch.arange(SOFT_SUB, device=device) % 8 != 0  # every eighth point unmarked
        g = torch.randn((num, SOFT_SUB, 3), device=device, generator=gen)
        subsample[label] = (p_sub, g)
        got_t, want_t = (f(p_sub, *lights, g, valid=v_sub) for f in (table, table_plain))
        got_p, want_p = (f(p_sub, *lights, key, num, valid=v_sub) for f in (prng, prng_plain))
        torch.cuda.synchronize()
        table_exact = torch.equal(got_t, want_t)
        agree = (got_p == want_p).float().mean().item()
        diff = (got_p - want_p).abs().max().item()
        print(f"  {label} table kernel vs twin, {SOFT_SUB} hit points x {num} samples, one in "
              f"eight unmarked: {'exact' if table_exact else 'DIFFER'}; PRNG kernel vs twin on the "
              f"same Philox stream (first point {SOFT_KEY_OFFSET}): counts equal on {agree:.5%} "
              f"of points, max |diff| {diff:g}")
        assert table_exact, f"{label}: the table kernel differs from its twin"
        assert agree == 1.0, f"{label}: PRNG kernel vs twin {agree:.4%}"
        assert not (got_t[~v_sub].any() or got_p[~v_sub].any()), f"{label}: unmarked points count"
        note(table_w, 0.0, 0.0)
        note(prng_w, 1.0 - agree, diff)
        # This run's work per sample ray, on the subsample's marked points.
        marked = torch.nonzero(v_sub).squeeze(1)
        so, sd, tm = soft.sample_rays(p_sub[marked][:, None], soft.philox_gauss(
            key, marked, torch.arange(num, device=device)), light)
        so, sd, tm = so.reshape(-1, 3), sd.reshape(-1, 3), tm.reshape(-1)
        if label == "box":
            tests = roofline.anyhit_tests(tri, so, sd, tm).double().mean().item()
            work[label] = tests * (roofline.MT_FLOPS + roofline.ANYHIT_UPDATE)
            what = f"{tests:.3f} triangle tests"
        else:
            work[label] = roofline.tree_anyhit_flops(tree, so, sd, tm) / tm.numel()
            what = f"{work[label]:.1f} operations of node visits and triangle tests"
        print(f"  {label}: a sample ray of this frame makes {what} (twin's count on the subsample)")
    curand = checks.philox_matches_curand(device, n=4096)
    print(f"  Philox4x32-10 words of the twin equal curand_Philox4x32_10 on {curand:.2%} of 4096 "
          f"random (counter, key) pairs")
    assert curand == 1.0
    bad = checks.sincos_mismatches(device)
    print(f"  soft.cu's sincosf against sinf and cosf on all 2^24 angles its Box-Muller takes: "
          f"{bad} differ in any bit")
    assert bad == 0, "sincosf is not bit-equal to sinf and cosf on the card"
    fracs, full = {}, {}
    for label, (scene, pos, valid, light, prim) in frames.items():
        full[label] = sampler[label][0](pos, scene.spherical_lights.position[0],
                                        scene.spherical_lights.radius[0], key, num, valid=valid)
        fr = full[label] / num
        pen = (valid & (fr > 0) & (fr < 1)).float().sum().item() / valid.sum().item()
        lit = (valid & (fr > 0)).float().sum().item() / valid.sum().item()
        print(f"  {label} 1024^2 level 0: {valid.float().mean().item():.2%} of rays hit; of the "
              f"hit points {lit:.2%} see the light, {pen:.2%} in penumbra (0 < fraction < 1)")
        assert pen > 0.001 and lit > 0.1, label
        fracs[label] = fr[None].contiguous()
    # The shade kernels with spherical fractions, on level 0's records.
    for label, (scene, pos, valid, light, prim) in frames.items():
        bits = torch.zeros_like(prim)
        sph, fr = shade._sph_table(scene).detach().contiguous(), fracs[label]
        cts = [torch.randn(o1.shape, device=device, generator=gen) for _ in range(4)]
        if label == "box":
            tables = tuple(x.detach() for x in shade._shade_tables(scene)[:4])
            got = shade.shade_fwd_cuda(*tables, o1, d1, prim, bits, scene.num_triangles, sph, fr)
            want = shade.shade_plain(*tables, o1, d1, prim, bits, num_tris=scene.num_triangles,
                                     sph=sph, fracs=fr)
            grads = shade.shade_bwd_cuda(*tables, o1, d1, prim, bits, scene.num_triangles, cts,
                                         sph, fr)
            twin, exact = checks.twin_grads(tables, o1, d1, prim, bits, scene.num_triangles, cts,
                                            sph=sph, fracs=fr)
            names, fwd_w, bwd_w = checks.GRAD_NAMES, "shade_fwd_cuda", "shade_bwd_cuda"
        else:
            tables = tuple(x.detach().contiguous() for x in shade._pre_tables(scene)[:4])
            got = shade.shade_pre_fwd_cuda(*tables, o1, d1, prim, bits, sph, fr)
            want = shade.shade_plain_pre(*tables, o1, d1, prim, bits, sph=sph, fracs=fr)
            grads = shade.shade_pre_bwd_cuda(*tables, o1, d1, prim, bits, cts, sph, fr)
            twin, exact = checks.twin_grads(tables, o1, d1, prim, bits, scene.num_triangles, cts,
                                            plain=shade.shade_plain_pre, sph=sph, fracs=fr)
            names, fwd_w, bwd_w = checks.PRE_GRAD_NAMES, "shade_pre_fwd_cuda", "shade_pre_bwd_cuda"
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **SHADE_FWD)
        note(fwd_w, 0.0, err)
        report = checks.shade_grads_close(grads, twin, exact, o1.shape[0], names=names)
        d_sph = (grads[-1] - twin[-1]).abs().max().item()
        print(f"  {fwd_w} with the recorded fractions, {label}: max |d direct,ks,normal,position| "
              f"{err:.3g}; {bwd_w}: d_sph max |kernel - twin| {d_sph:.3g} (max |twin| "
              f"{twin[-1].abs().max().item():.3g}), every cotangent within "
              f"{max(r for r, _ in report.values()):.3g} of its tolerance")
        assert twin[-1].abs().sum().item() > 0
        note(bwd_w, max(p for _, p in report.values()), d_sph)
    torch.cuda.synchronize()

    phase("phase 17: the soft-shadow main path (spherical box and teacup; counts from 0)")
    for module in (ck, shade, b4, soft):
        module.reset_launch_counts()
    spherical = {"spherical_box": (box, None), "spherical_teacup": (cup, accel)}
    renders = {}
    for label, (scene, acc) in spherical.items():
        for size in (800, 1024):
            for fo in (False, True):
                cfg = RenderConfig(width=size, height=size, forward_only=fo)
                renders[(label, size, fo)] = render(scene, cam, cfg, accel=acc)
    contracts = {"full": True, "materials": False}
    train = {(label, c): run_bench(scene, width=1024, height=1024, include_bwd=True, iters=3,
                                   include_vertex_params=v, scene_name=f"stand-in {label}")
             for label, (scene, _) in spherical.items() for c, v in contracts.items()}
    cli_png = os.path.join(out, "cli_spherical_teacup.png")
    assert cli.main(["render", "--scene", "teacup", "--device", "cuda", "--remove-light", "0",
                     "--add-spherical-light", "-1", "1", "-1", "0.1", "1", "1", "1",
                     "--spp", str(num), "-o", cli_png]) == 0
    torch.cuda.synchronize()
    counts = {**ck.launch_counts(), **shade.launch_counts(), **b4.launch_counts(),
              **soft.launch_counts()}
    print(f"  launch counts of the soft-shadow main path {counts}")
    for wrapper in ("soft_prng_cuda", "soft4_prng_cuda", "shade_fwd_cuda", "shade_bwd_cuda",
                    "shade_pre_fwd_cuda", "shade_pre_bwd_cuda"):
        assert counts[wrapper] > 0, f"{wrapper} never launched its kernel on the main path"
    assert counts["occluded_cuda"] == counts["occluded_bvh4_cuda"] == 0, (
        "the card ran the scan over the any-hit oracle for a scene the samplers support")
    for (label, size, fo), img in renders.items():
        what = f"{label} {size}^2 forward_only={fo}"
        assert img.shape == (size, size, 3) and bool(torch.isfinite(img).all()), what
        lit = (img.amax(dim=-1) > 0.02).float().mean().item()
        print(f"  {what}: lit fraction {lit:.3f}, mean {img.mean().item():.4f}")
        assert lit > 0.1, what
        write_png(os.path.join(out, f"{label}_{size}_{'fwd_only' if fo else 'default'}.png"), img)
    cli_img = read_image(cli_png)
    assert cli_img.shape == (800, 800, 3) and (cli_img.max(axis=-1) > 0.02).mean() > 0.1
    # Against the plain path at 256^2: the same samples (a generator seeded 0).
    cfg256 = RenderConfig(width=256, height=256)
    for label, (scene, acc) in spherical.items():
        img = render(scene, cam, cfg256, accel=acc)
        plain = render_image(scene, cam, cfg256, generator=torch.Generator().manual_seed(0),
                             backend=make_backend(scene, cfg256, plain=True, accel=acc))
        images_close(img, plain, f"{label} 256^2 vs plain path")
    jitter = bench.camera_jitter(torch.Generator(device).manual_seed(9), device)
    steps = {}
    for label, (scene, acc) in spherical.items():
        for c, v in contracts.items():
            cfg = bench.training_config(RenderConfig(width=256, height=256), v)
            params = bench.training_params(scene, v)
            (lk, gk), (lp, gp) = (bench.fwd_bwd_step(
                scene, cam, cfg, params, jitter, plain=plain, accel=acc,
                generator=torch.Generator().manual_seed(4)) for plain in (False, True))
            print(f"  {label} {c} contract, one 256^2 step: loss {lk.item():.8g} (plain path "
                  f"{lp.item():.8g})")
            torch.testing.assert_close(lk, lp, rtol=1e-5, atol=1e-7)
            for name in gk:
                assert bool(torch.isfinite(gk[name]).all()), name
                tol = (dict(checks.TABLE_GRAD, atol=2e-5) if name == "vertices"
                       else checks.TABLE_GRAD)
                torch.testing.assert_close(gk[name], gp[name], **tol, msg=f"{label} {c} d/d{name}")
                print(f"    d/d{name}: max |kernel - plain| "
                      f"{(gk[name] - gp[name]).abs().max().item():.3g}, max |grad| "
                      f"{gp[name].abs().max().item():.3g}")
            steps[(label, c)] = (bench.training_config(RenderConfig(width=1024, height=1024), v),
                                 params)

    phase("phase 18: soft-shadow kernel times at 1024^2, frames, steps and the soft tree")
    print("  ms = one bare launch between CUDA events (median of 20: each runs 0.1-20 ms, so the "
          "launch's own microseconds do not count); plain_ms = the twin (events, one run); the "
          f"PRNG kernels on the frame's hit points, the table kernels on the {SOFT_SUB}-point "
          "subsample")
    for label, (scene, pos, valid, light, _) in frames.items():
        prng_plain, table_plain, bare = sampler[label][1], sampler[label][3], sampler[label][4]
        lights = (scene.spherical_lights.position[0], scene.spherical_lights.radius[0])
        v8 = valid.to(torch.uint8).contiguous()
        n_valid = int(valid.sum())
        scene_bytes = roofline.table_bytes(tri) if label == "box" else roofline.tree_bytes(tree)
        p_sub, g = subsample[label]
        g_nsc = g.permute(1, 0, 2).contiguous()
        for wrapper, kernel_fn, plain_fn, points, flops, int_ops, bytes_ in (
                (wrapper_names[label][0], lambda: bare(pos, light, num, v8, key),
                 lambda: prng_plain(pos, *lights, key, num, valid=valid), n_valid,
                 n_valid * num * (roofline.SAMPLE_FLOPS + work[label]),
                 n_valid * num * roofline.PHILOX_INT_OPS,
                 pos.shape[0] * (12 + 1 + 4) + 16 + scene_bytes),
                (wrapper_names[label][1], lambda: bare(p_sub, light, num, None, None, g_nsc),
                 lambda: table_plain(p_sub, *lights, g), SOFT_SUB,
                 SOFT_SUB * num * (roofline.SAMPLE_FLOPS - 25 + work[label]), 0,
                 SOFT_SUB * (12 + 4 + 12 * num) + 16 + scene_bytes)):
            ms = median(time_frames(kernel_fn, iters=20, warmup=1))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            want = plain_fn()
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
            name, source, replaces = KERNELS[wrapper]
            if wrapper == wrapper_names[label][0]:
                # The wrapper's counts on the whole frame (phase 16), the hit
                # mask and the key's offset included, against the twin's.
                exact = torch.equal(full[label], want)
                diff = (full[label] - want).abs().max().item()
                print(f"  {name} ({label}): the wrapper's counts on all {pos.shape[0]} points "
                      f"({n_valid} hit) {'equal' if exact else 'DIFFER from'} the twin's, max "
                      f"|diff| {diff:g}")
                assert exact, f"{label}: the PRNG sampler differs from its twin on the frame"
                note(wrapper, 0.0, diff)
            b_ms, b_by = roofline.bound_ms(flops, bytes_, int_ops)
            print(f"  {name} ({label}, {points} points x {num} samples): ms {ms:.5f}, plain_ms "
                  f"{plain_ms:.3f} (x{plain_ms / ms:.1f}), bound_ms {b_ms:.5f} by {b_by} "
                  f"({b_ms / ms:.1%} of it); {points * num / ms / 1e6:.4g} G sample rays/s")
            kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                            "launches": counts[wrapper], "max_abs_err": check[wrapper]["err"],
                            "mismatch_frac": check[wrapper]["mismatch"], "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": None, "points": points, "samples": num})
    for label, (scene, acc) in spherical.items():
        r = run_bench(scene, width=1024, height=1024, scene_name=f"stand-in {label}", iters=5)
        cfg = RenderConfig(width=1024, height=1024)
        prof = device_breakdown(lambda: render(scene, cam, cfg, accel=acc), iters=3)
        busy = f"{prof['busy']:.3f}" if prof["busy"] is not None else "not measured"
        e2e[f"{label}_1024_default"] = {"ms": r["seconds_per_frame"] * 1e3,
                                        "rays_per_s": r["value"], "profile": prof}
        print(f"  render {label} 1024^2: {r['seconds_per_frame'] * 1e3:.5f} ms/frame (CUDA "
              f"events), {r['value']:.6g} primary rays/s; profiled wall {prof['wall_ms']:.4f} ms, "
              f"device busy {busy}")
        for kname, kms, n in prof["kernels"][:5]:
            print(f"    {kms:.5f} ms x{n:g}  {kname[:90]}")
        for c in contracts:
            cfg, params = steps[(label, c)]
            prof = device_breakdown(lambda: bench.fwd_bwd_step(
                scene, cam, cfg, params, jitter, accel=acc,
                generator=torch.Generator().manual_seed(5)), iters=2)
            r = train[(label, c)]
            busy = f"{prof['busy']:.3f}" if prof["busy"] is not None else "not measured"
            e2e[f"{label}_1024_train_{c}"] = {"ms": r["seconds_per_frame"] * 1e3,
                                              "rays_per_s": r["value"], "profile": prof}
            print(f"  train {label} {c} contract 1024^2: {r['seconds_per_frame'] * 1e3:.5f} "
                  f"ms/step (CUDA events), {r['value']:.6g} primary rays/s fwd+bwd; profiled "
                  f"wall {prof['wall_ms']:.4f} ms, device busy {busy}")
            for kname, kms, n in prof["kernels"][:5]:
                print(f"    {kms:.5f} ms x{n:g}  {kname[:90]}")
    # The soft tree: the scene's one tree (SAH, leaf 4; the port's auto)
    # against the JAX package's soft-tree auto (median, leaf 14), on the
    # teacup's frame.
    _, pos, valid, light, _ = frames["teacup"]
    v8 = valid.to(torch.uint8).contiguous()
    soft_trees = {}
    for leaf, builder in ((4, "sah"), (14, "median")):
        t0 = time.perf_counter()
        tr = tree if (leaf, builder) == (4, "sah") else b4.build_bvh4(cup, max_leaf=leaf,
                                                                     builder=builder)[1]
        build_s = time.perf_counter() - t0
        cnt = soft._tree_kernel(tr, pos, light, num, v8, key)
        ms = median(time_frames(lambda: soft._tree_kernel(tr, pos, light, num, v8, key), iters=5))
        soft_trees[f"{builder}{leaf}"] = {"ms": ms, "nodes": tr.num_nodes, "build_s": build_s,
                                          "counts": cnt}
        print(f"  cone sampler over the {builder} leaf-{leaf} tree ({tr.num_nodes} nodes, built "
              f"in {build_s:.3f} s): {ms:.5f} ms (events)")
    same = (soft_trees["sah4"]["counts"] == soft_trees["median14"]["counts"]).float().mean().item()
    print(f"  the two trees' counts agree on {same:.5%} of points (the rest are ties)")
    assert same >= 0.995
    results["soft_tree_ab"] = {k: {kk: vv for kk, vv in v.items() if kk != "counts"}
                               for k, v in soft_trees.items()}
    scenes.update(spherical_box=box, spherical_teacup=(cup, accel),
                  soft=dict(frames=frames, subsample=subsample, full=full, key=key, num=num,
                            work=work))
    return {w: counts[w] for w in SOFT_KERNELS}


def torus_scene(device, grid: int = TORUS_GRID):
    """The donut's torus, material and light on a grid x grid surface grid
    (2 grid^2 triangles): a tree past the card's L2.  Not a preset."""
    import numpy as np

    from cg_raytracer_tpu_torch.scene.loader import center_and_scale_to_unit
    from cg_raytracer_tpu_torch.scene.presets import _grid_mesh
    from cg_raytracer_tpu_torch.scene.types import PointLights, make_scene

    def surface(uu, vv):
        th, ph = 2 * np.pi * uu, 2 * np.pi * vv
        return ((1.0 + 0.4 * np.cos(ph)) * np.cos(th), 0.4 * np.sin(ph),
                (1.0 + 0.4 * np.cos(ph)) * np.sin(th))

    mesh = _grid_mesh(surface, grid, grid, wrap_u=True, wrap_v=True,
                      material={"kd": (0.9, 0.6, 0.3), "ks": (0.0, 0.0, 0.0), "shininess": 1.0,
                                "transparency": 1.0})
    center_and_scale_to_unit([mesh])
    return make_scene([mesh], point_lights=PointLights.of(((-1, 1, -1), (1.0, 1.0, 1.0))),
                      device=device)


# Phase 23's graphed donut frames in a fresh process: run_bench's frame
# time and device_breakdown's profile of render() at each size, as JSON.
DONUT_FRAMES_SNIPPET = """
import json, sys
sys.path.insert(0, ".")
from cg_raytracer_tpu_torch.models.whitted import build_accel, render
from cg_raytracer_tpu_torch.scene.presets import load_scene
from cg_raytracer_tpu_torch.scene.types import Camera
from cg_raytracer_tpu_torch.utils.bench import run_bench
from cg_raytracer_tpu_torch.utils.config import RenderConfig
from cg_raytracer_tpu_torch.utils.profiling import device_breakdown
donut, cam, out = load_scene("donut", device="cuda"), Camera.default(device="cuda"), {}
tree = build_accel(donut, RenderConfig())
for size, fo in ((800, False), (1024, False), (1024, True)):
    r = run_bench(donut, width=size, height=size, cfg_overrides={"forward_only": fo})
    cfg = RenderConfig(width=size, height=size, forward_only=fo)
    prof = device_breakdown(lambda: render(donut, cam, cfg, accel=tree), iters=3)
    out[f"{size}_{'fwd_only' if fo else 'default'}"] = {
        "bench": {k: r[k] for k in ("seconds_per_frame", "value")}, "profile": prof}
print(json.dumps(out))
"""


def scale_phases(out, device, check, note, kernels, e2e, results, scenes) -> dict:
    """Phases 19-23: the scale slice (the donut, a torus past L2) and
    ``optimize()`` with the refit.  Returns the large tier's launch counts
    from the donut main path (phase 21)."""
    import numpy as np
    import torch

    from cg_raytracer_tpu_torch import cli
    from cg_raytracer_tpu_torch.models.whitted import (build_accel, effective_max_depth,
                                                       make_backend, render, render_image,
                                                       resolve_fwd_shade_kernel)
    from cg_raytracer_tpu_torch.ops import bvh4 as b4
    from cg_raytracer_tpu_torch.ops import cuda_kernels as ck
    from cg_raytracer_tpu_torch.ops import refit, shade, soft
    from cg_raytracer_tpu_torch.ops.camera import generate_rays
    from cg_raytracer_tpu_torch.ops.intersect import reconstruct_hit
    from cg_raytracer_tpu_torch.ops.linalg import norm, safe_normalize
    from cg_raytracer_tpu_torch.optim import inverse
    from cg_raytracer_tpu_torch.scene.presets import load_scene, load_standin
    from cg_raytracer_tpu_torch.scene.types import Camera
    from cg_raytracer_tpu_torch.utils import bench, checks, roofline
    from cg_raytracer_tpu_torch.utils.bench import median, run_bench, time_frames
    from cg_raytracer_tpu_torch.utils.config import RenderConfig
    from cg_raytracer_tpu_torch.utils.image import read_image, write_png
    from cg_raytracer_tpu_torch.utils.profiling import device_breakdown

    cam = Camera.default(device=device)
    gen = torch.Generator(device).manual_seed(19)
    big = lambda t: torch.where(torch.isinf(t), 1e9, t)  # noqa: E731

    phase("phase 19: large-tier builds on the host (the auto past 200,000 triangles)")
    donut = load_scene("donut", device=device)
    cfg0 = RenderConfig()
    builder = cfg0.resolve_bvh_builder(donut.num_triangles, device)
    leaf = cfg0.resolve_bvh_max_leaf()
    t0 = time.perf_counter()
    tree = build_accel(donut, cfg0)
    torch.cuda.synchronize()
    donut_s = time.perf_counter() - t0
    assert isinstance(tree, b4.BVH4) and builder == "median", (type(tree), builder)
    t0 = time.perf_counter()
    torus = torus_scene(device)
    make_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tbvh, ttree = b4.build_bvh4(torus, max_leaf=leaf, builder=builder)
    torch.cuda.synchronize()
    torus_s = time.perf_counter() - t0
    builds = {}
    for label, scene, tr, secs in (("donut", donut, tree, donut_s), ("torus", torus, ttree, torus_s)):
        nbytes = roofline.tree_bytes(tr)
        builds[label] = {"triangles": scene.num_triangles, "builder": builder, "leaf": leaf,
                         "nodes": tr.num_nodes, "depth": tr.depth, "bytes": nbytes,
                         "build_s": secs, "stack_entries": 3 * tr.depth + 1}
        print(f"  {label}: {scene.num_triangles} triangles, {builder} leaf {leaf}: {tr.num_nodes} "
              f"4-wide nodes, {tr.depth} levels (a walk holds at most {3 * tr.depth + 1} of "
              f"{b4.MAX_STACK} stack entries), {nbytes} bytes ({nbytes / L2_BYTES:.3f}x the L2), "
              f"built in {secs:.3f} s")
    print(f"  (the torus's mesh made in {make_s:.3f} s)")
    assert torus.num_triangles >= 1_280_000 and builds["torus"]["bytes"] > L2_BYTES
    results["scale_builds"] = builds

    phase("phase 20: the 4-wide kernels on the large tier against their twins, exactly")
    o1, d1 = generate_rays(cam, 1024, 1024)

    def against_twins(label, scene, tr, o, d):
        exact = {}
        got, want = b4._closest_kernel(tr, o, d, None), b4._closest_plain(tr, o, d, None)
        exact["closest"] = all(torch.equal(a, b) for a, b in zip(got, want))
        surf = reconstruct_hit(scene, o, d, got)
        to_light = scene.point_lights.position[0] - surf.position
        ldir = safe_normalize(to_light).contiguous()
        so = (surf.position + 1e-3 * ldir).contiguous()
        st = torch.where(surf.valid, norm(to_light) - 1e-3, -1.0)
        st = (st * torch.rand(st.shape, device=device, generator=gen) * 1.5).contiguous()
        got_a, want_a = b4._anyhit_kernel(tr, so, ldir, st), b4._anyhit_plain(tr, so, ldir, st)
        exact["anyhit"] = torch.equal(got_a, want_a)
        live = torch.arange(o.shape[0], device=device) % 5 != 0
        tml = torch.where(live, float("inf"), -1.0).contiguous()
        lp = scene.point_lights.position.contiguous()
        (gh, gb), (wh, wb) = (b4._bounce_kernel(tr, lp, o, d, tml),
                              b4._bounce_plain(tr, lp, o, d, tml))
        exact["bounce"] = all(torch.equal(a, b) for a, b in zip(gh, wh)) and torch.equal(gb, wb)
        print(f"  {label}: t, prim, u, v and bits equal to the twins' {exact} "
              f"({(got.prim_id >= 0).float().mean().item():.2%} of {o.shape[0]} rays hit, "
              f"{want_a.float().mean().item():.2%} of the shadow rays occluded, "
              f"{(gb > 0).float().mean().item():.2%} of the bounce rays shadowed)")
        assert all(exact.values()), (label, exact)
        return so, ldir, st

    shadow = against_twins("donut, 1024^2 primary rays", donut, tree, o1, d1)
    sub = torch.arange(0, o1.shape[0], 16, device=device)
    against_twins("torus, every 16th ray of the 1024^2 frame", torus, ttree,
                  o1[sub].contiguous(), d1[sub].contiguous())
    for wrapper in SCALE_KERNELS:
        note(wrapper, 0.0, 0.0)
    torch.cuda.synchronize()

    phase("phase 21: the donut main path (counts from 0)")
    for module in (ck, shade, b4, soft):
        module.reset_launch_counts()
    renders = {}
    for size in (800, 1024):
        for fo in (False, True):
            cfg = RenderConfig(width=size, height=size, forward_only=fo)
            renders[("donut", size, fo)] = (donut, cfg, render(donut, cam, cfg))
    donut_spheres = dataclasses.replace(donut, spheres=two_spheres(device))
    scenes.update(donut=donut, donut_spheres=donut_spheres, torus=(torus, tbvh, ttree))
    cfg = RenderConfig(width=800, height=800)
    renders[("donut+spheres", 800, False)] = (donut_spheres, cfg, render(donut_spheres, cam, cfg))
    contracts = {"full": True, "materials": False}
    train = {c: run_bench(donut, width=1024, height=1024, include_bwd=True, iters=3,
                          include_vertex_params=v, scene_name="donut")
             for c, v in contracts.items()}
    cli_png = os.path.join(out, "cli_donut.png")
    assert cli.main(["render", "--scene", "donut", "--device", "cuda", "-o", cli_png]) == 0
    sph_png = os.path.join(out, "cli_spherical_donut.png")
    assert cli.main(["render", "--scene", "donut", "--device", "cuda", "--remove-light", "0",
                     "--add-spherical-light", "-1", "1", "-1", "0.1", "1", "1", "1",
                     "-o", sph_png]) == 0
    torch.cuda.synchronize()
    counts = {**ck.launch_counts(), **shade.launch_counts(), **b4.launch_counts(),
              **soft.launch_counts()}
    print(f"  launch counts of the donut main path {counts}")
    for wrapper in ("intersect_bvh4_cuda", "occluded_bvh4_cuda", "bounce_bvh4_cuda",
                    "shade_pre_fwd_cuda", "shade_pre_bwd_cuda"):
        assert counts[wrapper] > 0, f"{wrapper} never launched its kernel on the main path"
    assert counts["soft4_prng_cuda"] == 0, "a sampler ran past 200,000 triangles"
    scale_counts = {"intersect_bvh4_cuda:large": (counts["intersect_bvh4_cuda"]
                                                  + counts["occluded_bvh4_cuda"]),
                    "bounce_bvh4_cuda:large": counts["bounce_bvh4_cuda"]}
    for (label, size, fo), (scene, cfg, img) in renders.items():
        what = f"{label} {size}^2 forward_only={fo}"
        assert img.shape == (size, size, 3) and bool(torch.isfinite(img).all()), what
        cfg = resolve_fwd_shade_kernel(scene, dataclasses.replace(
            cfg, max_depth=effective_max_depth(scene, cfg)))
        plain = render_image(scene, cam, cfg, backend=make_backend(
            scene, cfg, plain=True, accel=build_accel(scene, cfg)))
        images_close(img, plain, f"{what} vs plain path (depth {cfg.max_depth})")
        write_png(os.path.join(out, f"{label}_{size}_{'fwd_only' if fo else 'default'}.png"), img)
        lit = (img.amax(dim=-1) > 0.02).float().mean().item()
        print(f"  {what}: lit fraction {lit:.3f}, mean {img.mean().item():.4f}")
        assert lit > 0.1, what
    for png in (cli_png, sph_png):
        img = read_image(png)
        assert img.shape == (800, 800, 3) and (img.max(axis=-1) > 0.02).mean() > 0.1, png
    jitter = bench.camera_jitter(torch.Generator(device).manual_seed(9), device)
    steps = {}
    for c, v in contracts.items():
        cfg = RenderConfig(width=1024, height=1024)
        cfg = bench.training_config(dataclasses.replace(  # depth 1, as run_bench resolves it
            cfg, max_depth=effective_max_depth(donut, cfg)), v)
        params = bench.training_params(donut, v)
        (lk, gk), (lp, gp) = (bench.fwd_bwd_step(donut, cam, cfg, params, jitter, plain=plain,
                                                 accel=tree) for plain in (False, True))
        steps[c] = (cfg, params)
        print(f"  {c} contract, one donut step: loss {lk.item():.8g} (plain path {lp.item():.8g})")
        torch.testing.assert_close(lk, lp, rtol=1e-5, atol=1e-7)
        for name in gk:
            assert bool(torch.isfinite(gk[name]).all()), name
            tol = dict(checks.TABLE_GRAD, atol=2e-5) if name == "vertices" else checks.TABLE_GRAD
            torch.testing.assert_close(gk[name], gp[name], **tol, msg=f"{c} d/d{name}")
            print(f"    d/d{name}: max |kernel - plain| "
                  f"{(gk[name] - gp[name]).abs().max().item():.3g}, max |grad| "
                  f"{gp[name].abs().max().item():.3g}")
        for name in ("kd", "light_color", "light_position") + (("vertices",) if v else ()):
            assert gk[name].abs().sum().item() > 0, f"{c}: d/d{name} is zero"

    phase("phase 22: optimize() on the card: vertex steps, the tree refit in every step")
    teacup = load_scene("teacup", device=device)
    refits = []
    real_refit = refit.refit_accel
    refit.refit_accel = lambda *a, **k: refits.append(1) or real_refit(*a, **k)
    opt = {}
    try:
        for label, scene in (("teacup", teacup), ("donut", donut)):
            cfg = RenderConfig(width=1024, height=1024)
            target = render(scene, cam, cfg)
            moved = dataclasses.replace(
                scene, vertices=scene.vertices + torch.tensor([0.0, 0.0, 0.02], device=device))
            log = os.path.join(out, f"optimize_{label}.jsonl")
            if os.path.exists(log):
                os.remove(log)
            run = dict(steps=4, learning_rate=1e-3, params=inverse.vertex_params(moved),
                       apply_params=inverse.apply_vertex_params, log_every=1)
            del refits[:]
            params, losses = inverse.optimize(moved, cam, target, cfg, log_jsonl=log, **run)
            # The four steps are one chunk, one CUDA graph: its warm-up step
            # and its capture call the refit once per step, its replay none.
            assert len(refits) == run["steps"] + 1, f"{label}: {len(refits)} refits"
            step_s = [json.loads(line)["step_seconds"] for line in open(log)]
            opt[label] = {"losses": losses, "step_ms": median(step_s) * 1e3}
            print(f"  {label} 1024^2 (depth {effective_max_depth(scene, cfg)}), "
                  f"{moved.num_triangles} triangles: losses {losses}, "
                  f"{opt[label]['step_ms']:.4f} ms/step: the chunk's seconds / 4, its warm-up "
                  f"and capture included (host clock; phase 36 times replays)")
            assert all(np.isfinite(losses)) and losses[-1] < losses[0], (label, losses)
            tcfg = inverse.training_config(cfg, True)
            accel0 = build_accel(moved, tcfg)  # memoized: the tree optimize built
            plan = refit.make_refit_plan(accel0)
            final = inverse.apply_vertex_params(moved, params)
            refit_ms = median(time_frames(lambda: real_refit(accel0, final, plan), iters=10))
            opt[label]["refit_ms"] = refit_ms
            print(f"  {label}: refit {refit_ms:.5f} ms per step (CUDA events, "
                  f"{accel0.num_nodes} nodes, {len(plan.levels)} levels)")
            if label != "teacup":
                continue
            # The graphed chunk against the eager loop's steps (the shade
            # backward's atomics add in another order in each run).
            _, eager_losses = inverse.optimize(moved, cam, target, cfg, jit=False, **run)
            np.testing.assert_allclose(losses, eager_losses, rtol=1e-4)
            # The kernels against the plain twins, on a non-capturable Adam
            # (so the kernels' run is eager).  A vertex step moves hit edges,
            # so a float difference in one step's update can flip a pixel
            # three steps on; the capturable Adam's float32 bias correction
            # is such a difference.
            adam = lambda p: torch.optim.Adam(list(p.values()), lr=run["learning_rate"])  # noqa
            _, k_losses = inverse.optimize(moved, cam, target, cfg, jit=False, optimizer=adam,
                                           **run)
            _, plain_losses = inverse.optimize(moved, cam, target, cfg, plain=True,
                                               optimizer=adam, **run)
            print(f"  teacup: the graphed steps' losses "
                  f"{'equal' if losses == eager_losses else 'within rtol 1e-4 of'} the eager "
                  f"loop's {eager_losses}; with Adam not capturable, the kernels' losses "
                  f"{k_losses}, the plain path's {plain_losses}")
            np.testing.assert_allclose(k_losses, plain_losses, rtol=1e-4)
            refit_tree = real_refit(accel0, final, plan)
            fresh = b4.build_bvh4(final, max_leaf=tcfg.resolve_bvh_max_leaf(),
                                  builder=tcfg.resolve_bvh_builder(final.num_triangles, device))[1]
            a = b4.intersect_bvh4_cuda(final, refit_tree, o1, d1)
            b = b4.intersect_bvh4_cuda(final, fresh, o1, d1)
            t_ok = torch.isclose(big(a.t), big(b.t), atol=1e-4, rtol=1e-5).float().mean().item()
            p_ok = (a.prim_id == b.prim_id).float().mean().item()
            print(f"  teacup after the last step: the refit tree's hits against a fresh build "
                  f"on the moved vertices: t agrees on {t_ok:.5%}, prim ids on {p_ok:.5%}")
            assert t_ok >= 0.998 and p_ok >= 0.998
    finally:
        refit.refit_accel = real_refit
    box = load_standin("mirror_box", device=device)
    target_png = os.path.join(out, "optimize_target.png")
    write_png(target_png, render(box, cam, RenderConfig(width=64, height=64)) * 0.8)
    ckpt = os.path.join(out, "optimize_box.npz")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    fit_png = os.path.join(out, "optimize_box.png")
    base = ["optimize", "--scene", "mirror_box", "--device", "cuda", "--width", "64",
            "--height", "64", "--target", target_png, "--checkpoint", ckpt]
    assert cli.main([*base, "--steps", "2"]) == 0
    with np.load(ckpt) as data:
        assert int(data["step"]) == 2
    assert cli.main([*base, "--steps", "4", "-o", fit_png]) == 0  # resumes at step 2
    with np.load(ckpt) as data:
        assert int(data["step"]) == 4
    assert read_image(fit_png).shape == (64, 64, 3)
    print("  cgrt-torch optimize on the stand-in box: checkpoint written at step 2, resumed to 4")
    results["optimize"] = opt

    phase("phase 23: times (rows 21-22 on the donut's 1024^2 primary rays, frames, steps, trees)")
    so, sd, st = shadow
    lpos = donut.point_lights.position.contiguous()
    tb, n1, tbytes = roofline.table_bytes, o1.shape[0], roofline.tree_bytes(tree)
    calls = {  # (the bare kernel launch, its plain twin, (operations, bytes))
        "intersect_bvh4_cuda:large": (
            lambda: b4._closest_kernel(tree, o1, d1, None),
            lambda: b4._closest_plain(tree, o1, d1, None),
            (roofline.tree_bounce_flops(tree, lpos[:0], o1, d1)[0], n1 * (24 + 16) + tbytes)),
        "anyhit": (lambda: b4._anyhit_kernel(tree, so, sd, st),
                   lambda: b4._anyhit_plain(tree, so, sd, st),
                   (roofline.tree_anyhit_flops(tree, so, sd, st), n1 * (28 + 1) + tbytes)),
        "bounce_bvh4_cuda:large": (
            lambda: b4._bounce_kernel(tree, lpos, o1, d1, None),
            lambda: b4._bounce_plain(tree, lpos, o1, d1, None),
            (roofline.tree_bounce_flops(tree, lpos, o1, d1)[0], n1 * (24 + 20) + tbytes + tb(lpos))),
    }
    # One bare launch between CUDA events: the profiler records no event of
    # some bare launches, and once caught only the any-hit wrapper's .bool().
    print("  ms = one bare launch between CUDA events (median of 20; each runs ~0.3-0.6 ms); "
          "plain_ms = the twin (events)")
    timed = {}
    for key, (kernel_fn, plain_fn, work) in calls.items():
        ms = median(time_frames(kernel_fn, iters=20))
        plain_ms = median(time_frames(plain_fn, iters=2, warmup=1))
        b_ms, b_by = roofline.bound_ms(*work)
        timed[key] = (ms, plain_ms, b_ms, b_by)
        print(f"  {key}: ms {ms:.5f}, plain_ms {plain_ms:.4f} (x{plain_ms / ms:.1f}), bound_ms "
              f"{b_ms:.5f} by {b_by} ({b_ms / ms:.1%} of it)")
    for wrapper in SCALE_KERNELS:
        name, source, replaces = KERNELS[wrapper]
        ms, plain_ms, b_ms, b_by = timed[wrapper]
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": scale_counts[wrapper], "max_abs_err": check[wrapper]["err"],
                 "mismatch_frac": check[wrapper]["mismatch"], "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        if wrapper == "intersect_bvh4_cuda:large":
            entry.update(anyhit_ms=timed["anyhit"][0], anyhit_plain_ms=timed["anyhit"][1],
                         anyhit_bound_ms=timed["anyhit"][2])
        kernels.append(entry)
    # The closest-hit kernel per million camera rays across tree sizes.
    per_mray = {}
    for label, scene, tr in (("teacup", teacup, build_accel(teacup, cfg0)),
                             ("donut", donut, tree), ("torus", torus, ttree)):
        ms = median(time_frames(lambda: b4._closest_kernel(tr, o1, d1, None), iters=10))
        hit = (b4._closest_kernel(tr, o1, d1, None).prim_id >= 0).float().mean().item()
        per_mray[label] = {"ms_per_mray": ms / (n1 / 1e6), "hit": hit,
                           "tree_bytes": roofline.tree_bytes(tr), "nodes": tr.num_nodes}
        print(f"  closest hit, {label} ({scene.num_triangles} triangles, tree "
              f"{roofline.tree_bytes(tr) / 1e6:.1f} MB): {ms / (n1 / 1e6):.5f} ms per million "
              f"camera rays, {hit:.2%} hit")
    results["closest_ms_per_mray"] = per_mray
    # The donut's graphed frames and their profiles come from a process of
    # their own (DONUT_FRAMES_SNIPPET): in this process, after phases 1-22, a
    # profiled replay of them died of a segmentation fault in three of seven
    # full runs on an H100, and never in 16 fresh processes that profiled the
    # same frames 18-24 times each.
    r = subprocess.run([sys.executable, "-c", DONUT_FRAMES_SNIPPET], capture_output=True,
                       text=True, cwd=ROOT, timeout=300)
    assert r.returncode == 0, f"donut frames: rc {r.returncode}: {r.stderr[-3000:]}"
    frames = json.loads(r.stdout.strip().splitlines()[-1])
    for size, fo in ((800, False), (1024, False), (1024, True)):
        route = "fwd_only" if fo else "default"
        r, prof = frames[f"{size}_{route}"]["bench"], frames[f"{size}_{route}"]["profile"]
        busy = f"{prof['busy']:.3f}" if prof["busy"] is not None else "not measured"
        e2e[f"donut_{size}_{route}"] = {"ms": r["seconds_per_frame"] * 1e3,
                                        "rays_per_s": r["value"], "profile": prof}
        print(f"  render donut {size}^2 {route}: {r['seconds_per_frame'] * 1e3:.5f} ms/frame "
              f"(CUDA events), {r['value']:.6g} primary rays/s; profiled wall "
              f"{prof['wall_ms']:.4f} ms, device busy {busy}")
        for kname, kms, n in prof["kernels"][:5]:
            print(f"    {kms:.5f} ms x{n:g}  {kname[:90]}")
    for c, (cfg, params) in steps.items():
        prof = device_breakdown(lambda: bench.fwd_bwd_step(donut, cam, cfg, params, jitter,
                                                           accel=tree), iters=3)
        r = train[c]
        busy = f"{prof['busy']:.3f}" if prof["busy"] is not None else "not measured"
        e2e[f"donut_1024_train_{c}"] = {"ms": r["seconds_per_frame"] * 1e3,
                                        "rays_per_s": r["value"], "profile": prof}
        print(f"  train donut {c} contract 1024^2: {r['seconds_per_frame'] * 1e3:.5f} ms/step "
              f"(CUDA events), {r['value']:.6g} primary rays/s fwd+bwd; profiled wall "
              f"{prof['wall_ms']:.4f} ms, busy {busy}")
        for kname, kms, n in prof["kernels"][:6]:
            print(f"    {kms:.5f} ms x{n:g}  {kname[:90]}")
    # The donut's tree: the auto (median, leaf 4) against SAH, and against
    # leaf 28 (the JAX package's streaming build on the donut: 2 rows of 14).
    # Frames are host-clocked, so the trees take turns over three rounds.
    variants = {}
    base_hit = b4._closest_kernel(tree, o1, d1, None)
    for bld, lf in (("median", 4), ("sah", 4), ("median", 28)):
        t0 = time.perf_counter()
        tr = tree if (bld, lf) == ("median", 4) else b4.build_bvh4(donut, max_leaf=lf,
                                                                   builder=bld)[1]
        torch.cuda.synchronize()
        build_s = donut_s if (bld, lf) == ("median", 4) else time.perf_counter() - t0
        same = (b4._closest_kernel(tr, o1, d1, None).prim_id == base_hit.prim_id)
        assert same.float().mean().item() >= MIN_MATCH
        variants[f"{bld}{lf}"] = (tr, RenderConfig(width=1024, height=1024, bvh_builder=bld,
                                                   bvh_max_leaf=lf),
                                  {"build_s": build_s, "nodes": tr.num_nodes, "depth": tr.depth,
                                   "same_prim": same.float().mean().item(), "bounce_ms": [],
                                   "frame_ms": []})
    for _ in range(3):
        for key, (tr, cfg, row) in variants.items():
            row["bounce_ms"].append(median(time_frames(
                lambda: b4._bounce_kernel(tr, lpos, o1, d1, None), iters=10)))
            row["frame_ms"].append(median(time_frames(lambda: render(donut, cam, cfg, accel=tr),
                                                      iters=10)))
    trees = {}
    for key, (tr, cfg, row) in variants.items():
        trees[key] = row
        print(f"  donut tree {key}: built in {row['build_s']:.3f} s, {row['nodes']} nodes, "
              f"{row['depth']} levels, prim ids equal to the auto tree's on "
              f"{row['same_prim']:.5%}; bounce kernel ms (events, three rounds) "
              f"{[round(x, 5) for x in row['bounce_ms']]}, default-route frame ms (build "
              f"excluded) {[round(x, 4) for x in row['frame_ms']]}")
    results["donut_tree_ab"] = trees
    return scale_counts


def width_phases(out, device, check, note, kernels, e2e, results, scenes) -> dict:
    """Phases 24-28: the tree width.  The one walk of csrc/bvh4.cuh at node
    width 2 (the JAX package's binary kernels: B13 on-chip, B14 streaming)
    and 8 (B15), and the samplers over those trees: the 'sample' route over
    the binary tree (B12) and the 'cone' route at widths 2 (B11) and 8.  Returns the new rows' launch counts from the main path (phase 27)."""
    import torch

    from cg_raytracer_tpu_torch.models import whitted
    from cg_raytracer_tpu_torch.models.whitted import (build_accel, effective_max_depth,
                                                       make_backend, render, render_image,
                                                       resolve_fwd_shade_kernel)
    from cg_raytracer_tpu_torch.ops import bvh4 as b4
    from cg_raytracer_tpu_torch.ops import soft
    from cg_raytracer_tpu_torch.ops.bvh import build_bvh
    from cg_raytracer_tpu_torch.ops.camera import generate_rays
    from cg_raytracer_tpu_torch.ops.intersect import reconstruct_hit
    from cg_raytracer_tpu_torch.ops.linalg import norm, safe_normalize
    from cg_raytracer_tpu_torch.scene.types import Camera
    from cg_raytracer_tpu_torch.utils import bench, checks, roofline
    from cg_raytracer_tpu_torch.utils.bench import median, run_bench, time_frames
    from cg_raytracer_tpu_torch.utils.config import RenderConfig
    from cg_raytracer_tpu_torch.utils.image import write_png

    cam = Camera.default(device=device)
    gen = torch.Generator(device).manual_seed(24)
    o1, d1 = generate_rays(cam, 1024, 1024)
    n1 = o1.shape[0]
    teacup, dragon, donut = scenes["teacup"], scenes["dragon"], scenes["donut"]
    torus, torus_bvh, torus4 = scenes["torus"]

    def events(fn):
        """(fn(), the ms of that one call between CUDA events)."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        res = fn()
        end.record()
        torch.cuda.synchronize()
        return res, start.elapsed_time(end)

    def shadow_rays(scene, tree, o, d):
        """Shadow rays toward light 0 from the rays' hits, with a random t_max."""
        surf = reconstruct_hit(scene, o, d, b4._closest_kernel(tree, o, d, None))
        to_light = scene.point_lights.position[0] - surf.position
        ldir = safe_normalize(to_light).contiguous()
        so = (surf.position + 1e-3 * ldir).contiguous()
        st = torch.where(surf.valid, norm(to_light) - 1e-3, -1.0)
        return so, ldir, (st * torch.rand(st.shape, device=device, generator=gen) * 1.5).contiguous()

    walks = {}  # (scene, width): the inputs of the checks, reused for the times

    def against_twins(label, width, scene, tree, o, d):
        """The walk's three entry points at the tree's width, exactly equal to
        their twins; each twin timed on its one run."""
        assert tree.width == width
        lp = scene.point_lights.position.contiguous()
        so, sd, st = shadow_rays(scene, tree, o, d)
        tml = torch.where(torch.arange(o.shape[0], device=device) % 5 != 0, float("inf"),
                          -1.0).contiguous()
        got, (want, closest_ms) = (b4._closest_kernel(tree, o, d, None),
                                   events(lambda: b4._closest_plain(tree, o, d, None)))
        exact = {"closest": all(torch.equal(a, b) for a, b in zip(got, want))}
        got_a, (want_a, anyhit_ms) = (b4._anyhit_kernel(tree, so, sd, st),
                                      events(lambda: b4._anyhit_plain(tree, so, sd, st)))
        exact["anyhit"] = torch.equal(got_a, want_a)
        (gh, gb), ((wh, wb), bounce_ms) = (b4._bounce_kernel(tree, lp, o, d, tml),
                                           events(lambda: b4._bounce_plain(tree, lp, o, d, tml)))
        exact["bounce"] = all(torch.equal(a, b) for a, b in zip(gh, wh)) and torch.equal(gb, wb)
        print(f"  {label}, width {width} ({tree.num_nodes} nodes, {tree.depth} levels): t, prim, "
              f"u, v and bits equal to the twins' {exact} ({(got.prim_id >= 0).float().mean():.2%}"
              f" of {o.shape[0]} rays hit, {want_a.float().mean():.2%} of the shadow rays "
              f"occluded, {(gb > 0).float().mean():.2%} of the bounce rays shadowed)")
        assert all(exact.values()), (label, width, exact)
        walks[(label, width)] = dict(tree=tree, lp=lp, o=o, d=d, shadow=(so, sd, st), tml=tml,
                                     plain_ms=(closest_ms, anyhit_ms, bounce_ms))

    phase("phase 24: the walk at widths 2 (B13) and 8 (B15) against its twins, teacup 1024^2")
    trees, collapse = {}, {}
    for label, scene in (("teacup", teacup), ("dragon", dragon)):
        for w in (2, 4, 8):
            t0 = time.perf_counter()
            trees[(label, w)] = build_accel(scene, RenderConfig(bvh_wide=str(w)))
            collapse[(label, w)] = time.perf_counter() - t0
    donut_leaf = RenderConfig().resolve_bvh_max_leaf()
    donut_builder = RenderConfig().resolve_bvh_builder(donut.num_triangles, device)
    for w in (2, 4, 8):
        t0 = time.perf_counter()
        trees[("donut", w)] = (build_accel(donut, RenderConfig(bvh_wide_hbm=str(w))) if w < 8 else
                               whitted._wide_tree(donut, donut_leaf, donut_builder, 8))
        collapse[("donut", w)] = time.perf_counter() - t0
        t0 = time.perf_counter()
        trees[("torus", w)] = torus4 if w == 4 else b4.collapse_bvhw(torus_bvh, w).to(device)
        collapse[("torus", w)] = time.perf_counter() - t0
    shapes = {}
    for (label, w), tr in trees.items():
        assert tr.width == w, (label, w, tr.width)
        shapes[f"{label}_w{w}"] = {"nodes": tr.num_nodes, "levels": tr.depth,
                                   "stack": (w - 1) * tr.depth + 1, "bytes": roofline.tree_bytes(tr),
                                   "collapse_s": collapse[(label, w)]}
        print(f"  {label} width {w}: {tr.num_nodes} nodes, {tr.depth} levels (a walk holds at "
              f"most {(w - 1) * tr.depth + 1} of {b4.MAX_STACK} stack entries), "
              f"{roofline.tree_bytes(tr) / 1e6:.2f} MB, {collapse[(label, w)]:.3f} s from the "
              f"memoized binary tree")
    results["width_trees"] = shapes
    for w in (2, 8):
        against_twins("teacup 1024^2 camera rays", w, teacup, trees[("teacup", w)], o1, d1)
    for key in ("intersect_bvh4_cuda:w2", "bounce_bvh4_cuda:w2", "intersect_bvh4_cuda:w8",
                "bounce_bvh4_cuda:w8"):
        note(key, 0.0, 0.0)

    phase("phase 25: the binary walk on the large tier (B14) against its twins")
    against_twins("donut 1024^2 camera rays", 2, donut, trees[("donut", 2)], o1, d1)
    sub = torch.arange(0, n1, 16, device=device)
    against_twins("torus, every 16th ray of the 1024^2 frame", 2, torus, trees[("torus", 2)],
                  o1[sub].contiguous(), d1[sub].contiguous())
    for key in ("intersect_bvh4_cuda:w2:large", "bounce_bvh4_cuda:w2:large"):
        note(key, 0.0, 0.0)
    torch.cuda.synchronize()

    phase("phase 26: the tree samplers at width 2 ('sample' B12, 'cone' B11) and 8 (B15)")
    sd_ = scenes["soft"]
    frames, subsample, key, num = sd_["frames"], sd_["subsample"], sd_["key"], sd_["num"]
    box, (cup, cup_accel) = scenes["spherical_box"], scenes["spherical_teacup"]
    box_bvh = build_bvh(box, max_leaf=4, builder="sah")
    stree = {("box", w): b4.collapse_bvhw(box_bvh, w).to(device) for w in (2, 4, 8)}
    stree[("teacup", 2)] = build_accel(cup, RenderConfig(soft_shadow_tile="sample"))
    stree[("teacup", 4)] = cup_accel
    stree[("teacup", 8)] = build_accel(cup, RenderConfig(bvh_wide="8"))
    for (label, w), tr in stree.items():
        assert isinstance(tr, b4.BVH4) and tr.width == w, (label, w)
    routes = (("sample", 2), ("cone", 2), ("cone", 8))
    # Both routes launch one pair of wrappers; the table keeps a row per route.
    wrappers = (soft.soft4_prng_cuda, soft.soft4_table_cuda)

    def row_key(f, w, route):
        return f"{f.__name__}:w{w}" + (":sample" if route == "sample" else "")
    v_sub = torch.arange(SOFT_SUB, device=device) % 8 != 0  # as phase 16
    sampler_plain, per_sample = {}, {}
    for label, (scene, pos, valid, light, _) in frames.items():
        lights = (scene.spherical_lights.position[0], scene.spherical_lights.radius[0])
        p_sub, g = subsample[label]
        for w in (2, 8):
            tr = stree[(label, w)]
            want_t, table_ms = events(lambda: soft.soft4_table_plain(scene, tr, p_sub, *lights, g,
                                                                     valid=v_sub))
            want_p, prng_ms = events(lambda: soft.soft4_prng_plain(scene, tr, p_sub, *lights, key,
                                                                   num, valid=v_sub))
            sampler_plain[(label, w)] = (prng_ms, table_ms)
            for route, rw in routes:
                if rw != w:
                    continue
                prng, table = wrappers
                got_t = table(scene, tr, p_sub, *lights, g, valid=v_sub)
                got_p = prng(scene, tr, p_sub, *lights, key, num, valid=v_sub)
                exact = (torch.equal(got_t, want_t), torch.equal(got_p, want_p))
                print(f"  {label} '{route}' width {w}, {SOFT_SUB} hit points x {num} samples, one "
                      f"in eight unmarked: table kernel vs twin {'exact' if exact[0] else 'DIFFER'}"
                      f", PRNG kernel vs twin {'exact' if exact[1] else 'DIFFER'} (twins: "
                      f"{table_ms:.1f} ms, {prng_ms:.1f} ms)")
                assert all(exact), (label, route, w)
                for f in (prng, table):
                    note(row_key(f, w, route), 0.0, 0.0)
            # This run's work per sample ray at this width (twin's count).
            marked = torch.nonzero(v_sub).squeeze(1)
            so, sd, tm = soft.sample_rays(p_sub[marked][:, None], soft.philox_gauss(
                key, marked, torch.arange(num, device=device)), light)
            per_sample[(label, w)] = roofline.tree_anyhit_flops(
                tr, so.reshape(-1, 3), sd.reshape(-1, 3), tm.reshape(-1)) / tm.numel()
        # Every hit point of the 1024^2 frame: each route's counts equal the
        # 4-wide kernel's (an any-hit count does not depend on the tree).
        ref = soft.soft4_prng_cuda(scene, stree[(label, 4)], pos, *lights, key, num, valid=valid)
        for route, w in routes:
            got = wrappers[0](scene, stree[(label, w)], pos, *lights, key, num, valid=valid)
            same = (got == ref).float().mean().item()
            print(f"  {label} 1024^2, all {pos.shape[0]} points ({int(valid.sum())} hit): '{route}'"
                  f" width {w} counts equal the 4-wide kernel's on {same:.5%} of points, max "
                  f"|diff| {(got - ref).abs().max().item():g}")
            assert torch.equal(got, ref), (label, route, w)
    torch.cuda.synchronize()

    phase("phase 27: the width routes end to end: renders and steps (counts from 0)")
    point_cfgs = {  # label: (scene, knobs)
        "teacup bvh_wide=2": (teacup, {"bvh_wide": "2"}),
        "teacup bvh_wide=8": (teacup, {"bvh_wide": "8"}),
        "dragon bvh_wide=2": (dragon, {"bvh_wide": "2"}),
        "dragon bvh_wide=8": (dragon, {"bvh_wide": "8"}),
        "teacup+spheres bvh_wide=2": (scenes["teacup_spheres"], {"bvh_wide": "2"}),
        "teacup+spheres bvh_wide=8": (scenes["teacup_spheres"], {"bvh_wide": "8"}),
    }
    soft_cfgs = {
        "spherical teacup soft_shadow_tile=sample": (cup, {"soft_shadow_tile": "sample"}),
        "spherical teacup bvh_wide=2 (cone)": (cup, {"bvh_wide": "2"}),
        "spherical teacup bvh_wide=8 (cone)": (cup, {"bvh_wide": "8"}),
    }
    large_cfgs = {
        "donut bvh_wide_hbm=2": (donut, {"bvh_wide_hbm": "2"}),
        "donut+spheres bvh_wide_hbm=2": (scenes["donut_spheres"], {"bvh_wide_hbm": "2"}),
    }
    trained = ("teacup bvh_wide=2", "teacup bvh_wide=8", "dragon bvh_wide=2", "dragon bvh_wide=8",
               "spherical teacup soft_shadow_tile=sample", "donut bvh_wide_hbm=2")
    jitter = bench.camera_jitter(torch.Generator(device).manual_seed(9), device)

    def drive(cfgs):
        """The main path of each configuration with the counts from 0: a
        1024^2 render and run_bench(include_bwd=True) -> (images, counts)."""
        for module in (b4, soft):
            module.reset_launch_counts()
        images = {}
        for label, (scene, kw) in cfgs.items():
            images[label] = render(scene, cam, RenderConfig(width=1024, height=1024, **kw))
            if label in trained:
                r = run_bench(scene, width=1024, height=1024, include_bwd=True, iters=2,
                              include_vertex_params=True, cfg_overrides=kw,
                              scene_name=label.split(" bvh")[0].split(" soft")[0])
                print(f"  {label}: run_bench(include_bwd=True) {r['seconds_per_frame'] * 1e3:.5f}"
                      f" ms/step")
        torch.cuda.synchronize()
        return images, {**b4.launch_counts(), **soft.launch_counts()}

    # The 'sample' route alone: its sampler counts as the cone's at width 2.
    sample = "spherical teacup soft_shadow_tile=sample"
    sample_imgs, sample_counts = drive({sample: soft_cfgs[sample]})
    print(f"  launch counts, 'sample' route {sample_counts}")
    vmem_imgs, vmem_counts = drive({**point_cfgs, **{k: v for k, v in soft_cfgs.items()
                                                     if k != sample}})
    vmem_imgs.update(sample_imgs)
    print(f"  launch counts, on-chip tier {vmem_counts}")
    large_imgs, large_counts = drive(large_cfgs)
    print(f"  launch counts, large tier {large_counts}")
    for counts_, keys in ((sample_counts, ("bounce_bvh4_cuda:w2", "soft4_prng_cuda:w2")),
                          (vmem_counts, ("intersect_bvh4_cuda:w2", "occluded_bvh4_cuda:w2",
                                         "bounce_bvh4_cuda:w2", "intersect_bvh4_cuda:w8",
                                         "occluded_bvh4_cuda:w8", "bounce_bvh4_cuda:w8",
                                         "soft4_prng_cuda:w2", "soft4_prng_cuda:w8")),
                          (large_counts, ("intersect_bvh4_cuda:w2", "occluded_bvh4_cuda:w2",
                                          "bounce_bvh4_cuda:w2"))):
        for k in keys:
            assert counts_[k] > 0, f"{k} never launched its kernel on the main path"
        wide4 = {k: n for k, n in counts_.items() if k.endswith(":w4") and n}
        assert not wide4, f"the 4-wide kernels ran under another width's knob: {wide4}"
    width_counts = {
        "intersect_bvh4_cuda:w2": (vmem_counts["intersect_bvh4_cuda:w2"]
                                   + vmem_counts["occluded_bvh4_cuda:w2"]),
        "bounce_bvh4_cuda:w2": vmem_counts["bounce_bvh4_cuda:w2"],
        "intersect_bvh4_cuda:w2:large": (large_counts["intersect_bvh4_cuda:w2"]
                                         + large_counts["occluded_bvh4_cuda:w2"]),
        "bounce_bvh4_cuda:w2:large": large_counts["bounce_bvh4_cuda:w2"],
        "intersect_bvh4_cuda:w8": (vmem_counts["intersect_bvh4_cuda:w8"]
                                   + vmem_counts["occluded_bvh4_cuda:w8"]),
        "bounce_bvh4_cuda:w8": vmem_counts["bounce_bvh4_cuda:w8"],
    }
    for k in ("soft4_prng_cuda:w2", "soft4_table_cuda:w2", "soft4_prng_cuda:w8",
              "soft4_table_cuda:w8"):
        width_counts[k] = vmem_counts[k]
    for k in ("soft4_prng_cuda:w2", "soft4_table_cuda:w2"):
        width_counts[f"{k}:sample"] = sample_counts[k]
    # Each image against the plain path on the config render() resolved; the
    # spherical ones at 256^2 on one generator (the samplers' twins on a
    # whole 1024^2 frame take tens of seconds).
    for label, img in {**vmem_imgs, **large_imgs}.items():
        scene, kw = {**point_cfgs, **soft_cfgs, **large_cfgs}[label]
        assert img.shape == (1024, 1024, 3) and bool(torch.isfinite(img).all()), label
        lit = (img.amax(dim=-1) > 0.02).float().mean().item()
        write_png(os.path.join(out, label.replace(" ", "_").replace("=", "") + ".png"), img)
        size = 256 if label in soft_cfgs else 1024
        cfg = RenderConfig(width=size, height=size, **kw)
        cfg = resolve_fwd_shade_kernel(scene, dataclasses.replace(
            cfg, max_depth=effective_max_depth(scene, cfg)))
        accel = build_accel(scene, cfg)
        gen0 = lambda: torch.Generator().manual_seed(0)  # noqa: E731
        if size != 1024:
            img = render_image(scene, cam, cfg, generator=gen0(),
                               backend=make_backend(scene, cfg, accel=accel))
        plain = render_image(scene, cam, cfg, generator=gen0(),
                             backend=make_backend(scene, cfg, plain=True, accel=accel))
        images_close(img, plain, f"{label} {size}^2 vs plain path (lit fraction {lit:.3f})")
        assert lit > 0.1, label
    for label in trained:
        scene, kw = {**point_cfgs, **soft_cfgs, **large_cfgs}[label]
        size = 256 if label in soft_cfgs else 1024
        cfg = RenderConfig(width=size, height=size, **kw)
        cfg = bench.training_config(dataclasses.replace(
            cfg, max_depth=effective_max_depth(scene, cfg)), True)
        params = bench.training_params(scene, True)
        accel = build_accel(scene, cfg)
        (lk, gk), (lp, gp) = (bench.fwd_bwd_step(scene, cam, cfg, params, jitter, plain=plain,
                                                 accel=accel,
                                                 generator=torch.Generator().manual_seed(4))
                              for plain in (False, True))
        torch.testing.assert_close(lk, lp, rtol=1e-5, atol=1e-7)
        worst = 0.0
        for name in gk:
            assert bool(torch.isfinite(gk[name]).all()), (label, name)
            tol = dict(checks.TABLE_GRAD, atol=2e-5) if name == "vertices" else checks.TABLE_GRAD
            torch.testing.assert_close(gk[name], gp[name], **tol, msg=f"{label} d/d{name}")
            worst = max(worst, (gk[name] - gp[name]).abs().max().item())
        assert gk["vertices"].abs().sum().item() > 0, label
        print(f"  {label}, one full-contract {size}^2 step: loss {lk.item():.8g} (plain path "
              f"{lp.item():.8g}), gradients within {worst:.3g} of the plain step's")
    torch.cuda.synchronize()

    phase("phase 28: times by node width (events; frames and steps by run_bench)")
    per_mray = {}
    for label, scene in (("teacup", teacup), ("dragon", dragon), ("donut", donut),
                         ("torus", torus)):
        lp = scene.point_lights.position.contiguous()
        for w in (2, 4, 8):
            tr = trees[(label, w)]
            closest = median(time_frames(lambda: b4._closest_kernel(tr, o1, d1, None), iters=10))
            bounce = median(time_frames(lambda: b4._bounce_kernel(tr, lp, o1, d1, None), iters=10))
            per_mray[f"{label}_w{w}"] = {"closest_ms_per_mray": closest / (n1 / 1e6),
                                         "bounce_ms": bounce}
            print(f"  {label} width {w}: closest hit {closest / (n1 / 1e6):.5f} ms per million "
                  f"camera rays, bounce {bounce:.5f} ms (1024^2 camera rays, one light)")
    results["width_kernel_ms"] = per_mray
    frame_cfgs = {
        "teacup": (teacup, [{"bvh_wide": w} for w in "248"]),
        "dragon": (dragon, [{"bvh_wide": w} for w in "248"]),
        "donut": (donut, [{"bvh_wide_hbm": w} for w in "24"]),
        "spherical_teacup": (cup, [{"soft_shadow_tile": "sample"}, {"bvh_wide": "2"}, {},
                                   {"bvh_wide": "8"}]),
    }
    frames_ms = {}
    for rnd in range(2):  # host-clocked: the widths take turns, twice
        for label, (scene, kws) in frame_cfgs.items():
            for kw in kws:
                tag = f"{label} " + (",".join(f"{k}={v}" for k, v in kw.items()) or "auto")
                r = run_bench(scene, width=1024, height=1024, iters=5,
                              cfg_overrides={"forward_only": False, **kw}, scene_name=label)
                s = run_bench(scene, width=1024, height=1024, include_bwd=True, iters=3,
                              include_vertex_params=True, cfg_overrides=kw, scene_name=label)
                row = frames_ms.setdefault(tag, {"frame_ms": [], "step_ms": []})
                row["frame_ms"].append(r["seconds_per_frame"] * 1e3)
                row["step_ms"].append(s["seconds_per_frame"] * 1e3)
    for tag, row in frames_ms.items():
        print(f"  {tag}: default-route frame {[round(x, 4) for x in row['frame_ms']]} ms, "
              f"full-contract step {[round(x, 4) for x in row['step_ms']]} ms (two rounds)")
        e2e[f"width {tag}"] = row
    # The new rows: a bare launch between CUDA events (median of 20) on the
    # inputs the twins ran on, the twin's time from its check run, the bound
    # counted by the twin on the same rays.
    tb = roofline.table_bytes
    for closest_w, (label, w) in (("intersect_bvh4_cuda:w2", ("teacup 1024^2 camera rays", 2)),
                                  ("intersect_bvh4_cuda:w8", ("teacup 1024^2 camera rays", 8)),
                                  ("intersect_bvh4_cuda:w2:large", ("donut 1024^2 camera rays",
                                                                    2))):
        k = walks[(label, w)]
        tr, o, d, (so, sd, st), lp, tml = (k["tree"], k["o"], k["d"], k["shadow"], k["lp"],
                                           k["tml"])
        nr, tbytes = o.shape[0], roofline.tree_bytes(tr)
        closest_plain, anyhit_plain, bounce_plain = k["plain_ms"]
        ms = median(time_frames(lambda: b4._closest_kernel(tr, o, d, None), iters=20))
        any_ms = median(time_frames(lambda: b4._anyhit_kernel(tr, so, sd, st), iters=20))
        b_ms_ = median(time_frames(lambda: b4._bounce_kernel(tr, lp, o, d, tml), iters=20))
        bound = roofline.bound_ms(roofline.tree_bounce_flops(tr, lp[:0], o, d)[0],
                                  nr * (24 + 16) + tbytes)
        any_bound = roofline.bound_ms(roofline.tree_anyhit_flops(tr, so, sd, st),
                                      nr * (28 + 1) + tbytes)
        live = tml > 0
        bounce_bound = roofline.bound_ms(roofline.tree_bounce_flops(tr, lp, o, d, live)[0],
                                         nr * (24 + 20) + tbytes + tb(lp))
        bounce_w = closest_w.replace("intersect", "bounce")
        for wrapper, row in ((closest_w, (ms, closest_plain, *bound)),
                             (bounce_w, (b_ms_, bounce_plain, *bounce_bound))):
            name, source, replaces = KERNELS[wrapper]
            entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": width_counts[wrapper], "max_abs_err": check[wrapper]["err"],
                     "mismatch_frac": check[wrapper]["mismatch"], "ms": row[0],
                     "plain_ms": row[1], "bound_ms": row[2], "bound_by": row[3],
                     "library_ms": None, "width": w, "rays": nr}
            if wrapper == closest_w:
                entry.update(anyhit_ms=any_ms, anyhit_plain_ms=anyhit_plain,
                             anyhit_bound_ms=any_bound[0])
            print(f"  {name} ({label}): ms {row[0]:.5f}, plain_ms {row[1]:.4f} "
                  f"(x{row[1] / row[0]:.1f}), bound_ms {row[2]:.5f} by {row[3]} "
                  f"({row[2] / row[0]:.1%} of it)"
                  + (f"; any hit ms {any_ms:.5f}, plain {anyhit_plain:.4f}, bound "
                     f"{any_bound[0]:.5f}" if wrapper == closest_w else ""))
            kernels.append(entry)
    # The samplers on the spherical teacup: PRNG on every hit point of the
    # 1024^2 frame, table on the subsample; the twins on the subsample.
    scene, pos, valid, light, _ = frames["teacup"]
    v8 = valid.to(torch.uint8).contiguous()
    n_valid = int(valid.sum())
    p_sub, g = subsample["teacup"]
    g_nsc = g.permute(1, 0, 2).contiguous()
    for route, w in routes:
        tr = stree[("teacup", w)]
        prng_plain, table_plain = sampler_plain[("teacup", w)]
        work = per_sample[("teacup", w)]
        tbytes = roofline.tree_bytes(tr)
        prng_w, table_w = (row_key(f, w, route) for f in wrappers)
        for wrapper, fn, plain_ms, points, flops, int_ops, bytes_ in (
                (prng_w, lambda: soft._tree_kernel(tr, pos, light, num, v8, key, None),
                 prng_plain, n_valid, n_valid * num * (roofline.SAMPLE_FLOPS + work),
                 n_valid * num * roofline.PHILOX_INT_OPS, pos.shape[0] * (12 + 1 + 4) + 16 + tbytes),
                (table_w, lambda: soft._tree_kernel(tr, p_sub, light, num, None, None, g_nsc),
                 table_plain, SOFT_SUB, SOFT_SUB * num * (roofline.SAMPLE_FLOPS - 25 + work), 0,
                 SOFT_SUB * (12 + 4 + 12 * num) + 16 + tbytes)):
            ms = median(time_frames(fn, iters=20, warmup=1))
            b_ms, b_by = roofline.bound_ms(flops, bytes_, int_ops)
            name, source, replaces = KERNELS[wrapper]
            print(f"  {name} ('{route}', width {w}, {points} points x {num} samples): ms {ms:.5f},"
                  f" plain_ms {plain_ms:.3f} on {SOFT_SUB} points, bound_ms {b_ms:.5f} by {b_by} "
                  f"({b_ms / ms:.1%} of it); {points * num / ms / 1e6:.4g} G sample rays/s")
            kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                            "launches": width_counts[wrapper],
                            "max_abs_err": check[wrapper]["err"],
                            "mismatch_frac": check[wrapper]["mismatch"], "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": None, "points": points, "plain_points": SOFT_SUB,
                            "samples": num, "width": w})
    scenes.update(soft_trees=stree, soft_work=per_sample, walk_trees=trees)
    return {k: width_counts[k] for k in WIDTH_KERNELS}


CSRC = os.path.join("cg_raytracer_tpu_torch", "csrc")
# Moller-Trumbore in full (sweep.cuh mt) in place of mt_blocks's early
# exits: the any-hit walk's and the brute sampler's triangle test.
_MT_BLOCKS = ("__device__ __forceinline__ bool mt_blocks(const float4 v0, const float4 e1, "
              "const float4 e2,\n" + " " * 42 + "const Ray& r, float t_max) {\n")
_MT_FULL = ("sweep.cuh", _MT_BLOCKS, _MT_BLOCKS + """  {
    float t, u, v;
    return mt(v0, e1, e2, r, t, u, v) && t < t_max;
  }
""", 1)
_MINMAX_COMPARES = ("bvh4.cuh", "#ifdef __CUDA_ARCH__", "#if 0", 2)
# Phase 29's variants of csrc/: each takes one lever of the samplers' design
# out again, or tries another block size or grid cap, by substitutions on
# the sources (file, old text, new text, how often the old text occurs).
# Only this script builds them; the port has one body.
SOFT_ABLATIONS = {
    "min/max by compares": [_MINMAX_COMPARES],
    "full Moller-Trumbore": [_MT_FULL],
    "sinf and cosf": [("soft.cu", "sincosf(kTwoPi * u2, &s2, &c2);",
                       "s2 = sinf(kTwoPi * u2);\n  c2 = cosf(kTwoPi * u2);", 1)],
    "64 threads per block": [("soft.cu", "kSoftThreads = 128;", "kSoftThreads = 64;", 1)],
    "256 threads per block": [("soft.cu", "kSoftThreads = 128;", "kSoftThreads = 256;", 1)],
    "16,384-block grid": [("soft.cu", "kMaxBlocks = 65536;", "kMaxBlocks = 16384;", 1)],
    "262,144-block grid": [("soft.cu", "kMaxBlocks = 65536;", "kMaxBlocks = 262144;", 1)],
}
E2E_SNIPPET = """
import json, sys
sys.path.insert(0, ".")
from cg_raytracer_tpu_torch.utils.bench import run_bench
out = {}
for scene in ("spherical_box", "spherical_teacup"):
    f = run_bench(scene, width=1024, height=1024, iters=5)
    full = run_bench(scene, width=1024, height=1024, include_bwd=True, iters=3,
                     include_vertex_params=True)
    mat = run_bench(scene, width=1024, height=1024, include_bwd=True, iters=3)
    out[scene] = [x["seconds_per_frame"] * 1e3 for x in (f, full, mat)]
print(json.dumps(out))
"""


NCU_SNIPPET = """
import sys, torch
sys.path.insert(0, ".")
from cg_raytracer_tpu_torch.models.whitted import build_accel
from cg_raytracer_tpu_torch.ops import bvh4 as b4, cuda_kernels as ck, soft
from cg_raytracer_tpu_torch.ops.camera import generate_rays
from cg_raytracer_tpu_torch.scene.presets import load_standin
from cg_raytracer_tpu_torch.scene.types import Camera
from cg_raytracer_tpu_torch.utils.config import RenderConfig
dev = torch.device("cuda")
o, d = generate_rays(Camera.default(device=dev), 1024, 1024)
key = soft.SampleKey(2026, 16)
for name in ("spherical_box", "spherical_teacup"):
    scene = load_standin(name, dev)
    accel = build_accel(scene, RenderConfig()) if name == "spherical_teacup" else None
    hit = (ck.intersect_cuda(scene, o, d) if accel is None
           else b4.intersect_bvh4_cuda(scene, accel, o, d))
    valid = hit.prim_id >= 0
    pos = torch.where(valid[:, None], o + d * torch.where(valid, hit.t, 0.0)[:, None], 0.0)
    light = (scene.spherical_lights.position[0], scene.spherical_lights.radius[0])
    if accel is None:
        soft.soft_prng_cuda(scene, pos.contiguous(), *light, key, 200, valid=valid)
    else:
        soft.soft4_prng_cuda(scene, accel, pos.contiguous(), *light, key, 200, valid=valid)
torch.cuda.synchronize()
"""
NCU_METRICS = ("smsp__inst_executed.sum", "smsp__thread_inst_executed.sum",
               "smsp__thread_inst_executed_per_inst_executed.ratio",
               "smsp__issue_active.avg.pct_of_peak_sustained_active",
               "sm__warps_active.avg.pct_of_peak_sustained_active",
               "l1tex__t_sector_hit_rate.pct", "gpu__time_duration.sum")


def variant_dir(root, subs) -> str:
    """A copy of csrc/ in ``root`` with the substitutions ``subs`` made."""
    os.makedirs(root, exist_ok=True)
    src_dir = os.path.join(ROOT, CSRC)
    texts = {}
    for name in os.listdir(src_dir):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(src_dir, name)) as f:
                texts[name] = f.read()
    for name, old, new, n in subs:
        assert texts[name].count(old) == n, f"{name}: {old!r} occurs {texts[name].count(old)} " \
                                            f"times, not {n}"
        texts[name] = texts[name].replace(old, new)
    for name, text in texts.items():
        with open(os.path.join(root, name), "w") as f:
            f.write(text)
    return root


def build_variants(source, ablations, signatures, parent=None, parent_signatures=None,
                   tag: str = "") -> dict:
    """name -> (ctypes library, ptxas log): csrc/``source`` (a file name, or
    a tuple of them linked into one library) compiled with each of
    ``ablations``' substitutions and, given ``parent`` (an unpacked
    checkout), that checkout's ``source``; one nvcc each, all started
    together, into the build directory (``tag``: a directory of its own, so
    that libraries another phase loaded are not rebuilt under it).
    ``signatures``: the argtypes of the entry points to declare
    (``parent_signatures`` the parent's)."""
    import ctypes

    from cg_raytracer_tpu_torch.ops import _build

    sources = (source,) if isinstance(source, str) else tuple(source)
    root = os.path.join(_build.build_dir(),
                        "variants_" + "_".join(x.split(".")[0] for x in sources) + tag)
    jobs = {}
    for k, (name, subs) in enumerate(ablations.items()):
        src_dir = variant_dir(os.path.join(root, f"v{k}"), subs)
        jobs[name] = ([os.path.join(src_dir, x) for x in sources],
                      os.path.join(root, f"v{k}.so"), signatures)
    if parent is not None:
        jobs["parent"] = ([os.path.join(parent, CSRC, x) for x in sources],
                          os.path.join(root, "parent.so"), parent_signatures or signatures)
    procs = {}
    for name, (srcs, so, sig) in jobs.items():
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so, *srcs]
        procs[name] = (cmd, so, sig, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (cmd, so, sig, proc) in procs.items():
        stdout, stderr = proc.communicate()
        assert proc.returncode == 0, f"{name}: {' '.join(cmd)}\n{stdout}{stderr}"
        lib = ctypes.CDLL(so)
        _build.declare(lib, sig)
        libs[name] = (lib, stdout + stderr)
    return libs


def soft_signatures(key_by_value: bool = False, tally: bool = True, tree_tally: bool = True,
                    lists: bool = True):
    """The samplers' argtypes; ``key_by_value``: an earlier tree's, whose
    kernels took the key's words (k0, k1) as scalars; ``tally``: whether the
    brute sampler takes its tally's pointer (trees since its culling);
    ``tree_tally``: whether the tree samplers take theirs; ``lists``: whether
    they take the tree's node count and the point pass's scratch and tally
    (trees since the per-point lists)."""
    import ctypes

    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    key = [u, u, u] if key_by_value else [p, u]
    return {"cgrt_soft_brute": [p, p, p, i, p, p, i, i, *key, p, p, *([p] if tally else []), p],
            "cgrt_soft_bvh4": [p, p, p, i, p, i, p, p, *([i] if lists else []), i, *key, p, p,
                               *([p] if tree_tally else []), *([p] * 4 if lists else []), p]}


def parent_keys_by_value(parent) -> bool:
    """Whether the checkout ``parent``'s samplers take the key's words as
    scalars (trees before the key moved to the card)."""
    if parent is None:
        return False
    with open(os.path.join(parent, CSRC, "soft.cu")) as f:
        return "const unsigned* key" not in f.read()


def parent_tally(parent) -> bool:
    """Whether the checkout ``parent``'s brute sampler takes a tally."""
    if parent is None:
        return True
    with open(os.path.join(parent, CSRC, "soft.cu")) as f:
        return "unsigned long long* tally" in f.read()


def parent_tree_tally(parent) -> bool:
    """Whether the checkout ``parent``'s tree samplers take a tally."""
    if parent is None:
        return True
    with open(os.path.join(parent, CSRC, "soft.cu")) as f:
        params = f.read().split("int cgrt_soft_bvh4(")[1].split(") {")[0]
    return "unsigned long long* tally" in params


def parent_lists(parent) -> bool:
    """Whether the checkout ``parent``'s tree samplers run the point pass."""
    if parent is None:
        return True
    with open(os.path.join(parent, CSRC, "soft.cu")) as f:
        params = f.read().split("int cgrt_soft_bvh4(")[1].split(") {")[0]
    return "int* lists" in params


def parent_soft_signatures(parent):
    return soft_signatures(key_by_value=parent_keys_by_value(parent), tally=parent_tally(parent),
                           tree_tally=parent_tree_tally(parent), lists=parent_lists(parent))


def mark_parent(variants, parent) -> None:
    """Tell soft_launch how the parent's samplers take their arguments."""
    if "parent" in variants:
        variants["parent"][0].key_by_value = parent_keys_by_value(parent)
        variants["parent"][0].tally = parent_tally(parent)
        variants["parent"][0].tree_tally = parent_tree_tally(parent)
        variants["parent"][0].lists = parent_lists(parent)


def soft_launch(lib, target, pos, light, num, valid, key, gauss_nsc):
    """counts [N] int32 of one launch of ``lib``'s sampler: ``target`` is the
    brute sampler's triangle table [T, 9] or a BVH4 (its records)."""
    import ctypes

    import torch

    from cg_raytracer_tpu_torch.ops import bvh4 as b4
    from cg_raytracer_tpu_torch.ops import cuda_kernels as ck
    from cg_raytracer_tpu_torch.ops import soft

    counts = torch.zeros((pos.shape[0],), dtype=torch.int32, device=pos.device)
    head, _keep = soft._head("soft variant", pos, light, valid, gauss_nsc)
    if getattr(lib, "key_by_value", False):
        k = key if key is not None else soft.SampleKey(0, 0)
        key_args = (num, *(ctypes.c_uint32(int(x) & 0xFFFFFFFF) for x in k[:3]))
    else:
        key_args, _words = soft._key_args(key, num, pos.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    tail = (*key_args, ck._ptr(gauss_nsc), ck._ptr(counts))
    if isinstance(target, b4.BVH4):
        tally = (ctypes.c_void_p(0),) if getattr(lib, "tree_tally", True) else ()
        nodes, scratch = (), ()
        if getattr(lib, "lists", True):
            n, dev = pos.shape[0], pos.device
            nodes = (target.num_nodes,)
            keep = (torch.empty((n, 2 * lib.cgrt_soft_list_max()), dtype=torch.int32, device=dev),
                    torch.empty((n,), dtype=torch.int32, device=dev),
                    torch.empty((target.num_nodes,), dtype=torch.int32, device=dev))
            scratch = (*(ck._ptr(x) for x in keep), ctypes.c_void_p(0))
        err = lib.cgrt_soft_bvh4(*head, target.width, ck._ptr(target.nodes),
                                 ck._ptr(target.rows), *nodes, *tail, *tally, *scratch, stream)
    else:
        tally = (ctypes.c_void_p(0),) if getattr(lib, "tally", True) else ()
        err = lib.cgrt_soft_brute(*head, ck._ptr(target), target.shape[0], *tail, *tally, stream)
    assert err == 0, f"soft variant launch: CUDA error {err}"
    return counts


SOFT_MANGLED = r"soft_kernelILb([01])ELi(\d)E(?:Lb([01])E)?E"  # (table?, W, culled?)


def soft_instance(name: str, cull: bool = False):
    """(table?, W) of a mangled soft_kernel instantiation, if it is a culled
    one exactly when ``cull`` (an earlier tree's have no such flag)."""
    import re

    m = re.search(SOFT_MANGLED, name)
    if not m or (m.group(3) == "1") != cull:
        return None
    return m.group(1) == "1", int(m.group(2))


def ptxas_soft(log: str, cull: bool = False) -> dict:
    """(table?, W) -> registers, stack frame and spill bytes of soft_kernel's
    instantiations in a ``-Xptxas=-v`` log (``cull``: the brute sampler's
    culled ones, W = 0)."""
    import re

    info, cur = {}, None
    for line in log.splitlines():
        if "Function properties for" in line or "Compiling entry function" in line:
            cur = soft_instance(line, cull)
            if cur is not None:
                info.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            info[cur].update(frame=int(m.group(1)), spill_st=int(m.group(2)),
                             spill_ld=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            info[cur]["regs"] = int(m.group(1))
    return info


def occupancy_warps(regs: int, smem: int, threads: int = 128) -> int:
    """Resident warps per SM of a kernel at ``regs`` registers and ``smem``
    bytes of shared memory per block on an H100 (65,536 registers allocated
    per warp in steps of 256, 228 KB of shared memory with 1 KB reserved per
    block, at most 32 blocks and 64 warps)."""
    warps = threads // 32
    by_regs = 65536 // (-(-regs * 32 // 256) * 256) // warps
    by_smem = 233472 // (smem + 1024)
    return min(by_regs, by_smem, 32, 64 // warps) * warps


def sass_soft(lib_path: str):
    """(table?, W) -> {'total': SASS instructions, opcode: count} of
    soft_kernel's instantiations (cuobjdump), or None without cuobjdump."""
    import re

    from cg_raytracer_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = soft_instance(line)
            if cur is not None:
                out[cur] = {"total": 0}
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if cur is None or not m or m.group(1) == "NOP":
            continue
        op = m.group(1)
        out[cur]["total"] += 1
        for key in ("IMAD.WIDE.U32", "IMAD.HI.U32", "MUFU", "FMNMX", "LDG", "LDS", "STS", "LDL",
                    "STL", "CALL", "FSETP", "FADD", "FMUL", "FFMA"):
            if op.startswith(key):
                out[cur][key] = out[cur].get(key, 0) + 1
    return out


def sampler_phase(out, device, kernels, e2e, results, scenes, parent=None) -> None:
    """Phase 29: the samplers measured (ptxas, SASS, the sample stage against
    the table read, rays/s and the bound) and their ablations, with
    ``parent``'s samplers and spherical frames and steps beside them."""
    import shutil

    import torch

    from cg_raytracer_tpu_torch.ops import _build
    from cg_raytracer_tpu_torch.ops import cuda_kernels as ck
    from cg_raytracer_tpu_torch.ops import soft
    from cg_raytracer_tpu_torch.utils import roofline
    from cg_raytracer_tpu_torch.utils.bench import median, time_frames

    phase("phase 29: the samplers measured: registers, SASS, sample stage, ablations"
          + (f", against {parent}" if parent else ""))
    sd_ = scenes["soft"]
    frames, subsample, key, num = sd_["frames"], sd_["subsample"], sd_["key"], sd_["num"]
    stree, work = scenes["soft_trees"], dict(sd_["work"])
    work.update({f"teacup w{w}": scenes["soft_work"][("teacup", w)] for w in (2, 8)})
    work["teacup w4"] = work.pop("teacup")
    tri = ck._tri_table(scenes["spherical_box"]).detach()
    # label: (frame, brute table or tree, per-sample work of this run's twin count)
    targets = {"brute": ("box", tri, work["box"])}
    targets.update({f"w{w}": ("teacup", stree[("teacup", w)], work[f"teacup w{w}"])
                    for w in (2, 4, 8)})
    t0 = time.perf_counter()
    variants = build_variants("soft.cu", SOFT_ABLATIONS, soft_signatures(), parent,
                              parent_soft_signatures(parent))
    mark_parent(variants, parent)
    print(f"  {len(variants)} variants of soft.cu built in {time.perf_counter() - t0:.1f} s")
    with open(_build.library_path()[:-3] + ".log") as f:
        logs = {"this tree": f.read()}
    logs.update({k: v[1] for k, v in variants.items()})
    info = {name: ptxas_soft(log) for name, log in logs.items()}
    print("  ptxas, per instantiation (table?, W): registers, stack frame / spill store / spill "
          "load bytes, resident warps per SM (from registers and shared memory)")
    smem = {0: 48 * tri.shape[0], 2: 0, 4: 0, 8: 0}
    occ = {}
    for name in ("this tree", *(["parent"] if parent else [])):
        for (table, w), r in sorted(info[name].items(), key=lambda kv: (kv[0][1], kv[0][0])):
            sm = smem[w]
            occ[(name, table, w)] = occupancy_warps(r["regs"], sm)
            print(f"    {name}: ({'table' if table else 'PRNG'}, W = {w}): {r['regs']} registers, "
                  f"{r['frame']} / {r['spill_st']} / {r['spill_ld']} bytes, {sm} B shared per "
                  f"block, {occ[(name, table, w)]} warps per SM")
    sass = sass_soft(_build.library_path())
    if sass is None:
        print("  SASS: no cuobjdump beside nvcc")
    else:
        for (table, w), c in sorted(sass.items(), key=lambda kv: (kv[0][1], kv[0][0])):
            print(f"  SASS ({'table' if table else 'PRNG'}, W = {w}): {c}")
        for w in (0, 2, 4, 8):
            if (False, w) in sass and (True, w) in sass:
                print(f"  SASS, W = {w}: the PRNG instantiation has "
                      f"{sass[(False, w)]['total'] - sass[(True, w)]['total']} more instructions "
                      "than the table one (Philox and Box-Muller, straight-line code: issued once "
                      "per sample ray)")
    ncu = shutil.which("ncu") or ("/usr/local/cuda/bin/ncu"
                                 if os.path.exists("/usr/local/cuda/bin/ncu") else None)
    print(f"  ncu: {ncu or 'not on this machine'}")
    if ncu:
        # One launch of each PRNG sampler on its 1024^2 frame (the brute on
        # the box, the 4-wide cone on the teacup), in a process of its own.
        try:
            r = subprocess.run([ncu, "--target-processes", "all", "-k", "regex:soft_kernel",
                                "-c", "2", "--metrics", ",".join(NCU_METRICS), sys.executable,
                                "-c", NCU_SNIPPET], capture_output=True, text=True, cwd=ROOT,
                               timeout=180)
            lines = [ln for ln in (r.stdout + r.stderr).splitlines()
                     if "soft_kernel" in ln or any(m in ln for m in NCU_METRICS) or "ERR" in ln
                     or "==" in ln]
            print(f"    ncu exit {r.returncode}:")
            print("\n".join(f"    {ln.strip()[:200]}" for ln in lines[-40:]))
        except subprocess.TimeoutExpired:
            print("    ncu did not finish in 180 s")

    # The table variant on every hit point of the frame against the PRNG
    # variant on the same points: the difference is the sample stage.
    stage = {}
    print("  every hit point of the 1024^2 frame, compacted (ms: median of 20 bare launches)")
    for k, (label, target, per_ray) in targets.items():
        _, pos, valid, light, _ = frames[label]
        pts = pos[valid].contiguous()
        m = pts.shape[0]
        table = torch.empty((m, num, 3), device=device)
        samples = torch.arange(num, device=device)
        for s0 in range(0, m, 16384):
            rows = torch.arange(s0, min(m, s0 + 16384), device=device)
            table[s0:s0 + rows.numel()] = soft.philox_gauss(key, rows, samples)
        lib = _build.load()
        prng_fn = partial(soft_launch, lib, target, pts, light, num, None, key, None)
        table_fn = partial(soft_launch, lib, target, pts, light, num, None, None, table)
        same = (prng_fn() == table_fn()).float().mean().item()
        ms_p, ms_t = (median(time_frames(fn, iters=20)) for fn in (prng_fn, table_fn))
        read_ms = table.numel() * 4 / roofline.HBM_BYTES_PER_S * 1e3
        scene_bytes = roofline.table_bytes(target) if k == "brute" else roofline.tree_bytes(target)
        b_ms, b_by = roofline.bound_ms(m * num * (roofline.SAMPLE_FLOPS + per_ray),
                                       m * (12 + 4) + 16 + scene_bytes,
                                       m * num * roofline.PHILOX_INT_OPS)
        stage[k] = {"points": m, "prng_ms": ms_p, "table_ms": ms_t, "table_read_ms": read_ms,
                    "counts_agree": same, "bound_ms": b_ms, "rays_per_s": m * num / ms_p * 1e3}
        print(f"    {k} ({label}, {m} points x {num}): PRNG {ms_p:.5f} ms, table {ms_t:.5f} ms "
              f"(its {table.numel() * 4 / 1e9:.2f} GB read at 3.35 TB/s: {read_ms:.5f} ms); the "
              f"sample stage {ms_p - ms_t:.5f} ms; counts agree on {same:.5%} of points; "
              f"{m * num / ms_p / 1e6:.5g} G sample rays/s, bound {b_ms:.5f} ms by {b_by} "
              f"({b_ms / ms_p:.1%} of it)")
        del table
    results["sampler_stage"] = stage

    # The ablations (and the parent) in turns with this tree's kernel, on the
    # inputs phases 18 and 28 time: PRNG on the frame's hit points, table on
    # the subsample; each variant's counts exact against this tree's.
    print("  ablations: ms, median of 20 bare launches, two rounds in opposite orders")
    names = ["this tree", *variants]
    libs = {"this tree": _build.load(), **{k: v[0] for k, v in variants.items()}}
    ab = {}
    for k, (label, target, _) in targets.items():
        _, pos, valid, light, _ = frames[label]
        v8 = valid.to(torch.uint8).contiguous()
        p_sub, g = subsample[label]
        g_nsc = g.permute(1, 0, 2).contiguous()
        for kind, args in (("prng", (pos, light, num, v8, key, None)),
                           ("table", (p_sub, light, num, None, None, g_nsc))):
            calls = {n: partial(soft_launch, libs[n], target, *args) for n in names}
            ref = calls["this tree"]()
            for n, fn in calls.items():
                assert torch.equal(fn(), ref), f"{n}: {k} {kind} counts differ from this tree's"
            times = {n: [] for n in names}
            for order in (names, names[::-1]):
                for n in order:
                    times[n].append(median(time_frames(calls[n], iters=20)))
            ab[(k, kind)] = times
            base = sum(times["this tree"]) / 2
            print(f"    {k} {kind}: this tree {times['this tree'][0]:.5f}, "
                  f"{times['this tree'][1]:.5f}; "
                  + "; ".join(f"{n} {t[0]:.5f}, {t[1]:.5f} (x{sum(t) / 2 / base:.3f})"
                              for n, t in times.items() if n != "this tree"))
    results["sampler_ablations"] = {f"{k} {kind}": t for (k, kind), t in ab.items()}
    if parent:
        rows = {("brute", "prng"): ("soft_prng",), ("brute", "table"): ("soft_table",),
                ("w2", "prng"): ("soft_bvh_prng", "soft_bvh_cone_prng"),
                ("w2", "table"): ("soft_bvh_table", "soft_bvh_cone_table"),
                ("w4", "prng"): ("soft4_prng",), ("w4", "table"): ("soft4_table",),
                ("w8", "prng"): ("soft4_prng_w8",), ("w8", "table"): ("soft4_table_w8",)}
        for key_, names_ in rows.items():
            t = ab[key_]
            for entry in kernels:
                if entry["name"] in names_:
                    entry.update(parent_ms=sum(t["parent"]) / 2, ab_ms=sum(t["this tree"]) / 2)
        # End to end: the spherical frames and steps, a process per tree.
        runs = {"parent": [], "this tree": []}
        for who in ("parent", "this tree", "this tree", "parent"):
            r = subprocess.run([sys.executable, "-c", E2E_SNIPPET], capture_output=True,
                               text=True, cwd=parent if who == "parent" else ROOT, timeout=600)
            assert r.returncode == 0, f"{who}: {r.stderr[-3000:]}"
            runs[who].append(json.loads(r.stdout.strip().splitlines()[-1]))
        for scene in ("spherical_box", "spherical_teacup"):
            for j, what in enumerate(("default-route frame", "full-contract step",
                                      "materials step")):
                vals = {who: [run[scene][j] for run in rs] for who, rs in runs.items()}
                print(f"  {scene} 1024^2 {what}: parent {[round(x, 5) for x in vals['parent']]} "
                      f"ms, this tree {[round(x, 5) for x in vals['this tree']]} ms")
                e2e[f"{scene} {what} parent vs this tree"] = vals
    results["sampler_cull"] = cull_part(device, parent)



# cull_part: the brute sampler's per-point culling measured.  soft.cu is
# rebuilt with its threshold on the samples moved, so that one build culls
# at every S and one at none; each is held exactly to this tree's kernel.
CULL_SAMPLES = (1, 4, 5, 6, 8, 16, 64, 200)
CULL_ORBIT_POSES = 96  # a figure-eight: yaw +-45 deg, pitch +-15 deg about the default camera
CULL_TIMED_POSES = 24  # the first poses' launches timed again, level by level


def cull_threshold() -> int:
    with open(os.path.join(ROOT, CSRC, "soft.cu")) as f:
        text = f.read()
    return int(text.split("constexpr int kCullMinSamples = ")[1].split(";")[0])


def cull_variants() -> dict:
    old = f"kCullMinSamples = {cull_threshold()};"
    bounds = "__launch_bounds__(kSoftThreads) soft_kernel"
    return {"no cull": [("soft.cu", old, "kCullMinSamples = 1 << 30;", 1)],
            "cull always": [("soft.cu", old, "kCullMinSamples = 1;", 1)],
            **{f"culled at {k} blocks an SM": [
                ("soft.cu", bounds, f"__launch_bounds__(kSoftThreads, kCull ? {k} : 1) "
                                    "soft_kernel", 1)] for k in (12, 16)}}


def sass_functions(lib_path: str, pattern: str) -> dict:
    """Mangled name -> its SASS instructions without addresses or encodings,
    for the functions of ``lib_path`` whose name matches ``pattern``."""
    import re

    from cg_raytracer_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            cur = name if re.search(pattern, name) else None
            if cur is not None:
                out[cur] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(.*?);", line)
        if cur is not None and m:
            out[cur].append(m.group(1).strip())
    return out


def cull_part(device, parent=None) -> dict:
    """The brute sampler's culling on the card: registers; the tree
    samplers' SASS against ``parent``'s; on every hit point of the spherical
    box at 1024^2, the Philox counts of this tree, of the builds that cull
    at every S and at none, and of ``parent``'s kernel, bit-equal, and their
    times in turns at each of CULL_SAMPLES; the kept share; and over an orbit
    of eager 800^2 frames every launch of the brute sampler held bit for bit
    to ``parent``'s (else the no-cull build's) on the same inputs."""
    import ctypes
    import math

    import torch

    from cg_raytracer_tpu_torch.models.whitted import render
    from cg_raytracer_tpu_torch.ops import _build
    from cg_raytracer_tpu_torch.ops import cuda_kernels as ck
    from cg_raytracer_tpu_torch.ops import soft
    from cg_raytracer_tpu_torch.ops.camera import generate_rays
    from cg_raytracer_tpu_torch.scene.presets import load_standin
    from cg_raytracer_tpu_torch.scene.types import Camera
    from cg_raytracer_tpu_torch.utils.config import RenderConfig

    phase(f"cull: the brute sampler's per-point culling (kCullMinSamples "
          f"{cull_threshold()})" + (f", against {parent}" if parent else ""))
    t0 = time.perf_counter()
    variants = build_variants("soft.cu", cull_variants(), soft_signatures(), parent,
                              parent_soft_signatures(parent), tag="_cull")
    mark_parent(variants, parent)
    libs = {"this tree": _build.load(), **{k: v[0] for k, v in variants.items()}}
    print(f"  {len(variants)} builds of soft.cu in {time.perf_counter() - t0:.1f} s")
    with open(_build.library_path()[:-3] + ".log") as f:
        logs = {"this tree": f.read(), **{k: v[1] for k, v in variants.items()}}
    for name, log in logs.items():
        for cull in (False, True):
            info = ptxas_soft(log, cull)
            print(f"  ptxas {name}{', culled' if cull else ''}: " + "; ".join(
                f"({'table' if t else 'PRNG'}, W = {w}) {r['regs']} registers, {r['frame']} / "
                f"{r['spill_st']} / {r['spill_ld']} bytes" for (t, w), r in sorted(info.items())))
    result = {"threshold": cull_threshold()}
    if parent:
        mine, theirs = ({soft_instance(k): v for k, v in sass_functions(path, "soft_kernel").items()
                         if soft_instance(k) and soft_instance(k)[1] > 0}
                        for path in (_build.library_path(),
                                     os.path.join(_build.build_dir(), "variants_soft_cull",
                                                  "parent.so")))
        same = {k: mine[k] == theirs.get(k) for k in mine}
        print(f"  tree samplers' SASS equal to the parent's: {same}")
        result["tree_sass_equal"] = all(same.values()) and len(same) == 6
    scene = load_standin("spherical_box", device)
    o, d = generate_rays(Camera.default(device=device), 1024, 1024)
    hit = ck.intersect_cuda(scene, o, d)
    valid = hit.prim_id >= 0
    pos = torch.where(valid[:, None], o + d * torch.where(valid, hit.t, 0.0)[:, None],
                      0.0).contiguous()
    tri = ck._tri_table(scene).detach().contiguous()
    light = soft.light_row(scene.spherical_lights.position[0], scene.spherical_lights.radius[0])
    head, keep = soft._head("cull", pos, light, valid.to(torch.uint8).contiguous(), None)
    key = soft.SampleKey(2026, 20, 0)
    words = soft.device_key(key, device)
    counts = torch.zeros((pos.shape[0],), dtype=torch.int32, device=device)
    tally = torch.zeros((2,), dtype=torch.int64, device=device)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def launch(lib, num, with_tally=False):
        counts.zero_()
        extra = ((ck._ptr(tally) if with_tally else ctypes.c_void_p(0)),) \
            if getattr(lib, "tally", True) else ()
        err = lib.cgrt_soft_brute(*head, ck._ptr(tri), tri.shape[0], int(num), ck._ptr(words),
                                  ctypes.c_uint32(0), ctypes.c_void_p(0), ck._ptr(counts),
                                  *extra, stream)
        assert err == 0, f"CUDA error {err}"
        return counts

    points = int(valid.sum())
    print(f"  {points} hit points of the spherical box at 1024^2; ms a launch (batched, two "
          f"rounds in turns)")
    result["turns"] = {}
    for num in CULL_SAMPLES:
        ref = launch(libs["no cull"], num).clone()
        for n, lib in libs.items():
            assert torch.equal(launch(lib, num), ref), f"S = {num}: {n} counts differ"
        times = in_turns({n: partial(launch, lib, num) for n, lib in libs.items()},
                         iters=max(5, min(40, 2000 // num)))
        tally.zero_()
        launch(libs["this tree"], num, with_tally=True)
        kept, swept = tally.tolist()
        result["turns"][num] = {"ms": times, "kept": kept, "swept": swept}
        print(f"    S = {num}: counts bit-equal across {len(libs)} builds; kept {kept} of "
              f"{swept} tests ({100.0 * kept / swept:.3f}%); {turns_line(times)}")
    del keep

    # An orbit of eager frames: each brute launch against the reference build;
    # the first CULL_TIMED_POSES' launches kept, to be timed level by level.
    ref_name = "parent" if parent else "no cull"
    ref_lib = libs[ref_name]
    seen = {"launches": 0, "points": 0, "differ": 0}
    original = soft._brute_kernel
    kept_launches = []

    def checked(tri_, pos_, light_, num_, valid_, key_=None, gauss_=None):
        got = original(tri_, pos_, light_, num_, valid_, key_, gauss_)
        want = soft_launch(ref_lib, tri_, pos_, light_, num_, valid_, key_, gauss_)
        if seen["launches"] < 2 * CULL_TIMED_POSES:
            kept_launches.append((seen["launches"] % 2, pos_.clone(),
                                  None if valid_ is None else valid_.clone(), num_, key_))
        seen["launches"] += 1
        seen["points"] += int(valid_.sum()) if valid_ is not None else pos_.shape[0]
        seen["differ"] += int((got != want).sum())
        return got

    cfg = RenderConfig(width=800, height=800)
    gen = torch.Generator().manual_seed(20)
    soft.reset_cull_counts()
    soft._brute_kernel = checked
    try:
        for k in range(CULL_ORBIT_POSES):
            a = 2.0 * math.pi * k / CULL_ORBIT_POSES
            cam = Camera.default(euler_deg=(20.0 + 15.0 * math.sin(2.0 * a),
                                            20.0 + 45.0 * math.sin(a), 0.0), device=device)
            render(scene, cam, cfg, generator=gen, jit=False)
        torch.cuda.synchronize()
    finally:
        soft._brute_kernel = original
    kept, swept = soft.cull_counts()
    result["orbit"] = dict(seen, kept=kept, swept=swept, reference=ref_name)
    print(f"  orbit of {CULL_ORBIT_POSES} eager 800^2 frames: {seen['launches']} brute launches, "
          f"{seen['points']} marked points, {seen['differ']} counts differ from {ref_name}'s; "
          f"kept {kept} of {swept} tests ({100.0 * kept / max(swept, 1):.3f}%)")
    assert seen["launches"] > 0 and seen["differ"] == 0

    # The kept launches, level by level, each build in turns (events around
    # all of a level's launches; each launch's compaction done beforehand).
    for level in (0, 1):
        prepared = []
        for lv, pos_, valid_, num_, key_ in kept_launches:
            if lv == level:
                head_, keep_ = soft._head("cull", pos_, light, valid_, None)
                prepared.append((head_, keep_, soft.device_key(key_, device), num_, key_.offset,
                                 pos_.shape[0] if valid_ is None else int(valid_.sum())))

        def level_launches(lib, with_tally=False):
            for head_, _k, words_, num_, offset_, _n in prepared:
                counts.zero_()
                extra = ((ck._ptr(tally) if with_tally else ctypes.c_void_p(0)),) \
                    if getattr(lib, "tally", True) else ()
                err = lib.cgrt_soft_brute(*head_, ck._ptr(tri), tri.shape[0], int(num_),
                                          ck._ptr(words_), ctypes.c_uint32(offset_ & 0xFFFFFFFF),
                                          ctypes.c_void_p(0), ck._ptr(counts), *extra, stream)
                assert err == 0, f"CUDA error {err}"

        calls = {"this tree": partial(level_launches, libs["this tree"], True),
                 **{n: partial(level_launches, lib) for n, lib in libs.items()
                    if n != "this tree"},
                 "this tree, no tally": partial(level_launches, libs["this tree"])}
        times = {n: [] for n in calls}
        for order in (list(calls), list(calls)[::-1]):
            for n in order:
                torch.cuda.synchronize()
                a0, a1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a0.record()
                calls[n]()
                a1.record()
                torch.cuda.synchronize()
                times[n].append(a0.elapsed_time(a1) / max(len(prepared), 1))
        marked = sum(p[5] for p in prepared) / max(len(prepared), 1)
        result[f"orbit_level_{level + 1}"] = {"ms": times, "marked": marked}
        print(f"  orbit level {level + 1}, {len(prepared)} launches of {marked:.0f} marked points "
              f"on average, ms a launch (events, two rounds in turns): {turns_line(times)}")
    return result


_SHARED_STACK = """
// (chip_smoke.py phase 30's variant) the walks' node stack in shared memory,
// [entry][thread]; the closest walk's entry t stay in local memory.
__shared__ int g_walk_stack[kStack][128];
struct SharedStack {
  __device__ __forceinline__ int& operator[](int k) { return g_walk_stack[k][threadIdx.x]; }
};
"""
_CLOSEST_PUSH = """          tstack[sp] = ts[c];
          ++sp;
        }
      }
"""
# Phase 30's variants of the walk: each takes one lever of the design out
# again, or tries on one walk a lever the other takes (the parent's kernel
# has none of them), or another block size or a register cap.
WALK_ABLATIONS = {
    "min/max by compares": [_MINMAX_COMPARES],
    "any hit: full Moller-Trumbore": [_MT_FULL],
    "any hit: nearest child pushed": [("bvh4.cuh", "for (int c = 0; c < W - 1; ++c) {",
                                       "for (int c = 0; c < W; ++c) {", 1),
                                      ("bvh4.cuh", "if (ts[W - 1] < kBig) {", "if (false) {", 1)],
    "closest: nearest child walked at once": [
        ("bvh4.cuh", "      for (int c = 0; c < W; ++c) {\n        if (ts[c] < kBig) {\n"
                     "          stack[sp] = es[c];\n          tstack",
         "      for (int c = 0; c < W - 1; ++c) {\n        if (ts[c] < kBig) {\n"
         "          stack[sp] = es[c];\n          tstack", 1),
        ("bvh4.cuh", _CLOSEST_PUSH, _CLOSEST_PUSH + "      if (ts[W - 1] < kBig) {\n"
                                                   "        ref = es[W - 1];\n"
                                                   "        continue;\n      }\n", 1)],
    "closest: early-exit Moller-Trumbore": [
        ("bvh4.cuh", "if (mt(v0, e1, e2, r, t, uu, vv) && t < t_best) {",
         "if (mt_early(v0, e1, e2, r, t_best, t, uu, vv)) {", 1)],
    "stack in shared memory": [("bvh4.cuh", "  int stack[kStack];\n", "  SharedStack stack;\n", 2),
                               ("bvh4.cuh", "constexpr float kBig = 3.4e38f;\n",
                                "constexpr float kBig = 3.4e38f;\n" + _SHARED_STACK, 1)],
    "64 threads per block": [("bvh4.cu", "kWalkThreads = 128;", "kWalkThreads = 64;", 1)],
    "256 threads per block": [("bvh4.cu", "kWalkThreads = 128;", "kWalkThreads = 256;", 1)],
    "40-register cap": [("bvh4.cu", "__launch_bounds__(kWalkThreads)",
                         "__launch_bounds__(kWalkThreads, 12)", 2)],
}
_PAYLOAD_VEC = """// (chip_smoke.py phase 30's variant) the 18 payload floats with sm_90's
// 16-byte atomicAdd from the first 16-byte boundary of the row on.
template <int P>
__device__ __forceinline__ void add_payload_at(float* dst, const float* v) {
#pragma unroll
  for (int k = 0; k < P; ++k) atomicAdd(dst + k, v[k]);
#pragma unroll
  for (int k = P; k + 4 <= 18; k += 4) {
    atomicAdd(reinterpret_cast<float4*>(dst + k), make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]));
  }
#pragma unroll
  for (int k = P + (18 - P) / 4 * 4; k < 18; ++k) atomicAdd(dst + k, v[k]);
}

__device__ __forceinline__ void add_payload_vec(float* dst, const float* v) {
  switch ((4u - (reinterpret_cast<uintptr_t>(dst) >> 2) % 4u) % 4u) {
    case 0: add_payload_at<0>(dst, v); break;
    case 1: add_payload_at<1>(dst, v); break;
    case 2: add_payload_at<2>(dst, v); break;
    default: add_payload_at<3>(dst, v); break;
  }
}

"""
_ROW_GROUP = "  return group_of(__match_any_sync(kFullWarp, live ? key : -1));"
# Phase 30's variants of the shade backward: the warp aggregation taken out
# (every lane adds its own values, as the parent did), a warp adding lane by
# lane past a number of distinct surface rows, and vector atomics for the
# pregathered payload rows.
SHADE_ABLATIONS = {
    "per-lane atomics": [("shade.cu", _ROW_GROUP, "  return group_of(lane_bit());", 1),
                         ("shade.cu", "  const Group g = group_of(mask);",
                          "  const Group g = group_of(lane_bit());", 1)],
    **{f"lane by lane past {k} rows": [
        ("shade.cu", _ROW_GROUP,
         "  const unsigned same = __match_any_sync(kFullWarp, live ? key : -1);\n"
         "  const bool lead = (same & (lane_bit() - 1u)) == 0u;\n"
         "  const int rows = __popc(__ballot_sync(kFullWarp, live && lead));\n"
         f"  return group_of(rows <= {k} ? same : lane_bit());", 1)] for k in (4, 16)},
    "float4 atomics on d_payload": [
        ("shade.cu", "add_row<18>(g.d_payload + 19 * f.row, gs);",
         "add_payload_vec(g.d_payload + 19 * f.row, gs);", 1),
        ("shade.cu", "template <bool kPre>\n__global__ void __launch_bounds__(kThreads) "
                     "shade_bwd_kernel", _PAYLOAD_VEC + "template <bool kPre>\n__global__ void "
                     "__launch_bounds__(kThreads) shade_bwd_kernel", 1)],
}
WALK_E2E_SNIPPET = """
import dataclasses, json, sys, torch
sys.path.insert(0, ".")
from cg_raytracer_tpu_torch.models.whitted import (build_accel, effective_max_depth, needs_bvh,
                                                   resolve_fwd_shade_kernel)
from cg_raytracer_tpu_torch.scene.presets import load_scene, load_standin
from cg_raytracer_tpu_torch.scene.types import Camera
from cg_raytracer_tpu_torch.utils import bench
from cg_raytracer_tpu_torch.utils.bench import run_bench
from cg_raytracer_tpu_torch.utils.config import RenderConfig
from cg_raytracer_tpu_torch.utils.profiling import device_breakdown
ms = lambda r: r["seconds_per_frame"] * 1e3
out = {"mirror_box materials step": ms(run_bench("mirror_box", include_bwd=True, iters=10)),
       "mirror_box forward-only frame": ms(run_bench("mirror_box", iters=10,
                                                    cfg_overrides={"forward_only": True}))}
for name in ("mirror_box", "teacup", "donut"):
    if name != "mirror_box":
        out[name + " frame"] = ms(run_bench(name, iters=5, cfg_overrides={"forward_only": False}))
    out[name + " full step"] = ms(run_bench(name, include_bwd=True, include_vertex_params=True,
                                            iters=5))
    # The same step under the profiler: the card's time and its busy share.
    scn = (load_standin(name, device="cuda") if name == "mirror_box"
           else load_scene(name, device="cuda"))
    cfg = RenderConfig(width=1024, height=1024, forward_only=False)
    cfg = resolve_fwd_shade_kernel(scn, dataclasses.replace(
        cfg, max_depth=effective_max_depth(scn, cfg)))
    accel = (build_accel(scn, cfg) if needs_bvh(cfg, scn.num_triangles, torch.device("cuda"))
             else None)
    cfg = bench.training_config(cfg, True)
    params = bench.training_params(scn, True)
    jitter = bench.camera_jitter(torch.Generator("cuda").manual_seed(9), "cuda")
    prof = device_breakdown(lambda: bench.fwd_bwd_step(scn, Camera.default(device="cuda"), cfg,
                                                       params, jitter, accel=accel), iters=5)
    out[name + " full step device ms"] = prof["device_ms"]
    out[name + " full step busy"] = prof["busy"]
print(json.dumps(out))
"""


def walk_signatures(old: bool = False):
    """The walk's entry points' argtypes (``old``: a parent from before the
    packed node records, which took boxes, meta, nchild and tris where this
    tree takes the records)."""
    import ctypes

    p, i = ctypes.c_void_p, ctypes.c_int
    tree = [p] * (5 if old else 3)
    return {"cgrt_bvh4_closest": [p, p, p, i, i, *tree, p, p, p, p, p],
            "cgrt_bvh4_anyhit": [p, p, p, i, i, *tree, p, p],
            "cgrt_bvh4_bounce": [p, p, p, i, i, *tree, p, i, p, p, p, p, p, p]}


def shade_signatures():
    import ctypes

    p, i = ctypes.c_void_p, ctypes.c_int
    return {"cgrt_shade_bwd": [p, p, p, p, i, p, p, i, i, p, i, p, i, p, i, p] + [p] * 12,
            "cgrt_shade_pre_bwd": [p, p, p, p, i, p, i, p, i, p, i, p, i, p, i, p] + [p] * 12}


def walk_launch(lib, old, kind, tree, o, d, tm, lights):
    """One launch of ``lib``'s walk ``kind`` ('closest', 'anyhit', 'bounce')
    -> its outputs (t, prim, u, v[, bits]) or (hit,)."""
    import ctypes

    import torch

    from cg_raytracer_tpu_torch.ops import cuda_kernels as ck

    n, dev = o.shape[0], o.device
    f32 = lambda: torch.empty((n,), dtype=torch.float32, device=dev)  # noqa: E731
    i32 = lambda: torch.empty((n,), dtype=torch.int32, device=dev)  # noqa: E731
    tr = ((tree.boxes, tree.meta, tree.nchild, tree.tris) if old else (tree.nodes, tree.rows))
    head = (ck._ptr(o), ck._ptr(d), ck._ptr(tm), n, tree.width, *(ck._ptr(x) for x in tr),
            ck._ptr(tree.slot_to_prim))
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    if kind == "anyhit":
        outs = (torch.empty((n,), dtype=torch.uint8, device=dev),)
        err = lib.cgrt_bvh4_anyhit(*head, ck._ptr(outs[0]), stream)
    elif kind == "closest":
        outs = (f32(), i32(), f32(), f32())
        err = lib.cgrt_bvh4_closest(*head, *(ck._ptr(x) for x in outs), stream)
    else:
        outs = (f32(), i32(), f32(), f32(), i32())
        err = lib.cgrt_bvh4_bounce(*head, ck._ptr(lights), lights.shape[0],
                                   *(ck._ptr(x) for x in outs), stream)
    assert err == 0, f"walk variant {kind}: CUDA error {err}"
    return outs


def shade_bwd_launch(lib, pre, tables, o, d, prim, bits, cts):
    """One launch of ``lib``'s shade backward (point lights only) -> (d
    tables..., d_o, d_d, d_sph), as ``shade_bwd_cuda`` / ``shade_pre_bwd_cuda``
    return them."""
    import ctypes

    import torch

    from cg_raytracer_tpu_torch.ops import cuda_kernels as ck

    n = o.shape[0]
    sph = torch.zeros((0, 6), dtype=torch.float32, device=o.device)
    fracs = torch.zeros((0, n), dtype=torch.float32, device=o.device)
    d_tables = [torch.zeros_like(x) for x in tables]
    d_o, d_d, d_sph = torch.empty_like(o), torch.empty_like(d), torch.zeros_like(sph)
    t0, t1, lights, spheres = tables
    head = (ck._ptr(o), ck._ptr(d), ck._ptr(prim), ck._ptr(bits), n)
    if pre:
        head += (ck._ptr(t0), t0.shape[0], ck._ptr(t1), t1.shape[0])
    else:
        head += (ck._ptr(t0), ck._ptr(t1), t0.shape[0], t0.shape[0])
    args = (*head, ck._ptr(lights), lights.shape[0], ck._ptr(spheres), spheres.shape[0],
            ck._ptr(sph), 0, ck._ptr(fracs), *(ck._ptr(c) for c in cts), ck._ptr(d_o),
            ck._ptr(d_d), *(ck._ptr(x) for x in d_tables), ck._ptr(d_sph),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    err = (lib.cgrt_shade_pre_bwd if pre else lib.cgrt_shade_bwd)(*args)
    assert err == 0, f"shade variant: CUDA error {err}"
    return (*d_tables, d_o, d_d, d_sph)


def ptxas_kernels(log: str, patterns) -> dict:
    """label -> registers, stack frame and spill bytes of the entry functions
    of a ``-Xptxas=-v`` log whose mangled names match one of ``patterns``
    ((regex, label function of its groups), ...)."""
    import re

    info, cur = {}, None
    for line in log.splitlines():
        if "Function properties for" in line or "Compiling entry function" in line:
            cur = None
            for pat, label in patterns:
                m = re.search(pat, line)
                if m:
                    cur = label(*m.groups())
                    info.setdefault(cur, {})
                    break
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            info[cur].update(frame=int(m.group(1)), spill_st=int(m.group(2)),
                             spill_ld=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            info[cur]["regs"] = int(m.group(1))
    return info


WALK_PTXAS = ((r"bvh_kernelILi(\d)ELb([01])E",
               lambda w, a: f"{'any hit' if a == '1' else 'closest'}, W = {w}"),
              (r"bvh_bounce_kernelILi(\d)E", lambda w: f"bounce, W = {w}"),
              (r"shade_bwd_kernelILb([01])E",
               lambda p: f"shade backward, {'pregathered' if p == '1' else 'select'}"))
# (scene, width) -> the rows of PERF.md's table that the case stands for: the
# kernels JSON entry names of its closest (with any hit) and bounce walks.
WALK_ROWS = {("teacup", 2): ("bvh_w2", "bvh_bounce_w2"), ("teacup", 4): ("bvh4", "bvh4_bounce"),
             ("teacup", 8): ("bvh4_w8", "bvh4_bounce_w8"),
             ("donut", 2): ("bvh_w2_large", "bvh_bounce_w2_large"),
             ("donut", 4): ("bvh4_large", "bvh4_bounce_large"),
             ("torus", 2): (None, None), ("torus", 4): (None, None)}


SLEEP_CYCLES = 40_000_000  # ~20 ms of torch.cuda._sleep on an H100's ~2 GHz SM clock


def batched_ms(fn, iters=20) -> float:
    """Device ms per call of ``fn``: CUDA events around ``iters`` calls that
    the host enqueues while a sleep kernel holds the card, so they run back
    to back and the host's per-call overhead (allocation, ctypes; as long as
    a ~0.1-0.3 ms launch) stays out of the time.  Asserts that the host
    finished enqueueing before the card did."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sleep_ms = _sleep_ms()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    assert host_ms < sleep_ms, (f"the host took {host_ms:.2f} ms to enqueue {iters} calls, "
                                f"past the {sleep_ms:.2f}-ms sleep; raise SLEEP_CYCLES")
    return start.elapsed_time(end) / iters


_SLEEP = {}


def _sleep_ms() -> float:
    """How long SLEEP_CYCLES of torch.cuda._sleep hold the card (measured once)."""
    import torch

    if "ms" not in _SLEEP:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        b.record()
        torch.cuda.synchronize()
        _SLEEP["ms"] = a.elapsed_time(b)
    return _SLEEP["ms"]


def in_turns(calls, iters=20):
    """name -> [device ms per call (batched_ms) of each call], two rounds in
    opposite orders after an untimed one."""
    names = list(calls)
    for n in names:
        batched_ms(calls[n], iters=5)
    times = {n: [] for n in names}
    for order in (names, names[::-1]):
        for n in order:
            times[n].append(batched_ms(calls[n], iters=iters))
    return times


def turns_line(times, base="this tree") -> str:
    b = sum(times[base]) / 2
    return f"{base} {times[base][0]:.5f}, {times[base][1]:.5f}; " + "; ".join(
        f"{n} {t[0]:.5f}, {t[1]:.5f} (x{sum(t) / 2 / b:.3f})" for n, t in times.items()
        if n != base)


def walk_shade_phase(out, device, kernels, e2e, results, scenes, parent=None) -> None:
    """Phase 30: the shade backward and the walk measured.  ptxas for each
    instantiation; this tree's csrc/bvh4.cu and shade.cu against each lever
    taken out again and, given ``parent``, that checkout's, in turns on the
    same inputs (every walk exact against this tree's, every shade backward's
    d_o and d_d bit-equal to it and its tables within checks' rule); each
    row's time against its bound; and, given ``parent``, the headline
    frames and steps in a process per tree, three pairs in alternating order."""
    import torch

    from cg_raytracer_tpu_torch.ops import _build
    from cg_raytracer_tpu_torch.ops import bvh4 as b4
    from cg_raytracer_tpu_torch.ops import cuda_kernels as ck
    from cg_raytracer_tpu_torch.ops import shade
    from cg_raytracer_tpu_torch.ops.camera import generate_rays
    from cg_raytracer_tpu_torch.ops.intersect import reconstruct_hit
    from cg_raytracer_tpu_torch.ops.linalg import norm, safe_normalize
    from cg_raytracer_tpu_torch.scene.types import Camera
    from cg_raytracer_tpu_torch.utils import checks

    phase("phase 30: the shade backward and the walk measured: registers, ablations"
          + (f", against {parent}" if parent else ""))
    t0 = time.perf_counter()
    # A parent from before the packed records takes the tree's arrays.
    old = parent is not None and "const float* boxes" in open(
        os.path.join(parent, CSRC, "bvh4.cu")).read()
    walk_vars = build_variants("bvh4.cu", WALK_ABLATIONS, walk_signatures(), parent,
                               walk_signatures(old=old))
    shade_vars = build_variants("shade.cu", SHADE_ABLATIONS, shade_signatures(), parent)
    print(f"  {len(walk_vars)} variants of bvh4.cu and {len(shade_vars)} of shade.cu built in "
          f"{time.perf_counter() - t0:.1f} s")
    with open(_build.library_path()[:-3] + ".log") as f:
        logs = {"this tree": f.read()}
    print("  ptxas, per instantiation: registers, stack frame / spill store / spill load bytes")
    for name in ("this tree", *(["parent"] if parent else [])):
        log = logs["this tree"] if name == "this tree" else (walk_vars["parent"][1]
                                                            + shade_vars["parent"][1])
        for label, r in sorted(ptxas_kernels(log, WALK_PTXAS).items()):
            print(f"    {name}: {label}: {r.get('regs')} registers, {r.get('frame')} / "
                  f"{r.get('spill_st')} / {r.get('spill_ld')} bytes")
    lib = _build.load()

    # The walk on the 1024^2 camera rays (closest), shadow rays toward light 0
    # from their hits with a random t_max (any hit), and the camera rays with
    # every fifth one dead (bounce).
    cam = Camera.default(device=device)
    gen = torch.Generator(device).manual_seed(30)
    o1, d1 = generate_rays(cam, 1024, 1024)
    trees = scenes["walk_trees"]
    libs = {"this tree": (lib, False),
            **{k: (v[0], k == "parent" and old) for k, v in walk_vars.items()}}
    walk_t = {}
    print(f"  the walk: device ms per launch, 20 launches enqueued behind a "
          f"{_sleep_ms():.1f}-ms sleep kernel (batched_ms), two rounds in opposite orders; "
          "every variant's outputs equal to this tree's")
    for (label, w), rows in WALK_ROWS.items():
        scene = scenes[label] if label != "torus" else scenes["torus"][0]
        tree = trees[(label, w)]
        lp = scene.point_lights.position.contiguous()
        surf = reconstruct_hit(scene, o1, d1, b4._closest_kernel(tree, o1, d1, None))
        to_light = lp[0] - surf.position
        sd = safe_normalize(to_light).contiguous()
        so = (surf.position + 1e-3 * sd).contiguous()
        st = torch.where(surf.valid, norm(to_light) - 1e-3, -1.0)
        st = (st * torch.rand(st.shape, device=device, generator=gen) * 1.5).contiguous()
        tml = torch.where(torch.arange(o1.shape[0], device=device) % 5 != 0, float("inf"),
                          -1.0).contiguous()
        for kind, args in (("closest", (o1, d1, None)), ("anyhit", (so, sd, st)),
                           ("bounce", (o1, d1, tml))):
            calls = {n: partial(walk_launch, lb, old, kind, tree, *args, lp)
                     for n, (lb, old) in libs.items()}
            ref = calls["this tree"]()
            for n, fn in calls.items():
                assert all(torch.equal(a, b) for a, b in zip(fn(), ref)), (
                    f"{n}: {label} W = {w} {kind} differs from this tree's")
            times = in_turns(calls)
            walk_t[(label, w, kind)] = times
            print(f"    {label} W = {w} {kind}: {turns_line(times)}")
    results["walk_ablations"] = {f"{k[0]} w{k[1]} {k[2]}": t for k, t in walk_t.items()}
    by_name = {e["name"]: e for e in kernels}
    print("  each row's time in these turns against its bound (the entry's, utils/roofline.py)")
    for (label, w), (closest_row, bounce_row) in WALK_ROWS.items():
        for row, kinds in ((closest_row, ("closest", "anyhit")), (bounce_row, ("bounce",))):
            if row is None or row not in by_name:
                continue
            e = by_name[row]
            for kind in kinds:
                t = walk_t[(label, w, kind)]
                ms = sum(t["this tree"]) / 2
                bound = e["anyhit_bound_ms"] if kind == "anyhit" else e["bound_ms"]
                pre = "anyhit_" if kind == "anyhit" else ""
                e[pre + "ab_ms"] = ms
                if parent:
                    e[pre + "parent_ms"] = sum(t["parent"]) / 2
                print(f"    {row} ({label}, W = {w}, {kind}): {ms:.5f} ms"
                      + (f", parent {sum(t['parent']) / 2:.5f}" if parent else "")
                      + f"; bound {bound:.5f} ms ({bound / ms:.1%} of it)")

    # The shade backward on the stand-in box's level-0 records (select path,
    # row 25) and the teacup's (pregathered, row 26).
    box, teacup = scenes["box"], scenes["teacup"]
    recs = ck.record_trace_cuda(box, o1, d1, 2)
    bo, bd, bhit, bbits, _ = recs[0]
    hit, tbits = b4.bounce_bvh4_cuda(teacup, trees[("teacup", 4)], o1, d1)
    cases = {
        "box": (False, tuple(x.detach().contiguous() for x in shade._shade_tables(box)[:4]),
                bo.contiguous(), bd.contiguous(), bhit.prim_id.contiguous(), bbits,
                box.num_triangles, "shade_bwd"),
        "teacup": (True, tuple(x.detach().contiguous() for x in shade._pre_tables(teacup)[:4]),
                   o1, d1, hit.prim_id.contiguous(), tbits, teacup.num_triangles,
                   "shade_pre_bwd"),
    }
    libs = {"this tree": lib, **{k: v[0] for k, v in shade_vars.items()}}
    print("  the shade backward: device ms per launch (batched_ms, the tables' zeroing "
          "included), two rounds in opposite orders; d_o and d_d bit-equal to this tree's, "
          "tables within utils/checks.py's rule")
    shade_t = {}
    for label, (pre, tables, o, d, prim, bits, num_t, row) in cases.items():
        cts = [torch.randn(o.shape, device=device, generator=gen) for _ in range(4)]
        twin, exact = checks.twin_grads(tables, o, d, prim, bits, num_t, cts,
                                        plain=shade.shade_plain_pre if pre else shade.shade_plain)
        names = checks.PRE_GRAD_NAMES if pre else checks.GRAD_NAMES
        calls = {n: partial(shade_bwd_launch, lb, pre, tables, o, d, prim, bits, cts)
                 for n, lb in libs.items()}
        ref = calls["this tree"]()
        for n, fn in calls.items():
            got = fn()
            assert torch.equal(got[4], ref[4]) and torch.equal(got[5], ref[5]), (
                f"{n}: {label} d_o or d_d differs from this tree's")
            report = checks.shade_grads_close(got, twin, exact, o.shape[0], names=names)
            if n in ("this tree", "parent"):
                print(f"    {n} {label}: d_o, d_d bit-equal; tables at most "
                      f"{max(r[0] for r in report.values()):.3g} of the tolerance")
        times = in_turns(calls)
        shade_t[label] = times
        print(f"    {label} ({row}, {int((prim >= 0).sum())} live rays): {turns_line(times)}")
        if row in by_name:
            e, ms = by_name[row], sum(times["this tree"]) / 2
            e["ab_ms"] = ms
            if parent:
                e["parent_ms"] = sum(times["parent"]) / 2
            print(f"    {row}: {ms:.5f} ms; bound {e['bound_ms']:.5f} ms "
                  f"({e['bound_ms'] / ms:.1%} of it)")
    results["shade_ablations"] = shade_t
    if parent:
        runs = {"parent": [], "this tree": []}
        for who in ("parent", "this tree", "this tree", "parent", "parent", "this tree"):
            r = subprocess.run([sys.executable, "-c", WALK_E2E_SNIPPET], capture_output=True,
                               text=True, cwd=parent if who == "parent" else ROOT, timeout=600)
            assert r.returncode == 0, f"{who}: {r.stderr[-3000:]}"
            runs[who].append(json.loads(r.stdout.strip().splitlines()[-1]))
        for key in runs["parent"][0]:
            vals = {who: [run[key] for run in rs] for who, rs in runs.items()}
            print(f"  {key} (1024^2): parent {[round(x, 5) for x in vals['parent']]}, this "
                  f"tree {[round(x, 5) for x in vals['this tree']]}")
            e2e[f"{key} parent vs this tree"] = vals


# Phase 31's variants of the brute sweep (csrc/sweep.cuh, built into
# oracle.cu, trace.cu and record.cu): each takes one lever of the design out
# again (the parent's kernels have none of them), or tries the closest sweep
# first written for this card (four full tests in flight), u's sign before
# the reciprocal, a one-wave grid or another block size.
_STAGE_ROWS3 = """    s_rows[3 * k] = make_float4(r[0], r[1], r[2], 0.0f);
    s_rows[3 * k + 1] = make_float4(r[3] - r[0], r[4] - r[1], r[5] - r[2], 0.0f);
    s_rows[3 * k + 2] = make_float4(r[6] - r[0], r[7] - r[1], r[8] - r[2], 0.0f);
"""
_STAGE_NINE = """    float* s = reinterpret_cast<float*>(s_rows) + 9 * k;
    s[0] = r[0];
    s[1] = r[1];
    s[2] = r[2];
    s[3] = r[3] - r[0];
    s[4] = r[4] - r[1];
    s[5] = r[5] - r[2];
    s[6] = r[6] - r[0];
    s[7] = r[7] - r[1];
    s[8] = r[8] - r[2];
"""
_TRI_ROWS = """  v0 = s_tri[3 * k];
  e1 = s_tri[3 * k + 1];
  e2 = s_tri[3 * k + 2];
"""
_TRI_NINE = """  const float* t = reinterpret_cast<const float*>(s_tri) + 9 * k;
  v0 = make_float4(t[0], t[1], t[2], 0.0f);
  e1 = make_float4(t[3], t[4], t[5], 0.0f);
  e2 = make_float4(t[6], t[7], t[8], 0.0f);
"""
_WAVE_BLOCKS = """// (chip_smoke.py phase 31's variant) one wave of blocks striding over the rays.
template <class K>
__host__ int wave_blocks(K kernel, int n, size_t smem) {
  int blocks = num_blocks(n);
  wave_grid(kernel, n, smem, blocks);
  return blocks;
}

"""
_CLOSEST_TEST = "    if (mt_early(v0, e1, e2, r, t_best, t, u, v)) {\n"
_CLOSEST_LOOP = """#pragma unroll 1
  for (int k = 0; k < num_tris; ++k) {
    float4 v0, e1, e2;
    tri_rows(s_tri, k, v0, e1, e2);
    float t, u, v;
""" + _CLOSEST_TEST + """      t_best = t;
      slot = k;
      u_best = u;
      v_best = v;
    }
  }
"""
# The closest sweep first written for this card: four full tests, then
# their selects in index order.
_CLOSEST_UNROLLED = """  int k = 0;
#pragma unroll 1
  for (; k + 4 <= num_tris; k += 4) {
    float t[4], u[4], v[4];
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float4 v0, e1, e2;
      tri_rows(s_tri, k + j, v0, e1, e2);
      ok[j] = mt(v0, e1, e2, r, t[j], u[j], v[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (ok[j] && t[j] < t_best) {
        t_best = t[j];
        slot = k + j;
        u_best = u[j];
        v_best = v[j];
      }
    }
  }
#pragma unroll 1
  for (; k < num_tris; ++k) {
    float4 v0, e1, e2;
    tri_rows(s_tri, k, v0, e1, e2);
    float t, u, v;
    if (mt(v0, e1, e2, r, t, u, v) && t < t_best) {
      t_best = t;
      slot = k;
      u_best = u;
      v_best = v;
    }
  }
"""
_U_BEFORE_RCP = """  const float inv_det = 1.0f / det;
  const float tx = r.ox - v0.x, ty = r.oy - v0.y, tz = r.oz - v0.z;
  u = (tx * px + ty * py + tz * pz) * inv_det;
"""
# u's numerator against det before the reciprocal: where their signs differ
# and |un| > 2 kBaryEps |det|, u = un * (1 / det) < -kBaryEps after any
# rounding, so the test can stop without dividing (same outputs).
_U_SIGN_FIRST = """  const float tx = r.ox - v0.x, ty = r.oy - v0.y, tz = r.oz - v0.z;
  const float un = tx * px + ty * py + tz * pz;
  if ((un < 0.0f) != (det < 0.0f) && fabsf(un) > 2.0f * kBaryEps * fabsf(det)) return false;
  const float inv_det = 1.0f / det;
  u = un * inv_det;
"""
SWEEP_ABLATIONS = {
    "9-float rows": [("sweep.cuh", _STAGE_ROWS3, _STAGE_NINE, 1),
                     ("sweep.cuh", _TRI_ROWS, _TRI_NINE, 1)],
    "any hit: full Moller-Trumbore": [_MT_FULL],
    "closest: full Moller-Trumbore": [
        ("sweep.cuh", _CLOSEST_TEST, "    if (mt(v0, e1, e2, r, t, u, v) && t < t_best) {\n", 1)],
    "closest: full, unrolled by 4": [("sweep.cuh", _CLOSEST_LOOP, _CLOSEST_UNROLLED, 1)],
    "u's sign before 1/det": [("sweep.cuh", _U_BEFORE_RCP, _U_SIGN_FIRST, 1)],
    "one wave of blocks": [
        ("sweep.cuh", "}  // namespace cgrt\n", _WAVE_BLOCKS + "}  // namespace cgrt\n", 1),
        ("oracle.cu", "oracle_kernel<M><<<num_blocks(n),",
         "oracle_kernel<M><<<wave_blocks(oracle_kernel<M>, n, smem),", 1),
        *(("record.cu" if k != "trace" else "trace.cu", f"cgrt::{k}_kernel<<<cgrt::num_blocks(n),",
           f"cgrt::{k}_kernel<<<cgrt::wave_blocks(cgrt::{k}_kernel, n, smem),", 1)
          for k in ("trace", "record_trace", "bounce_refl"))],
    "64 threads per block": [("sweep.cuh", "constexpr int kThreads = 128;",
                              "constexpr int kThreads = 64;", 1)],
    "256 threads per block": [("sweep.cuh", "constexpr int kThreads = 128;",
                               "constexpr int kThreads = 256;", 1)],
}
SWEEP_SOURCES = ("oracle.cu", "trace.cu", "record.cu")
SWEEP_PTXAS = ((r"13oracle_kernelIL\w*ModeE(\d)E",
                lambda m: ("closest", "any hit", "bounce")[int(m)]),
               (r"12trace_kernel", lambda: "trace"),
               (r"19record_trace_kernel", lambda: "record trace"),
               (r"18bounce_refl_kernel", lambda: "bounce-refl"))
# The six kernels: the entry names of their rows in the kernels JSON line.
SWEEP_ROWS = {"closest": "closest", "anyhit": "anyhit", "bounce": "bounce", "trace": "trace",
              "record": "record_trace", "bounce_refl": "bounce_refl"}


def sweep_launch(lib, kind, tables, o, d, tm):
    """One launch of ``lib``'s brute kernel ``kind`` (a key of SWEEP_ROWS;
    trace and record at depth 2) on ``tables`` (tri [T, 9], aux [T, 19],
    light positions [L, 3], light rows [L, 6], spheres [S, 11]) -> its
    outputs."""
    import ctypes

    import torch

    from cg_raytracer_tpu_torch.ops import cuda_kernels as ck

    tri, aux, lpos, lrows, sph = tables
    n, dev = o.shape[0], o.device
    p = ck._ptr
    f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
    i32 = lambda *s: torch.empty(s, dtype=torch.int32, device=dev)  # noqa: E731
    u8 = lambda *s: torch.empty(s, dtype=torch.uint8, device=dev)  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    T, L = tri.shape[0], lpos.shape[0]
    if kind == "closest":
        outs = (f32(n), i32(n), f32(n), f32(n))
        err = lib.cgrt_closest(p(o), p(d), p(tm), n, p(tri), T, *map(p, outs), stream)
    elif kind == "anyhit":
        outs = (u8(n),)
        err = lib.cgrt_anyhit(p(o), p(d), p(tm), n, p(tri), T, p(outs[0]), stream)
    elif kind == "bounce":
        outs = (f32(n), i32(n), f32(n), f32(n), i32(n))
        err = lib.cgrt_bounce(p(o), p(d), p(tm), n, p(tri), T, p(lpos), L, *map(p, outs),
                              stream)
    elif kind == "trace":
        outs = (f32(n, 3),)
        err = lib.cgrt_trace(p(o), p(d), n, p(tri), T, p(aux), p(sph), sph.shape[0], p(lrows),
                             L, 2, 0, p(outs[0]), stream)
    elif kind == "record":
        outs = (f32(2, n), i32(2, n), f32(2, n), f32(2, n), i32(2, n), f32(1, n, 3),
                f32(1, n, 3), u8(1, n))
        err = lib.cgrt_record_trace(p(o), p(d), n, p(tri), T, p(aux), p(lpos), L, 2, 0,
                                    *map(p, outs), stream)
    else:
        outs = (f32(n), i32(n), f32(n), f32(n), i32(n), f32(n, 3), f32(n, 3), u8(n))
        err = lib.cgrt_bounce_refl(p(o), p(d), p(tm), n, p(tri), T, p(aux), p(lpos), L, 0,
                                   *map(p, outs), stream)
    assert err == 0, f"sweep variant {kind}: CUDA error {err}"
    return outs


def same_bits(a, b) -> bool:
    """Equal bit for bit (floats compared as their int32 words)."""
    import torch

    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def sass_sweep(lib_path: str, patterns):
    """label -> SASS counts of the kernels matching ``patterns`` (ptxas_kernels'
    form): the whole kernel's, and each sweep loop's, one triangle test per
    iteration (a backward branch whose body holds one reciprocal, the test's
    MUFU.RCP, and its three or more shared loads).  None without cuobjdump."""
    import re

    from cg_raytracer_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = None
            for pat, label in patterns:
                m = re.search(pat, line)
                if m:
                    cur = label(*m.groups())
                    funcs[cur] = []
                    break
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)(.*?);",
                      line)
        if cur is not None and m and m.group(2) != "NOP":
            funcs[cur].append((int(m.group(1), 16), m.group(2), m.group(3)))

    def counts(ins):
        return {"total": len(ins), "LDS": sum(op.startswith("LDS") for _, op, _ in ins),
                "LDS.128": sum(op.startswith("LDS.128") for _, op, _ in ins),
                "float": sum(op.startswith(("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX",
                                            "MUFU", "FCHK")) for _, op, _ in ins),
                "MUFU.RCP": sum(op.startswith("MUFU.RCP") for _, op, _ in ins)}

    out = {}
    for label, ins in funcs.items():
        spans = []
        for addr, op, rest in ins:
            m = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and m and int(m.group(1), 16) < addr:
                c = counts([x for x in ins if int(m.group(1), 16) <= x[0] <= addr])
                if c["MUFU.RCP"] == 1 and c["LDS"] >= 3:
                    spans.append((int(m.group(1), 16), addr, c))
        # The innermost ones (a ray loop around a sweep also holds one test).
        loops = [c for a, b, c in spans
                 if not any(a <= a2 and b2 <= b and (a2, b2) != (a, b) for a2, b2, _ in spans)]
        out[label] = {"kernel": counts(ins), "loops": loops}
    return out


def dense_box(device):
    """The mirror box at the kernels' caps: 256 triangles (each quad cut into
    2 x 4), 8 point lights."""
    from cg_raytracer_tpu_torch.scene import standins
    from cg_raytracer_tpu_torch.scene.types import PointLights, make_scene

    return make_scene(standins.dense_mirror_box_meshes(),
                      point_lights=PointLights.of(*standins.DENSE_BOX_LIGHTS), device=device)


def sweep_cases(scene, o1, d1):
    """kind -> (o, d, t_max or None, (flops, bytes) of the work): phase 3's
    and phase 8's inputs (closest and bounce on the 1024^2 camera rays and
    their reflections, the bounce's reflections dead where the camera ray
    missed; any hit on the shadow rays toward light 0; trace and record from
    the camera rays, depth 2; bounce-refl on the camera rays, every fifth
    dead), with their work counted on these rays (utils/roofline.py)."""
    import torch

    from cg_raytracer_tpu_torch.ops import cuda_kernels as ck
    from cg_raytracer_tpu_torch.utils import roofline as rf

    o2, d2, valid1, (so, sd, st) = ray_sets(scene, o1, d1)
    tri, aux, sph, lrows = (ck._tri_table(scene), ck._aux_table(scene), ck._sphere_table(scene),
                            ck._light_table(scene))
    lpos = scene.point_lights.position.contiguous()
    tb, n1, n2, n_l = rf.table_bytes, o1.shape[0], o2.shape[0], lpos.shape[0]
    inf = lambda live: torch.where(live, float("inf"), -1.0).contiguous()  # noqa: E731
    live2 = torch.cat([torch.ones_like(valid1), valid1])
    live5 = torch.arange(n1, device=o1.device) % 5 != 0
    closest_f, _ = rf.brute_bounce_flops(tri, lpos[:0], o2, d2)
    bounce_f, _ = rf.brute_bounce_flops(tri, lpos, o2, d2, live2)
    level0_f, hit0 = rf.brute_bounce_flops(tri, lpos, o1, d1)
    refl_f, hit_r = rf.brute_bounce_flops(tri, lpos, o1, d1, live5)
    _, _, _, _, _, o_next, d_next, active = ck._record_plain(tri, aux, lpos, o1, d1, 2, False)
    level1_f, hit1 = rf.brute_bounce_flops(tri, lpos, o_next[0], d_next[0], active[0])
    hits = int(hit0.sum()) + int(hit1.sum())
    tables = (tri, aux, lpos, lrows, sph)
    st = st.contiguous()
    return tables, active[0], {
        "closest": (o2, d2, None, (closest_f, n2 * (24 + 16) + tb(tri))),
        "anyhit": (so.contiguous(), sd.contiguous(), st,
                   (float(rf.anyhit_tests(tri, so, sd, st).sum()) * (rf.MT_FLOPS
                                                                    + rf.ANYHIT_UPDATE),
                    n1 * (28 + 1) + tb(tri))),
        "bounce": (o2, d2, inf(live2), (bounce_f, n2 * (28 + 20) + tb(tri, lpos))),
        "trace": (o1, d1, None, (level0_f + level1_f
                                 + hits * (rf.RECON_FLOPS + n_l * rf.SHADE_FLOPS
                                           + rf.BOUNCE_MISC_FLOPS),
                                 n1 * (24 + 12) + tb(tri, aux, sph, lrows))),
        "record": (o1, d1, None, (level0_f + level1_f + hits * rf.RECON_FLOPS,
                                  n1 * (24 + 2 * 20 + 24 + 1) + tb(tri, aux, lpos))),
        "bounce_refl": (o1, d1, inf(live5), (refl_f + int(hit_r.sum()) * rf.RECON_FLOPS,
                                             n1 * (28 + 20 + 24 + 1) + tb(tri, aux, lpos))),
    }


def sweep_phase(out, device, kernels, e2e, results, scenes, parent=None) -> None:
    """Phase 31: the brute sweeps measured.  ptxas for the six kernels
    (none may spill), SASS counts per triangle test (static, each sweep
    loop's body) against the parent's, the six kernels on the box and on
    the 256-triangle, 8-light box: each variant's (and the parent's) outputs
    bit-equal to this tree's, device ms in turns (batched_ms), the share of
    the bound, and the share of record-trace's warps that are partly active
    at level 1."""
    from cg_raytracer_tpu_torch.ops import _build
    from cg_raytracer_tpu_torch.ops.camera import generate_rays
    from cg_raytracer_tpu_torch.scene.types import Camera
    from cg_raytracer_tpu_torch.utils import roofline

    phase("phase 31: the brute sweeps measured: registers, SASS, ablations"
          + (f", against {parent}" if parent else ""))
    t0 = time.perf_counter()
    sig = {k: _build.SIGNATURES[k] for k in ("cgrt_closest", "cgrt_anyhit", "cgrt_bounce",
                                            "cgrt_trace", "cgrt_record_trace",
                                            "cgrt_bounce_refl")}
    variants = build_variants(SWEEP_SOURCES, SWEEP_ABLATIONS, sig, parent)
    print(f"  {len(variants)} variants of oracle.cu, trace.cu and record.cu built in "
          f"{time.perf_counter() - t0:.1f} s")
    with open(_build.library_path()[:-3] + ".log") as f:
        logs = {"this tree": f.read()}
    logs.update({k: v[1] for k, v in variants.items()})
    print("  ptxas: registers, stack frame / spill store / spill load bytes")
    for name, log in logs.items():
        info = ptxas_kernels(log, SWEEP_PTXAS)
        print(f"    {name}: " + "; ".join(
            f"{label} {r.get('regs')}, {r.get('frame')}/{r.get('spill_st')}/{r.get('spill_ld')}"
            for label, r in sorted(info.items())))
        if name == "this tree":
            assert len(info) == 6 and all(r["spill_st"] == r["spill_ld"] == 0
                                          for r in info.values()), f"spills: {info}"
    paths = {"this tree": _build.library_path()}
    if parent:
        paths["parent"] = os.path.join(_build.build_dir(), "variants_oracle_trace_record",
                                       "parent.so")
    for name, path in paths.items():
        sass = sass_sweep(path, SWEEP_PTXAS)
        if sass is None:
            print("  SASS: no cuobjdump beside nvcc")
            break
        for label, c in sorted(sass.items()):
            loops = "; ".join(", ".join(f"{k} {v}" for k, v in x.items() if k != "MUFU.RCP")
                              for x in c["loops"]) or "none found"
            print(f"  SASS {name}, {label}: kernel {c['kernel']}; per test, each sweep "
                  f"loop: {loops}")
        results.setdefault("sweep_sass", {})[name] = sass

    cam = Camera.default(device=device)
    o1, d1 = generate_rays(cam, 1024, 1024)
    libs = {"this tree": _build.load(), **{k: v[0] for k, v in variants.items()}}
    by_name = {e["name"]: e for e in kernels}
    print(f"  device ms per launch, 20 launches enqueued behind a {_sleep_ms():.1f}-ms sleep "
          "kernel (batched_ms), two rounds in opposite orders; every variant's outputs "
          "bit-equal to this tree's")
    times_all = {}
    for label, scene in (("box", scenes["box"]), ("256 triangles, 8 lights",
                                                  dense_box(device))):
        tables, active1, cases = sweep_cases(scene, o1, d1)
        warps = active1.reshape(-1, 32).sum(dim=1)
        partly = ((warps > 0) & (warps < 32)).float().mean().item()
        print(f"  {label}: record-trace level 1: {active1.float().mean().item():.3%} of rays "
              f"active, {(warps > 0).float().mean().item():.3%} of warps with an active ray, "
              f"{partly:.3%} of warps partly active")
        results.setdefault("sweep_level1", {})[label] = {"active": active1.float().mean().item(),
                                                         "partly_active_warps": partly}
        for kind, (o, d, tm, work) in cases.items():
            calls = {n: partial(sweep_launch, lb, kind, tables, o, d, tm)
                     for n, lb in libs.items()}
            ref = calls["this tree"]()
            for n, fn in calls.items():
                assert all(same_bits(a, b) for a, b in zip(fn(), ref)), (
                    f"{n}: {label} {kind} differs from this tree's")
            times = in_turns(calls)
            times_all[(label, kind)] = times
            ms = sum(times["this tree"]) / 2
            b_ms, b_by = roofline.bound_ms(*work)
            print(f"    {label} {kind}: {turns_line(times)}; bound {b_ms:.5f} ms by {b_by} "
                  f"({b_ms / ms:.1%} of it)")
            row = SWEEP_ROWS[kind]
            if label == "box" and row in by_name:
                e = by_name[row]
                e.update(ab_ms=ms, ab_bound_ms=b_ms)
                if parent:
                    e["parent_ms"] = sum(times["parent"]) / 2
    results["sweep_ablations"] = {f"{k[0]} {k[1]}": t for k, t in times_all.items()}



EFFECTS = {  # label -> the effect flags of RenderConfig
    "aa": dict(anti_aliasing=True),
    "bloom": dict(bloom=True),
    "motion blur": dict(motion_blur=True),
    "aa+bloom": dict(anti_aliasing=True, bloom=True),
    "aa+bloom+motion blur": dict(anti_aliasing=True, bloom=True, motion_blur=True),
    "quirks aa": dict(anti_aliasing=True, reference_quirks=True),
    "quirks bloom": dict(bloom=True, reference_quirks=True),
    "quirks aa+bloom": dict(anti_aliasing=True, bloom=True, reference_quirks=True),
    "quirks motion blur": dict(motion_blur=True, reference_quirks=True),
}
# Phase 32's sizes: each scene's renders (the last one timed), the plain
# twins' check of every effect (and the box's at 800^2), render_rows, the
# CLI, the debug hit buffers and the training steps.
EFFECT_SIZES = {"box": (800, 1024), "spherical box": (800, 1024), "teacup": (800,)}
FX = dict(plain=128, box_plain=800, rows=1024, cli=800, debug=800, step=256)


def sub_renders(flags) -> int:
    """The frames one render with ``flags`` traces: 4 under AA (also on the
    reference's AA + bloom path), 16 under motion blur (15 under quirks)."""
    aa = 4 if flags.get("anti_aliasing") else 1
    if not flags.get("motion_blur"):
        return aa
    return aa * (15 if flags.get("reference_quirks") else 16)


def makefile_build(out) -> str:
    """native/'s library built with its Makefile's CXXFLAGS (the JAX
    package's build of the same sources), into ``out``."""
    import re

    from cg_raytracer_tpu_torch import native

    with open(os.path.join(native.NATIVE_DIR, "Makefile")) as f:
        flags = re.search(r"^CXXFLAGS \?= (.*)$", f.read(), re.M).group(1).split()
    path = os.path.join(out, "libcgrt_makefile.so")
    subprocess.run(["g++", *flags, "-shared", "-o", path,
                    *(os.path.join(native.NATIVE_DIR, n) for n in native.SOURCES)],
                   check=True, capture_output=True, text=True)
    return path


def tree_inputs(scene):
    """(tri_lo, tri_hi, centroids) of ``ops/bvh.py::build_bvh``."""
    verts = scene.vertices.detach().cpu().numpy()
    tris = scene.triangles.detach().cpu().numpy()
    p0, p1, p2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    import numpy as np

    return (np.minimum(np.minimum(p0, p1), p2), np.maximum(np.maximum(p0, p1), p2),
            (p0 + p1 + p2) / 3.0)


def effects_phase(out, device, e2e, results, scenes) -> None:
    """Phase 32: the effects (AA, bloom, motion blur, their quirks),
    ``render_rows``, the CLI's effects and ``--profile``, the debug front
    ends, a training step with AA + bloom, and the native host builds."""
    import ctypes
    import shutil

    import numpy as np
    import torch

    from cg_raytracer_tpu_torch import cli, native
    from cg_raytracer_tpu_torch.models.whitted import (build_accel, effective_max_depth,
                                                       make_backend, render, render_image,
                                                       render_rows, resolve_fwd_shade_kernel)
    from cg_raytracer_tpu_torch.ops import bvh as tbvh
    from cg_raytracer_tpu_torch.ops import bvh4 as b4
    from cg_raytracer_tpu_torch.ops import cuda_kernels as ck
    from cg_raytracer_tpu_torch.ops import effects, shade, soft
    from cg_raytracer_tpu_torch.ops.camera import generate_rays
    from cg_raytracer_tpu_torch.optim import inverse
    from cg_raytracer_tpu_torch.scene.types import Camera
    from cg_raytracer_tpu_torch.utils import bench, checks
    from cg_raytracer_tpu_torch.utils.bench import median, time_frames
    from cg_raytracer_tpu_torch.utils.config import RenderConfig
    from cg_raytracer_tpu_torch.utils.debug import debug_trace, hit_statistics
    from cg_raytracer_tpu_torch.utils.image import read_image, write_png

    phase("phase 32: effects and front ends on the card")
    start = time.perf_counter()

    def lap(what):
        print(f"  [{what}: {time.perf_counter() - start:.1f} s into phase 32]")
    cam = Camera.default(device=device)
    modules = (ck, shade, b4, soft)

    def reset():
        for module in modules:
            module.reset_launch_counts()

    def counts():
        torch.cuda.synchronize()
        return {k: v for m in modules for k, v in m.launch_counts().items() if v}

    def resolved(scene, cfg):
        cfg = dataclasses.replace(cfg, max_depth=effective_max_depth(scene, cfg))
        return resolve_fwd_shade_kernel(scene, cfg)

    box, sbox = scenes["box"], scenes["spherical_box"]
    teacup = scenes["teacup"]
    cases = {  # label -> (scene, route); the box on the CLI's route
        "box": (box, dict(forward_only=True)),
        "spherical box": (sbox, {}),
        "teacup": (teacup, {}),
    }
    timed = {label: sizes[-1] for label, sizes in EFFECT_SIZES.items()}
    fx = {}
    for label, (scene, route) in cases.items():
        accel = build_accel(scene, RenderConfig(**route))
        for size in EFFECT_SIZES[label]:
            base = RenderConfig(width=size, height=size, **route)
            reset()
            plain_img = render(scene, cam, base, accel=accel)
            per_frame = counts()
            assert per_frame, f"{label}: no kernel launched"
            row = fx.setdefault(f"{label} {size}^2", {"launches per frame": per_frame})
            times = {}
            if size == timed[label]:
                lap(f"{label} renders at {EFFECT_SIZES[label][:-1]}")
                times["plain frame"] = median(time_frames(
                    lambda: render(scene, cam, base, accel=accel), iters=3, warmup=0))
            for name, flags in EFFECTS.items():
                cfg = dataclasses.replace(base, **flags)
                reset()
                img = render(scene, cam, cfg, accel=accel)
                got, n = counts(), sub_renders(flags)
                want = {k: n * v for k, v in per_frame.items()}
                assert got == want, f"{label} {size}^2 {name}: launches {got}, {n} x a frame {want}"
                assert img.shape == (size, size, 3) and bool(torch.isfinite(img).all())
                lit = (img.amax(dim=-1) > 0.02).float().mean().item()
                assert lit > 0.1, (label, size, name, lit)
                if flags.get("bloom"):
                    assert (img - plain_img).amax().item() > 1e-3 or flags.get("anti_aliasing")
                if size == timed[label]:
                    # The quirk blur takes most of a second: one timed call.
                    iters = 1 if flags.get("bloom") and flags.get("reference_quirks") else 2
                    times[name] = median(time_frames(
                        lambda: render(scene, cam, cfg, accel=accel), iters=iters, warmup=0))
                    write_png(os.path.join(out, f"effects_{label.replace(' ', '_')}_"
                                                f"{name.replace(' ', '_').replace('+', '_')}.png"),
                              img)
                print(f"  {label} {size}^2 {name}: {n} frames' launches ({sum(got.values())}), "
                      f"lit {lit:.3f}, mean {img.mean().item():.4f}")
            if times:
                frame = times["plain frame"]
                row["ms"] = times
                row["x plain frame"] = {k: v / frame for k, v in times.items()}
                print(f"  {label} {size}^2 ms per frame (CUDA events): " + ", ".join(
                    f"{k} {v:.3f} (x{v / frame:.2f})" for k, v in times.items()))
                lap(f"{label} {size}^2 renders and times")
        # The effects against the plain twins, on the card, at FX["plain"]^2:
        # every one on the box, those without motion blur on the spherical
        # box, AA + bloom and its quirk path on the teacup (the 4-wide twin
        # walk takes seconds per frame); the allowance of n frames is n times
        # a frame's.
        small = RenderConfig(width=FX["plain"], height=FX["plain"], **route)
        for name, flags in EFFECTS.items():
            if ((label == "spherical box" and flags.get("motion_blur"))
                    or (label == "teacup" and name not in ("aa+bloom", "quirks aa+bloom"))):
                continue
            cfg = resolved(scene, dataclasses.replace(small, **flags))
            img = render(scene, cam, cfg, accel=accel)
            plain = render_image(scene, cam, cfg, backend=make_backend(scene, cfg, plain=True,
                                                                       accel=accel))
            images_close(img, plain, f"{label} {FX['plain']}^2 {name} vs the plain twins",
                         max_bad=min(1.0, IMG_MAX_BAD * sub_renders(flags)))
        lap(f"{label} against the plain twins")
    # The box's effects without motion blur at 800^2 against the plain twins too.
    size = FX["box_plain"]
    for name, flags in EFFECTS.items():
        if flags.get("motion_blur"):
            continue
        cfg = resolved(box, RenderConfig(width=size, height=size, forward_only=True, **flags))
        images_close(render(box, cam, cfg), render_image(
            box, cam, cfg, backend=make_backend(box, cfg, plain=True)),
            f"box {size}^2 {name} vs the plain twins", max_bad=IMG_MAX_BAD * sub_renders(flags))
    # The post-passes alone on the box's frame.
    size = timed["box"]
    frame = render(box, cam, RenderConfig(width=size, height=size, forward_only=True))
    post = {}
    for name, cfg in (("clean bloom", RenderConfig(bloom=True)),
                      ("quirk bloom", RenderConfig(bloom=True, reference_quirks=True))):
        post[name] = median(time_frames(lambda: effects.bloom(frame, cfg), iters=3, warmup=1))
    print(f"  bloom post-pass on the box's {size}^2 frame: clean {post['clean bloom']:.3f} ms, "
          f"quirk (csrc/bloom.cu) {post['quirk bloom']:.3f} ms")
    fx[f"bloom post-pass {size}^2 ms"] = post
    lap("the box at 800^2 against the twins, the post-passes")
    results["effects"] = fx
    e2e["effects"] = {k: v.get("ms") for k, v in fx.items() if isinstance(v, dict) and "ms" in v}

    # render_rows: three tiles put together are the frame, bit for bit.
    size = FX["rows"]
    for label, scene, route in (("box", box, dict(forward_only=True)), ("spherical box", sbox, {})):
        for flags in ({}, dict(anti_aliasing=True)):
            cfg = RenderConfig(width=size, height=size, **route, **flags)
            backend = make_backend(scene, cfg)
            full = render_image(scene, cam, cfg, backend=backend)
            tiles = [render_rows(scene, cam, cfg, rows, backend=backend)
                     for rows in (slice(0, size // 3), slice(size // 3, 2 * size // 3 + 1),
                                  slice(2 * size // 3 + 1, size))]
            assert torch.equal(torch.cat(tiles), full), (label, flags)
            print(f"  render_rows {label} {size}^2 {flags or 'plain'}: 3 tiles equal the frame")
    lap("render_rows")

    # The CLI with every effect and a trace.
    png, trace_dir = os.path.join(out, "cli_effects.png"), os.path.join(out, "cli_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    reset()
    size = str(FX["cli"])
    assert cli.main(["render", "--scene", "mirror_box", "--device", device.type, "--aa",
                     "--bloom", "--motion-blur", "--profile", trace_dir, "--width", size,
                     "--height", size, "-o", png]) == 0
    cli_counts = counts()
    # The warm-up render captures its graph (an eager warm-up, then a replay)
    # and the timed one replays it: 64 frames each, three times.
    assert cli_counts == {"trace_cuda": 3 * 64}, cli_counts
    img = read_image(png)
    assert img.shape == (FX["cli"], FX["cli"], 3) and (img.max(axis=-1) > 0.02).mean() > 0.1
    traces = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    on_card = sum(1 for e in events if e.get("cat") == "kernel")
    print(f"  cgrt-torch render --aa --bloom --motion-blur --profile: {cli_counts}, trace "
          f"{os.path.getsize(traces[0])} bytes, {on_card} kernel events of {len(events)}")
    assert on_card > 0, "the trace holds no kernel of the card"
    os.remove(traces[0])  # tens of MB
    lap("the CLI")

    # The debug front ends: the kernels against the twin backend.
    ndc = torch.stack(torch.meshgrid(torch.linspace(-0.9, 0.9, 16), torch.linspace(-0.9, 0.9, 16),
                                     indexing="ij"), -1).reshape(-1, 2)
    for label, scene in (("box", box), ("teacup", teacup)):
        cfg = RenderConfig(width=FX["debug"], height=FX["debug"])
        accel = build_accel(scene, cfg)
        reset()
        got = debug_trace(scene, cam, ndc, cfg, backend=make_backend(scene, cfg, accel=accel))
        stats = hit_statistics(scene, cam, cfg, backend=make_backend(scene, cfg, accel=accel))
        debug_counts = counts()
        twin = make_backend(scene, cfg, plain=True, accel=accel)
        want = debug_trace(scene, cam, ndc, cfg, backend=twin)
        want_stats = hit_statistics(scene, cam, cfg, backend=twin)
        for level, (g, w) in enumerate(zip(got["levels"], want["levels"])):
            assert np.array_equal(g["prim_id"], w["prim_id"]), (label, level)
            for a, b in zip(g["shadowed_by_light"], w["shadowed_by_light"]):
                assert np.array_equal(a, b), (label, level)
        same = (stats["prim_id"] == want_stats["prim_id"]).mean()
        assert same >= MIN_MATCH, (label, same)
        wrappers = (("intersect_cuda", "occluded_cuda") if label == "box"
                    else ("intersect_bvh4_cuda", "occluded_bvh4_cuda"))
        assert all(debug_counts.get(w, 0) > 0 for w in wrappers), debug_counts
        print(f"  debug {label}: debug_trace prim ids and shadow bits equal to the twins' on "
              f"{ndc.shape[0]} rays x {len(got['levels'])} levels; hit_statistics {cfg.width}^2 "
              f"prim ids equal on {same:.5%} ({stats['hit'].mean():.2%} hit); launches "
              f"{debug_counts}")
    lap("debug")

    # Training with AA + bloom: a step's gradients against the plain path,
    # and optimize() running its kernels.
    jitter = bench.camera_jitter(torch.Generator(device).manual_seed(32), device)
    for label, scene in (("box", box), ("teacup", teacup)):
        cfg = bench.training_config(RenderConfig(width=FX["step"], height=FX["step"],
                                                 anti_aliasing=True, bloom=True), True)
        params = bench.training_params(scene, True)
        accel = build_accel(scene, cfg)
        reset()
        (lk, gk), (lp, gp) = (bench.fwd_bwd_step(scene, cam, cfg, params, jitter, plain=plain,
                                                 accel=accel) for plain in (False, True))
        step_counts = counts()
        print(f"  {label} AA + bloom step {cfg.width}^2: loss {lk.item():.8g} (plain "
              f"{lp.item():.8g}); launches {step_counts}")
        torch.testing.assert_close(lk, lp, rtol=1e-5, atol=1e-7)
        for name in gk:
            assert bool(torch.isfinite(gk[name]).all()), name
            tol = dict(checks.TABLE_GRAD, atol=2e-5) if name == "vertices" else checks.TABLE_GRAD
            torch.testing.assert_close(gk[name], gp[name], **tol, msg=f"{label} d/d{name}")
        needed = (("record_trace_cuda", "shade_fwd_cuda", "shade_bwd_cuda") if label == "box"
                  else ("bounce_bvh4_cuda", "shade_pre_fwd_cuda", "shade_pre_bwd_cuda"))
        assert all(step_counts.get(w, 0) > 0 for w in needed), step_counts
        target = 0.9 * render(scene, cam, cfg).detach()
        reset()
        _, losses = inverse.optimize(scene, cam, target, cfg, steps=1, log_fn=lambda *a: None)
        opt_counts = counts()
        assert len(losses) == 1 and np.isfinite(losses[0])
        assert all(opt_counts.get(w, 0) > 0 for w in needed), opt_counts
        print(f"  {label} optimize(), one AA + bloom step: loss {losses[0]:.6g}, launches "
              f"{opt_counts}")
    lap("training")

    # The native host builds: the median tree in C++ against numpy.
    assert native.available(), "the host library did not build"
    lib = ctypes.CDLL(makefile_build(out))
    native._declare(lib)
    o1, d1 = generate_rays(cam, 1024, 1024)
    builds = {}
    for label, scene in (("teacup", teacup), ("donut", scenes["donut"]),
                         ("torus", scenes["torus"][0])):
        t0 = time.perf_counter()
        nat = tbvh.build_bvh(scene, max_leaf=4)
        nat_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = tbvh.build_bvh(scene, max_leaf=4, use_native=False)
        np_s = time.perf_counter() - t0
        # The same sources built with the Makefile's flags give the same arrays.
        n, m = scene.num_triangles, 2 * scene.num_triangles + 1
        arrays = (np.zeros((m, 3), np.float32), np.zeros((m, 3), np.float32),
                  *(np.zeros(m, np.int32) for _ in range(4)), np.arange(n, dtype=np.int32))
        nodes = lib.cgrt_build_bvh(*(np.ascontiguousarray(x, np.float32)
                                     for x in tree_inputs(scene)),
                                   n, tbvh.DEFAULT_MAX_DEPTH, 4, *arrays)
        fields = ("node_lo", "node_hi", "left", "right", "first", "count", "tri_order")
        for name, arr in zip(fields, arrays):
            mine = getattr(nat, name).numpy()
            assert np.array_equal(mine, arr[:nodes] if name != "tri_order" else arr), (label, name)
        differ = [f for f in fields if not torch.equal(getattr(nat, f), getattr(ref, f))]
        boxes = (nat.node_lo != ref.node_lo).any(dim=1) | (nat.node_hi != ref.node_hi).any(dim=1)
        # Hits through the card's 4-wide walk over each tree.
        step = 16 if label == "torus" else 1
        o, d = o1[::step].contiguous(), d1[::step].contiguous()
        hn = b4.intersect_bvh4_cuda(scene, b4.collapse_bvh4(nat).to(device), o, d)
        hr = b4.intersect_bvh4_cuda(scene, b4.collapse_bvh4(ref).to(device), o, d)
        same = (hn.prim_id == hr.prim_id).float().mean().item()
        both = (hn.prim_id == hr.prim_id) & (hn.prim_id >= 0)
        t_err = (hn.t[both] - hr.t[both]).abs().max().item() if both.any() else 0.0
        assert same >= MIN_MATCH and t_err <= TOL, (label, same, t_err)
        builds[label] = {"triangles": n, "native_s": nat_s, "numpy_s": np_s,
                         "x": np_s / nat_s, "fields_differing_from_numpy": differ,
                         "nodes_whose_box_differs": boxes.float().mean().item(),
                         "prim_ids_equal": same}
        print(f"  {label} ({n} triangles) median leaf 4: native {nat_s:.3f} s, numpy "
              f"{np_s:.3f} s (x{np_s / nat_s:.1f}); native arrays equal the Makefile build's; "
              f"against numpy: {differ or 'every array equal'} differ "
              f"({boxes.float().mean().item():.2%} of node boxes), prim ids through the "
              f"4-wide walk equal on {same:.5%} of {o.shape[0]} rays, max |dt| {t_err:.3g}")
    results["native_builds"] = builds
    lap("native builds")


PAST_CAP_GRID = 1200  # the torus on a 1200 x 1200 grid: 2,880,000 triangles
PARALLEL = dict(box=1024, spherical=256, step=256, teacup=512, torus=256, torus_rays=1024)
_PATH_MODULES = ("cuda_kernels", "shade", "bvh4", "soft", "level")


def _modules():
    import importlib

    return [importlib.import_module(f"cg_raytracer_tpu_torch.ops.{m}") for m in _PATH_MODULES]


def _reset_counts():
    for module in _modules():
        module.reset_launch_counts()


def _read_counts() -> dict:
    import torch

    torch.cuda.synchronize()
    return {k: v for m in _modules() for k, v in m.launch_counts().items()
            if v and ":w" not in k}


def _wall_ms(fn, mesh=None, iters=3) -> float:
    """Median host milliseconds of ``fn`` ending in a synchronise (and, on
    a mesh, a barrier first, so the ranks start together)."""
    import torch

    fn()
    times = []
    for _ in range(iters):
        if mesh is not None:
            mesh.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def _parallel_scenes(device):
    import torch  # noqa: F401

    from cg_raytracer_tpu_torch.scene import standins
    from cg_raytracer_tpu_torch.scene.presets import load_standin
    from cg_raytracer_tpu_torch.scene.types import PointLights, make_scene

    box = make_scene(standins.mirror_box_meshes(),
                     point_lights=PointLights.of(*standins.MIRROR_BOX_LIGHTS), device=device)
    return box, load_standin("spherical_box", device=device)


def _parallel_configs():
    from cg_raytracer_tpu_torch.optim import inverse
    from cg_raytracer_tpu_torch.utils.config import RenderConfig

    n = PARALLEL
    return (RenderConfig(width=n["box"], height=n["box"]),
            RenderConfig(width=n["spherical"], height=n["spherical"], soft_shadow_kernel="off"),
            inverse.training_config(RenderConfig(width=n["step"], height=n["step"]), False))


def _step(mesh, box, cam, cfg):
    """One ``make_train_step`` on the box's materials and light (Adam 1e-2)
    toward 0.9 x its render -> (loss, params, the step's launches)."""
    import torch

    from cg_raytracer_tpu_torch.models.whitted import render
    from cg_raytracer_tpu_torch.optim import inverse
    from cg_raytracer_tpu_torch.parallel import sharding

    target = 0.9 * render(box, cam, cfg).detach()
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in inverse.material_params(box).items()}
    # Capturable on the card (as optimize() builds it): the step without a
    # mesh replays a CUDA graph, the mesh's runs eagerly with the same update.
    opt = torch.optim.Adam(list(params.values()), lr=1e-2,
                           capturable=box.device.type == "cuda")
    step = sharding.make_train_step(cfg, opt, inverse.apply_material_params, mesh=mesh)
    _reset_counts()
    loss = step(params, box, cam, target, None)
    return loss.item(), {k: v.detach().cpu() for k, v in params.items()}, _read_counts()


def _ray_parallel_cases(mesh, sample_mesh) -> dict:
    """Phase 33's paths on ``mesh``: each frame and step, its launches from
    0, and its ms (host clock)."""
    from cg_raytracer_tpu_torch.parallel import sharding
    from cg_raytracer_tpu_torch.scene.types import Camera

    box, sbox = _parallel_scenes(mesh.device)
    cam = Camera.default(device=mesh.device)
    box_cfg, sph_cfg, step_cfg = _parallel_configs()
    res = {}
    for label, fn in (
            ("box", lambda: sharding.sharded_render(box, cam, box_cfg, mesh)),
            ("spherical", lambda: sharding.sample_sharded_render(sbox, cam, sph_cfg,
                                                                 sample_mesh))):
        fn()  # the tree and first launches
        _reset_counts()
        img = fn()
        res[f"{label} launches"] = _read_counts()
        res[label] = img.cpu()
        res[f"{label} ms"] = _wall_ms(fn, mesh)
    loss, params, res["step launches"] = _step(mesh, box, cam, step_cfg)
    res["step"] = (loss, params)
    return res


def _gloo_ray_rank(rank, path):
    """Phase 33 on one of two ranks sharing the card over gloo."""
    import torch

    from cg_raytracer_tpu_torch.parallel import sharding

    mesh = sharding.make_mesh(device="cuda")
    res = _ray_parallel_cases(mesh, sharding.make_mesh2(1, 2, device="cuda"))
    res["device"] = str(mesh.device)
    if rank == 0:
        torch.save(res, path)


def _gloo_geometry_rank(rank, path):
    """Phase 35 on one of two ranks sharing the card over gloo."""
    import torch

    from cg_raytracer_tpu_torch.ops.camera import generate_rays
    from cg_raytracer_tpu_torch.parallel import geometry, sharding
    from cg_raytracer_tpu_torch.scene.presets import load_scene
    from cg_raytracer_tpu_torch.scene.types import Camera
    from cg_raytracer_tpu_torch.utils.config import RenderConfig

    mesh = sharding.make_mesh(device="cuda", axis=geometry.PRIM_AXIS)
    cam = Camera.default(device=mesh.device)
    res = {}
    for label, scene in (("teacup", load_scene("teacup", device=mesh.device)),
                         ("torus", torus_scene(mesh.device, PAST_CAP_GRID))):
        size = PARALLEL[label]
        cfg = RenderConfig(width=size, height=size)
        t0 = time.perf_counter()
        shards = geometry.build_geometry_shards(scene, 2, cfg, shard=mesh.index(geometry.PRIM_AXIS))
        torch.cuda.synchronize()
        res[f"{label} shard build s"] = time.perf_counter() - t0
        res[f"{label} shard size"] = shards.shard_size
        if label == "teacup":
            o, d = generate_rays(cam, size, size)
            _reset_counts()
            hit = geometry.geometry_sharded_intersect(scene, cfg, mesh, shards, o, d)
            res["teacup hits launches"] = _read_counts()
            res["teacup hits"] = tuple(x.cpu() for x in hit)
        render_fn = lambda: geometry.geometry_sharded_render(  # noqa: E731
            scene, cam, cfg, mesh, shards=shards)
        _reset_counts()
        res[label] = render_fn().cpu()
        res[f"{label} launches"] = _read_counts()
        res[f"{label} ms"] = _wall_ms(render_fn, mesh)
    if rank == 0:
        torch.save(res, path)


def parallel_phases(out, device, e2e, results, scenes) -> None:
    """Phases 33-35: the multi-device slice and scenes past the JAX
    package's HBM_MAX_TRIS."""
    import torch
    import torch.distributed as dist

    from cg_raytracer_tpu_torch.models.whitted import build_accel, make_backend, render
    from cg_raytracer_tpu_torch.ops import bvh4 as b4
    from cg_raytracer_tpu_torch.ops.camera import generate_rays
    from cg_raytracer_tpu_torch.parallel import multihost, sharding
    from cg_raytracer_tpu_torch.scene.types import Camera
    from cg_raytracer_tpu_torch.utils import checks, roofline
    from cg_raytracer_tpu_torch.utils.bench import median, time_frames
    from cg_raytracer_tpu_torch.utils.config import RenderConfig
    from cg_raytracer_tpu_torch.utils.image import write_png

    cam = Camera.default(device=device)
    par = {}

    phase("phase 33: ray- and sample-parallel render and step (one-rank NCCL, two gloo ranks)")
    box, sbox = _parallel_scenes(device)
    box_cfg, sph_cfg, step_cfg = _parallel_configs()
    single = {"box": render(box, cam, box_cfg), "spherical": render(sbox, cam, sph_cfg)}
    single_ms = {"box": _wall_ms(lambda: render(box, cam, box_cfg)),
                 "spherical": _wall_ms(lambda: render(sbox, cam, sph_cfg))}
    want_loss, want_params, _ = _step(None, box, cam, step_cfg)
    assert multihost.initialize_distributed(f"tcp://127.0.0.1:{multihost.free_port()}", 1, 0,
                                            device=device) == "nccl"
    try:
        one = torch.ones((4,), device=device)
        dist.all_reduce(one)  # NCCL itself, once: a one-rank mesh's collectives are no-ops
        assert torch.equal(one, torch.ones_like(one))
        mesh = sharding.make_mesh(device=device)
        nccl = _ray_parallel_cases(mesh, sharding.make_mesh2(1, 1, device=device))
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    multihost.spawn(_gloo_ray_rank, 2, args=(os.path.join(out, "parallel_gloo.pt"),),
                    backend="gloo", device="cuda")
    spawn_s = time.perf_counter() - t0
    gloo = torch.load(os.path.join(out, "parallel_gloo.pt"), weights_only=False)
    for run, got in (("one-rank NCCL", nccl), ("two gloo ranks", gloo)):
        for label in ("box", "spherical"):
            assert torch.equal(got[label], single[label].cpu()), (run, label)
            assert got[f"{label} launches"], (run, label, "no kernel launched")
        loss, params = got["step"]
        if run == "one-rank NCCL":  # the single-device step itself
            assert f"{loss:.8g}" == f"{want_loss:.8g}", (run, loss, want_loss)
        else:  # two ranks' sums add in another order
            assert abs(loss - want_loss) <= 1e-6 * abs(want_loss), (run, loss, want_loss)
        for k in params:
            torch.testing.assert_close(params[k], want_params[k], **checks.TABLE_GRAD,
                                       msg=f"{run} {k}")
        assert got["step launches"], (run, "the step launched no kernel")
        print(f"  {run}: box {PARALLEL['box']}^2 and spherical box {PARALLEL['spherical']}^2 "
              f"(200 samples, the scan) equal to the single-device renders bit for bit; step "
              f"{PARALLEL['step']}^2 loss {loss:.8g} (single {want_loss:.8g}), parameters "
              f"within TABLE_GRAD")
        print(f"    ms per frame (host clock, median of 3): box {got['box ms']:.3f} (single "
              f"{single_ms['box']:.3f}), spherical box {got['spherical ms']:.3f} (single "
              f"{single_ms['spherical']:.3f})")
        print(f"    launches: box {got['box launches']}; spherical {got['spherical launches']}; "
              f"step {got['step launches']}")
    print(f"  two gloo ranks: spawned, ran and joined in {spawn_s:.1f} s")
    par["ray_parallel"] = {run: {k: v for k, v in got.items() if "ms" in k or "launches" in k}
                           for run, got in (("nccl_1", nccl), ("gloo_2", gloo))}
    par["ray_parallel"]["single_ms"] = single_ms
    write_png(os.path.join(out, "parallel_box.png"), gloo["box"])

    phase(f"phase 34: past HBM_MAX_TRIS ({b4.HBM_MAX_TRIS}): the {2 * PAST_CAP_GRID ** 2}-"
          f"triangle torus on the card's autos")
    t0 = time.perf_counter()
    torus = torus_scene(device, PAST_CAP_GRID)
    make_s = time.perf_counter() - t0
    cfg0 = RenderConfig()
    t0 = time.perf_counter()
    tree = build_accel(torus, cfg0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    assert torus.num_triangles == 2 * PAST_CAP_GRID ** 2 > b4.HBM_MAX_TRIS
    assert isinstance(tree, b4.BVH4) and tree.width == 4 and tree.num_tris == torus.num_triangles
    mb = roofline.tree_bytes(tree) / 1e6
    n = PARALLEL["torus_rays"]
    o1, d1 = generate_rays(cam, n, n)
    sub = torch.arange(0, o1.shape[0], 16, device=device)
    o, d = o1[sub].contiguous(), d1[sub].contiguous()
    got, want = b4._closest_kernel(tree, o, d, None), b4._closest_plain(tree, o, d, None)
    assert all(torch.equal(a, b) for a, b in zip(got, want)), "closest walk vs twin"
    lp = torus.point_lights.position[0]
    hitp = o + d * torch.where(got.prim_id >= 0, got.t, 0.0)[:, None]
    ldir = torch.nn.functional.normalize(lp - hitp, dim=1).contiguous()
    so = (hitp + 1e-3 * ldir).contiguous()
    st = torch.where(got.prim_id >= 0, (lp - so).norm(dim=1), -1.0).contiguous()
    occ, occ_want = b4._anyhit_kernel(tree, so, ldir, st), b4._anyhit_plain(tree, so, ldir, st)
    assert torch.equal(occ, occ_want), "any-hit walk vs twin"
    per_mray = {}
    for label, tr in (("torus 2.88M", tree),) + ((("torus 1.28M", scenes["torus"][2]),)
                                                  if "torus" in scenes else ()):
        ms = median(time_frames(lambda: b4._closest_kernel(tr, o1, d1, None), iters=10))
        per_mray[label] = ms / (o1.shape[0] / 1e6)
    _reset_counts()
    img = render(torus, cam, RenderConfig(width=n, height=n), accel=tree)
    counts = _read_counts()
    assert img.shape == (n, n, 3) and bool(torch.isfinite(img).all())
    lit = (img.amax(dim=-1) > 0.02).float().mean().item()
    assert lit > 0.05 and counts.get("bounce_bvh4_cuda", 0) > 0, (lit, counts)
    write_png(os.path.join(out, "torus_past_cap.png"), img)
    frame_ms = median(time_frames(lambda: render(torus, cam, RenderConfig(width=n, height=n),
                                                 accel=tree), iters=3, warmup=0))
    print(f"  {torus.num_triangles} triangles (mesh {make_s:.2f} s): tree {tree.num_nodes} "
          f"nodes, {tree.depth} levels, {mb:.1f} MB, built in {build_s:.2f} s (median, leaf "
          f"{cfg0.resolve_bvh_max_leaf()}, width {tree.width})")
    print(f"  closest and any-hit walks equal to their twins on {o.shape[0]} rays "
          f"({(got.prim_id >= 0).float().mean().item():.2%} hit, "
          f"{occ.float().mean().item():.2%} of the shadow rays occluded)")
    print("  closest walk, ms per million 1024^2 camera rays (events, median of 10): " +
          ", ".join(f"{k} {v:.5f}" for k, v in per_mray.items()))
    print(f"  render() {n}^2: lit {lit:.3f}, {frame_ms:.3f} ms per frame (events), "
          f"launches {counts}")
    par["past_cap"] = {"triangles": torus.num_triangles, "tree_mb": mb, "build_s": build_s,
                       "nodes": tree.num_nodes, "depth": tree.depth,
                       "closest_ms_per_mray": per_mray, "frame_ms": frame_ms,
                       "launches": counts}

    phase("phase 35: geometry sharding, two gloo ranks sharing the card")
    t0 = time.perf_counter()
    multihost.spawn(_gloo_geometry_rank, 2, args=(os.path.join(out, "geometry_gloo.pt"),),
                    backend="gloo", device="cuda")
    spawn_s = time.perf_counter() - t0
    geo = torch.load(os.path.join(out, "geometry_gloo.pt"), weights_only=False)
    teacup = scenes["teacup"]
    size = PARALLEL["teacup"]
    cfg = RenderConfig(width=size, height=size)
    o, d = generate_rays(cam, size, size)
    rep = make_backend(teacup, cfg, accel=build_accel(teacup, cfg)).closest(o, d)
    g = [x.to(device) for x in geo["teacup hits"]]
    agree = (g[1] == rep.prim_id) & (g[0] == rep.t) & (g[2] == rep.u) & (g[3] == rep.v)
    share = agree.float().mean().item()
    assert share >= 1 - IMG_MAX_BAD, f"sharded teacup hits agree on {share:.4%}"
    print(f"  teacup {size}^2 geometry_sharded_intersect: global prim id, t, u and v equal to "
          f"the replicated walk's on {share:.5%} of the rays (shard {geo['teacup shard size']} "
          f"triangles); launches {geo['teacup hits launches']}")
    for label, scene, accel in (("teacup", teacup, None), ("torus", torus, tree)):
        size = PARALLEL[label]
        rcfg = RenderConfig(width=size, height=size)
        want = render(scene, cam, rcfg, accel=accel)
        rep_ms = _wall_ms(lambda: render(scene, cam, rcfg, accel=accel))
        images_close(geo[label].to(device), want, f"{label} {size}^2 geometry-sharded vs "
                                                  f"replicated")
        assert geo[f"{label} launches"], (label, "no kernel launched")
        print(f"    {label}: {geo[label + ' ms']:.3f} ms per frame on two ranks (host clock; "
              f"replicated {rep_ms:.3f}); shards of {geo[label + ' shard size']} triangles "
              f"built in {geo[label + ' shard build s']:.2f} s; launches "
              f"{geo[label + ' launches']}")
        write_png(os.path.join(out, f"geometry_{label}.png"), geo[label])
    print(f"  two gloo ranks: spawned, ran and joined in {spawn_s:.1f} s")
    par["geometry"] = {k: v for k, v in geo.items() if "ms" in k or "launches" in k
                       or " s" in k or "size" in k}
    results["parallel"] = par
    e2e["parallel"] = {"box_ms": {"single": single_ms["box"], "nccl_1": nccl["box ms"],
                                  "gloo_2": gloo["box ms"]},
                       "torus_2.88M_frame_ms": frame_ms}


# Phase 36's sizes: the frames (the tree routes at widths 2 also at 512^2),
# the steps, optimize()'s teacup steps, the odd bloom size, and the teacup's
# motion-blur sets against the twins (the 4-wide twin walk takes ~2 s a
# frame at any size: 95 frames, so the twins run on the CPU in processes
# of their own from the script's start, ``start_mb_twins``).
DISPATCH = dict(frame=1024, small=512, step=1024, bloom_step=256, opt=256, opt_steps=16,
                opt_k=8, odd=(37, 53), mb=16)
MB_SETS = ("motion blur", "aa+bloom+motion blur", "quirks motion blur")
BLOOM_TOL = dict(rtol=1e-5, atol=1e-5)  # window sums in another order than the twin's
MB_TWIN_SNIPPET = """
import json, os, sys, torch
os.nice(10)  # behind the script's own host work
sys.path.insert(0, ".")
from cg_raytracer_tpu_torch.models.whitted import make_backend, render_image, resolve_render
from cg_raytracer_tpu_torch.scene.presets import load_scene
from cg_raytracer_tpu_torch.scene.types import Camera
from cg_raytracer_tpu_torch.utils.config import RenderConfig
torch.set_num_threads(1)
flags, size, path = json.loads(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
scene = load_scene("teacup", device="cpu")
cfg, accel = resolve_render(scene, RenderConfig(width=size, height=size, backend="cuda", **flags))
torch.save(render_image(scene, Camera.default(device="cpu"), cfg,
                        backend=make_backend(scene, cfg, plain=True, accel=accel)), path)
"""


def start_mb_twins(out) -> dict:
    """The teacup's motion-blur sets through the plain twins on the CPU, one
    process per set (no card: CUDA hidden), started now and read in phase
    36: name -> (process, output path).  Any still running when the script
    exits (a phase failed first) is killed then."""
    import atexit

    procs = {}
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for name in MB_SETS:
        path = os.path.join(out, f"mb_twin_{name.replace(' ', '_').replace('+', '_')}.pt")
        cmd = [sys.executable, "-c", MB_TWIN_SNIPPET, json.dumps(EFFECTS[name]),
               str(DISPATCH["mb"]), path]
        procs[name] = (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True), path)
    atexit.register(lambda: [p.kill() for p, _ in procs.values() if p.poll() is None])
    return procs


def _kd_moved(scene):
    """``scene`` with material 0's kd scaled (a value the graph must copy in)."""
    kd = scene.materials.kd.clone()
    kd[0] = kd[0] * 0.7
    return dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, kd=kd))


def _bloom_work(h, w, adjoint=False):
    """(operations, bytes) of csrc/bloom.cu's design on [h, w, 3] (or its
    adjoint), three channels: per pixel one column sum of its entering
    column's other in-bounds rows, a sum over its in-bounds columns' sums,
    its own row's cells (outputs left of it, raw cells from it on; the
    adjoint's first pass the pixel's own cotangent) and a divide; the
    adjoint adds its second pass, separable as the kernel takes it: per
    pixel one column sum of the window's in-bounds rows above it, a sum over
    its columns' sums and its own row's cells up to it.  Bytes: the image
    read once and written once."""
    import numpy as np

    ys, xs = np.arange(h), np.arange(w)
    cy = (np.minimum(ys + 10, h - 1) - np.maximum(ys - 10, 0) + 1)[:, None]
    cx = (np.minimum(xs + 10, w - 1) - np.maximum(xs - 10, 0) + 1)[None, :]
    left = (xs - np.maximum(xs - 10, 0))[None, :]
    right = (np.minimum(xs + 10, w - 1) - xs + 1)[None, :]
    if adjoint:
        below = (np.minimum(ys + 10, h - 1) - ys)[:, None]
        above = (ys - np.maximum(ys - 10, 0))[:, None]
        per_px = below + cx + (right - 1) + 1 + 1 + above + cx + left + 1
    else:
        per_px = (cy - 1) + cx + left + right + 1
    return 3.0 * float(np.broadcast_to(per_px, (h, w)).sum()), 2 * h * w * 12


# Phase 36's variants of bloom.cu: each takes one lever of the row pipeline
# out again or moves the cluster's size (substitutions as in SOFT_ABLATIONS;
# the full windows' are cut from the source by bloom_full_window()).
# "spinning polls": a waiting lane never sleeps; "acquire polls": every poll
# an acquire load and no sleep (the wait as it was before the sleep).
_BLOOM_SLEEP = "          if (now < (y - 1) * stride) __nanosleep(128);\n"
_BLOOM_POLLS = """        for (int now = above.load(cuda::std::memory_order_relaxed); now < target;
             now = above.load(cuda::std::memory_order_relaxed)) {
""" + _BLOOM_SLEEP + """        }
        (void)above.load(cuda::std::memory_order_acquire);
"""
BLOOM_ABLATIONS = {
    "one block": [("bloom.cu", "kBloomCluster = 16;", "kBloomCluster = 1;", 1)],
    "cluster of 8": [("bloom.cu", "kBloomCluster = 16;", "kBloomCluster = 8;", 1)],
    "spinning polls": [("bloom.cu", _BLOOM_SLEEP, "", 1)],
    "acquire polls": [("bloom.cu", _BLOOM_POLLS,
                       "        while (above.load(cuda::std::memory_order_acquire) < target) {\n"
                       "        }\n", 1)],
}
# Phase B2 of the full-window ablation: each pixel sums its window cell by
# cell (half 0 the rows above, half 1 the rows below and its row's raw
# cells; none below in the adjoint's first pass), through the L2.
_BLOOM_FULL_B2 = """      if (x < w) {
        const int r0 = half == 0 ? max(y - kBloomR, 0) : y + 1;
        const int r1 = half == 0 ? y - 1 : (kAdjoint ? y : min(y + kBloomR, h - 1));
        for (int r = r0; r <= r1; ++r) {
          for (int cc = c0; cc <= c1; ++cc) {
            const float* p = buf + cell<kAdjoint>(r, cc, h, w);
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) a[ch] += __ldcg(p + ch);
          }
        }
        for (int cc = x; half == 1 && cc <= (kAdjoint ? x : c1); ++cc) {
          const float* p = buf + cell<kAdjoint>(y, cc, h, w);
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) a[ch] += p[ch];
        }
      }
"""


def bloom_full_window():
    """The ablation "full 441-cell windows": bloom.cu with the column sums
    (phases A1, B1, A2 and the first group's loads) cut out and phase B2
    summing each pixel's whole window instead, as substitutions on the
    source as it stands."""
    with open(os.path.join(ROOT, CSRC, "bloom.cu")) as f:
        src = f.read()

    def span(start, end):
        i = src.index(start)
        return src[i:src.index(end, i)]

    return [("bloom.cu", "    copy_column<kAdjoint>(buf, y, j, h, w, half, lane, col);\n", "", 1),
            ("bloom.cu", span("      // A1.", "      // B1."), "", 1),
            ("bloom.cu", span("      // B1.", "      wait(y, min(c - j"),
             "      float a[3] = {0.0f, 0.0f, 0.0f};\n", 1),
            ("bloom.cu", span("      // A2.", "      if (g == 0) continue;"), "", 1),
            ("bloom.cu", span("      // B2.", "      float b[3];"), _BLOOM_FULL_B2, 1)]


# A build of bloom.cu that stamps clock64() at the parts of a step (wait,
# the hand-off's read of row y - 1's cells, the rest of A2, B2, C, publish)
# for rows 0 and 9 (slots 0 and 9 of the cluster), steps below 60, and
# returns them through cgrt_bloom_clock: the same arithmetic.
_BLOOM_STAMP = ("if (lane == 0 && (slot == 0 || slot == 9) && y < 10 && g < 60) "
                "g_clk[((slot == 9) * 60 + g) * 8 + {}] = clock64();\n")
BLOOM_CLOCKS = [
    ("bloom.cu", "      wait(y, min(c - j + kBloomChunk, w));\n",
     "      " + _BLOOM_STAMP.format(0) + "      wait(y, min(c - j + kBloomChunk, w));\n      "
     + _BLOOM_STAMP.format(1), 1),
    ("bloom.cu", "      __syncwarp();\n      if (g == 0) continue;\n",
     "      " + _BLOOM_STAMP.format(5) + "      __syncwarp();\n      " + _BLOOM_STAMP.format(2)
     + "      if (g == 0) continue;\n", 1),
    ("bloom.cu", "      // C. The chunk's pixels in order",
     "      " + _BLOOM_STAMP.format(3) + "      // C. The chunk's pixels in order", 1),
    ("bloom.cu", "      if (lane == 0 && y + 1 < h) {\n",
     "      " + _BLOOM_STAMP.format(4) + "      if (lane == 0 && y + 1 < h) {\n", 1),
    ("bloom.cu", "// buf [h, w, 3], blurred in place (kAdjoint",
     "__device__ long long g_clk[120 * 8];\n// buf [h, w, 3], blurred in place (kAdjoint", 1),
    ("bloom.cu", "int cgrt_bloom_config(int* out) {",
     "int cgrt_bloom_clock(long long* out) {\n  return static_cast<int>(cudaMemcpyFromSymbol("
     "out, cgrt::g_clk, sizeof(long long) * 960));\n}\nint cgrt_bloom_config(int* out) {", 1),
]


def bloom_step_cycles(lib, adjoint, buf, out):
    """Median cycles of each part of a step (steps 2-39) of rows 0 and 9 in
    one launch of the BLOOM_CLOCKS build: {row: {part: cycles}}."""
    import ctypes
    import statistics

    import torch

    bloom_call(lib, adjoint, buf, out)
    torch.cuda.synchronize()
    stamps = (ctypes.c_longlong * 960)()
    lib.cgrt_bloom_clock.argtypes = [ctypes.c_void_p]
    assert lib.cgrt_bloom_clock(ctypes.cast(stamps, ctypes.c_void_p)) == 0
    result = {}
    parts = ("wait", "hand-off read", "A2 rest", "B2", "C", "publish, A1, B1")
    for k, row in enumerate((0, 9)):
        steps = []
        for g in range(2, 40):
            t = stamps[(k * 60 + g) * 8:(k * 60 + g) * 8 + 6]
            t_next = stamps[(k * 60 + g + 1) * 8]
            steps.append((t[1] - t[0], t[5] - t[1], t[2] - t[5], t[3] - t[2], t[4] - t[3],
                          t_next - t[4]))
        med = [statistics.median(s[i] for s in steps) for i in range(len(parts))]
        result[row] = dict(zip(parts, med))
    return result


def bloom_signatures(in_place_adjoint=False):
    """bloom.cu's argtypes; ``in_place_adjoint``: an earlier tree's, whose
    adjoint took one buffer (the wavefront kernel)."""
    import ctypes

    p, i = ctypes.c_void_p, ctypes.c_int
    return {"cgrt_bloom_quirk": [p, i, i, p],
            "cgrt_bloom_quirk_adjoint": [p, i, i, p] if in_place_adjoint else [p, p, i, i, p]}


def bloom_call(lib, adjoint, buf, out=None):
    """One launch of ``lib``'s blur (in place on ``buf``) or adjoint (``buf``
    the cotangent, ``out`` the result; an in-place adjoint when None)."""
    import ctypes

    import torch

    from cg_raytracer_tpu_torch.ops import cuda_kernels as ck

    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    h, w = buf.shape[0], buf.shape[1]
    if not adjoint:
        err = lib.cgrt_bloom_quirk(ck._ptr(buf), h, w, stream)
    elif out is None:
        err = lib.cgrt_bloom_quirk_adjoint(ck._ptr(buf), h, w, stream)
    else:
        err = lib.cgrt_bloom_quirk_adjoint(ck._ptr(buf), ck._ptr(out), h, w, stream)
    assert err == 0, f"bloom variant launch: CUDA error {err}"


def bloom_config(lib):
    """(cluster blocks, warps a block, pixels a chunk) of a built bloom.cu."""
    import ctypes

    out = (ctypes.c_int * 3)()
    lib.cgrt_bloom_config.argtypes = [ctypes.c_void_p]
    lib.cgrt_bloom_config(ctypes.cast(out, ctypes.c_void_p))
    return tuple(out)


def bloom_part(device, kernels, main_counts, box, cam, bloom_builds, parent_in_place, lap):
    """Phase 36's quirk blur: ``csrc/bloom.cu`` against its twins at three
    sizes, its variants and the parent's (``bloom_builds``, a future of
    ``build_variants``) bit-equal to it there (but the full windows', to the
    twin), all timed in turns at 1024^2, the derived pixel step and row lag;
    appends the two kernels' rows to ``kernels``."""
    import torch

    from cg_raytracer_tpu_torch.models.whitted import render
    from cg_raytracer_tpu_torch.ops import _build, effects
    from cg_raytracer_tpu_torch.utils import roofline
    from cg_raytracer_tpu_torch.utils.bench import median, time_frames
    from cg_raytracer_tpu_torch.utils.config import RenderConfig

    n = DISPATCH["frame"]
    # bloom.cu against its twins: the box's bright buffers at 1024^2 and at
    # 800^2 (the reference's buffer) and an odd size, forward and adjoint.
    rng = torch.Generator(device).manual_seed(53)
    inputs = {}
    for size in (n, 800):
        frame = render(box, cam, RenderConfig(width=size, height=size, forward_only=True))
        inputs[f"{size}^2"] = effects._threshold(frame).contiguous()
    inputs["x".join(map(str, DISPATCH["odd"]))] = torch.rand(
        (*DISPATCH["odd"], 3), device=device, generator=rng) * 1.5
    errs = {"bloom_quirk": 0.0, "bloom_quirk_adjoint": 0.0}
    bl = {"sizes": {}}
    twins = {}
    for size_label, x in inputs.items():
        g = torch.randn(x.shape, device=device, generator=rng)
        for name, kern, plain, arg in (
                ("bloom_quirk", effects.bloom_quirk_cuda, effects.bloom_quirk_plain, x),
                ("bloom_quirk_adjoint", effects.bloom_quirk_adjoint_cuda,
                 effects.bloom_quirk_adjoint_plain, g)):
            got = kern(arg)
            t0 = time.perf_counter()
            want = plain(arg)
            torch.cuda.synchronize()
            twins[(name, size_label)] = (arg, want, (time.perf_counter() - t0) * 1e3)
            torch.testing.assert_close(got, want, **BLOOM_TOL, msg=f"{name} {size_label}")
            assert torch.equal(got, kern(arg)), f"{name}: two launches differ"
            err = (got - want).abs().max().item()
            errs[name] = max(errs[name], err)
            bl["sizes"][f"{name} {size_label}"] = err
            print(f"  {name} {size_label}: max |kernel - twin| {err:.3g} (max |twin| "
                  f"{want.abs().max().item():.3g}); two launches bit-equal")
    lap("bloom.cu against its twins")

    # Each variant and the parent's bloom.cu at the three sizes, held bit for
    # bit to this tree's kernel (the full windows sum in another order: to
    # the twin).  Then times at 1024^2: this tree's kernel, each variant and
    # the parent's in turns (the list, then reversed), each call restoring
    # its input first (a 12.6 MB copy, ~0.01 ms).
    libs = {"this tree": (_build.load(), ""), **bloom_builds.result()}
    clocks = libs.pop("step clocks")[0]
    for name, (lib, log) in libs.items():
        regs = [line.strip() for line in log.splitlines() if "registers" in line]
        shape = ("the parent's kernel" if name == "parent" else
                 "a cluster of {} block(s) of {} warps, chunks of {} pixels".format(
                     *bloom_config(lib)))
        print(f"  bloom.cu {name}: {shape}{'; ptxas: ' + ' | '.join(regs) if regs else ''}")
    for (name, size_label), (arg, want, _) in twins.items():
        adjoint = name.endswith("adjoint")
        mine = (effects.bloom_quirk_adjoint_cuda if adjoint else effects.bloom_quirk_cuda)(arg)
        for lname, (lib, _log) in libs.items():
            if lname == "this tree":
                continue
            buf, out2 = torch.empty_like(arg), torch.empty_like(arg)
            in_place = adjoint and lname == "parent" and parent_in_place
            bloom_call(lib, adjoint, buf.copy_(arg), None if in_place else out2)
            got = buf if (not adjoint or in_place) else out2
            if lname == "full 441-cell windows":
                torch.testing.assert_close(got, want, **BLOOM_TOL, msg=f"{name} {lname}")
            else:
                assert torch.equal(got, mine), (f"{name} {size_label} {lname}: not bit-equal to "
                                                "this tree's")
    same = [lname for lname in libs if lname not in ("this tree", "full 441-cell windows")]
    print(f"  bloom.cu: {', '.join(same)} bit-equal to this tree's kernel at "
          f"{', '.join(inputs)}, forward and adjoint")
    bright = inputs[f"{n}^2"]
    h, w = bright.shape[0], bright.shape[1]
    row = bright[:1].contiguous()
    times = {}
    for name in ("bloom_quirk", "bloom_quirk_adjoint"):
        arg = twins[(name, f"{n}^2")][0]
        adjoint = name.endswith("adjoint")
        for turn in range(2):
            order = list(libs) if turn == 0 else list(reversed(libs))
            for lname in order:
                lib = libs[lname][0]
                in_place = adjoint and lname == "parent" and parent_in_place
                buf, out2 = torch.empty_like(arg), torch.empty_like(arg)
                slow = lname in ("one block", "full 441-cell windows")
                ms = median(time_frames(
                    lambda: bloom_call(lib, adjoint, buf.copy_(arg), None if in_place else out2),
                    iters=2 if slow else 5, warmup=1))
                times.setdefault((name, lname), []).append(ms)
        # One row of the same width: a lone row's walk, no hand-off.
        lib = libs["this tree"][0]
        buf, out2 = torch.empty_like(row), torch.empty_like(row)
        row_ms = median(time_frames(lambda: bloom_call(lib, adjoint, buf.copy_(row), out2),
                                    iters=10, warmup=2))
        times[(name, "one row")] = [row_ms]
        bl[f"{name} step cycles"] = cycles = bloom_step_cycles(
            clocks, adjoint, torch.empty_like(arg).copy_(arg), torch.empty_like(arg))
        for row_y, parts in cycles.items():
            print(f"  {name} {h}x{w}, row {row_y}: median cycles of a step's parts "
                  f"(clock64, steps 2-39) {parts}")
    lap("bloom.cu variants timed in turns")
    blocks, warps, chunk = bloom_config(libs["this tree"][0])
    for name in ("bloom_quirk", "bloom_quirk_adjoint"):
        adjoint = name.endswith("adjoint")
        ms = median(times[(name, "this tree")])
        row_ms = times[(name, "one row")][0]
        step_us = row_ms * 1e3 / w  # a pixel's step in a lone row
        lag_us = (ms - row_ms) * 1e3 / (h - 1)  # derived: what each row adds
        handoff_us = lag_us - 11 * step_us  # the lag beyond 11 pixel steps
        plain_ms = twins[(name, f"{n}^2")][2]
        b_ms, b_by = roofline.bound_ms(*_bloom_work(h, w, adjoint=adjoint))
        chain = 11 * (h - 1) + w
        floor_ms = chain * step_us / 1e3  # the data's chain at this step, hand-offs free
        variants = {lname: [round(t, 5) for t in times[(name, lname)]]
                    for lname in libs if lname != "this tree"}
        bl[name] = {"ms": ms, "turns_ms": times[(name, "this tree")], "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "cluster_blocks": blocks,
                    "warps_per_block": warps, "chunk": chunk, "one_row_ms": row_ms,
                    "pixel_step_us": step_us, "row_lag_us": lag_us, "handoff_us": handoff_us,
                    "chain_steps": chain, "chain_floor_ms": floor_ms, "variants_ms": variants}
        print(f"  {name} {h}x{w}: {ms:.4f} ms (turns {times[(name, 'this tree')]}), a cluster "
              f"of {blocks} blocks ran; twin {plain_ms:.2f} ms (x{plain_ms / ms:.0f}), bound "
              f"{b_ms:.5f} ms by {b_by} ({b_ms / ms:.2%} of it); one row {row_ms:.4f} ms: "
              f"{step_us:.4f} us a pixel step; {lag_us:.3f} us a row (derived), "
              f"{handoff_us:.3f} us of it beyond 11 steps (chunks and hand-off); the chain "
              f"of 11 (H-1) + W = {chain} pixel steps alone {floor_ms:.4f} ms")
        for lname, ts in variants.items():
            print(f"    {lname}: {ts} ms (x{median(ts) / ms:.2f} this tree's)")
        kernels.append({"name": name, "route": "cuda",
                        "source": "cg_raytracer_tpu_torch/csrc/bloom.cu",
                        "replaces": "cg_raytracer_tpu/ops/effects.py:132",
                        "launches": main_counts.get(f"{name}_cuda", 0), "max_abs_err": errs[name],
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None})
    lap("bloom.cu")
    return bl


def dispatch_phase(out, device, kernels, e2e, results, scenes, mb_twins,
                   parent=None) -> dict:
    """Phase 36: compiled dispatch.  Returns the launch counts of its main
    path (the graphed frames, steps and ``optimize()``)."""
    import numpy as np
    import torch

    from cg_raytracer_tpu_torch.models import whitted
    from cg_raytracer_tpu_torch.models.whitted import make_backend, render, render_image
    from cg_raytracer_tpu_torch.ops import effects, soft
    from cg_raytracer_tpu_torch.optim import inverse
    from cg_raytracer_tpu_torch.scene import standins
    from cg_raytracer_tpu_torch.scene.presets import load_scene
    from cg_raytracer_tpu_torch.scene.types import Camera, PointLights, Spheres, make_scene
    from cg_raytracer_tpu_torch.utils import bench, checks, graphs
    from cg_raytracer_tpu_torch.utils.bench import median, time_frames
    from cg_raytracer_tpu_torch.utils.config import RenderConfig
    from cg_raytracer_tpu_torch.utils.profiling import device_breakdown

    phase("phase 36: compiled dispatch: graphed frames, steps and optimize() against eager "
          "runs; the quirk blur's kernel")
    start = time.perf_counter()
    # bloom.cu's ablations (and the parent's bloom.cu) build while the frames run.
    parent_bloom = parent is not None and os.path.exists(os.path.join(parent, CSRC, "bloom.cu"))
    parent_in_place = False  # the parent's adjoint takes one buffer (the wavefront kernel)
    if parent_bloom:
        with open(os.path.join(parent, CSRC, "bloom.cu")) as f:
            parent_in_place = "float* g_in" not in f.read()
    bloom_builds = concurrent.futures.ThreadPoolExecutor(1).submit(
        build_variants, "bloom.cu", {**BLOOM_ABLATIONS, "full 441-cell windows":
                                     bloom_full_window(), "step clocks": BLOOM_CLOCKS},
        bloom_signatures(),
        parent if parent_bloom else None, bloom_signatures(parent_in_place))

    def lap(what):
        print(f"  [{what}: {time.perf_counter() - start:.1f} s into phase 36]")

    modules = _modules() + [effects]

    def reset():
        for m in modules:
            m.reset_launch_counts()

    def read():
        torch.cuda.synchronize()
        return {k: v for m in modules for k, v in m.launch_counts().items() if v}

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    cam = Camera.default(device=device)
    cam2 = Camera.default(look_at=(0.02, -0.015, 0.01), euler_deg=(21.0, 18.5, 0.0),
                          device=device)
    mixed = make_scene(standins.mixed_meshes(),
                       spheres=Spheres(**{k: torch.as_tensor(v)
                                          for k, v in standins.mixed_spheres().items()}),
                       point_lights=PointLights.of(*standins.MIXED_LIGHTS), device=device)
    box, sbox, teacup = scenes["box"], scenes["spherical_box"], scenes["teacup"]
    steacup, donut = scenes["spherical_teacup"][0], scenes["donut"]
    n, m = DISPATCH["frame"], DISPATCH["small"]
    routes = {  # label -> (scene, size, RenderConfig flags); rows of PERF.md's table
        "box default (3)": (box, n, {}),
        "box forward-only (6)": (box, n, dict(forward_only=True)),
        "mixed default (1, 2)": (mixed, n, {}),
        "spheres preset": (load_scene("spheres", device=device), n, {}),
        "spherical box (3, 4)": (sbox, n, {}),
        "teacup default (18)": (teacup, n, {}),
        "teacup bvh_wide=2 (10)": (teacup, m, dict(bvh_wide="2")),
        "spherical teacup (18, 19)": (steacup, n, {}),
        "spherical teacup bvh_wide=2 (10, 15)": (steacup, m, dict(bvh_wide="2")),
        "spherical teacup tile=sample (10, 13)": (steacup, m,
                                                   dict(soft_shadow_tile="sample")),
        "teacup + spheres (17)": (scenes["teacup_spheres"], n, {}),
        "teacup + spheres bvh_wide=2 (9)": (scenes["teacup_spheres"], m, dict(bvh_wide="2")),
        "donut default (22)": (donut, n, {}),
        "donut bvh_wide_hbm=2 (12)": (donut, m, dict(bvh_wide_hbm="2")),
        "donut + spheres (21)": (scenes["donut_spheres"], n, {}),
        "donut + spheres bvh_wide_hbm=2 (11)": (scenes["donut_spheres"], m,
                                                dict(bvh_wide_hbm="2")),
        "box quirk bloom (bloom.cu)": (box, n, dict(bloom=True, reference_quirks=True)),
        "box quirk aa+bloom (bloom.cu)": (box, n, dict(anti_aliasing=True, bloom=True,
                                                      reference_quirks=True)),
    }
    graphs.clear()
    main_counts = {}
    table = {}
    for label, (scene, size, flags) in routes.items():
        cfg = RenderConfig(width=size, height=size, **flags)
        rcfg, accel = whitted.resolve_render(scene, cfg)
        # The main path: counts from 0, the first graphed call (warm-up,
        # capture, one replay), then one more replay.
        reset()
        t0 = time.perf_counter()
        img = render(scene, cam, cfg, generator=gen(1))
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        key = graphs.render_key(scene, cam, rcfg, accel)
        graph = graphs.CACHE.get(key)
        assert graph is not None, f"{label}: render() captured no graph"
        moved = _kd_moved(scene)
        img2 = render(moved, cam2, cfg, generator=gen(2))
        counts = read()
        # The spheres preset has no triangle: its frame is plain PyTorch.
        assert counts or scene.num_triangles == 0, f"{label}: no kernel launched"
        assert graphs.CACHE.get(key) is graph and len(graphs.CACHE) <= graphs.MAX_GRAPHS
        for k, v in counts.items():
            main_counts[k] = main_counts.get(k, 0) + v
        # Bit for bit against eager renders of the same inputs; the second
        # replay took the new material, camera and key.
        want = render(scene, cam, cfg, generator=gen(1), jit=False)
        want2 = render(moved, cam2, cfg, generator=gen(2), jit=False)
        assert torch.equal(img, want), f"{label}: graphed frame differs from the eager one"
        assert torch.equal(img2, want2), f"{label}: the second replay differs from eager"
        assert not torch.equal(img, img2), f"{label}: the replay ignored its new inputs"
        assert bool(torch.isfinite(img).all()) and img.shape == (size, size, 3)
        if scene.spherical_lights.position.shape[0] > 0:
            other = render(scene, cam, cfg, generator=gen(3))
            assert torch.equal(other, render(scene, cam, cfg, generator=gen(3), jit=False))
            assert not torch.equal(other, img), f"{label}: a new key changed no sample"
        # Eager against graphed, on the pre-resolved frame (run_bench's call).
        calls = {"eager": lambda: whitted.render_resolved(scene, cam, rcfg, accel, jit=False),
                 "graphed": lambda: whitted.render_resolved(scene, cam, rcfg, accel)}
        row = {"size": size, "first_call_s": first_s, "warmup_s": graph.warmup_s,
               "capture_s": graph.capture_s, "pool_mb": graph.pool_mb,
               "launches per replay": graph.tally.by_name(),
               "launches": counts}
        for kind, fn in calls.items():
            row[f"{kind}_ms"] = median(time_frames(fn, iters=3, warmup=1))
            prof = device_breakdown(fn, iters=2)
            row[f"{kind}_busy"] = prof["busy"]
            row[f"{kind}_device_ms"] = prof["device_ms"]
        table[label] = row
        busy = {k: ("not measured" if row[f"{k}_busy"] is None else f"{row[f'{k}_busy']:.3f}")
                for k in calls}
        print(f"  {label} {size}^2: eager {row['eager_ms']:.4f} ms (busy {busy['eager']}), "
              f"graphed {row['graphed_ms']:.4f} ms (busy {busy['graphed']}), "
              f"x{row['eager_ms'] / row['graphed_ms']:.2f}; first call {first_s:.3f} s (warm-up "
              f"{graph.warmup_s:.3f}, capture + instantiation {graph.capture_s:.3f}), pool "
              f"{graph.pool_mb:.1f} MB; frames bit-equal to eager, the second replay too; "
              f"launches {counts}")
    lap("frames")

    # Training: one graphed forward + backward (run_bench's step) against the
    # eager one, then a second replay with another jitter and material.
    steps = {"box step, full contract (8, 23, 25)": (box, DISPATCH["step"], {}),
             "teacup step, full contract (18, 24, 26)": (teacup, DISPATCH["step"], {}),
             "box quirk bloom step (bloom.cu adjoint)": (
                 box, DISPATCH["bloom_step"], dict(bloom=True, reference_quirks=True))}
    gen_j = torch.Generator(device).manual_seed(36)
    for label, (scene, size, flags) in steps.items():
        cfg = bench.training_config(
            whitted.resolve_render(scene, RenderConfig(width=size, height=size, **flags))[0],
            True)
        accel = whitted.build_accel(scene, cfg) if whitted.needs_bvh(
            cfg, scene.num_triangles, device) else None

        def owner(s, c, j, key, cfg=cfg, accel=accel):
            return bench.fwd_bwd_step(s, c, cfg, bench.training_params(s, True), j,
                                      accel=accel, generator=key)

        def graphed(s, j):
            return graphs.fwd_bwd(owner, (s, cam, j), None, cfg, accel, owner=owner)

        def eager(s, j):
            return bench.fwd_bwd_step(s, cam, cfg, bench.training_params(s, True), j,
                                      accel=accel)

        jit1, jit2 = (bench.camera_jitter(gen_j, device) for _ in range(2))
        reset()
        t0 = time.perf_counter()
        got = graphed(scene, jit1)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        moved = _kd_moved(scene)
        got2 = graphed(moved, jit2)
        counts = read()
        assert counts, f"{label}: no kernel launched"
        for k, v in counts.items():
            main_counts[k] = main_counts.get(k, 0) + v
        row = {"size": size, "first_call_s": first_s, "launches": counts}
        for which, (g, w) in (("first", (got, eager(scene, jit1))),
                              ("second", (got2, eager(moved, jit2)))):
            assert torch.equal(g[0], w[0]), f"{label} {which}: loss {g[0]} != eager {w[0]}"
            exact = all(torch.equal(g[1][k], w[1][k]) for k in w[1])
            for k in w[1]:
                assert bool(torch.isfinite(g[1][k]).all()), (label, k)
                tol = dict(checks.TABLE_GRAD, atol=2e-5) if k == "vertices" else checks.TABLE_GRAD
                torch.testing.assert_close(g[1][k], w[1][k], **tol, msg=f"{label} d/d{k}")
            row[f"{which} grads bit-equal"] = exact
            row[f"{which} max grad diff"] = max((g[1][k] - w[1][k]).abs().max().item()
                                                for k in w[1])
        assert not torch.equal(got[0], got2[0]), f"{label}: the replay ignored its inputs"
        for kind, fn in (("eager", lambda: eager(scene, jit1)),
                         ("graphed", lambda: graphed(scene, jit1))):
            row[f"{kind}_ms"] = median(time_frames(fn, iters=3, warmup=1))
            prof = device_breakdown(fn, iters=2)
            row[f"{kind}_busy"], row[f"{kind}_device_ms"] = prof["busy"], prof["device_ms"]
        table[label] = row
        busy = {k: ("not measured" if row[f"{k}_busy"] is None else f"{row[f'{k}_busy']:.3f}")
                for k in ("eager", "graphed")}
        print(f"  {label} {size}^2: eager {row['eager_ms']:.4f} ms, graphed "
              f"{row['graphed_ms']:.4f} ms (x{row['eager_ms'] / row['graphed_ms']:.2f}), busy "
              f"{busy['eager']} / {busy['graphed']}; loss bit-equal; gradients "
              f"{'bit-equal' if row['first grads bit-equal'] else 'within TABLE_GRAD'} (max "
              f"diff {row['first max grad diff']:.3g}; second replay "
              f"{row['second max grad diff']:.3g}); "
              f"first call {first_s:.3f} s; launches {counts}")
    assert main_counts.get("bloom_quirk_adjoint_cuda", 0) > 0, "the adjoint never launched"
    lap("steps")

    # optimize(steps_per_call=8): 16 vertex steps of the teacup, graphed
    # against the eager loop (the same capturable Adam).
    size = DISPATCH["opt"]
    cfg = RenderConfig(width=size, height=size)
    shift = torch.tensor([0.0, 0.0, 0.02], device=device)  # phase 22's problem
    start_scene = dataclasses.replace(teacup, vertices=teacup.vertices + shift)
    target = render(teacup, cam, cfg)
    run = dict(steps=DISPATCH["opt_steps"], learning_rate=3e-4,
               params=inverse.vertex_params(start_scene), apply_params=inverse.apply_vertex_params,
               log_every=0, steps_per_call=DISPATCH["opt_k"])
    reset()
    t0 = time.perf_counter()
    p_g, l_g = inverse.optimize(start_scene, cam, target, cfg, **run)
    torch.cuda.synchronize()
    opt_g_s = time.perf_counter() - t0
    opt_counts = read()
    for k, v in opt_counts.items():
        main_counts[k] = main_counts.get(k, 0) + v
    t0 = time.perf_counter()
    p_e, l_e = inverse.optimize(start_scene, cam, target, cfg, jit=False, **run)
    torch.cuda.synchronize()
    opt_e_s = time.perf_counter() - t0
    # The chunk alone: a K-step loop captured once, then two chunks replayed,
    # against the eager loop's two chunks (host clock; the optimizer moves on).
    from cg_raytracer_tpu_torch.ops.refit import make_refit_plan
    from cg_raytracer_tpu_torch.parallel import sharding

    tcfg = inverse.training_config(cfg, True)
    accel = whitted.build_accel(start_scene, tcfg)
    chunk_s = {}
    for kind, jit in (("graphed", True), ("eager", False)):
        params = {"vertices": start_scene.vertices.detach().clone().requires_grad_(True)}
        adam = torch.optim.Adam(list(params.values()), lr=3e-4, capturable=True)
        loop = sharding.make_train_loop(tcfg, adam, inverse.apply_vertex_params,
                                        DISPATCH["opt_k"], accel=accel,
                                        refit_plan=make_refit_plan(accel), jit=jit)
        base = soft.draw_key(None)
        loop(params, start_scene, cam, target, base, 0).tolist()  # the capture (or a warm-up)
        t0 = time.perf_counter()
        for c in (1, 2):
            loop(params, start_scene, cam, target, base, c * DISPATCH["opt_k"]).tolist()
        chunk_s[kind] = (time.perf_counter() - t0) / (2 * DISPATCH["opt_k"])
        graphs.forget(loop)
    print(f"  optimize() losses: graphed {l_g}, eager {l_e}")
    # The shade backward's atomics add in another order in each run, and a
    # vertex step can move a hit edge: phase 22's rtol for the losses,
    # TABLE_GRAD for the vertices.
    np.testing.assert_allclose(l_g, l_e, rtol=1e-4, atol=0.0)
    torch.testing.assert_close(p_g["vertices"], p_e["vertices"], **checks.TABLE_GRAD)
    assert l_g[-1] < l_g[0], "optimize() did not lower the loss"
    opt = {"size": size, "steps": DISPATCH["opt_steps"], "k": DISPATCH["opt_k"],
           "losses bit-equal": l_g == l_e,
           "max loss rel diff": max(abs(a - b) / abs(b) for a, b in zip(l_g, l_e)),
           "max vertex diff": (p_g["vertices"] - p_e["vertices"]).abs().max().item(),
           "graphed_s": opt_g_s, "eager_s": opt_e_s, "chunk_step_ms": {
               k: v * 1e3 for k, v in chunk_s.items()}, "launches": opt_counts}
    table["optimize teacup vertices"] = opt
    same = "bit-equal to" if opt["losses bit-equal"] else "within rtol 1e-4 of"
    print(f"  optimize() {DISPATCH['opt_steps']} teacup vertex steps {size}^2, steps_per_call "
          f"{DISPATCH['opt_k']}: losses {same} the eager loop's (max rel diff "
          f"{opt['max loss rel diff']:.3g}, vertices {opt['max vertex diff']:.3g}); "
          f"{opt_g_s / DISPATCH['opt_steps'] * 1e3:.3f} ms per step with the captures, eager "
          f"{opt_e_s / DISPATCH['opt_steps'] * 1e3:.3f}; a chunk's steps replayed "
          f"{chunk_s['graphed'] * 1e3:.3f} ms each, eager {chunk_s['eager'] * 1e3:.3f} "
          f"(host clock, the chunk's losses read once); launches {opt_counts}")
    lap("optimize")

    bl = bloom_part(device, kernels, main_counts, box, cam, bloom_builds, parent_in_place, lap)

    # The teacup's motion-blur sets against the twins (on the CPU, started
    # with the script): the graphed kernel renders at the same size.
    size = DISPATCH["mb"]
    for name in MB_SETS:
        proc, path = mb_twins[name]
        stdout, stderr = proc.communicate()
        assert proc.returncode == 0, f"the {name} twin process failed:\n{stdout}{stderr}"
        twin = torch.load(path).to(device)
        cfg = RenderConfig(width=size, height=size, **EFFECTS[name])
        img = render(teacup, cam, cfg)
        images_close(img, twin, f"teacup {size}^2 {name} (graphed kernels) vs the plain twins "
                                f"(CPU)",
                     max_bad=min(1.0, IMG_MAX_BAD * sub_renders(EFFECTS[name])))
    lap("the teacup's motion blur against the twins")
    results["dispatch"] = {"routes": table, "bloom": bl, "cache": len(graphs.CACHE)}
    e2e["dispatch"] = {k: {kk: v.get(kk) for kk in ("eager_ms", "graphed_ms", "eager_busy",
                                                    "graphed_busy")}
                       for k, v in table.items() if "eager_ms" in v}
    graphs.clear()
    print(f"  launches of phase 36's main path (graphed frames, steps, optimize): {main_counts}")
    return main_counts


LEVEL_OUTPUTS = ("color", "throughput", "active", "o_next", "d_next")
SURFACE_FIELDS = ("valid", "position", "normal", "kd", "ks", "shininess")
LEVEL_KERNELS = ("level_cuda", "level_surface_cuda", "level_shade_cuda")
# Phase 37's routes and their parent-tree turns: label -> (scene name, size, flags).
LEVEL_SCENE_NAMES = ("box", "mixed", "spheres", "spherical_box", "teacup", "donut",
                     "donut_spheres")
LEVEL_ROUTES = {
    "box default": ("box", "frame", {}),
    "box quirks": ("box", "frame", dict(reference_quirks=True)),
    "mixed": ("mixed", "frame", {}),
    "spheres preset": ("spheres", "frame", {}),
    "spherical box": ("spherical_box", "frame", {}),
    "teacup default": ("teacup", "frame", {}),
    "teacup bvh_wide=2": ("teacup", "small", dict(bvh_wide="2")),
    "donut default": ("donut", "frame", {}),
    "donut + spheres": ("donut_spheres", "frame", {}),
}
LEVEL_SCENES_SNIPPET = """
def level_scenes(device, have):
    # Phase 37's scenes: those in ``have`` (built by earlier phases, their
    # trees memoized) as they are, the others built here.
    import dataclasses, torch
    from cg_raytracer_tpu_torch.scene import standins
    from cg_raytracer_tpu_torch.scene.presets import load_scene, load_standin
    from cg_raytracer_tpu_torch.scene.types import PointLights, Spheres, make_scene
    two = lambda: Spheres(center=torch.tensor([[0.55, -0.35, -0.45], [-0.6, 0.45, 0.3]]),
                          radius=torch.tensor([0.2, 0.15]),
                          kd=torch.tensor([[0.9, 0.2, 0.2], [0.2, 0.3, 0.9]]),
                          ks=torch.tensor([[0.3, 0.3, 0.3], [0.0, 0.0, 0.0]]),
                          shininess=torch.tensor([20.0, 1.0])).to(device)
    build = {
        "box": lambda: load_standin("mirror_box", device=device),
        "mixed": lambda: make_scene(standins.mixed_meshes(), spheres=Spheres(**{
            k: torch.as_tensor(v) for k, v in standins.mixed_spheres().items()}),
            point_lights=PointLights.of(*standins.MIXED_LIGHTS), device=device),
        "spheres": lambda: load_scene("spheres", device=device),
        "spherical_box": lambda: load_standin("spherical_box", device=device),
        "teacup": lambda: load_scene("teacup", device=device),
        "donut": lambda: load_scene("donut", device=device),
        "donut_spheres": lambda: dataclasses.replace(out["donut"], spheres=two()),
    }
    out = {}
    for name, make in build.items():
        out[name] = have[name] if name in have else make()
    return out
"""
# One process per tree (``--parent``): each route's graphed frame, its busy
# share and kernels per frame, printed as JSON.
LEVEL_E2E_SNIPPET = LEVEL_SCENES_SNIPPET + """
import json, sys, torch
sys.path.insert(0, ".")
from cg_raytracer_tpu_torch.models import whitted
from cg_raytracer_tpu_torch.scene.types import Camera
from cg_raytracer_tpu_torch.utils.bench import median, time_frames
from cg_raytracer_tpu_torch.utils.config import RenderConfig
from cg_raytracer_tpu_torch.utils.profiling import device_breakdown
routes, sizes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
scenes, cam, out = level_scenes("cuda", {}), Camera.default(device="cuda"), {}
for label, (name, size, flags) in routes.items():
    size = sizes[size]
    rcfg, accel = whitted.resolve_render(scenes[name], RenderConfig(width=size, height=size,
                                                                    **flags))
    fn = lambda: whitted.render_resolved(scenes[name], cam, rcfg, accel)
    prof = device_breakdown(fn, iters=2)
    out[label] = {"graphed_ms": median(time_frames(fn, iters=5, warmup=1)), "busy": prof["busy"],
                  "kernels": sum(k[2] for k in prof["kernels"])}
print(json.dumps(out))
"""


def ulp_gap(a, b) -> int:
    """The largest distance in units of the last place between two float32
    tensors (their int32 words, signs folded onto one line)."""
    import torch

    def line(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int((line(a) - line(b)).abs().max().item()) if a.numel() else 0


def level_phase(out, device, kernels, e2e, results, scenes, parent=None) -> dict:
    """Phase 37: the default route's bounce level (``csrc/level.cu``).
    Returns the launch counts of its main path (the routes' graphed frames)."""
    import torch

    from cg_raytracer_tpu_torch.models import whitted
    from cg_raytracer_tpu_torch.models.whitted import make_backend, render, render_image
    from cg_raytracer_tpu_torch.ops import level as lv
    from cg_raytracer_tpu_torch.ops import shading
    from cg_raytracer_tpu_torch.ops.intersect import reconstruct_hit
    from cg_raytracer_tpu_torch.scene.types import Camera
    from cg_raytracer_tpu_torch.utils import graphs, roofline
    from cg_raytracer_tpu_torch.utils.bench import median, time_frames
    from cg_raytracer_tpu_torch.utils.config import RenderConfig
    from cg_raytracer_tpu_torch.utils.profiling import device_breakdown

    phase("phase 37: the default route's bounce level (csrc/level.cu): every level of every "
          "route against the chain bit for bit, graphed frames, kernels per frame")
    start = time.perf_counter()
    namespace = {}
    exec(LEVEL_SCENES_SNIPPET, namespace)  # the parent's turns build the same scenes
    built = namespace["level_scenes"](device, {k: v for k, v in scenes.items()
                                               if k in LEVEL_SCENE_NAMES})
    cam = Camera.default(device=device)
    sizes = {"frame": DISPATCH["frame"], "small": DISPATCH["small"]}
    routes = {label: (built[name], sizes[size], flags)
              for label, (name, size, flags) in LEVEL_ROUTES.items()}

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    # Every level of every route: the kernels' wrapper and the chain on the
    # same inputs (the frame's own, through a backend whose level runs both).
    gaps, err = {}, {k: 0.0 for k in LEVEL_KERNELS}
    timed = {}  # label -> the first level's inputs, for the kernel rows

    def checked(label):
        calls = {"n": 0}

        def level(scene, o, d, hit, bits, color, thr, active, cfg, backend, key=None,
                  last=False):
            args = (scene, o, d, hit, bits, color, thr, active, cfg, backend, key)
            want = lv.level_plain(*args, last=last)
            got = lv.level_cuda(*args, last=last)
            lvl = calls["n"] % cfg.max_depth
            calls["n"] += 1
            fused = bits is not None and scene.spherical_lights.position.shape[0] == 0
            which = "level_cuda" if fused else "level_shade_cuda"
            for name, g, w in zip(LEVEL_OUTPUTS, got, want):
                assert (g is None) == (w is None), (label, name)
                if w is None:
                    continue
                if not same_bits(g, w):  # named below, held to the checks' rule
                    assert w.dtype == torch.float32, f"{label} level {lvl}: {name} differs"
                    torch.testing.assert_close(g, w, **SHADE_FWD)
                    gaps[(label, lvl, name)] = ulp_gap(g, w)
                    err[which] = max(err[which], (g - w).abs().max().item())
            surf_g = lv.level_surface_cuda(scene, o, d, hit)
            surf_w = reconstruct_hit(scene, o, d, hit)
            for name, g, w in zip(SURFACE_FIELDS, surf_g, surf_w):
                if not same_bits(g, w):
                    assert w.dtype == torch.float32, f"{label} level {lvl}: surface {name}"
                    torch.testing.assert_close(g, w, **SHADE_FWD)
                    gaps[(label, lvl, "surface " + name)] = ulp_gap(g, w)
                    err["level_surface_cuda"] = max(err["level_surface_cuda"],
                                                    (g - w).abs().max().item())
            if lvl == 0 and label not in timed:
                timed[label] = (args, last, surf_g)
            return got

        return level

    frames = {}
    for label, (scene, size, flags) in routes.items():
        rcfg, accel = whitted.resolve_render(scene, RenderConfig(width=size, height=size,
                                                                 **flags))
        backend = make_backend(scene, rcfg, accel=accel)
        img = render_image(scene, cam, rcfg, backend=backend._replace(level=checked(label)),
                           generator=gen(1))
        chain = render_image(scene, cam, rcfg, backend=backend._replace(level=lv.level_plain),
                             generator=gen(1))
        assert same_bits(img, chain), f"{label}: the kernels' frame differs from the chain's"
        assert bool(torch.isfinite(img).all()) and img.shape == (size, size, 3)
        frames[label] = (scene, rcfg, accel, chain)
    torch.cuda.synchronize()
    named = {}
    for (label, lvl, name), gap in gaps.items():
        named[name] = max(named.get(name, 0), gap)
    print(f"  every output of every level, {len(routes)} routes: "
          + ("bit-equal to the chain" if not gaps else
             f"bit-equal but {sorted(named)}, which fall to utils/checks.py's rule (max ulp "
             f"gap {named}; levels {sorted(gaps)})"))
    lap = lambda what: print(f"  [{what}: {time.perf_counter() - start:.1f} s into phase 37]")
    lap("levels checked")

    # The main path: every route's graphed frame, the counts from 0.
    graphs.clear()
    _reset_counts()
    for label, (scene, size, flags) in routes.items():
        img = render(scene, cam, RenderConfig(width=size, height=size, **flags),
                     generator=gen(1))
        assert same_bits(img, frames[label][3]), (
            f"{label}: the graphed frame differs from the chain's eager frame")
    main_counts = _read_counts()
    for w in LEVEL_KERNELS:
        assert main_counts.get(w, 0) > 0, f"{w} never launched on the default routes"
    print(f"  graphed frames bit-equal to the chain's eager frames; launches {main_counts}")
    graphs.clear()
    lap("graphed frames")

    # Graphed frames: the kernels' against the chain's (make_backend takes the
    # chain where level_cuda is swapped for it), in turns; kernels per frame.
    table = {}
    for label, (scene, rcfg, accel, _) in frames.items():
        key = whitted._frame_key(scene, gen(1))
        roots = [] if key is None else [key]
        held = {}

        def replay(graph):
            """One frame of ``graph`` on this route's inputs, as render() runs it."""
            graph.load((scene, cam))
            return graph.replay(roots)

        for who in ("kernel", "chain"):
            if who == "chain":
                lv.level_cuda, kept = lv.level_plain, lv.level_cuda
            try:
                whitted.render_resolved(scene, cam, rcfg, accel, generator=gen(1))
                gkey = graphs.render_key(scene, cam, rcfg, accel)
                held[who] = graphs.CACHE.entries.pop(gkey)
            finally:
                if who == "chain":
                    lv.level_cuda = kept
        row = {}
        for who in ("kernel", "chain", "chain", "kernel"):
            fn = partial(replay, held[who])
            row.setdefault(f"{who}_ms", []).append(median(time_frames(fn, iters=3, warmup=1)))
        for who, g in held.items():
            prof = device_breakdown(partial(replay, g), iters=2)
            row[f"{who}_busy"] = prof["busy"]
            row[f"{who}_kernels"] = sum(k[2] for k in prof["kernels"])
            row[f"{who}_by_name"] = {k[0][:80]: k[2] for k in prof["kernels"]}
            g.release()
        table[label] = row
        k_ms, c_ms = sum(row["kernel_ms"]) / 2, sum(row["chain_ms"]) / 2
        busy = {w: "not measured" if row[f"{w}_busy"] is None else f"{row[f'{w}_busy']:.3f}"
                for w in held}
        print(f"  {label} {rcfg.width}^2 graphed: kernel {row['kernel_ms'][0]:.4f}, "
              f"{row['kernel_ms'][1]:.4f} ms (busy {busy['kernel']}, "
              f"{row['kernel_kernels']:g} kernels a frame); chain {row['chain_ms'][0]:.4f}, "
              f"{row['chain_ms'][1]:.4f} ms (busy {busy['chain']}, {row['chain_kernels']:g} "
              f"kernels); x{c_ms / k_ms:.2f}")
    # What the kernel route's frame still launches, most launched first.
    top = sorted(table["box default"]["kernel_by_name"].items(), key=lambda kv: -kv[1])
    print("  box default, the kernel route's launches a frame by kernel: " + "; ".join(
        f"{n:g} {k}" for k, n in top[:12]))
    lap("graphed frames timed")

    # The kernel rows: each wrapper on its route's first level, against the
    # plain version on the same inputs.
    rows = {"level_cuda": "box default", "level_surface_cuda": "spherical box",
            "level_shade_cuda": "spherical box"}
    for wrapper, label in rows.items():
        (scene, o, d, hit, bits, color, thr, active, cfg, backend, key), last, surf = timed[label]
        prim = hit.prim_id
        if wrapper == "level_cuda":
            run = partial(lv.level_cuda, scene, o, d, hit, bits, color, thr, active, cfg, backend,
                          key, last=last)
            plain = partial(lv.level_plain, scene, o, d, hit, bits, color, thr, active, cfg,
                            backend, key, last=last)
            work = roofline.level_work(scene, prim, "level", bits=True, state=color is not None,
                                       last=last)
        elif wrapper == "level_surface_cuda":
            run = partial(lv.level_surface_cuda, scene, o, d, hit)
            plain = partial(reconstruct_hit, scene, o, d, hit)
            work = roofline.level_work(scene, prim, "surface")
        else:
            fracs = shading.spherical_fracs(
                scene, surf.position, backend.occluded, key, num_samples=cfg.soft_shadow_samples,
                sample_chunk=cfg.soft_shadow_chunk, soft_vis_fn=backend.soft_vis,
                valid=surf.valid)
            shade_args = (scene, d, surf, bits, None, fracs, color, thr, active,
                          cfg.reference_quirks, last)
            got, want = lv.level_shade_cuda(*shade_args), lv.level_shade_plain(*shade_args)
            for name, g, w in zip(LEVEL_OUTPUTS, got, want):
                assert (g is None and w is None) or same_bits(g, w) or name in named, name
            run = partial(lv.level_shade_cuda, *shade_args)
            plain = partial(lv.level_shade_plain, *shade_args)
            work = roofline.level_work(scene, prim, "shade", bits=bits is not None,
                                       state=color is not None, last=last)
        ms = batched_ms(run)
        plain_ms = median(time_frames(plain, iters=5, warmup=1))
        b_ms, b_by = roofline.bound_ms(*work)
        name, source, replaces = KERNELS[wrapper]
        print(f"  {name} ({label}, {o.shape[0]} rays, level 0): ms {ms:.5f}, plain_ms "
              f"{plain_ms:.4f} (x{plain_ms / ms:.1f}), bound_ms {b_ms:.5f} by {b_by} "
              f"({b_ms / ms:.1%} of it); launches {main_counts[wrapper]}")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": main_counts[wrapper], "max_abs_err": err[wrapper],
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None})
    lap("kernel rows")

    if parent:
        runs = {"parent": [], "this tree": []}
        argv = [json.dumps(LEVEL_ROUTES), json.dumps(sizes)]
        for who in ("parent", "this tree", "this tree", "parent"):
            r = subprocess.run([sys.executable, "-c", LEVEL_E2E_SNIPPET, *argv],
                               capture_output=True, text=True,
                               cwd=parent if who == "parent" else ROOT, timeout=600)
            assert r.returncode == 0, f"{who}: {r.stderr[-3000:]}"
            runs[who].append(json.loads(r.stdout.strip().splitlines()[-1]))
        for label in LEVEL_ROUTES:
            vals = {who: [run[label] for run in rs] for who, rs in runs.items()}
            table[label]["parent vs this tree"] = vals
            print(f"  {label} graphed, in turns: parent "
                  f"{[round(v['graphed_ms'], 4) for v in vals['parent']]} ms "
                  f"({vals['parent'][0]['kernels']:g} kernels, busy "
                  f"{vals['parent'][0]['busy']}), this tree "
                  f"{[round(v['graphed_ms'], 4) for v in vals['this tree']]} ms "
                  f"({vals['this tree'][0]['kernels']:g} kernels, busy "
                  f"{vals['this tree'][0]['busy']})")
        lap("the parent's turns")
    results["level"] = {"routes": table, "ulp_gaps": {f"{k[0]} level {k[1]} {k[2]}": v
                                                      for k, v in gaps.items()}}
    e2e["level"] = table
    return {w: main_counts[w] for w in LEVEL_KERNELS}

if __name__ == "__main__":
    sys.exit(main())
