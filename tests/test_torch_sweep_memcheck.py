"""PyTorch port, the brute-force sweep kernels' memory safety, on the CPU.

The CUDA sources ``csrc/oracle.cu``, ``csrc/trace.cu`` and ``csrc/record.cu``
(with ``sweep.cuh``) are compiled as host C++ against the stand-in CUDA
header of ``tests/cuda_emu`` with AddressSanitizer and UBSan.  Their
launches run one block at a time with the block's threads at once
(``emu_launch_threads``: the staging barrier is a barrier) over 529 rays:
five blocks of 128, the last one ragged, as launched on the card; and, in
one case per kernel, a grid cut to two blocks (``emu_max_grid``), so that
each block strides over the rays more than once, as under a one-wave grid.
Every array lives in a heap buffer of exactly its size, the kernels'
shared memory too, so a stray load or store aborts the run.

Each entry point runs on tables of 1, 32 (the stand-in mirror box) and 256
triangles (the box with each quad cut into eight), with 0, 1 and 30 point
lights for the shadow bits, 8 lights and two spheres for the trace, dead
rays (``t_max < 0``) and depths 1-3.  Hits, records and bits are held to
the plain twins of ``ops/cuda_kernels.py`` exactly (bit for bit), the
trace's colors at ``chip_smoke.py``'s image tolerance.  A planted fault
proves the harness sees the staging: a build that stages one triangle past
the table must abort.
"""
import functools
import os
import re
import shutil
import struct
import subprocess

import numpy as np
import pytest
import torch

import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu_torch.ops import cuda_kernels as ck
from cg_raytracer_tpu_torch.ops.camera import generate_rays
from cg_raytracer_tpu_torch.scene import standins
from cg_raytracer_tpu_torch.scene.types import PointLights, Spheres, make_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "cg_raytracer_tpu_torch", "csrc")
EMU = os.path.join(ROOT, "tests", "cuda_emu")
SOURCES = ("oracle.cu", "trace.cu", "record.cu")
SIZE = 23  # 529 rays: five blocks of 128 on a grid of two, the last one ragged
IMG_ATOL, IMG_MAX_BAD = 1e-4, 0.005  # chip_smoke.py's image tolerance
KINDS = ("closest", "anyhit", "bounce", "trace", "record", "bounce_refl")


def build(out, csrc):
    """The sanitized host build of ``csrc``'s three sweep sources in one
    translation unit, their launches rewritten to ``emu_launch_threads`` and
    their dynamic shared memory to the emulator's; returns the started g++."""
    parts = []
    for name in SOURCES:
        with open(os.path.join(csrc, name)) as f:
            src = f.read()
        src, launches = re.subn(r"([\w:]+(?:<[^<>;]*>)?)<<<([^;]*?)>>>\(",
                                r"emu_launch_threads(\2, \1, ", src)
        src, shared = re.subn(r"extern __shared__ (\w+) (\w+)\[\];",
                              r"\1* const \2 = emu_dynamic_shared<\1>();", src)
        assert launches == shared == (2 if name == "record.cu" else 1), name
        parts.append(src)
    with open(os.path.join(out, "sweep_emu.cpp"), "w") as f:
        f.write("\n".join(parts))
    exe = os.path.join(out, "sweep_memcheck")
    cmd = ["g++", "-std=c++17", "-O1", "-g", "-fsanitize=address,undefined",
           "-fno-sanitize-recover=all", "-fno-omit-frame-pointer", "-ffp-contract=off",
           "-pthread", "-I", EMU, "-I", csrc, os.path.join(out, "sweep_emu.cpp"),
           os.path.join(EMU, "sweep_main.cpp"), "-o", exe]
    return exe, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(job):
    exe, proc = job
    _, err = proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    return exe


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """(the build, the planted build's directory and job): both g++ runs
    started together."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation")
    out = tmp_path_factory.mktemp("sweep_emu")
    planted = tmp_path_factory.mktemp("sweep_planted")
    csrc = planted / "csrc"
    shutil.copytree(CSRC, csrc)
    header = csrc / "sweep.cuh"
    text, n = re.subn(re.escape("for (int k = threadIdx.x; k < num_tris; k += blockDim.x) {"),
                      "for (int k = threadIdx.x; k <= num_tris; k += blockDim.x) {",
                      header.read_text())
    assert n == 1, "stage_rows3's loop was not found"
    header.write_text(text)
    good = build(str(out), CSRC)
    bad = build(str(planted), str(csrc))
    return finish(good), out, (planted, bad)


@functools.lru_cache(maxsize=None)
def scene(num_tris, num_lights, num_spheres=0):
    """The mirror box at 1 (the mirror's first triangle), 32 or 256
    triangles, with 0, 1 (the box's), 8 (``DENSE_BOX_LIGHTS``) or 30 point
    lights (from a seed, inside the box) and 0 or 2 spheres."""
    meshes = (standins.dense_mirror_box_meshes() if num_tris == 256
              else standins.mirror_box_meshes())
    if num_tris == 1:
        mirror = dict(meshes[-1], triangles=meshes[-1]["triangles"][:1])
        meshes = [mirror]
    if num_lights == 1:
        lights = standins.MIRROR_BOX_LIGHTS
    elif num_lights == 8:
        lights = standins.DENSE_BOX_LIGHTS
    else:
        rng = np.random.default_rng(30)
        pos = rng.normal(size=(num_lights, 3))
        pos *= (0.5 * rng.uniform(0.2, 1.0, (num_lights, 1)) / np.linalg.norm(pos, axis=1,
                                                                              keepdims=True))
        lights = tuple((tuple(p), (0.03, 0.03, 0.03)) for p in pos.tolist())
    spheres = None
    if num_spheres:
        spheres = Spheres(center=torch.tensor([[-0.2, 0.1, 0.1], [0.25, -0.1, -0.2]]),
                          radius=torch.tensor([0.12, 0.1]),
                          kd=torch.tensor([[0.2, 0.5, 0.8], [0.7, 0.7, 0.2]]),
                          ks=torch.tensor([[0.4, 0.4, 0.4], [0.0, 0.0, 0.0]]),
                          shininess=torch.tensor([30.0, 1.0]))
    sc = make_scene(meshes, spheres=spheres,
                    point_lights=PointLights.of(*lights) if lights else None, device="cpu")
    assert sc.num_triangles == num_tris and sc.point_lights.position.shape[0] == num_lights
    return sc


@functools.lru_cache(maxsize=None)
def rays():
    """529 camera rays; t_max for the closest sweeps (every seventh ray dead,
    every third bounded); the camera rays' shadow rays toward the box's
    light with a random t_max (the misses and every seventh ray dead)."""
    gen = torch.Generator().manual_seed(9)
    o, d = generate_rays(trt.Camera.default(device="cpu"), SIZE, SIZE)
    n = o.shape[0]
    k = torch.arange(n)
    bounded = torch.where(k % 3 == 0, torch.rand(n, generator=gen) * 3.0, ck.INF)
    tm = torch.where(k % 7 == 0, -1.0, bounded)
    box = scene(32, 1)
    hit = ck.intersect_plain(box, o, d)
    valid = hit.prim_id >= 0
    p = o + d * torch.where(valid, hit.t, 0.0)[:, None]
    so, sd, dist = ck._shadow_rays(p, box.point_lights.position[0])
    st = (dist - ck.SHADOW_EPS) * torch.rand(n, generator=gen) * 1.5
    st = torch.where(valid & (k % 7 != 0), st, -1.0)
    live = k % 5 != 0
    return (o.contiguous(), d.contiguous(), tm.contiguous(), so.contiguous(), sd.contiguous(),
            st.contiguous(), torch.where(live, ck.INF, -1.0).contiguous())


def launch_inputs(kind, num_tris, num_lights, num_spheres):
    """(rays o, d, t_max or None, the tables the kind reads)."""
    sc = scene(num_tris, num_lights, num_spheres)
    o, d, tm, so, sd, st, live_tm = rays()
    tri = ck._tri_table(sc)
    lights3 = sc.point_lights.position.contiguous()
    if kind == "closest":
        return o, d, tm, (tri,)
    if kind == "anyhit":
        return so, sd, st, (tri,)
    if kind == "bounce":
        return o, d, live_tm, (tri, lights3)
    if kind == "trace":
        return o, d, None, (tri, ck._aux_table(sc), ck._light_table(sc), ck._sphere_table(sc))
    if kind == "record":
        return o, d, None, (tri, ck._aux_table(sc), lights3)
    return o, d, live_tm, (tri, ck._aux_table(sc), lights3)


def run_emulated(exe, out, tag, kind, num_tris, num_lights, num_spheres=0, depth=1, quirk=0,
                 grid=0):
    """The emulated launch (its grid cut to ``grid`` blocks where not 0) ->
    (completed process, outputs or None)."""
    o, d, tm, tables = launch_inputs(kind, num_tris, num_lights, num_spheres)
    n = o.shape[0]
    header = struct.pack("<9q", KINDS.index(kind), n, num_tris, num_lights, num_spheres, depth,
                         quirk, int(tm is not None), grid)
    path = out / f"{tag}.in"
    with open(path, "wb") as f:
        f.write(header)
        for a in (o, d, tm, *tables):
            if a is not None:
                f.write(a.contiguous().numpy().tobytes())
    env = dict(os.environ, ASAN_OPTIONS="detect_leaks=0:abort_on_error=0",
               UBSAN_OPTIONS="print_stacktrace=1")
    r = subprocess.run([exe, str(path), str(out / f"{tag}.out")], capture_output=True, text=True,
                       env=env, timeout=120)
    if r.returncode != 0:
        return r, None
    f32, i32, u8 = np.float32, np.int32, np.uint8
    level, rest = (depth, n), (depth - 1, n)
    layout = {
        "closest": [(f32, (n,)), (i32, (n,)), (f32, (n,)), (f32, (n,))],
        "anyhit": [(u8, (n,))],
        "bounce": [(f32, (n,)), (i32, (n,)), (f32, (n,)), (f32, (n,)), (i32, (n,))],
        "trace": [(f32, (n, 3))],
        "record": [(f32, level), (i32, level), (f32, level), (f32, level), (i32, level),
                   (f32, rest + (3,)), (f32, rest + (3,)), (u8, rest)],
        "bounce_refl": [(f32, (n,)), (i32, (n,)), (f32, (n,)), (f32, (n,)), (i32, (n,)),
                        (f32, (n, 3)), (f32, (n, 3)), (u8, (n,))],
    }[kind]
    raw = bytearray((out / f"{tag}.out").read_bytes())
    outs, at = [], 0
    for dtype, shape in layout:
        size = int(np.prod(shape)) * np.dtype(dtype).itemsize
        outs.append(torch.from_numpy(np.frombuffer(raw, dtype, offset=at,
                                                   count=int(np.prod(shape))).reshape(shape)))
        at += size
    assert at == len(raw)
    return r, outs


def twin(kind, num_tris, num_lights, num_spheres=0, depth=1, quirk=0, grid=0):
    """The plain twin's outputs in the harness's order."""
    o, d, tm, tables = launch_inputs(kind, num_tris, num_lights, num_spheres)
    if kind == "closest":
        return list(ck._closest_plain(*tables, o, d, tm))
    if kind == "anyhit":
        return [ck._anyhit_plain(*tables, o, d, tm).to(torch.uint8)]
    if kind == "bounce":
        hit, bits = ck._bounce_plain(*tables, o, d, tm)
        return [*hit, bits]
    if kind == "trace":
        tri, aux, lights, sph = tables
        return [ck._trace_plain(tri, aux, sph, lights, o, d, depth, bool(quirk))]
    if kind == "record":
        outs = list(ck._record_plain(*tables, o, d, depth, bool(quirk)))
        outs[-1] = outs[-1].to(torch.uint8)
        return outs
    hit, bits, pos, refl, reflective = ck._bounce_refl_plain(*tables, o, d, tm, bool(quirk))
    return [*hit, bits, pos, refl, reflective.to(torch.uint8)]


def same_bits(a, b):
    a, b = a.contiguous(), b.contiguous()
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b.to(a.dtype))


# (kind, triangles, point lights, spheres, depth, quirk, grid: 0 as launched)
CASES = [
    ("closest", 1, 0, 0, 1, 0, 0), ("closest", 32, 0, 0, 1, 0, 0),
    ("closest", 256, 0, 0, 1, 0, 0), ("closest", 32, 0, 0, 1, 0, 2),
    ("anyhit", 1, 0, 0, 1, 0, 0), ("anyhit", 32, 0, 0, 1, 0, 0), ("anyhit", 256, 0, 0, 1, 0, 0),
    ("anyhit", 256, 0, 0, 1, 0, 2),
    ("bounce", 1, 1, 0, 1, 0, 0), ("bounce", 32, 0, 0, 1, 0, 0), ("bounce", 32, 1, 0, 1, 0, 0),
    ("bounce", 32, 30, 0, 1, 0, 0), ("bounce", 256, 30, 0, 1, 0, 0),
    ("bounce", 32, 30, 0, 1, 0, 2),
    ("bounce_refl", 1, 1, 0, 1, 0, 0), ("bounce_refl", 32, 0, 0, 1, 1, 0),
    ("bounce_refl", 32, 30, 0, 1, 0, 0), ("bounce_refl", 256, 1, 0, 1, 0, 0),
    ("bounce_refl", 32, 30, 0, 1, 0, 2),
    ("record", 1, 1, 0, 2, 0, 0), ("record", 32, 1, 0, 1, 0, 0), ("record", 32, 0, 0, 2, 1, 0),
    ("record", 32, 30, 0, 3, 0, 0), ("record", 256, 30, 0, 3, 0, 0),
    ("record", 32, 1, 0, 3, 0, 2),
    ("trace", 1, 8, 0, 1, 0, 0), ("trace", 32, 1, 0, 2, 1, 0), ("trace", 32, 8, 2, 2, 0, 0),
    ("trace", 256, 8, 2, 3, 0, 0), ("trace", 32, 8, 2, 2, 0, 2),
]


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "{}-T{}-L{}-S{}-d{}-q{}-grid{}".format(*c))
def test_sweep_kernels_memcheck(builds, case):
    exe, out, _ = builds
    kind, num_tris, num_lights, num_spheres, depth, quirk, _ = case
    tag = "_".join(map(str, case))
    r, got = run_emulated(exe, out, tag, *case)
    assert r.returncode == 0, f"{case}: the sanitized kernel failed\n{r.stderr[:4000]}"
    want = twin(*case)
    assert len(got) == len(want)
    if kind == "trace":
        (a,), (b,) = got, want
        bad = ((a - b).abs().amax(dim=-1) > IMG_ATOL).float().mean().item()
        assert bad <= IMG_MAX_BAD, f"{case}: {bad:.4%} of rays differ"
        assert b.abs().sum().item() > 0
        return
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (case, k)
        assert same_bits(a, b), f"{case}: output {k} differs from the twin's"
    if kind in ("closest", "bounce", "record", "bounce_refl"):
        slot = got[1]
        assert bool((slot >= 0).any()) and bool((slot < 0).any()), case
    if kind in ("bounce", "bounce_refl", "record") and num_lights == 30 and num_tris > 1:
        assert bool((got[4] != 0).any()), f"{case}: no shadow bit set"


def test_planted_staging_fault_is_caught(builds):
    """Staging one triangle past the table reads past the end of the input
    table (and writes past the staged rows)."""
    _, _, (planted, job) = builds
    exe = finish(job)
    r, _ = run_emulated(exe, planted, "planted", "closest", 32, 0)
    assert r.returncode != 0 and "heap-buffer-overflow" in r.stderr, r.stderr[-2000:]
