"""PyTorch port, the level kernels' memory safety, on the CPU.

The CUDA source ``csrc/level.cu`` is compiled as host C++ against the
stand-in CUDA header of ``tests/cuda_emu`` with AddressSanitizer and UBSan
(``-ffp-contract=off``, so each multiply and add rounds alone, as the card's
``-fmad=false`` build does).  Its launches run one block at a time with the
block's threads at once (``emu_launch_threads``); one case caps the grid at
one block, so the grid-stride loop runs each thread over several rays.
Each case runs all three entry points: ``cgrt_level`` where the shadow bits
are given and the scene has no spherical light, then
``cgrt_level_surface`` and ``cgrt_level_shade`` on the surface it wrote:

- the stand-in box (32 triangles) with a sphere, two point lights and a
  spherical light with given fractions;
- the 1,154-triangle cup with two spheres, two point lights and the
  spherical teacup's light;

each with the shadow bits (its spherical light left out, so that the
fused kernel runs) and with per-light blocked masks, at level 0 (no state)
and at a later level (random state, some rays dead), the last level and
``reference_quirks``.  Every array lives in a heap buffer of exactly its
size, and every output starts as NaN bytes, so a stray access aborts and a
lane left unwritten shows.  The outputs are held to the plain twins
(``reconstruct_hit``, ``level_plain``, ``level_shade_plain``): booleans and
gathered fields exactly, the rest at ``SHADE_FWD`` (``utils/checks.py``'s
rule for a forward; the CPU's ``pow`` is not the host C library's).  A
planted fault proves the harness sees the tables: a build whose shade reads
each point light one row past its own must abort.
"""
import dataclasses
import functools
import os
import re
import shutil
import struct
import subprocess
import types

import numpy as np
import pytest
import torch

import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu_torch.ops import cuda_kernels as ck
from cg_raytracer_tpu_torch.ops import level as lv
from cg_raytracer_tpu_torch.ops.camera import generate_rays
from cg_raytracer_tpu_torch.ops.intersect import reconstruct_hit
from cg_raytracer_tpu_torch.scene import standins
from cg_raytracer_tpu_torch.scene.types import PointLights, SphericalLights, Spheres, make_scene
from tests.test_torch_bvh import cup_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "cg_raytracer_tpu_torch", "csrc")
EMU = os.path.join(ROOT, "tests", "cuda_emu")
SIZE = 23  # 529 rays: three blocks of 256, the last one ragged
SHADE_FWD = dict(rtol=1e-5, atol=1e-6)  # chip_smoke.py's tolerance for a forward
SECOND_LIGHT = ((0.3, 0.4, 0.5), (0.4, 0.3, 0.2))


def build(out, csrc):
    """The sanitized host build of ``csrc``'s level.cu, its launch rewritten
    to ``emu_launch_threads``, in one translation unit with the harness."""
    with open(os.path.join(csrc, "level.cu")) as f:
        src = f.read()
    src, launches = re.subn(r"([\w:]+<[^<>;]*>)<<<([^;]*?)>>>\(", r"emu_launch_threads(\2, \1, ",
                            src)
    assert launches == 1, "level.cu's kernel launch was not found"
    with open(os.path.join(out, "level_emu.cpp"), "w") as f:
        f.write(src)
    exe = os.path.join(out, "level_memcheck")
    r = subprocess.run(["g++", "-std=c++17", "-O1", "-g", "-fsanitize=address,undefined",
                        "-fno-sanitize-recover=all", "-fno-omit-frame-pointer",
                        "-ffp-contract=off", "-pthread", "-I", EMU, "-I", out,
                        os.path.join(EMU, "level_main.cpp"), "-o", exe],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    return exe


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation")
    out = tmp_path_factory.mktemp("level_emu")
    return build(str(out), CSRC), out


@functools.lru_cache(maxsize=None)
def scene_of(name, spherical):
    if name == "box":
        sphere = Spheres(center=torch.tensor([[-0.3, 0.0, -0.3]]), radius=torch.tensor([0.2]),
                         kd=torch.tensor([[0.2, 0.5, 0.8]]), ks=torch.tensor([[0.4, 0.4, 0.4]]),
                         shininess=torch.tensor([30.0]))
        scene = make_scene(standins.mirror_box_meshes(), spheres=sphere,
                           point_lights=PointLights.of(*standins.MIRROR_BOX_LIGHTS, SECOND_LIGHT),
                           device="cpu")
        sph = standins.SPHERICAL_BOX_LIGHTS
    else:
        _, cup = cup_pair(spheres=True)
        pl = cup.point_lights
        scene = dataclasses.replace(cup, point_lights=PointLights(
            position=torch.cat([pl.position, torch.tensor([SECOND_LIGHT[0]])]),
            color=torch.cat([pl.color, torch.tensor([SECOND_LIGHT[1]])])))
        sph = standins.SPHERICAL_CUP_LIGHTS
    if spherical:
        scene = dataclasses.replace(scene, spherical_lights=SphericalLights.of(*sph))
    return scene


@functools.lru_cache(maxsize=None)
def inputs(name, spherical, state):
    """(scene, o, d, hit, bits, masks, fracs, color, throughput, active): one
    level's inputs, made from a seed; ``state`` False is level 0."""
    scene = scene_of(name, spherical)
    gen = torch.Generator().manual_seed(15)
    o, d = generate_rays(trt.Camera.default(device="cpu"), SIZE, SIZE)
    if state:  # a later level: the rays from points of the frame, some dead
        o = o + d * torch.rand((o.shape[0], 1), generator=gen) * 2.0
        d = d + 0.3 * torch.randn(d.shape, generator=gen)
    hit = ck.intersect_plain(scene, o, d)
    n, num_pl = o.shape[0], scene.point_lights.position.shape[0]
    bits = torch.randint(0, 1 << num_pl, (n,), dtype=torch.int32, generator=gen)
    masks = torch.rand((num_pl, n), generator=gen) < 0.3
    fracs = torch.rand((scene.spherical_lights.position.shape[0], n), generator=gen)
    fracs[:, ::5] = 0.0
    color = throughput = active = None
    if state:
        color = torch.rand((n, 3), generator=gen)
        throughput = torch.rand((n, 3), generator=gen)
        active = torch.rand((n,), generator=gen) < 0.7
    return scene, o, d, hit, bits, masks, fracs, color, throughput, active


def run_emulated(emulator, case, tag, max_grid=0):
    """The emulated launches -> (completed process, outputs or None)."""
    exe, out = emulator
    name, spherical, state, use_bits, quirk, last = case
    scene, o, d, hit, bits, masks, fracs, color, throughput, active = inputs(name, spherical,
                                                                            state)
    m, s = scene.materials, scene.spheres
    pl, sl = scene.point_lights, scene.spherical_lights
    n = o.shape[0]
    header = struct.pack("<12q", n, scene.vertices.shape[0], scene.num_triangles,
                         m.kd.shape[0], s.radius.shape[0], pl.position.shape[0],
                         sl.position.shape[0], int(quirk), int(last), int(state), int(use_bits),
                         max_grid)
    arrays = [o, d, hit.prim_id.to(torch.int32),
              bits if use_bits else masks.to(torch.uint8), fracs]
    if state:
        arrays += [active.to(torch.uint8), throughput, color]
    arrays += [scene.vertices, scene.normals, scene.triangles, scene.tri_material, m.kd, m.ks,
               m.shininess, s.center, s.radius, s.kd, s.ks, s.shininess, pl.position, pl.color,
               sl.position, sl.color]
    path = out / f"{tag}.in"
    with open(path, "wb") as f:
        f.write(header)
        for a in arrays:
            f.write(a.contiguous().numpy().tobytes())
    env = dict(os.environ, ASAN_OPTIONS="detect_leaks=0:abort_on_error=0",
               UBSAN_OPTIONS="print_stacktrace=1")
    r = subprocess.run([exe, str(path), str(out / f"{tag}.out")], capture_output=True, text=True,
                       env=env, timeout=300)
    if r.returncode != 0:
        return r, None
    return r, torch.from_numpy(np.fromfile(out / f"{tag}.out", dtype=np.float32))


def take(flat, shapes):
    sizes = [int(np.prod(s)) for s in shapes]
    parts = flat[:sum(sizes)].split(sizes)
    return [p.view(s) for p, s in zip(parts, shapes)], flat[sum(sizes):]


def assert_level(got, want, what):
    """A level's outputs (color, throughput, active, o_next, d_next)."""
    for k, (g, w) in enumerate(zip(got, want)):
        if w is None:
            continue
        if w.dtype == torch.bool:
            assert torch.equal(g.bool(), w) and bool(((g == 0) | (g == 1)).all()), (what, k)
        else:
            torch.testing.assert_close(g, w, **SHADE_FWD, msg=f"{what}: output {k}")


CASES = [  # (scene, spherical light, state, shadow bits, reference_quirks, last level)
    ("box", False, False, True, False, False),
    ("box", False, True, True, True, False),
    ("box", True, True, False, False, False),
    ("box", True, False, False, True, True),
    ("cup", False, True, True, False, False),
    ("cup", True, True, False, True, False),
    ("cup", True, False, True, False, True),
]


@pytest.mark.parametrize("case", CASES, ids=["-".join(str(int(x)) if isinstance(x, bool) else x
                                                      for x in c) for c in CASES])
def test_level_kernels_memcheck(emulator, case):
    name, spherical, state, use_bits, quirk, last = case
    scene, o, d, hit, bits, masks, fracs, color, throughput, active = inputs(name, spherical,
                                                                            state)
    n = o.shape[0]
    assert n % 256 != 0
    assert bool((hit.prim_id >= scene.num_triangles).any()), "no ray hits a sphere"
    assert bool((hit.prim_id < 0).any()) and bool((hit.prim_id >= 0).any())
    r, flat = run_emulated(emulator, case, "-".join(map(str, case)),
                           max_grid=1 if name == "box" and state else 0)
    assert r.returncode == 0, f"{case}: the sanitized level kernels failed\n{r.stderr[:4000]}"
    level_shapes = [(n, 3)] if last else [(n, 3), (n, 3), (n,), (n, 3), (n, 3)]
    bits_in = bits if use_bits else None
    masks_in = None if use_bits else masks
    if use_bits and not spherical:
        fused, flat = take(flat, level_shapes)
        cfg = trt.RenderConfig(reference_quirks=quirk)
        backend = types.SimpleNamespace(occluded=None, soft_vis=None, sample_split=None)
        want = lv.level_plain(scene, o, d, hit, bits, color, throughput, active, cfg, backend,
                              last=last)
        assert_level(fused, want, f"{case} cgrt_level")
    surf, flat = take(flat, [(n, 3)] * 4 + [(n,), (n,)])
    want_surf = reconstruct_hit(scene, o, d, hit)
    for g, w in zip(surf[:2], (want_surf.position, want_surf.normal)):
        torch.testing.assert_close(g, w, **SHADE_FWD)
    for g, w in zip(surf[2:5], (want_surf.kd, want_surf.ks, want_surf.shininess)):
        assert torch.equal(g, w), f"{case}: a gathered field differs"
    assert torch.equal(surf[5].bool(), want_surf.valid) and bool((surf[5] <= 1).all())
    shade, flat = take(flat, level_shapes)
    assert flat.numel() == 0
    want = lv.level_shade_plain(scene, d, want_surf, bits_in, masks_in,
                                fracs if spherical else None, color, throughput, active, quirk,
                                last)
    assert_level(shade, want, f"{case} cgrt_level_shade")
    assert want[0].abs().sum().item() > 0


def test_planted_light_row_fault_is_caught(tmp_path):
    """The shade reading each point light one row past its own: the last
    light's position lies past the end of its table."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation")
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    src = csrc / "level.cu"
    text, planted = re.subn(re.escape("load3(a.pl_position, l)"), "load3(a.pl_position, l + 1)",
                            src.read_text())
    assert planted == 1
    src.write_text(text)
    exe = build(str(tmp_path), str(csrc))
    r, _ = run_emulated((exe, tmp_path), ("box", False, False, True, False, False), "planted")
    assert r.returncode != 0 and "heap-buffer-overflow" in r.stderr, r.stderr[-2000:]
