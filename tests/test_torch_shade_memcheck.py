"""PyTorch port, the shade kernels' memory safety, on the CPU.

The CUDA source ``csrc/shade.cu`` (with ``sweep.cuh``) is compiled as host
C++ against the stand-in CUDA header of ``tests/cuda_emu`` with
AddressSanitizer and UBSan.  Its launches run one block at a time with the
block's threads at once (``emu_launch_threads``: ``__syncthreads`` a
barrier, ``atomicAdd`` an atomic), on a one-wave grid of two blocks that
strides over the rays, as the backward's ``launch_bwd`` sizes it on the
card.  A warp vote there sees only the calling lane, so every lane is a
group of one and adds exactly its own values (``tests/cuda_emu``).  Each
path runs its forward and its backward:

- the select path on the stand-in box with a sphere, one point light and
  a spherical light with recorded fractions;
- the pregathered path on the 1,154-triangle cup with two spheres, its two
  point lights and the spherical teacup's light.

Every array lives in a heap buffer of exactly its size, the kernels'
shared memory too, so a stray load or store aborts the run.  The outputs
are held to the plain twins (``shade_plain``, ``shade_plain_pre`` and their
autograd): the forward as on the card, ``d_o`` and ``d_d`` at ``RAY_GRAD``
and the tables at ``TABLE_GRAD`` (``utils/checks.py::shade_grads_close``).
A planted fault proves the harness sees the tables: the backward adding a
spherical light's cotangents one row past its own must abort.
"""
import dataclasses
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
from cg_raytracer_tpu_torch.ops import shade
from cg_raytracer_tpu_torch.ops.camera import generate_rays
from cg_raytracer_tpu_torch.scene import standins
from cg_raytracer_tpu_torch.scene.types import PointLights, SphericalLights, Spheres, make_scene
from cg_raytracer_tpu_torch.utils import checks
from tests.test_torch_bvh import cup_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "cg_raytracer_tpu_torch", "csrc")
EMU = os.path.join(ROOT, "tests", "cuda_emu")
SIZE = 23  # 529 rays: five blocks of 128 on a grid of two, the last one ragged
SHADE_FWD = dict(rtol=1e-5, atol=1e-6)  # chip_smoke.py's tolerance for the forward


def build(out, csrc):
    """The sanitized host build of ``csrc``'s shade.cu, its launches rewritten
    to ``emu_launch_threads`` and its dynamic shared memory to the emulator's."""
    with open(os.path.join(csrc, "shade.cu")) as f:
        src = f.read()
    src, launches = re.subn(r"([\w:]+<[^<>;]*>)<<<([^;]*?)>>>\(", r"emu_launch_threads(\2, \1, ",
                            src)
    assert launches == 2, "shade.cu's kernel launches were not found"
    src, shared = re.subn(r"extern __shared__ (\w+) (\w+)\[\];",
                          r"\1* const \2 = emu_dynamic_shared<\1>();", src)
    assert shared == 2, "shade.cu's dynamic shared memory was not found"
    with open(os.path.join(out, "shade_emu.cpp"), "w") as f:
        f.write(src)
    exe = os.path.join(out, "shade_memcheck")
    r = subprocess.run(["g++", "-std=c++17", "-O1", "-g", "-fsanitize=address,undefined",
                        "-fno-sanitize-recover=all", "-fno-omit-frame-pointer",
                        "-ffp-contract=off", "-pthread", "-I", EMU, "-I", csrc,
                        os.path.join(out, "shade_emu.cpp"), os.path.join(EMU, "shade_main.cpp"),
                        "-o", exe],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    return exe


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation")
    out = tmp_path_factory.mktemp("shade_emu")
    return build(str(out), CSRC), out


@functools.lru_cache(maxsize=None)
def records(name):
    """(scene, pregathered?, tables, o, d, prim, bits, sph, fracs, cotangents):
    one launch's inputs, made from a seed."""
    gen = torch.Generator().manual_seed(8)
    if name == "box":
        sphere = Spheres(center=torch.tensor([[-0.3, 0.0, -0.3]]), radius=torch.tensor([0.2]),
                         kd=torch.tensor([[0.2, 0.5, 0.8]]), ks=torch.tensor([[0.4, 0.4, 0.4]]),
                         shininess=torch.tensor([30.0]))
        scene = make_scene(standins.mirror_box_meshes(), spheres=sphere,
                           point_lights=PointLights.of(*standins.MIRROR_BOX_LIGHTS),
                           spherical_lights=SphericalLights.of(*standins.SPHERICAL_BOX_LIGHTS),
                           device="cpu")
        cam = trt.Camera.default(device="cpu")
    else:
        _, cup = cup_pair(spheres=True)
        scene = dataclasses.replace(
            cup, spherical_lights=SphericalLights.of(*standins.SPHERICAL_CUP_LIGHTS))
        cam = trt.Camera.default(device="cpu")
    pre = scene.num_triangles > shade.SHADE_MAX_TRIS
    o, d = generate_rays(cam, SIZE, SIZE)
    hit = ck.intersect_plain(scene, o, d)
    prim = hit.prim_id.to(torch.int32).contiguous()
    num_pl = scene.point_lights.position.shape[0]
    bits = torch.randint(0, 1 << num_pl, prim.shape, dtype=torch.int32, generator=gen)
    fracs = torch.rand((1, prim.shape[0]), generator=gen)
    fracs[0, ::5] = 0.0
    tables = shade._pre_tables(scene)[:4] if pre else shade._shade_tables(scene)[:4]
    tables = tuple(x.detach().contiguous() for x in tables)
    cts = tuple(torch.randn(o.shape, generator=gen) for _ in range(4))
    return (scene, pre, tables, o.contiguous(), d.contiguous(), prim, bits,
            shade._sph_table(scene).detach(), fracs, cts)


def run_emulated(emulator, name, tag):
    """The emulated forward and backward -> (completed process, outputs or None)."""
    exe, out = emulator
    scene, pre, tables, o, d, prim, bits, sph, fracs, cts = records(name)
    n, rows = o.shape[0], tables[0].shape[0]
    num_mats = tables[1].shape[0] if pre else 0
    shapes = [(n, 3)] * 6 + [tuple(tables[0].shape), tuple(tables[1].shape),
                             tuple(tables[2].shape), tuple(tables[3].shape), tuple(sph.shape)]
    header = struct.pack("<8q", int(pre), n, rows, scene.num_triangles, num_mats,
                         tables[2].shape[0], tables[3].shape[0], sph.shape[0])
    path = out / f"{tag}.in"
    with open(path, "wb") as f:
        f.write(header)
        for a in (o, d, prim, bits, *tables, sph, fracs, *cts):
            f.write(a.contiguous().numpy().tobytes())
    env = dict(os.environ, ASAN_OPTIONS="detect_leaks=0:abort_on_error=0",
               UBSAN_OPTIONS="print_stacktrace=1")
    r = subprocess.run([exe, str(path), str(out / f"{tag}.out")], capture_output=True, text=True,
                       env=env, timeout=300)
    if r.returncode != 0:
        return r, None
    flat = torch.from_numpy(np.fromfile(out / f"{tag}.out", dtype=np.float32))
    sizes = [int(np.prod(s)) for s in shapes]
    assert flat.numel() == sum(sizes)
    return r, [x.view(s) for x, s in zip(flat.split(sizes), shapes)]


@pytest.mark.parametrize("name", ["box", "cup"])
def test_shade_kernels_memcheck(emulator, name):
    scene, pre, tables, o, d, prim, bits, sph, fracs, cts = records(name)
    assert pre == (name == "cup") and o.shape[0] % 128 != 0
    live = (prim >= 0) & (prim < scene.num_triangles + scene.spheres.radius.shape[0])
    assert bool((prim >= scene.num_triangles).any()), "no ray hits a sphere"
    assert 0 < int(live.sum()) < prim.shape[0]
    r, outs = run_emulated(emulator, name, name)
    assert r.returncode == 0, f"{name}: the sanitized shade kernels failed\n{r.stderr[:4000]}"
    plain = shade.shade_plain_pre if pre else shade.shade_plain
    want = plain(*tables, o, d, prim, bits, num_tris=scene.num_triangles, sph=sph, fracs=fracs)
    for got, w in zip(outs[:4], want):
        torch.testing.assert_close(got, w, **SHADE_FWD)
    assert want[0].abs().sum().item() > 0
    # The kernel's order (tables, rays, spherical lights), as the wrappers return it.
    d_o, d_d, d_h0, d_h1, d_lights, d_spheres, d_sph = outs[4:]
    got = (d_h0, d_h1, d_lights, d_spheres, d_o, d_d, d_sph)
    twin, exact = checks.twin_grads(tables, o, d, prim, bits, scene.num_triangles, cts,
                                    plain=plain, sph=sph, fracs=fracs)
    names = checks.PRE_GRAD_NAMES if pre else checks.GRAD_NAMES
    checks.shade_grads_close(got, twin, exact, o.shape[0], names=names)
    for g in got:
        assert g.abs().sum().item() > 0  # every table and the rays receive cotangents
    assert not bool(d_o[~live].any()) and not bool(d_d[~live].any())


def test_planted_row_fault_is_caught(tmp_path):
    """The backward adding a spherical light's cotangents one row past its
    own: the last light's sums land past the end of the shared tables."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation")
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    src = csrc / "shade.cu"
    text, planted = re.subn(re.escape("add_light_row(act, row, a_sphl + 6 * l);"),
                            "add_light_row(act, row, a_sphl + 6 * (l + 1));", src.read_text())
    assert planted == 1
    src.write_text(text)
    exe = build(str(tmp_path), str(csrc))
    r, _ = run_emulated((exe, tmp_path), "box", "planted")
    assert r.returncode != 0 and "heap-buffer-overflow" in r.stderr, r.stderr[-2000:]
