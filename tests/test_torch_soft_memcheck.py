"""PyTorch port, the soft-shadow samplers' memory safety, on the CPU.

The CUDA source ``csrc/soft.cu`` (with ``bvh4.cuh`` and ``sweep.cuh``) is
compiled as host C++ against the stand-in CUDA header of ``tests/cuda_emu``
with AddressSanitizer and UBSan, and ``soft_kernel`` runs one thread at a
time on small frames of the spherical box (brute sampler) and of the
1,154-triangle cup lit by ``monkey_spherical_light``'s light (cone sampler
over the port's tree at widths 4, and 2 and 8), every array in a heap buffer
of exactly its size.  The kernel's dynamic shared memory (the brute
sampler's triangle rows) is a heap buffer of exactly the launch's bytes too
(``tests/cuda_emu/cuda_runtime.h``).  Any stray load or store, in the
kernel's index arithmetic or the tree walk's stack, aborts the run.  Its counts are then held to the plain twins: exactly for
the table variant; for the Philox variant the host's ``logf``/``cosf``
differ from PyTorch's in the last bit now and then, so on >= 99% of points
and within 2 samples elsewhere.  Every launch has unmarked points, a stream
that does not start at point 0, and a tail of threads past the last sample.

The kernel takes the marked points compacted (``ops/soft.py::_compact``),
as the wrappers pass them.  A planted fault proves the harness sees the
walk's stack: the same build with the sampler's stack cut from 64 entries
to 4 must abort.
"""
import functools
import dataclasses
import os
import re
import shutil
import struct
import subprocess

import numpy as np
import pytest
import torch

import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu_torch.ops import bvh4 as b4
from cg_raytracer_tpu_torch.ops import cuda_kernels as ck
from cg_raytracer_tpu_torch.ops import soft
from cg_raytracer_tpu_torch.ops.camera import generate_rays
from cg_raytracer_tpu_torch.scene import standins
from cg_raytracer_tpu_torch.scene.presets import load_standin
from tests.test_torch_bvh import cup_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "cg_raytracer_tpu_torch", "csrc")
EMU = os.path.join(ROOT, "tests", "cuda_emu")
S = 200  # the reference's count: a point's samples straddle warps and blocks
SIZE = 23  # 529 points x 200 samples: the last block has a tail of idle threads
KEY = soft.SampleKey(2026, 4, 777_777)
BOX_TRIS = 32


def build(out, csrc):
    """The sanitized host build of ``csrc``'s soft.cu, its launch rewritten
    to ``emu_launch`` and its dynamic shared memory to the emulator's."""
    with open(os.path.join(csrc, "soft.cu")) as f:
        src = f.read()
    src, launches = re.subn(r"([\w:]+<[^<>;]*>)<<<([^<>;]*)>>>\(", r"emu_launch(\2, \1, ", src)
    assert launches == 1, "soft.cu's kernel launch was not found"
    src, shared = re.subn(r"extern __shared__ (\w+) (\w+)\[\];",
                          r"\1* const \2 = emu_dynamic_shared<\1>();", src)
    assert shared == 1, "soft.cu's dynamic shared memory was not found"
    with open(os.path.join(out, "soft_emu.cpp"), "w") as f:
        f.write(src)
    exe = os.path.join(out, "soft_memcheck")
    r = subprocess.run(["g++", "-std=c++17", "-O1", "-g", "-fsanitize=address,undefined",
                        "-fno-sanitize-recover=all", "-fno-omit-frame-pointer",
                        "-ffp-contract=off", "-I", EMU, "-I", csrc,
                        os.path.join(out, "soft_emu.cpp"), os.path.join(EMU, "soft_main.cpp"),
                        "-o", exe],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    return exe


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation")
    out = tmp_path_factory.mktemp("soft_emu")
    return build(str(out), CSRC), out


@functools.lru_cache(maxsize=None)
def frame(name, width=4):
    """(scene, tree or None, hit positions [N, 3], marked points [N]); the
    cup's tree at ``width``, collapsed from one binary tree."""
    o, d = generate_rays(trt.Camera.default(device="cpu"), SIZE, SIZE)
    if name == "box":
        scene, tree = load_standin("spherical_box", device="cpu"), None
        assert scene.num_triangles == BOX_TRIS
        hit = ck.intersect_plain(scene, o, d)
    else:
        scene, bvh = cup_tree()
        tree = b4.collapse_bvhw(bvh, width)
        hit = b4.intersect_bvh4_plain(scene, tree, o, d)
    valid = hit.prim_id >= 0
    pos = torch.where(valid[:, None], o + d * torch.where(valid, hit.t, 0.0)[:, None], 0.0)
    marked = valid & (torch.arange(valid.shape[0]) % 5 != 0)
    return scene, tree, pos.contiguous(), marked


@functools.lru_cache(maxsize=None)
def cup_tree():
    """The cup under the spherical teacup's light, and its binary tree (SAH,
    leaf 4: the card's autos)."""
    _, cup = cup_pair()
    scene = dataclasses.replace(
        cup, point_lights=trt.PointLights.empty(),
        spherical_lights=trt.SphericalLights.of(*standins.SPHERICAL_CUP_LIGHTS))
    return scene, b4.build_bvh4(scene, max_leaf=4, builder="sah")[0]


def run_emulated(emulator, scene, tree, pos, marked, gauss_nsc, tag, check=True):
    """The emulated launch's counts, the marked points compacted as the
    wrappers pass them.  With ``check=False``, the completed process and
    None when the run failed."""
    exe, out = emulator
    n = pos.shape[0]
    light = soft.light_row(scene.spherical_lights.position[0], scene.spherical_lights.radius[0])
    arrays = [pos, *soft._compact(marked.to(torch.uint8)), light]
    if tree is None:
        tris, nodes = ck._tri_table(scene).detach(), 0
        arrays.append(tris)
    else:
        tris, nodes = tree.tris, tree.num_nodes
        arrays += [soft.pack_nodes(tree), soft.pack_tris(tree.tris)]
    if gauss_nsc is not None:
        arrays.append(gauss_nsc)
    header = struct.pack("<10q", 0 if tree is None else tree.width, n, S, tris.shape[0], nodes, 1,
                         int(gauss_nsc is not None), KEY.k0, KEY.k1, KEY.offset)
    path = out / f"{tag}.in"
    with open(path, "wb") as f:
        f.write(header)
        for a in arrays:
            f.write(a.detach().contiguous().numpy().tobytes())
    env = dict(os.environ, ASAN_OPTIONS="detect_leaks=0:abort_on_error=0",
               UBSAN_OPTIONS="print_stacktrace=1")
    r = subprocess.run([exe, str(path), str(out / f"{tag}.out")], capture_output=True, text=True,
                       env=env)
    if not check:
        return r, None
    assert r.returncode == 0, f"{tag}: the sanitized sampler failed\n{r.stderr[:4000]}"
    return torch.from_numpy(np.fromfile(out / f"{tag}.out", dtype=np.int32)).to(torch.float32)


@pytest.mark.parametrize("source", ["philox", "table"])
@pytest.mark.parametrize("name", ["box", "cup"])
def test_soft_kernel_memcheck(emulator, name, source):
    scene, tree, pos, marked = frame(name)
    n = pos.shape[0]
    assert (n * S) % 128 != 0 and 0 < int(marked.sum()) < n
    lp, lr = scene.spherical_lights.position[0], scene.spherical_lights.radius[0]
    head = (scene,) if tree is None else (scene, tree)
    if source == "table":
        g = torch.randn((S, n, 3), generator=torch.Generator().manual_seed(7))
        got = run_emulated(emulator, scene, tree, pos, marked, g.permute(1, 0, 2).contiguous(),
                           f"{name}_{source}")
        twin = soft.soft_table_plain if tree is None else soft.soft4_table_plain
        want = twin(*head, pos, lp, lr, g, valid=marked)
        assert torch.equal(got, want), f"{name}: the emulated table kernel differs from its twin"
    else:
        got = run_emulated(emulator, scene, tree, pos, marked, None, f"{name}_{source}")
        twin = soft.soft_prng_plain if tree is None else soft.soft4_prng_plain
        want = twin(*head, pos, lp, lr, KEY, S, valid=marked)
        same = (got == want)[marked].float().mean().item()
        assert same >= 0.99 and (got - want).abs().max().item() <= 2, (name, same)
    assert not got[~marked].any()
    frac = got[marked] / S
    assert bool((frac > 0).any()) and bool((frac < 1).any())  # lit points and shadowed ones


@pytest.mark.parametrize("width", [2, 8])
def test_soft_tree_widths_memcheck(emulator, width):
    """The walk at widths 2 and 8 on the cup: table counts exact."""
    scene, tree, pos, marked = frame("cup", width)
    assert tree.width == width
    n = pos.shape[0]
    lp, lr = scene.spherical_lights.position[0], scene.spherical_lights.radius[0]
    g = torch.randn((S, n, 3), generator=torch.Generator().manual_seed(7 + width))
    got = run_emulated(emulator, scene, tree, pos, marked, g.permute(1, 0, 2).contiguous(),
                       f"cup_w{width}")
    want = soft.soft4_table_plain(scene, tree, pos, lp, lr, g, valid=marked)
    assert torch.equal(got, want), f"width {width}: the emulated table kernel differs"
    frac = got[marked] / S
    assert bool((frac > 0).any()) and bool((frac < 1).any())


def test_planted_stack_overflow_is_caught(tmp_path):
    """The sampler's stack cut to 4 entries, below the 4-wide cup tree's
    bound: a walk's fifth push writes past its stack array."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation")
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    src = csrc / "soft.cu"
    text, planted = re.subn(r"int stack\[kStack\];", "int stack[4];", src.read_text())
    assert planted == 1
    src.write_text(text)
    exe = build(str(tmp_path), str(csrc))
    scene, tree, pos, marked = frame("cup", 4)
    assert 3 * tree.depth + 1 > 4
    r, _ = run_emulated((exe, tmp_path), scene, tree, pos, marked, None, "planted", check=False)
    # UBSan's bounds check sees the index first; ASan the write, where UBSan
    # cannot type the array.
    caught = "index 4 out of bounds" in r.stderr or "stack-buffer-overflow" in r.stderr
    assert r.returncode != 0 and caught, r.stderr[-2000:]
