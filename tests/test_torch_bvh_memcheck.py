"""PyTorch port, the tree walk's memory safety, on the CPU.

The CUDA source ``csrc/bvh4.cu`` (with ``bvh4.cuh`` and ``sweep.cuh``) is
compiled as host C++ against the stand-in CUDA header of ``tests/cuda_emu``
with AddressSanitizer and UBSan, and its three entry points run one thread
at a time on the 1,154-triangle cup of ``test_torch_bvh.py::cup_pair`` (two
point lights) at each node width: ``cgrt_bvh4_closest``, ``cgrt_bvh4_anyhit``
and ``cgrt_bvh4_bounce`` (whose lights sit in an exactly sized stand-in for
shared memory).  Every array lives in a heap buffer of exactly its size, so
a stray load or store, in the index arithmetic or the walk's stack, aborts
the run.  The rays: a small camera frame and random rays with a random
t_max, every seventh ray dead (t_max < 0), and a tail of threads past the
last ray.  The outputs are then held to the plain twins exactly.

A planted fault proves the harness can see the walk's stack: the same build
with ``kStack`` cut from 64 to 4 must abort (UBSan's bounds check or ASan).
"""
import os
import re
import shutil
import struct
import subprocess

import numpy as np
import pytest
import torch

from cg_raytracer_tpu_torch.ops import bvh4 as b4
from tests.test_torch_bvh import cup_pair, mesh_rays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "cg_raytracer_tpu_torch", "csrc")
EMU = os.path.join(ROOT, "tests", "cuda_emu")
LIGHTS = (((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0)), ((1.0, 2.0, 0.5), (0.5, 0.5, 0.5)))
KINDS = {"closest": 0, "anyhit": 1, "bounce": 2}


def build(out, csrc):
    """The sanitized host build of ``csrc``'s bvh4.cu, its launches
    rewritten to ``emu_launch``."""
    with open(os.path.join(csrc, "bvh4.cu")) as f:
        src = f.read()
    src, launches = re.subn(r"([\w:]+(?:<[^<>;]*>)?)<<<([^<>;]*)>>>\(", r"emu_launch(\2, \1, ",
                            src)
    assert launches == 2, "bvh4.cu's kernel launches were not found"
    with open(os.path.join(out, "bvh_emu.cpp"), "w") as f:
        f.write(src)
    exe = os.path.join(out, "bvh_memcheck")
    r = subprocess.run(["g++", "-std=c++17", "-O1", "-g", "-fsanitize=address,undefined",
                        "-fno-sanitize-recover=all", "-fno-omit-frame-pointer",
                        "-ffp-contract=off", f"-DEMU_SHARED_FLOATS={3 * len(LIGHTS)}", "-I", EMU,
                        "-I", csrc, os.path.join(out, "bvh_emu.cpp"),
                        os.path.join(EMU, "bvh_main.cpp"), "-o", exe],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    return exe


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation")
    out = tmp_path_factory.mktemp("bvh_emu")
    return build(str(out), CSRC), out


@pytest.fixture(scope="module")
def cup():
    """The cup, its binary tree (SAH, leaf 4) and the rays: a 20^2 camera
    frame and 300 random rays with a random t_max, every seventh ray dead."""
    _, scene = cup_pair(lights=LIGHTS)
    bvh, _ = b4.build_bvh4(scene, max_leaf=4, builder="sah")
    o, d, _, _, tm = mesh_rays(n_random=300, size=20, seed=3)
    n = o.shape[0]
    t_max = np.concatenate([np.full(n - tm.shape[0], np.inf, np.float32), tm])
    t_max[::7] = -1.0
    assert n % 128 != 0
    return scene, bvh, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max)


def run_emulated(exe, out, kind, tree, o, d, t_max, lights, tag):
    n = o.shape[0]
    header = struct.pack("<8q", KINDS[kind], n, tree.width, tree.num_nodes, tree.num_tris, 1,
                         lights.shape[0], 0)
    path = out / f"{tag}.in"
    with open(path, "wb") as f:
        f.write(header)
        for a in (o, d, t_max, tree.nodes, tree.rows, tree.slot_to_prim):
            f.write(a.contiguous().numpy().tobytes())
        if kind == "bounce":
            f.write(lights.contiguous().numpy().tobytes())
    env = dict(os.environ, ASAN_OPTIONS="detect_leaks=0:abort_on_error=0",
               UBSAN_OPTIONS="print_stacktrace=1")
    r = subprocess.run([exe, str(path), str(out / f"{tag}.out")], capture_output=True, text=True,
                       env=env)
    if r.returncode != 0:
        return r, None
    raw = np.fromfile(out / f"{tag}.out", dtype=np.uint8)
    if kind == "anyhit":
        return r, torch.from_numpy(raw.astype(bool))
    cols = raw.view(np.int32).reshape(-1, n)
    f32 = lambda k: torch.from_numpy(cols[k].view(np.float32).copy())  # noqa: E731
    outs = [f32(0), torch.from_numpy(cols[1].copy()), f32(2), f32(3)]
    if kind == "bounce":
        outs.append(torch.from_numpy(cols[4].copy()))
    return r, outs


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("width", [2, 4, 8])
def test_bvh_kernel_memcheck(emulator, cup, width, kind):
    exe, out = emulator
    scene, bvh, o, d, t_max = cup
    tree = b4.collapse_bvhw(bvh, width)
    lights = scene.point_lights.position.contiguous()
    r, got = run_emulated(exe, out, kind, tree, o, d, t_max, lights, f"{kind}_{width}")
    assert r.returncode == 0, f"the sanitized {kind} walk failed\n{r.stderr[:4000]}"
    dead = t_max < 0
    if kind == "anyhit":
        want = b4._anyhit_plain(tree, o, d, t_max)
        assert torch.equal(got, want), f"width {width}: any-hit differs from the twin"
        assert bool(want.any()) and not bool(got[dead].any())
        return
    if kind == "closest":
        want = b4._closest_plain(tree, o, d, t_max)
    else:
        want_hit, want_bits = b4._bounce_plain(tree, lights, o, d, t_max)
        want = [*want_hit, want_bits]
        assert bool(want_bits.any()), "no shadowed hit point"
    for name, a, b in zip(("t", "prim", "u", "v", "bits"), got, want):
        assert torch.equal(a, b), f"width {width} {kind}: {name} differs from the twin"
    assert bool((got[1] >= 0).any()) and bool((got[1][dead] == -1).all())


def test_planted_stack_overflow_is_caught(cup, tmp_path):
    """kStack = 4: the walk's fifth push writes past its stack array."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation")
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    header = csrc / "bvh4.cuh"
    text, planted = re.subn(r"constexpr int kStack = 64;", "constexpr int kStack = 4;",
                            header.read_text())
    assert planted == 1
    header.write_text(text)
    exe = build(str(tmp_path), str(csrc))
    scene, bvh, o, d, t_max = cup
    tree = b4.collapse_bvhw(bvh, 4)
    r, _ = run_emulated(exe, tmp_path, "closest", tree, o, d, t_max,
                        scene.point_lights.position, "planted")
    # UBSan's bounds check sees the index first; ASan the write, where UBSan
    # cannot type the array.
    caught = "index 4 out of bounds" in r.stderr or "stack-buffer-overflow" in r.stderr
    assert r.returncode != 0 and caught, r.stderr[-2000:]
