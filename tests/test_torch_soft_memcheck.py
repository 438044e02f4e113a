"""PyTorch port, the soft-shadow samplers' memory safety, on the CPU.

The CUDA source ``csrc/soft.cu`` (with ``bvh4.cuh``, whose any-hit walk
the tree samplers run, and ``sweep.cuh``) is
compiled as host C++ against the stand-in CUDA header of ``tests/cuda_emu``
with AddressSanitizer and UBSan, and ``soft_kernel`` runs on small frames of
the spherical box (brute sampler) and of the 1,154-triangle cup lit by
``monkey_spherical_light``'s light (cone sampler over the port's tree at
widths 4, and 2 and 8), a block's threads at once, so that ``__syncthreads``
(the per-point masks', the tallies') is a barrier, ``atomicOr`` an atomic
and ``__reduce_add_sync`` a warp's sum, on a grid cut to ``EMU_GRID``
blocks, so that each block strides, every array in a heap buffer of exactly
its size.  The kernel's dynamic shared memory (the brute sampler's triangle
rows, cull rows, tally and masks; the tree samplers' warp sums) is a heap
buffer of exactly the launch's bytes too (``tests/cuda_emu/cuda_runtime.h``).
Any stray load or store, in the kernel's index arithmetic or the tree
walk's stack, aborts the run.  Its counts are then held to the plain twins:
exactly for the table variant; for the Philox variant the host's ``logf``/``cosf``
differ from PyTorch's in the last bit now and then, so on >= 99% of points
and within 2 samples elsewhere.  Every launch has unmarked points, a stream
that does not start at point 0, and a tail of threads past the last sample.

The kernel takes the marked points compacted (``ops/soft.py::_compact``)
and the tree's records (``BVH4.nodes``, ``BVH4.rows``), as the wrappers
pass them.  A planted fault proves the harness sees the walk's stack: the
same build with the walk's stack cut from 64 entries to 4 must abort.  The
tree samplers' tallies (live samples, node visits, triangle tests; the point
pass's own) are held to the plain model of the point pass and the sample
rays' lists and led walks (``soft.list_counts_plain``) on the same rays, and
their counts to the plain walk's.
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
EMU_GRID = 16  # the emulated grid: each block strides over many samples


def build(out, csrc, subs=(), name="soft_memcheck"):
    """The sanitized host build of ``csrc``'s soft.cu, its launch rewritten
    to ``emu_launch_threads`` and its dynamic shared memory to the
    emulator's; each of ``subs`` (pattern, replacement, count) a regex
    substitution made first."""
    with open(os.path.join(csrc, "soft.cu")) as f:
        src = f.read()
    for pattern, repl, count in subs:
        src, made = re.subn(pattern, repl, src)
        assert made == count, f"{pattern!r} matched {made} times, not {count}"
    src, launches = re.subn(r"([\w:]+(?:<[^<>;]*>)?)<<<([^<>;]*)>>>\(",
                            r"emu_launch_threads(\2, \1, ", src)
    assert launches == 1, "soft.cu's kernel launch was not found"
    src, shared = re.subn(r"extern __shared__ (\w+) (\w+)\[\];",
                          r"\1* const \2 = emu_dynamic_shared<\1>();", src)
    assert shared == 1, "soft.cu's dynamic shared memory was not found"
    with open(os.path.join(out, f"{name}.cpp"), "w") as f:
        f.write(src)
    exe = os.path.join(out, name)
    r = subprocess.run(["g++", "-std=c++17", "-O1", "-g", "-fsanitize=address,undefined",
                        "-fno-sanitize-recover=all", "-fno-omit-frame-pointer",
                        "-ffp-contract=off", "-I", EMU, "-I", csrc,
                        os.path.join(out, f"{name}.cpp"), os.path.join(EMU, "soft_main.cpp"),
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


def emulate(exe, out, tag, pos, marked, light, target, gauss_nsc, num_samples=S, key=KEY,
            max_grid=EMU_GRID, lists=False):
    """One emulated launch, the marked points compacted as the wrappers pass
    them: ``target`` is the brute sampler's triangle table [T, 9] or a BVH4.
    (completed process, counts [N] float32 or None where it failed, the
    tally or None where it failed: the brute sampler's (tests kept, tests of
    full sweeps), a tree sampler's (live samples, nodes expanded, triangles
    tested)); with ``lists``, a tree sampler's point pass too: its list
    tally (marked, listed, kept, its nodes expanded, its triangles tested),
    kept [N] int32 (per marked point in order; -1 walks, -2 never written)
    and lists [N, K] int32."""
    n = pos.shape[0]
    arrays = [pos, *soft._compact(marked.to(torch.uint8)), light]
    if isinstance(target, b4.BVH4):
        width, tris, nodes = target.width, target.tris, target.num_nodes
        arrays += [target.nodes, target.rows]
    else:
        width, tris, nodes = 0, target, 0
        arrays.append(tris)
    if gauss_nsc is not None:
        arrays.append(gauss_nsc)
    header = struct.pack("<10q", width, n, num_samples, tris.shape[0], nodes, 1,
                         int(gauss_nsc is not None), key.k0, key.k1, key.offset)
    path = out / f"{tag}.in"
    with open(path, "wb") as f:
        f.write(header)
        for a in arrays:
            f.write(a.detach().contiguous().numpy().tobytes())
    env = dict(os.environ, ASAN_OPTIONS="detect_leaks=0:abort_on_error=0",
               UBSAN_OPTIONS="print_stacktrace=1")
    r = subprocess.run([exe, str(path), str(out / f"{tag}.out"), str(max_grid)],
                       capture_output=True, text=True, env=env)
    if r.returncode != 0:
        return r, None, None
    raw = (out / f"{tag}.out").read_bytes()
    counts = torch.from_numpy(np.frombuffer(raw[:4 * n], dtype=np.int32).copy())
    size = 3 if width else 2
    tally = tuple(int(x) for x in np.frombuffer(raw[4 * n:4 * n + 8 * size], dtype=np.uint64))
    if not lists:
        return r, counts.to(torch.float32), tally
    rest = raw[4 * n + 8 * size:]
    list_tally = tuple(int(x) for x in np.frombuffer(rest[:48], dtype=np.uint64))
    ints = torch.from_numpy(np.frombuffer(rest[48:], dtype=np.int32).copy())
    return r, counts.to(torch.float32), tally, (list_tally, ints[:n], ints[n:].reshape(n, -1))


def run_emulated(emulator, scene, tree, pos, marked, gauss_nsc, tag, check=True):
    """The emulated launch's counts on ``scene``'s light.  With
    ``check=False``, the completed process and None when the run failed."""
    exe, out = emulator
    light = soft.light_row(scene.spherical_lights.position[0], scene.spherical_lights.radius[0])
    target = ck._tri_table(scene).detach() if tree is None else tree
    r, counts, _ = emulate(exe, out, tag, pos, marked, light, target, gauss_nsc)
    if not check:
        return r, counts
    assert r.returncode == 0, f"{tag}: the sanitized sampler failed\n{r.stderr[:4000]}"
    return counts


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
    """The any-hit walk's stack cut to 4 entries, below the 4-wide cup
    tree's bound: a walk's fifth push writes past its stack array."""
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
    scene, tree, pos, marked = frame("cup", 4)
    assert 3 * tree.depth + 1 > 4
    r, _ = run_emulated((exe, tmp_path), scene, tree, pos, marked, None, "planted", check=False)
    # UBSan's bounds check sees the index first; ASan the write, where UBSan
    # cannot type the array.
    caught = "index 4 out of bounds" in r.stderr or "stack-buffer-overflow" in r.stderr
    assert r.returncode != 0 and caught, r.stderr[-2000:]


@pytest.mark.parametrize("width", [2, 4, 8])
def test_tree_tally_matches_the_plain_walk(emulator, width):
    """The tree sampler's tallies of a table launch on the cup: its counts
    are the plain walk's; its live samples are the marked points' samples,
    and its node visits and triangle tests, and its point pass's tally
    (marked, listed, kept, the pass's visits and tests, led), those the plain
    model of the point pass and the sample rays' lists and led walks
    (``soft.list_counts_plain``) counts on the same rays, exactly."""
    scene, tree, pos, marked = frame("cup", width)
    n = pos.shape[0]
    g = torch.randn((S, n, 3), generator=torch.Generator().manual_seed(11 + width))
    g_nsc = g.permute(1, 0, 2).contiguous()
    exe, out = emulator
    light = soft.light_row(scene.spherical_lights.position[0], scene.spherical_lights.radius[0])
    r, got, tally, (list_tally, _, _) = emulate(exe, out, f"tally_w{width}", pos, marked, light,
                                                tree, g_nsc, lists=True)
    assert r.returncode == 0, r.stderr[:4000]
    stats = {}
    want = soft._counts_plain(soft._tree_anyhit(tree, stats), pos, light, S, marked.to(torch.uint8),
                              gauss_nsc=g_nsc)
    assert torch.equal(got, want.to(torch.float32))
    with open(os.path.join(CSRC, "soft.cu")) as f:
        k = int(re.search(r"constexpr int kListMax = (\d+);", f.read()).group(1))
    counts, tree_tally, model_lists = soft.list_counts_plain(
        tree, pos, light, S, marked.to(torch.uint8), k, gauss_nsc=g_nsc)
    assert torch.equal(counts, want)
    m = int(marked.sum())
    assert tally == tree_tally and tally[0] == m * S, (tally, tree_tally)
    assert list_tally == model_lists, (list_tally, model_lists)
    assert dict(zip(soft.LIST_KEYS, list_tally))["points"] == m
    # Listed points and led walks both occur; the lists spare node visits.
    assert 0 < list_tally[1] < m and list_tally[5] > 0
    assert tally[1] < stats["visits"] and tally[2] > 0
