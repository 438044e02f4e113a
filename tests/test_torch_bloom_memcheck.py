"""PyTorch port, the quirk blur's kernels (``csrc/bloom.cu``) on the CPU.

The source is compiled as host C++ against the stand-in CUDA header of
``tests/cuda_emu`` with AddressSanitizer and UBSan.  Its cluster launch
(``cudaLaunchKernelEx``) runs every thread of every block at once on host
threads, each block with shared memory of its own: the progress counters
are atomics, a hand-off to another block's counter goes through the stand-in
``map_shared_rank``, ``__syncwarp`` and ``__shfl_xor_sync`` are a warp's
barrier and exchange, and the cluster barrier spans every thread.  The
cluster is cut from 16 blocks of 16 warps to 4 blocks of 2 warps (8 row
slots), so rows wrap round the slots and hand off between blocks as on the
card.  The adjoint's second pass is rewritten to ``emu_launch_threads``.
Each image lives in a buffer of exactly its size, each block's shared
memory in one of exactly the launch's bytes.

- Both kernels against their plain twins (``bloom_quirk_plain``,
  ``bloom_quirk_adjoint_plain``) at rtol 1e-5, atol 1e-6: each window is
  summed in another order (column sums, then the row's own cells; the
  adjoint's first pass and masked box sum are not the twin's wavefronts),
  on sizes with fewer rows than slots, rows that wrap round the slots
  several times, widths below and above a chunk and a window.
- The adjoint is the forward's transpose: ``<F x, g>`` equals
  ``<x, F^T g>``, both kernels emulated, the dot products in float64.
- A build that drops the own row's outputs from a window, or the second
  pass's row-y terms, must differ: the harness sees each part.
"""
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cg_raytracer_tpu_torch.ops import effects as te

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "cg_raytracer_tpu_torch", "csrc")
EMU = os.path.join(ROOT, "tests", "cuda_emu")
FN = dict(rtol=1e-5, atol=1e-6)
SIZES = [(24, 20), (3, 40), (14, 100), (40, 64), (37, 29)]
MAIN = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
int main(int argc, char** argv) {
  const int h = atoi(argv[1]), w = atoi(argv[2]), adjoint = atoi(argv[3]);
  const size_t n = size_t(3) * h * w;
  float* buf = new float[n];
  float* out = new float[n];
  FILE* f = fopen(argv[4], "rb");
  if (f == nullptr || fread(buf, sizeof(float), n, f) != n) return 2;
  fclose(f);
  const int err = adjoint ? cgrt_bloom_quirk_adjoint(buf, out, h, w, nullptr)
                          : cgrt_bloom_quirk(buf, h, w, nullptr);
  f = fopen(argv[5], "wb");
  if (f == nullptr || fwrite(adjoint ? out : buf, sizeof(float), n, f) != n) return 2;
  fclose(f);
  delete[] buf;
  delete[] out;
  return err == 0 ? 0 : 3;
}
"""
CLUSTER = (("constexpr int kBloomCluster = 16;", "constexpr int kBloomCluster = 4;"),
           ("constexpr int kBloomWarps = 16;", "constexpr int kBloomWarps = 2;"))
# Substitutions that break one part of the design each.
FAULTS = {
    "own row's outputs dropped": ("for (int i = 0; i < kBloomR; ++i) sum += q[k + i];",
                                  "for (int i = 0; i < kBloomR; ++i) sum += 0.0f * q[k + i];"),
    "second pass's row-y terms dropped": ("for (int k = 0; k <= kBloomR; ++k) {",
                                          "for (int k = 0; k < 0; ++k) {"),
}


def build(out, name, subs=()):
    with open(os.path.join(CSRC, "bloom.cu")) as f:
        src = f.read()
    for old, new in (*CLUSTER, *subs):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    src, launches = re.subn(r"([\w:]+)<<<([^;]*?)>>>\(", r"emu_launch_threads(\2, \1, ", src)
    assert launches == 1, "bloom.cu's second-pass launch was not found"
    assert src.count("cudaLaunchKernelEx(") == 1, "bloom.cu's cluster launch was not found"
    src, shared = re.subn(r"extern __shared__ (\w+) (\w+)\[\];",
                          r"\1* const \2 = emu_dynamic_shared<\1>();", src)
    assert shared == 2, "bloom.cu's dynamic shared memory was not found"
    src = src.replace("#include <cuda_runtime.h>",
                      '#include "cuda_runtime.h"\n#include <algorithm>\n'
                      "using std::max;\nusing std::min;")
    path = os.path.join(out, f"{name}.cpp")
    with open(path, "w") as f:
        f.write(src + MAIN)
    exe = os.path.join(out, name)
    r = subprocess.run(["g++", "-std=c++17", "-O1", "-g", "-fsanitize=address,undefined",
                        "-fno-sanitize-recover=all", "-fno-omit-frame-pointer",
                        "-ffp-contract=off", "-pthread", "-I", EMU, path, "-o", exe],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    return exe


def needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation")


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    needs_gxx()
    out = tmp_path_factory.mktemp("bloom_emu")
    return build(str(out), "bloom_memcheck"), out


def run(exe, out, x, adjoint):
    h, w = x.shape[:2]
    src, dst = out / "in.bin", out / "out.bin"
    np.ascontiguousarray(x, np.float32).tofile(src)
    env = dict(os.environ, ASAN_OPTIONS="detect_leaks=0", UBSAN_OPTIONS="print_stacktrace=1")
    r = subprocess.run([exe, str(h), str(w), str(int(adjoint)), str(src), str(dst)],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-4000:]
    return np.fromfile(dst, np.float32).reshape(h, w, 3)


def inputs(hw):
    rng = np.random.default_rng(sum(hw))
    return (rng.uniform(0.0, 1.5, (*hw, 3)).astype(np.float32),
            rng.standard_normal((*hw, 3)).astype(np.float32))


@pytest.mark.parametrize("hw", SIZES)
def test_bloom_kernels_match_their_twins(emulator, hw):
    exe, out = emulator
    x, g = inputs(hw)
    np.testing.assert_allclose(run(exe, out, x, False),
                               te.bloom_quirk_plain(torch.from_numpy(x)).numpy(), **FN)
    np.testing.assert_allclose(run(exe, out, g, True),
                               te.bloom_quirk_adjoint_plain(torch.from_numpy(g)).numpy(), **FN)


@pytest.mark.parametrize("hw", [(40, 64), (37, 29)])
def test_bloom_adjoint_is_the_transpose(emulator, hw):
    exe, out = emulator
    x, g = inputs(hw)
    fx = run(exe, out, x, False).astype(np.float64)
    ftg = run(exe, out, g, True).astype(np.float64)
    lhs = float((fx * g.astype(np.float64)).sum())
    rhs = float((x.astype(np.float64) * ftg).sum())
    assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1.0), (lhs, rhs)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_part_is_seen(tmp_path, fault):
    needs_gxx()
    exe = build(str(tmp_path), "bloom_fault", subs=[FAULTS[fault]])
    x, g = inputs((24, 20))
    adjoint = fault.startswith("second")
    plain = te.bloom_quirk_adjoint_plain if adjoint else te.bloom_quirk_plain
    arg = g if adjoint else x
    assert not np.allclose(run(exe, tmp_path, arg, adjoint),
                           plain(torch.from_numpy(arg)).numpy(), atol=1e-4)
