"""PyTorch port, the quirk blur's kernels (``csrc/bloom.cu``) on the CPU.

The source is compiled as host C++ against the stand-in CUDA header of
``tests/cuda_emu`` with AddressSanitizer and UBSan, its launches rewritten
to ``emu_launch_threads`` (a block's threads on host threads: the block's
barrier between wavefronts is a barrier, and ``__shfl_xor_sync`` exchanges
values between the lanes of a warp) and its block cut from 1024 threads to
128 (four warps: each warp then blurs more pixels of a wavefront, the same
loop), its adjoint's dynamic shared memory a heap buffer of exactly the
launch's bytes.  Each image lives in a buffer of exactly its size.

- The forward against the plain twin ``bloom_quirk_plain`` at rtol 1e-5,
  atol 1e-6 (each window summed in another order), on sizes that make a
  wavefront hold one pixel, several, and more pixels than the block has
  warps.
- The adjoint against ``bloom_quirk_adjoint_plain`` bit for bit: both add,
  for each cell, its cotangent and then the covering centres' terms in row
  order.
- A build whose adjoint forgets the centre below (so a cell in two windows
  takes one term) must differ: the harness sees the overlap.
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
MAIN = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
int main(int argc, char** argv) {
  const int h = atoi(argv[1]), w = atoi(argv[2]), adjoint = atoi(argv[3]);
  float* buf = new float[3 * h * w];
  FILE* f = fopen(argv[4], "rb");
  if (f == nullptr || fread(buf, sizeof(float), 3 * h * w, f) != size_t(3 * h * w)) return 2;
  fclose(f);
  const int err = adjoint ? cgrt_bloom_quirk_adjoint(buf, h, w, nullptr)
                          : cgrt_bloom_quirk(buf, h, w, nullptr);
  f = fopen(argv[5], "wb");
  if (f == nullptr || fwrite(buf, sizeof(float), 3 * h * w, f) != size_t(3 * h * w)) return 2;
  fclose(f);
  delete[] buf;
  return err == 0 ? 0 : 3;
}
"""


def build(out, name, subs=()):
    with open(os.path.join(CSRC, "bloom.cu")) as f:
        src = f.read()
    for old, new in (("constexpr int kBloomThreads = 1024;", "constexpr int kBloomThreads = 128;"),
                     *subs):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    src, launches = re.subn(r"([\w:]+)<<<([^;]*?)>>>\(", r"emu_launch_threads(\2, \1, ", src)
    assert launches == 2, "bloom.cu's kernel launches were not found"
    src, shared = re.subn(r"extern __shared__ (\w+) (\w+)\[\];",
                          r"\1* const \2 = emu_dynamic_shared<\1>();", src)
    assert shared == 1, "bloom.cu's dynamic shared memory was not found"
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


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation")
    out = tmp_path_factory.mktemp("bloom_emu")
    return build(str(out), "bloom_memcheck"), out


def run(exe, out, x, adjoint):
    h, w = x.shape[:2]
    src, dst = out / "in.bin", out / "out.bin"
    np.ascontiguousarray(x, np.float32).tofile(src)
    env = dict(os.environ, ASAN_OPTIONS="detect_leaks=0", UBSAN_OPTIONS="print_stacktrace=1")
    r = subprocess.run([exe, str(h), str(w), str(int(adjoint)), str(src), str(dst)],
                       capture_output=True, text=True, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    return np.fromfile(dst, np.float32).reshape(h, w, 3)


@pytest.mark.parametrize("hw", [(24, 20), (3, 40), (14, 100)])
def test_bloom_kernels_match_their_twins(emulator, hw):
    exe, out = emulator
    rng = np.random.default_rng(sum(hw))
    x = rng.uniform(0.0, 1.5, (*hw, 3)).astype(np.float32)
    g = rng.standard_normal((*hw, 3)).astype(np.float32)
    np.testing.assert_allclose(run(exe, out, x, False),
                               te.bloom_quirk_plain(torch.from_numpy(x)).numpy(), **FN)
    np.testing.assert_array_equal(run(exe, out, g, True),
                                  te.bloom_quirk_adjoint_plain(torch.from_numpy(g)).numpy())


def test_a_dropped_overlap_term_is_seen(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation")
    exe = build(str(tmp_path), "bloom_fault",
                subs=[("const bool below = y + 1 <= y_hi",
                       "const bool below = false && y + 1 <= y_hi")])
    g = np.random.default_rng(5).standard_normal((24, 20, 3)).astype(np.float32)
    got = run(exe, tmp_path, g, True)
    assert not np.allclose(got, te.bloom_quirk_adjoint_plain(torch.from_numpy(g)).numpy(),
                           atol=1e-4)
