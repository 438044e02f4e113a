"""PyTorch port, the samplers' any-hit Moller-Trumbore test, on the CPU.

``csrc/sweep.cuh::mt_blocks`` stops at the first condition that fails
(|det|, then u, v, u + v, then 0 <= t < t_max); it must decide exactly as
the full test ``mt(...) && t < t_max``.  It wraps ``mt_early``, the brute
closest sweeps' test, which must also return mt's t, u and v bit for bit
where it hits.  All are compiled as host C++ against the stand-in CUDA
header of ``tests/cuda_emu`` (``-ffp-contract=off``, as the card's
``-fmad=false``) and run on the same cases, made with numpy from a seed:
random rays and triangles, rays nearly parallel to the triangle (|det|
around ``kMtEps``), rays that graze an edge or a vertex (barycentrics within
a few ``kBaryEps`` of the bound), and hits at t near 0 and near ``t_max``.
"""
import os
import shutil
import struct
import subprocess

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "cg_raytracer_tpu_torch", "csrc")
EMU = os.path.join(ROOT, "tests", "cuda_emu")
K = 4000  # cases per group


def unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def triangles(rng, k):
    return (rng.uniform(-1, 1, (k, 3)), rng.uniform(-1, 1, (k, 3)) * rng.uniform(0.05, 1, (k, 1)),
            rng.uniform(-1, 1, (k, 3)) * rng.uniform(0.05, 1, (k, 1)))


def toward(v0, e1, e2, u, v, d, dist):
    """Rays along unit ``d`` that reach barycentric (u, v) at distance ``dist``."""
    target = v0 + u[:, None] * e1 + v[:, None] * e2
    return target - d * dist[:, None], d


def cases(seed=0):
    """group -> (rays [k, 6], triangles [k, 9] as v0, e1, e2, t_max [k]), float32."""
    rng = np.random.default_rng(seed)
    out = {}

    def put(name, o, d, v0, e1, e2, t_max):
        f32 = lambda *a: np.concatenate(a, axis=1).astype(np.float32)  # noqa: E731
        out[name] = (f32(o, d), f32(v0, e1, e2), np.asarray(t_max, np.float32))

    v0, e1, e2 = triangles(rng, K)
    u, v, dist = rng.uniform(-0.3, 1.3, K), rng.uniform(-0.3, 1.3, K), rng.uniform(0.1, 3, K)
    o, d = toward(v0, e1, e2, u, v, unit(rng.normal(size=(K, 3))), dist)
    put("random", o, d, v0, e1, e2, dist * rng.uniform(0, 2, K))

    # Near-parallel: a direction in the triangle's plane tilted out of it so
    # that det = -d . (e1 x e2) is 0.1 to 10 times kMtEps, either sign.
    v0, e1, e2 = triangles(rng, K)
    n = np.cross(e1, e2)
    in_plane = unit(np.cross(n, rng.normal(size=(K, 3))))
    tilt = rng.choice([-1, 1], K) * 10 ** rng.uniform(-10, -8, K) / np.linalg.norm(n, axis=1)
    d = unit(in_plane + tilt[:, None] * unit(n))
    o, d = toward(v0, e1, e2, rng.uniform(0.1, 0.4, K), rng.uniform(0.1, 0.4, K), d,
                  rng.uniform(0.1, 2, K))
    put("near_parallel", o, d, v0, e1, e2, np.full(K, 10.0))

    # Edge and vertex grazes: u = 0, v = 0, u + v = 1 or a vertex, moved by
    # 0 to a few kBaryEps either way.
    v0, e1, e2 = triangles(rng, K)
    s = rng.uniform(0, 1, K)
    kind = rng.integers(0, 4, K)
    u = np.select([kind == 0, kind == 1, kind == 2], [0 * s, s, 1 - s], rng.integers(0, 2, K) * 1.0)
    v = np.select([kind == 0, kind == 1, kind == 2], [s, 0 * s, s], 0 * s)
    du = rng.choice([0, 1e-8, 1e-7, 5e-7, 1e-6, 2e-6, 5e-6], K) * rng.choice([-1, 1], K)
    dv = rng.choice([0, 1e-8, 1e-7, 5e-7, 1e-6, 2e-6, 5e-6], K) * rng.choice([-1, 1], K)
    o, d = toward(v0, e1, e2, u + du, v + dv, unit(rng.normal(size=(K, 3))),
                  rng.uniform(0.1, 3, K))
    put("edge_graze", o, d, v0, e1, e2, np.full(K, 10.0))

    # t near 0: the origin a few 1e-7 in front of or behind the plane.
    v0, e1, e2 = triangles(rng, K)
    dist = rng.integers(-4, 5, K) * 1e-7
    o, d = toward(v0, e1, e2, rng.uniform(0, 0.5, K), rng.uniform(0, 0.5, K),
                  unit(rng.normal(size=(K, 3))), dist)
    put("t_near_0", o, d, v0, e1, e2, np.full(K, 10.0))

    # t near t_max: t_max within a few ulps-scale steps of the hit distance.
    v0, e1, e2 = triangles(rng, K)
    dist = rng.uniform(0.5, 2, K)
    o, d = toward(v0, e1, e2, rng.uniform(0, 0.5, K), rng.uniform(0, 0.5, K),
                  unit(rng.normal(size=(K, 3))), dist)
    put("t_near_t_max", o, d, v0, e1, e2, dist * (1 + rng.integers(-5, 6, K) * 1e-7))
    return out


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation")
    out = tmp_path_factory.mktemp("mt_emu")
    exe = str(out / "mt_check")
    r = subprocess.run(["g++", "-std=c++17", "-O1", "-g", "-fsanitize=address,undefined",
                        "-fno-sanitize-recover=all", "-ffp-contract=off", "-I", EMU, "-I", CSRC,
                        os.path.join(EMU, "mt_main.cpp"), "-o", exe],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    return exe, out


def run(harness, rays, tris, t_max, tag):
    exe, out = harness
    n = rays.shape[0]
    path = out / f"{tag}.in"
    with open(path, "wb") as f:
        f.write(struct.pack("<q", n))
        for a in (rays, tris, t_max):
            f.write(np.ascontiguousarray(a).tobytes())
    env = dict(os.environ, ASAN_OPTIONS="detect_leaks=0")
    r = subprocess.run([exe, str(path), str(out / f"{tag}.out")], capture_output=True, text=True,
                       env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    return np.fromfile(out / f"{tag}.out", dtype=np.uint8).reshape(4, n).astype(bool)


@pytest.mark.parametrize("group", ["random", "near_parallel", "edge_graze", "t_near_0",
                                   "t_near_t_max"])
def test_mt_blocks_decides_as_mt(harness, group):
    rays, tris, t_max = cases()[group]
    full, early, det_ok, _ = run(harness, rays, tris, t_max, group)
    bad = np.nonzero(full != early)[0]
    assert bad.size == 0, f"{group}: {bad.size} cases differ, first {bad[:5]}"
    # Each group reaches both decisions; the near-parallel rays fall on both
    # sides of the determinant's threshold.
    assert full.any() and not full.all(), (group, full.mean())
    if group == "near_parallel":
        assert det_ok.any() and not det_ok.all(), det_ok.mean()


@pytest.mark.parametrize("group", ["random", "near_parallel", "edge_graze", "t_near_0",
                                   "t_near_t_max"])
def test_mt_early_gives_mt_t_u_v(harness, group):
    """The closest sweeps' test (``mt_early``, t_max the best t so far)
    decides as the full test and, where it hits, returns mt's t, u and v
    bit for bit."""
    rays, tris, t_max = cases()[group]
    full, _, _, closer = run(harness, rays, tris, t_max, group)
    bad = np.nonzero(~closer)[0]
    assert bad.size == 0, f"{group}: {bad.size} cases differ, first {bad[:5]}"
    assert full.any(), group
