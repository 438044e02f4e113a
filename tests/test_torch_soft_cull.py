"""PyTorch port, the brute soft-shadow sampler's per-point culling, on the CPU.

``csrc/soft.cu``'s brute sampler tests each sample ray only against the
triangles that its point's two culling tests keep (``may_block``), and the
header's argument says a culled triangle never blocks a ray the kernel
forms.  Here the kernel runs in the sanitized host emulation of
``tests/test_torch_soft_memcheck.py`` (a block's threads at once, so that
its masks' barrier and atomics are real; the grid cut so that each block
strides over many points), its table variant's counts are held exactly to
the plain twin ``soft_table_plain``, which sweeps every triangle, on the
box's orbit shading points and on cases built to need each margin: points
a few ulps off a wall's plane, a light sphere that touches or crosses a
triangle's plane by less than the margins, sample rays that graze a face's
plane, near-degenerate triangles, and the dense 256-triangle box (eight mask
words), at S = 1, 7, 33 and 200 samples (blocks spanning many points,
samples that do not divide by 32).  Two builds run: the source as it is
(culling from ``kCullMinSamples`` samples on) and one that culls at every
S.  A planted fault proves the cases need the margins: the same build with
the margins negated must miscount.  The tally (tests kept, tests of full
sweeps) is held to what the launch swept.
"""
import functools
import os
import shutil

import numpy as np
import pytest
import torch

import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu_torch.ops import cuda_kernels as ck
from cg_raytracer_tpu_torch.ops import soft
from cg_raytracer_tpu_torch.ops.camera import generate_rays
from cg_raytracer_tpu_torch.scene import standins
from cg_raytracer_tpu_torch.scene.presets import load_standin
from cg_raytracer_tpu_torch.scene.types import make_scene
from tests import test_torch_soft_memcheck as mc

CULL_ALWAYS = [(r"constexpr int kCullMinSamples = \d+;", "constexpr int kCullMinSamples = 1;", 1)]
NEGATED = [(r"const float (mp|mc|ms) = (.*);", r"const float \1 = -(\2);", 3)]
ORBIT = ((20.0, 20.0), (5.0, -25.0), (35.0, 65.0), (5.0, 65.0), (35.0, -25.0))  # pitch, yaw
SIZE = 14


def _need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation")


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """name -> (executable, its directory): the source, and culling at every S."""
    _need_gxx()
    out = tmp_path_factory.mktemp("soft_cull")
    return {"source": (mc.build(str(out), mc.CSRC, name="cull_source"), out),
            "always": (mc.build(str(out), mc.CSRC, CULL_ALWAYS, name="cull_always"), out)}


def _hits(scene, o, d):
    hit = ck.intersect_plain(scene, o, d)
    valid = hit.prim_id >= 0
    pos = torch.where(valid[:, None], o + d * torch.where(valid, hit.t, 0.0)[:, None], 0.0)
    return pos, valid, hit.prim_id


def _normals(scene, prim):
    tri = ck._tri_table(scene)[prim.clamp_min(0)]
    n = torch.cross(tri[:, 3:6] - tri[:, 0:3], tri[:, 6:9] - tri[:, 0:3], dim=1)
    return n / n.norm(dim=1, keepdim=True)


@functools.lru_cache(maxsize=None)
def box():
    return load_standin("spherical_box", device="cpu")


@functools.lru_cache(maxsize=None)
def orbit_points():
    """Every level's shading points of the box along the orbit: the camera's
    hits at a few poses of the figure-eight and the hits of their
    reflections."""
    scene, pts = box(), []
    for pitch, yaw in ORBIT:
        cam = trt.Camera.default(euler_deg=(pitch, yaw, 0.0), device="cpu")
        o, d = generate_rays(cam, SIZE, SIZE)
        pos, valid, prim = _hits(scene, o, d)
        pts.append(pos[valid])
        n = _normals(scene, prim)[valid]
        dv = d[valid]
        r = dv - 2.0 * (dv * n).sum(1, keepdim=True) * n
        p2, v2, _ = _hits(scene, (pos[valid] + 1e-3 * r).contiguous(), r.contiguous())
        pts.append(p2[v2])
    return torch.cat(pts).contiguous()


def _ceiling(scene):
    """The ceiling quad's centroid and unit normal into the box."""
    tri = ck._tri_table(scene)[2].reshape(3, 3).double()
    n = torch.cross(tri[1] - tri[0], tri[2] - tri[0], dim=0)
    n = n / n.norm()
    m = tri.mean(0)
    return m, (n if float(n @ (torch.zeros(3, dtype=torch.float64) - m)) > 0 else -n)


def _near_plane_points(scene, count=96, ulps=(-3, -1, 0, 1, 3)):
    """Points on the walls' and blocks' triangles, moved a few ulps off
    their planes (each coordinate nudged toward or away from the normal)."""
    g = torch.Generator().manual_seed(11)
    tri = ck._tri_table(scene)
    k = torch.randint(0, tri.shape[0], (count,), generator=g)
    a, b = torch.rand((count, 1), generator=g), torch.rand((count, 1), generator=g)
    a, b = torch.minimum(a, 1 - b), torch.minimum(b, 1 - a)
    t = tri[k]
    p = t[:, 0:3] + a * (t[:, 3:6] - t[:, 0:3]) + b * (t[:, 6:9] - t[:, 0:3])
    n = _normals(scene, k)
    out = []
    for u in ulps:
        q = p.clone()
        for _ in range(abs(u)):
            q = torch.nextafter(q, q + torch.sign(torch.tensor(float(u))) * n * 1e3)
        out.append(q)
    return torch.cat(out).contiguous()


def _extra_scene(extra):
    """The box with the meshes ``extra`` (vertex lists of triangles) added."""
    meshes = standins.mirror_box_meshes()
    for tri in extra:
        v = np.asarray(tri, np.float32)
        nrm = np.cross(v[1] - v[0], v[2] - v[0]).astype(np.float64)
        nrm = (nrm / max(np.linalg.norm(nrm), 1e-30)).astype(np.float32)
        meshes.append({"vertices": v, "normals": np.tile(nrm, (3, 1)),
                       "triangles": np.asarray([[0, 1, 2]], np.int32),
                       "material": dict(standins.WHITE)})
    return make_scene(meshes, device="cpu",
                      spherical_lights=trt.SphericalLights.of(*standins.SPHERICAL_BOX_LIGHTS))


def _light(scene):
    return scene.spherical_lights.position[0].clone(), scene.spherical_lights.radius[0].clone()


@functools.lru_cache(maxsize=None)
def case(name):
    """(scene, points [N, 3], light position, light radius, S)."""
    scene = box()
    if name == "orbit":
        return scene, orbit_points(), *_light(scene), 200
    if name == "near_plane":
        return scene, _near_plane_points(scene), *_light(scene), 33
    if name.startswith("tangent"):
        # The light's sphere crosses the ceiling's plane by depth (negative:
        # stays below it), under the ceiling's centroid; points: the frame.
        depth = {"tangent_in": 1.5e-3, "tangent_0": 0.0, "tangent_out": -1e-4}[name]
        m, n_in = _ceiling(scene)
        r = 0.1
        c = (m + n_in * (r - depth)).float()
        o, d = generate_rays(trt.Camera.default(device="cpu"), SIZE, SIZE)
        pos, valid, _ = _hits(scene, o, d)
        return scene, pos[valid].contiguous(), c, torch.tensor(r), 200
    if name == "grazing":
        # The light's centre on the tall block's front face's plane, beyond
        # the face: rays from points near that plane graze it and its twin.
        tri = ck._tri_table(scene)[22].reshape(3, 3)
        e1, e2 = tri[1] - tri[0], tri[2] - tri[0]
        n = torch.cross(e1, e2, dim=0)
        n = n / n.norm()
        m = tri.mean(0)
        c = m + 0.5 * (m - tri[0]) / (m - tri[0]).norm()
        g = torch.Generator().manual_seed(5)
        a, b = torch.rand((160, 1), generator=g), torch.rand((160, 1), generator=g)
        off = (torch.rand((160, 1), generator=g) - 0.5) * 2e-3
        p = tri[0] + 2.0 * (a - 0.5) * e1 + 2.0 * (b - 0.5) * e2 + off * n
        return scene, p.contiguous(), c, torch.tensor(0.05), 7
    if name == "degenerate":
        # A sliver, a tiny triangle and a collinear one in the light's way,
        # over the floor.
        c = standins.SPHERICAL_BOX_LIGHTS[0][0]
        y = c[1] - 0.3
        extra = [((-0.2, y, 0.0), (0.2, y, 0.0), (0.0, y + 1e-6, 1e-6)),
                 ((0.01, y + 0.1, 0.01), (0.01 + 1e-5, y + 0.1, 0.01), (0.01, y + 0.1, 0.01 + 1e-5)),
                 ((-0.1, y + 0.05, -0.1), (0.0, y + 0.05, 0.0), (0.1, y + 0.05, 0.1)),
                 ((-0.15, y, -0.15), (0.15, y, -0.15), (0.0, y + 1e-7, 0.15))]
        scene = _extra_scene(extra)
        o, d = generate_rays(trt.Camera.default(device="cpu"), SIZE, SIZE)
        pos, valid, _ = _hits(scene, o, d)
        return scene, pos[valid].contiguous(), *_light(scene), 200
    if name.startswith("dense"):
        scene = make_scene(standins.dense_mirror_box_meshes(), device="cpu",
                           spherical_lights=trt.SphericalLights.of(
                               *standins.SPHERICAL_BOX_LIGHTS))
        o, d = generate_rays(trt.Camera.default(device="cpu"), 12, 12)
        pos, valid, _ = _hits(scene, o, d)
        return scene, pos[valid].contiguous(), *_light(scene), int(name.split("_")[1])
    raise ValueError(name)


CASES = ("orbit", "near_plane", "tangent_in", "tangent_0", "tangent_out", "grazing",
         "degenerate", "dense_1", "dense_33")


def run_case(build, name, tag):
    """(emulated counts, twin counts, tally, marked, S, T) of ``case(name)``."""
    scene, pos, lp, lr, num = case(name)
    n = pos.shape[0]
    marked = torch.arange(n) % 7 != 3
    g = torch.randn((num, n, 3), generator=torch.Generator().manual_seed(n + num))
    light = soft.light_row(lp, lr)
    tri = ck._tri_table(scene).detach().contiguous()
    exe, out = build
    r, got, tally = mc.emulate(exe, out, tag, pos, marked, light, tri,
                               g.permute(1, 0, 2).contiguous(), num_samples=num)
    assert r.returncode == 0, f"{tag}: the sanitized sampler failed\n{r.stderr[:4000]}"
    want = soft.soft_table_plain(scene, pos, lp, lr, g, valid=marked)
    return got, want, tally, marked, num, tri.shape[0]


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("which", ["source", "always"])
def test_culled_counts_equal_the_twin(builds, which, name):
    got, want, tally, marked, num, nt = run_case(builds[which], name, f"{which}_{name}")
    assert torch.equal(got, want), (
        f"{which}, {name}: {int((got != want).sum())} points differ from the twin")
    assert not got[~marked].any()
    kept, swept = tally
    if name.startswith("dense"):
        assert nt == 256  # eight mask words
    assert swept == nt * num * int(marked.sum())
    assert 0 < kept <= swept
    if which == "source" and num < _min_samples():
        assert kept == swept  # below the threshold every triangle is swept
    elif name == "orbit":
        assert kept < 0.5 * swept, (kept, swept)


def _min_samples() -> int:
    with open(os.path.join(mc.CSRC, "soft.cu")) as f:
        text = f.read()
    return int(text.split("constexpr int kCullMinSamples = ")[1].split(";")[0])


def test_tangent_cases_need_the_margins(tmp_path):
    """The margins negated (every cull test's margin subtracted instead of
    added): the sphere that crosses the ceiling by less than the margins
    has its ceiling culled for rays that end beyond it, and counts change."""
    _need_gxx()
    exe = mc.build(str(tmp_path), mc.CSRC, CULL_ALWAYS + NEGATED, name="cull_negated")
    got, want, _, _, _, _ = run_case((exe, tmp_path), "tangent_in", "negated_tangent_in")
    assert not torch.equal(got, want), "the negated margins changed no count"
    assert bool((got >= want).all())  # culling only lets rays through


def test_cull_counts_sum_and_reset(monkeypatch):
    """``cull_counts`` sums every device's pair; ``reset_cull_counts`` zeroes
    them in place (a captured graph keeps adding into the same tensor)."""
    monkeypatch.setattr(soft, "_TALLY", {})
    assert soft.cull_counts() == (0, 0)
    tally = soft._tally(torch.device("cpu"))
    tally.add_(torch.tensor([3, 10]))
    assert soft.cull_counts() == (3, 10)
    soft.reset_cull_counts()
    assert soft.cull_counts() == (0, 0) and soft._tally(torch.device("cpu")) is tally


@pytest.mark.parametrize("name", ["tangent_in", "grazing"])
def test_margin_cases_are_live(name):
    """The cases reach what they are built for: the ceiling blocks some of
    the tangent sphere's sample rays (those ending in its cap beyond the
    ceiling's plane); the grazing rays run within a few degrees of the
    face's plane."""
    scene, pos, lp, lr, num = case(name)
    if name == "tangent_in":
        meshes = standins.mirror_box_meshes()
        open_top = make_scene(meshes[:1] + meshes[2:], device="cpu",
                              spherical_lights=scene.spherical_lights)
        g = torch.randn((num, pos.shape[0], 3), generator=torch.Generator().manual_seed(3))
        with_ceiling = soft.soft_table_plain(scene, pos, lp, lr, g)
        without = soft.soft_table_plain(open_top, pos, lp, lr, g)
        assert bool((without >= with_ceiling).all()) and bool((without > with_ceiling).any())
    else:
        tri = ck._tri_table(scene)[22].reshape(3, 3)
        n = torch.cross(tri[1] - tri[0], tri[2] - tri[0], dim=0)
        n = n / n.norm()
        d = lp - pos
        sin = (d @ n).abs() / d.norm(dim=1)
        assert float(sin.median()) < 0.005
