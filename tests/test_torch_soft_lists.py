"""PyTorch port, the tree samplers' per-point lists, on the CPU.

``csrc/soft.cu``'s tree samplers run a point pass first: each marked point
walks the tree once against the hull of its sample rays and lists the
triangles that may block one of them (``may_block_tree`` in the leaves
``box_near`` enters).  A point that keeps at most ``kListMax`` has its
samples test that list alone, a blocker taken where the sample's own walk
would reach its leaf (``reaches``); the rest walk the tree, led by the path
of a probe toward the light's centre.  The header argues that the counts are
the walk's.  Here the kernel runs in the sanitized host emulation of
``tests/test_torch_soft_memcheck.py`` and its table variant's counts are held
exactly to the plain walk (``soft4_table_plain``) at widths 2, 4 and 8: on
the cup's frame, on the box's orbit points and on the box's cases built to
need each margin of the brute sampler's cull (``tests/test_torch_soft_cull.py``:
points a few ulps off a wall's plane, a light sphere tangent to the
ceiling's plane, grazing rays, slivers), on a ray that crosses a triangle's
plane just outside its box, parallel to the box's face (one that MT accepts
and the walk never reaches), and under a build whose lists hold two
triangles, so that most points walk.  Its lists and both tallies are held to
the plain model of the point pass (``soft.list_counts_plain``).  Planted
faults prove the cases need what they test: the hull's margins negated, or
``reaches`` taken as always true, must miscount.
"""
import functools
import os
import re

import numpy as np
import pytest
import torch

import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu_torch.ops import bvh4 as b4
from cg_raytracer_tpu_torch.ops import soft
from cg_raytracer_tpu_torch.ops.intersect import moller_trumbore_edges
from cg_raytracer_tpu_torch.scene import standins
from cg_raytracer_tpu_torch.scene.types import make_scene
from tests import test_torch_soft_cull as cull
from tests import test_torch_soft_memcheck as mc

LIST_MAX = re.compile(r"constexpr int kListMax = (\d+);")
SHORT = [(LIST_MAX.pattern, "constexpr int kListMax = 2;", 1)]
NEGATED = [(r"const float (near_p|far_c|off) = (n \* .*);", r"const float \1 = -(\2);", 3),
           (r"return 3\.0f \* kSlabEps \* (.*);", r"return -3.0f * kSlabEps * \1;", 1)]
ALWAYS_REACHES = [(r"(bool reaches\([^{]*\{)", r"\1\n  if (e != 0) return true;", 1)]
SAMPLES = 40  # samples a point at most: they straddle warps, and the plain models stay quick
CASES = ("cup", "orbit", "near_plane", "tangent_in", "tangent_0", "tangent_out", "grazing",
         "degenerate", "parallel")


def _list_max(subs=()) -> int:
    for pattern, repl, _ in subs:
        if pattern == LIST_MAX.pattern:
            return int(LIST_MAX.search(repl).group(1))
    with open(os.path.join(mc.CSRC, "soft.cu")) as f:
        return int(LIST_MAX.search(f.read()).group(1))


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """name -> ((executable, its directory), K): the source, and lists of two."""
    cull._need_gxx()
    out = tmp_path_factory.mktemp("soft_lists")
    return {"source": ((mc.build(str(out), mc.CSRC, name="lists_source"), out), _list_max()),
            "short": ((mc.build(str(out), mc.CSRC, SHORT, name="lists_short"), out),
                      _list_max(SHORT))}


def _parallel_scene():
    """One triangle in the plane z = 0 whose box ends at x = 0 (its vertex
    (0, 0, 0)), under the light of the parallel case."""
    mesh = {"vertices": np.asarray([(0.0, 0.0, 0.0), (-1.0, 0.5, 0.0), (-1.0, -0.5, 0.0)],
                                   np.float32),
            "normals": np.tile(np.asarray([0.0, 0.0, 1.0], np.float32), (3, 1)),
            "triangles": np.asarray([[0, 1, 2]], np.int32), "material": dict(standins.WHITE)}
    return make_scene([mesh], device="cpu", spherical_lights=trt.SphericalLights.of(
        ((1e-6, 0.0, 1.0), 0.1, (1.0, 1.0, 1.0))))


@functools.lru_cache(maxsize=None)
def case(name):
    """(scene, binary tree, points [N, 3], light position, light radius, S,
    gauss [S, N, 3] or None: drawn from the seed)."""
    if name == "cup":
        scene, bvh = mc.cup_tree()
        _, _, pos, marked = mc.frame("cup", 4)
        lp, lr = scene.spherical_lights.position[0], scene.spherical_lights.radius[0]
        return scene, bvh, pos[marked].contiguous(), lp, lr, SAMPLES, None
    if name == "parallel":
        # Points under the triangle's vertex and a light over it, 1e-6 past
        # the box's face x = 0; every Gaussian has gx = gy = 0, so every
        # sample ray runs along z with dx = 0: it crosses the plane at
        # (1e-6, 0, 0), where MT accepts (u = v = -5e-7), and never enters
        # the box.
        scene = _parallel_scene()
        pos = torch.stack([torch.full((12,), 1e-6), torch.zeros(12),
                           -torch.linspace(0.5, 1.5, 12)], 1)
        g = torch.randn((24, 12, 3), generator=torch.Generator().manual_seed(3))
        g[..., 0:2] = 0.0
        return (scene, b4.build_bvh4(scene, max_leaf=4, builder="sah")[0], pos,
                *cull._light(scene), 24, g)
    scene, pos, lp, lr, num = cull.case(name)
    if name == "orbit":
        pos = pos[::3].contiguous()
    return (scene, b4.build_bvh4(scene, max_leaf=4, builder="sah")[0], pos, lp, lr,
            min(num, SAMPLES), None)


def run_case(build, k, name, width, tag):
    """(emulated counts, the walk's counts, emulated tally, the model's
    counts and tally, emulated (list tally, kept, lists), the model's (kept,
    lists), marked) of ``case(name)`` on its tree at ``width``."""
    scene, bvh, pos, lp, lr, num, g = case(name)
    tree = b4.collapse_bvhw(bvh, width)
    n = pos.shape[0]
    marked = torch.arange(n) % 7 != 3
    if g is None:
        g = torch.randn((num, n, 3), generator=torch.Generator().manual_seed(n + num))
    g_nsc = g.permute(1, 0, 2).contiguous()
    light = soft.light_row(lp, lr)
    exe, out = build
    r, got, tally, lists = mc.emulate(exe, out, tag, pos, marked, light, tree, g_nsc,
                                      num_samples=num, lists=True)
    assert r.returncode == 0, f"{tag}: the sanitized sampler failed\n{r.stderr[:4000]}"
    want = soft.soft4_table_plain(scene, tree, pos, lp, lr, g, valid=marked)
    model = soft.list_counts_plain(tree, pos, light, num, marked.to(torch.uint8), k,
                                   gauss_nsc=g_nsc)
    plain = soft.point_lists_plain(tree, pos[marked], light, k)
    return got, want, tally, model, lists, plain, marked


def _valid_entries(kept, lists, k):
    """Each marked point's list entries that the pass wrote: 2 kept for a
    listed point, its path's length for the rest; -1 elsewhere."""
    cols = torch.arange(2 * k)[None, :]
    size = torch.where(kept >= 0, 2 * kept, -1 - kept)[:, None]
    return torch.where(cols < size, lists, -1)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("width", [2, 4, 8])
def test_list_counts_equal_the_walk(builds, width, name):
    (build, k) = builds["source"]
    got, want, tally, model, (list_tally, kept, lists), plain, marked = run_case(
        build, k, name, width, f"{name}_w{width}")
    assert torch.equal(got, want), (
        f"{name} at width {width}: {int((got != want).sum())} points differ from the walk")
    assert not got[~marked].any()
    m = int(marked.sum())
    counts, tree_tally, model_lists = model
    assert torch.equal(got, counts.to(torch.float32))
    assert tally == tree_tally and list_tally == model_lists, (tally, tree_tally, list_tally,
                                                               model_lists)
    p_kept, p_lists, _, _ = plain
    assert torch.equal(kept[:m], p_kept)
    assert torch.equal(_valid_entries(kept[:m], lists[:m], k), _valid_entries(p_kept, p_lists, k))
    assert list_tally[0] == m and 0 < list_tally[1] <= m


@pytest.mark.parametrize("name", ["cup", "orbit", "degenerate"])
@pytest.mark.parametrize("width", [2, 4, 8])
def test_short_lists_walk_led(builds, width, name):
    """Lists of two: most points walk, led by their probes' paths; counts
    and tallies as the walk's and the model's."""
    (build, k) = builds["short"]
    got, want, tally, model, (list_tally, kept, _), _, marked = run_case(
        build, k, name, width, f"short_{name}_w{width}")
    assert torch.equal(got, want), f"{name} at width {width}: the short lists miscount"
    counts, tree_tally, model_lists = model
    assert torch.equal(got, counts.to(torch.float32))
    assert tally == tree_tally and list_tally == model_lists
    m = int(marked.sum())
    assert list_tally[1] < m and list_tally[5] > 0  # some walk, and a probe led some
    assert bool((kept[:m] < -1).any())


def test_tangent_cases_need_the_margins(tmp_path):
    """The hull's margins negated (may_block_tree's and box_near's): the
    tangent sphere's ceiling is dropped from lists for rays that end beyond
    it, and counts change."""
    cull._need_gxx()
    exe = mc.build(str(tmp_path), mc.CSRC, NEGATED, name="lists_negated")
    got, want, *_ = run_case((exe, tmp_path), _list_max(), "tangent_in", 4, "negated_tangent_in")
    assert not torch.equal(got, want), "the negated margins changed no count"
    assert bool((got >= want).all())  # dropping a triangle only lets rays through


def test_parallel_case_needs_reaches(tmp_path):
    """``reaches`` taken as always true: the triangle that MT accepts but the
    walk never reaches blocks every sample, and counts change."""
    cull._need_gxx()
    exe = mc.build(str(tmp_path), mc.CSRC, ALWAYS_REACHES, name="lists_reaches")
    got, want, *_ = run_case((exe, tmp_path), _list_max(), "parallel", 4, "always_parallel")
    assert not torch.equal(got, want), "taking every list hit changed no count"
    assert bool((got <= want).all())


def test_parallel_case_is_live():
    """The parallel case reaches what it is built for: every sample ray has
    dx = 0 and MT accepts the triangle for it, while the walk never enters
    the triangle's leaf (the walk's counts are every sample)."""
    scene, bvh, pos, lp, lr, num, g = case("parallel")
    o, d, tm = soft.sample_rays(pos[None, :, :], g, soft.light_row(lp, lr))
    assert bool((d[..., 0] == 0.0).all())
    tri = b4.collapse_bvhw(bvh, 4).tris
    row = tri[(tri[:, 2] == 0.0) & (tri[:, 5] == 0.0)][0]
    _, _, _, ok = moller_trumbore_edges(o.reshape(-1, 3), d.reshape(-1, 3), row[0:3], row[3:6],
                                        row[6:9])
    assert bool(ok.all())
    want = soft.soft4_table_plain(scene, b4.collapse_bvhw(bvh, 4), pos, lp, lr, g)
    assert bool((want == num).all())


def test_tree_list_counts_sum_and_reset(monkeypatch):
    """``tree_list_counts`` sums every device's tally under ``LIST_KEYS``;
    ``reset_tree_list_counts`` zeroes it in place (a captured graph keeps
    adding into the same tensor)."""
    monkeypatch.setattr(soft, "_LIST_TALLY", {})
    assert soft.tree_list_counts() == dict.fromkeys(soft.LIST_KEYS, 0)
    tally = soft._list_tally(torch.device("cpu"))
    tally.add_(torch.arange(1, len(soft.LIST_KEYS) + 1))
    assert list(soft.tree_list_counts().values()) == list(range(1, len(soft.LIST_KEYS) + 1))
    soft.reset_tree_list_counts()
    assert set(soft.tree_list_counts().values()) == {0}
    assert soft._list_tally(torch.device("cpu")) is tally


def test_parallel_case_lists_its_points():
    """Every point of the parallel case keeps the triangle in its list (the
    hull cannot rule out a ray that MT accepts), so its samples take the
    list's path, where ``reaches`` decides."""
    _, bvh, pos, lp, lr, _, _ = case("parallel")
    kept, _, _, _ = soft.point_lists_plain(b4.collapse_bvhw(bvh, 4), pos,
                                           soft.light_row(lp, lr), _list_max())
    assert bool((kept == 1).all())
