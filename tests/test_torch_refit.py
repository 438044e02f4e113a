"""PyTorch port: the BVH refit (``ops/refit.py``) against the built tree, brute
force and the JAX package's ``refit_accel``.

A refit of unmoved vertices gives back the built tree bit for bit (min and
max are exact), for the binary ``BVH`` and the 4-wide ``BVH4``, a leaf root
included.  On the lathed cup of ``tests/test_torch_bvh.py`` moved by normal
noise (scale 0.05, seed 0), the refit tree's hits equal brute force on the
moved scene up to coincident-t ties (<= 0.2% of rays, ``tests/test_refit.py``'s
rule), and equal JAX's refit of the same tree walked by its BVH4 kernel in
interpret mode (boxes equal exactly, hits as ``assert_hits_agree``).  A
vertex gradient through one refit step (``backend='bvh'``, the loss
sum(image^2) of ``tests/test_refit.py:79-108``) equals JAX's to rtol 2e-4,
atol 2e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cg_raytracer_tpu as jrt
import cg_raytracer_tpu_torch as trt
from cg_raytracer_tpu.models import whitted as jw
from cg_raytracer_tpu.ops import bvh as jbvh
from cg_raytracer_tpu.ops import pallas_bvh4 as jb4
from cg_raytracer_tpu.ops import refit as jrefit
from cg_raytracer_tpu_torch.models import whitted as tw
from cg_raytracer_tpu_torch.ops import bvh as tbvh
from cg_raytracer_tpu_torch.ops import bvh4 as tb4
from cg_raytracer_tpu_torch.ops import intersect as tint
from cg_raytracer_tpu_torch.ops.refit import make_refit_plan, refit_accel
from tests.test_torch_bvh import assert_hits_agree, cup_pair, mesh_rays
from tests.test_torch_bvh4 import jax_and_port_trees


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same_bits(a, b, fields):
    return {f: torch.equal(_bits(getattr(a, f)), _bits(getattr(b, f))) for f in fields}


def moved_cup(scale=0.05, seed=0):
    j, t = cup_pair()
    rng = np.random.default_rng(seed)
    v2 = (np.asarray(j.vertices)
          + rng.normal(scale=scale, size=j.vertices.shape).astype(np.float32))
    return (j, t, dataclasses.replace(j, vertices=jnp.asarray(v2)),
            dataclasses.replace(t, vertices=torch.from_numpy(v2)))


def _mismatch(got, want):
    big = lambda t: np.where(np.isinf(t), 1e9, t)  # noqa: E731
    return (~np.isclose(big(got.t.numpy()), big(np.asarray(want.t)), atol=1e-4,
                        rtol=1e-5)).mean()


@pytest.mark.parametrize("builder,leaf", [("median", 4), ("sah", 4), ("median", 14)])
def test_refit_of_unmoved_vertices_is_the_built_tree(builder, leaf):
    _, t = cup_pair()
    bvh = tbvh.build_bvh(t, max_leaf=leaf, builder=builder)
    assert all(_same_bits(bvh, refit_accel(bvh, t), ("node_lo", "node_hi", "tv0", "tv1",
                                                     "tv2")).values())
    tree = tb4.collapse_bvh4(bvh)
    again = refit_accel(tree, t, make_refit_plan(tree))
    assert all(_same_bits(tree, again, ("boxes", "tris", "meta", "nchild")).values())
    assert again.boxes is not tree.boxes  # new tensors; the built tree is untouched
    # A leaf root: one binary leaf, one 4-wide node with one leaf child.
    small = dataclasses.replace(t, triangles=t.triangles[:3], tri_material=t.tri_material[:3])
    bvh = tbvh.build_bvh(small, max_leaf=leaf)
    tree = tb4.collapse_bvh4(bvh)
    assert bvh.num_nodes == 1 and tree.num_nodes == 1 and int(tree.nchild[0]) == 1
    assert all(_same_bits(bvh, refit_accel(bvh, small), ("node_lo", "node_hi")).values())
    assert all(_same_bits(tree, refit_accel(tree, small), ("boxes", "tris")).values())


def test_refit_on_moved_vertices_matches_brute_force():
    _, t, _, t2 = moved_cup()
    o, d, *_ = mesh_rays(n_random=0, size=32)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    brute = tint.intersect_brute(t2, o, d)
    bvh = tbvh.build_bvh(t)
    tree = tb4.build_bvh4(t, max_leaf=4, builder="sah")[1]
    stale = tb4.intersect_bvh4_cuda(t2, tree, o, d)
    assert _mismatch(stale, brute) > 0.01  # the built tree is stale on the moved scene
    for label, hit in (("bvh", tbvh.intersect_bvh(t2, refit_accel(bvh, t2), o, d)),
                       ("bvh4", tb4.intersect_bvh4_cuda(t2, refit_accel(tree, t2), o, d))):
        assert _mismatch(hit, brute) <= 0.002, label
    # Every refit box bounds its triangles.
    r = refit_accel(bvh, t2)
    first, count = r.first.numpy(), r.count.numpy()
    pts = torch.stack([r.tv0, r.tv1, r.tv2], dim=1).numpy()
    lo, hi = r.node_lo.numpy(), r.node_hi.numpy()
    for ni in np.nonzero(count > 0)[0]:
        p = pts[first[ni]:first[ni] + count[ni]].reshape(-1, 3)
        assert (p >= lo[ni]).all() and (p <= hi[ni]).all()


def test_refit_matches_jax_refit_and_its_bvh4_kernel():
    j, _, j2, t2 = moved_cup()
    _, jp4, tree = jax_and_port_trees(j, leaf=14, builder="sah")
    j_refit = jrefit.refit_accel(jp4, j2, jrefit.make_refit_plan(jp4, j2))
    refit = refit_accel(tree, t2)
    table, boxes, nchild = np.asarray(j_refit.nodes4), refit.boxes.numpy(), refit.nchild.numpy()
    for c in range(4):
        valid = c < nchild
        for k in range(3):
            np.testing.assert_array_equal(boxes[valid, 4 * k + c], table[valid, 6 * c + k])
            np.testing.assert_array_equal(boxes[valid, 12 + 4 * k + c], table[valid, 6 * c + 3 + k])
    o, d, ro, rd, tm = mesh_rays()
    got = tb4.intersect_bvh4_cuda(t2, refit, torch.from_numpy(o), torch.from_numpy(d))
    want = jb4.intersect_pallas_bvh4(j2, j_refit, jnp.asarray(o), jnp.asarray(d), interpret=True)
    assert_hits_agree(got, want, "refit closest vs JAX")
    occ = tb4.occluded_bvh4_cuda(t2, refit, torch.from_numpy(ro), torch.from_numpy(rd),
                                 torch.from_numpy(tm)).numpy()
    j_occ = np.asarray(jb4.occluded_pallas_bvh4(j2, j_refit, jnp.asarray(ro), jnp.asarray(rd),
                                                jnp.asarray(tm), interpret=True))
    assert (occ == j_occ).mean() >= 0.995


def test_vertex_gradient_through_a_refit_matches_jax():
    j, t, j2, t2 = moved_cup()
    size = 24
    jcfg = jrt.RenderConfig(width=size, height=size, backend="bvh")
    cfg = trt.RenderConfig(width=size, height=size, backend="bvh")
    jt0 = jbvh.build_bvh(j, use_native=False)
    jplan = jrefit.make_refit_plan(jt0, j)
    bvh0 = tbvh.build_bvh(t)
    plan = make_refit_plan(bvh0)

    def j_img(verts):
        s = dataclasses.replace(j, vertices=verts)
        return jw.render_image(s, jrt.Camera.default(), jcfg,
                               backend=jw.make_backend(s, jcfg, bvh=jrefit.refit_accel(jt0, s, jplan)),
                               key=jax.random.PRNGKey(0))

    verts = torch.from_numpy(np.asarray(j2.vertices)).requires_grad_(True)
    s = dataclasses.replace(t, vertices=verts)
    img = tw.render_image(s, trt.Camera.default(device="cpu"), cfg,
                          backend=tw.make_backend(s, cfg, accel=refit_accel(bvh0, s, plan)))
    want_img, vjp = jax.vjp(j_img, j2.vertices)
    want_img = np.asarray(want_img)
    # Tie pixels (a coincident-t hit resolved to another triangle) carry no weight.
    keep = (np.abs(img.detach().numpy() - want_img).max(axis=-1) <= 1e-4)[..., None]
    assert keep.mean() > 0.99
    ct = 2.0 * want_img * keep  # d sum(image^2) on the kept pixels
    (img * torch.from_numpy(ct)).sum().backward()
    want = np.asarray(vjp(jnp.asarray(ct, jnp.float32))[0])
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(verts.grad.numpy(), want, rtol=2e-4, atol=2e-5)


def test_bundle_of_one_tree_stays_one_tree():
    _, t, _, t2 = moved_cup()
    sph = dataclasses.replace(t, spherical_lights=trt.SphericalLights.of(((-1, 1, -1), 0.1,
                                                                         (1, 1, 1))))
    sph2 = dataclasses.replace(sph, vertices=t2.vertices)
    cfg = trt.RenderConfig(backend="cuda", soft_shadow_kernel="on")
    bundle = tw.build_accel(sph, cfg)
    assert isinstance(bundle, tw.AccelBundle) and bundle.soft is bundle.primary
    plan = make_refit_plan(bundle)
    assert plan[1] is None
    refit = refit_accel(bundle, sph2, plan)
    assert refit.soft is refit.primary
    assert not torch.equal(refit.primary.boxes, bundle.primary.boxes)
    # Knobs that give the sampler a tree of its own: both trees refit.
    two = tw.build_accel(sph, dataclasses.replace(cfg, soft_bvh_max_leaf=14))
    assert two.soft is not two.primary
    refit2 = refit_accel(two, sph2)
    assert refit2.soft is not refit2.primary
    assert torch.equal(refit2.primary.tris, refit.primary.tris)
    assert all(_same_bits(refit_accel(two.soft, sph2), refit2.soft, ("boxes", "tris")).values())
    with pytest.raises(TypeError, match="no refit"):
        refit_accel(object(), t2, plan=())
