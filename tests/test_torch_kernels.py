"""PyTorch port: the four CUDA kernels' plain twins against the JAX package's
Pallas kernels, which run in interpret mode on the CPU.  (Each kernel against
its twin on the card: ``test_torch_cuda.py``.)

Interpret mode compiles the Pallas kernels' statically unrolled sweeps, which
takes seconds per kernel, so these scenes keep to 12 triangles and the rays
to 32x32 camera rays plus 2048 random ones.

Tolerances: prim ids and shadow bits equal on >= 99.5% of rays (tie-breaks
on coincident edges); where ids match, t/u/v within atol 1e-5, rtol 1e-5;
colors as ``assert_images_close`` (<= 0.5% of rays off by more than 1e-4).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cg_raytracer_tpu.ops import pallas_kernels as pk
from cg_raytracer_tpu_torch.ops import cuda_kernels as ck
from tests.conftest import assert_images_close
from tests.test_torch_intersect import assert_hits_close, rays
from tests.test_torch_scene import scene_pair


def _t(x):
    return torch.from_numpy(np.array(x))


def test_intersect_plain_matches_pallas():
    j, t = scene_pair("mixed")
    o, d = rays(10)
    assert_hits_close(ck.intersect_plain(t, _t(o), _t(d)), pk.intersect_pallas(j, o, d))
    tm = np.random.default_rng(11).uniform(0.2, 3.0, o.shape[0]).astype(np.float32)
    assert_hits_close(ck.intersect_plain(t, _t(o), _t(d), t_max=_t(tm)),
                      pk.intersect_pallas(j, o, d, t_max=jnp.asarray(tm)))


def test_occluded_plain_matches_pallas():
    j, t = scene_pair("mixed")
    o, d = rays(12)
    tm = np.random.default_rng(13).uniform(0.0, 2.0, o.shape[0]).astype(np.float32)
    jb = np.asarray(pk.occluded_pallas(j, o, d, jnp.asarray(tm)))
    tb = ck.occluded_plain(t, _t(o), _t(d), _t(tm)).numpy()
    assert (tb == jb).mean() >= 0.995 and 0.02 < tb.mean() < 0.98


def test_bounce_plain_matches_pallas():
    j, t = scene_pair("mixed_tris")  # 12 triangles, two point lights
    o, d = rays(14)
    live = np.random.default_rng(15).uniform(size=o.shape[0]) < 0.8
    for lv in (None, live):
        jh, jbits = pk.bounce_pallas(j, o, d, live=None if lv is None else jnp.asarray(lv))
        th, tbits = ck.bounce_plain(t, _t(o), _t(d), live=None if lv is None else _t(lv))
        assert_hits_close(th, jh)
        assert tbits.dtype == torch.int32
        assert (tbits.numpy() == np.asarray(jbits)).mean() >= 0.995
        assert {1, 2} <= set(np.unique(tbits.numpy()).tolist())  # both lights occlude somewhere
    assert (th.prim_id.numpy()[~live] == -1).all()


@pytest.mark.parametrize("depth,quirks", [(2, False), (2, True)])
def test_trace_plain_matches_pallas(depth, quirks):
    j, t = scene_pair("mixed")  # 12 triangles + 2 spheres, one glossy
    o, d = rays(16, n=1024)
    jc = np.asarray(pk.trace_pallas(j, o, d, depth, quirk_ks_z=quirks))
    tc = ck.trace_plain(t, _t(o), _t(d), depth, quirk_ks_z=quirks)
    assert tc.shape == (o.shape[0], 3) and tc.dtype == torch.float32
    assert_images_close(tc.numpy(), jc, msg=f"trace depth={depth} quirks={quirks}")
    assert (tc.numpy().max(axis=1) > 0.01).mean() > 0.05


def test_tables_and_predicates_match_jax():
    for name in ("mirror_box", "mixed", "mixed_tris", "spheres"):
        j, t = scene_pair(name)
        assert ck.supports_trace_kernel(t) == pk.supports_trace_kernel(j), name
        assert ck.supports_fused_bounce(t) == pk.supports_fused_bounce(j), name
        if t.num_triangles:
            np.testing.assert_array_equal(ck._tri_table(t).numpy(), np.asarray(pk._tri_table(j)))
            np.testing.assert_allclose(ck._aux_table(t).numpy(), np.asarray(pk._aux_table(j)),
                                       rtol=1e-6, atol=1e-7)
        if t.spheres.radius.shape[0]:
            np.testing.assert_array_equal(ck._sphere_table(t).numpy(),
                                          np.asarray(pk._sphere_table(j)))
        assert ck._sphere_table(t).shape == (t.spheres.radius.shape[0], 11)


def test_wrappers_take_the_plain_twin_on_cpu_without_counting():
    _, t = scene_pair("mixed_tris")
    o, d = (_t(x) for x in rays(17, n=256))
    tm = torch.full((o.shape[0],), 1.0)
    ck.reset_launch_counts()
    for a, b in zip(ck.intersect_cuda(t, o, d), ck.intersect_plain(t, o, d)):
        assert torch.equal(a, b)
    assert torch.equal(ck.occluded_cuda(t, o, d, tm), ck.occluded_plain(t, o, d, tm))
    (h1, b1), (h2, b2) = ck.bounce_cuda(t, o, d), ck.bounce_plain(t, o, d)
    assert torch.equal(b1, b2) and all(torch.equal(a, b) for a, b in zip(h1, h2))
    assert torch.equal(ck.trace_cuda(t, o, d, 2), ck.trace_plain(t, o, d, 2))
    assert ck.launch_counts() == {"intersect_cuda": 0, "occluded_cuda": 0, "bounce_cuda": 0,
                                  "trace_cuda": 0, "bounce_refl_cuda": 0,
                                  "record_trace_cuda": 0}


def test_kernel_eligibility_is_enforced():
    _, spheres = scene_pair("spheres")
    o, d = (_t(x) for x in rays(18, n=8, camera=False))
    with pytest.raises(ValueError, match="supports_fused_bounce"):
        ck.bounce_cuda(spheres, o, d)
    _, box = scene_pair("mirror_box")
    with pytest.raises(ValueError, match="max_depth"):
        ck.trace_cuda(box, o, d, 0)
    with pytest.raises(ValueError, match=r"\[N, 3\]"):
        ck.intersect_cuda(box, o[:, :2], d[:, :2])


def test_forward_only_guard_raises_on_backward():
    _, t = scene_pair("mixed")
    t.materials.kd.requires_grad_(True)
    o, d = (_t(x) for x in rays(19, n=64))
    color = ck.trace_cuda(t, o, d, 2)
    assert color.requires_grad
    with pytest.raises(NotImplementedError, match="forward_only"):
        color.sum().backward()
    with torch.no_grad():
        assert not ck.trace_cuda(t, o, d, 2).requires_grad
