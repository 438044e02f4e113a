"""PyTorch port: the two-phase records (phase 1 of the gradient structure)
against the JAX package.

``record_trace_plain`` and ``bounce_refl_plain`` (the record kernels' plain
twins) against ``record_trace_pallas`` / ``bounce_refl_pallas``, whose Pallas
kernels run in interpret mode; ``record_surface`` against JAX's on the same
records; and the port's record loop (bounce + ``record_surface``) against its
record-trace path.  Interpret mode costs seconds per call, so the scene is
``mixed_tris`` (12 triangles, two point lights) at 32x32 camera rays.

Tolerances: prim ids, shadow bits and active flags equal on >= 99.5% of rays
(tie-breaks on coincident edges); where ids match, t/u/v within atol/rtol
1e-5; next rays (o, d) within atol/rtol 1e-5 where both packages hold the ray
active (a ray that is not active carries no meaning: the Pallas kernel gives
it the values of its tile's other rays' path, the port the dead record).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cg_raytracer_tpu as jrt
from cg_raytracer_tpu.ops import intersect as jint
from cg_raytracer_tpu.ops import pallas_kernels as pk
from cg_raytracer_tpu_torch.models import whitted as tw
from cg_raytracer_tpu_torch.ops import cuda_kernels as ck
from cg_raytracer_tpu_torch.ops import intersect as tint
from cg_raytracer_tpu_torch.utils.config import RenderConfig
from tests.test_torch_intersect import assert_hits_close
from tests.test_torch_scene import scene_pair

TOL = dict(rtol=1e-5, atol=1e-5)


def camera_rays(size=32):
    o, d = jrt.generate_rays(jrt.Camera.default(), size, size)
    return np.asarray(o), np.asarray(d)


def _t(x):
    return torch.from_numpy(np.array(x))


def assert_records_close(port, ref):
    """Per level: hits, bits and active flags; next rays where both are active."""
    assert len(port) == len(ref)
    for level, ((to, td, th, tb, ta), (jo, jd, jh, jb, ja)) in enumerate(zip(port, ref)):
        assert_hits_close(th, jh)
        assert tb.dtype == torch.int32 and ta.dtype == torch.bool
        assert (tb.numpy() == np.asarray(jb)).mean() >= 0.995, f"bits, level {level}"
        both = ta.numpy() & np.asarray(ja)
        assert (ta.numpy() == np.asarray(ja)).mean() >= 0.995, f"active, level {level}"
        for a, b in ((to, jo), (td, jd)):
            np.testing.assert_allclose(a.numpy()[both], np.asarray(b)[both], **TOL)


@pytest.mark.parametrize("depth,quirks", [(2, False), (2, True), (3, False)])
def test_record_trace_plain_matches_pallas(depth, quirks):
    j, t = scene_pair("mixed_tris")
    o, d = camera_rays()
    ref = pk.record_trace_pallas(j, o, d, depth, interpret=True, quirk_ks_z=quirks)
    port = ck.record_trace_plain(t, _t(o), _t(d), depth, quirk_ks_z=quirks)
    assert_records_close(port, ref)
    # Level 1 is live without the ks.z quirk (the red block's ks.x reflects).
    assert bool(port[1][4].any()) == (not quirks)
    assert (port[0][2].prim_id >= 0).float().mean() > 0.2


def test_bounce_refl_plain_matches_pallas():
    j, t = scene_pair("mixed_tris")
    o, d = camera_rays()
    live = np.random.default_rng(21).uniform(size=o.shape[0]) < 0.8
    jh, jb, jp, jr, jf = pk.bounce_refl_pallas(j, o, d, interpret=True, live=jnp.asarray(live))
    th, tb, tp, tr, tf = ck.bounce_refl_plain(t, _t(o), _t(d), live=_t(live))
    assert_hits_close(th, jh)
    assert (tb.numpy() == np.asarray(jb)).mean() >= 0.995
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    same = live & (th.prim_id.numpy() == np.asarray(jh.prim_id))
    for a, b in ((tp, jp), (tr, jr)):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same], **TOL)
    # The dead record: a miss with zero position and reflection.
    assert (th.prim_id.numpy()[~live] == -1).all() and not tf.numpy()[~live].any()
    assert (tp.numpy()[~live] == 0).all() and (tr.numpy()[~live] == 0).all()
    assert tf.numpy().any()


def test_record_surface_matches_jax():
    for name in ("mixed_tris", "mixed"):
        j, t = scene_pair(name)
        o, d = camera_rays()
        jh = jint.intersect_brute(j, jnp.asarray(o), jnp.asarray(d))
        th = tint.Hit(*(_t(x) for x in jh))
        js = jint.record_surface(j, jnp.asarray(o), jnp.asarray(d), jh)
        ts = tint.record_surface(t, _t(o), _t(d), th)
        np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
        for field in ("position", "normal", "kd", "ks", "shininess"):
            np.testing.assert_allclose(getattr(ts, field).numpy(),
                                       np.asarray(getattr(js, field)), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name} {field}")


@pytest.mark.parametrize("quirks", [False, True])
def test_record_loop_matches_record_trace(quirks):
    # The port's three phase-1 routes agree: the one-launch record trace,
    # the loop over bounce-refl, and the loop over bounce + record_surface.
    _, t = scene_pair("mirror_box")
    o, d = (_t(x) for x in camera_rays(24))
    cfg = RenderConfig(backend="cuda", max_depth=3, reference_quirks=quirks)
    backend = tw.make_backend(t, cfg)
    whole = backend.record_trace(o, d)
    by_refl = tw._two_phase_records(tw._detached(t), o, d, cfg,
                                    backend._replace(record_trace=None))
    by_surface = tw._two_phase_records(tw._detached(t), o, d, cfg,
                                       backend._replace(record_trace=None, bounce_refl=None))
    for loop in (by_refl, by_surface):
        assert len(loop) == len(whole) == 3
        for (ao, ad, ah, ab, aa), (bo, bd, bh, bb, ba) in zip(loop, whole):
            assert torch.equal(ah.prim_id, bh.prim_id) and torch.equal(ab, bb)
            assert torch.equal(aa, ba)
            for x, y in ((ah.t, bh.t), (ah.u, bh.u), (ah.v, bh.v)):
                torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(ao[aa], bo[aa], rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(ad[aa], bd[aa], rtol=1e-6, atol=1e-6)
    assert whole[1][4].any()


def test_record_wrappers_take_the_plain_twin_on_cpu():
    _, t = scene_pair("mixed_tris")
    o, d = (_t(x) for x in camera_rays(16))
    ck.reset_launch_counts()
    for a, b in zip(ck.record_trace_cuda(t, o, d, 2), ck.record_trace_plain(t, o, d, 2)):
        for x, y in zip(a, b):
            assert all(torch.equal(p, q) for p, q in zip(x, y)) if isinstance(x, tuple) \
                else torch.equal(x, y)
    for x, y in zip(ck.bounce_refl_cuda(t, o, d), ck.bounce_refl_plain(t, o, d)):
        assert all(torch.equal(p, q) for p, q in zip(x, y)) if isinstance(x, tuple) \
            else torch.equal(x, y)
    assert ck.launch_counts()["record_trace_cuda"] == ck.launch_counts()["bounce_refl_cuda"] == 0
    _, spheres = scene_pair("mixed")
    with pytest.raises(ValueError, match="supports_fused_bounce"):
        ck.record_trace_cuda(spheres, o, d, 2)
    with pytest.raises(ValueError, match="max_depth"):
        ck.record_trace_plain(t, o, d, 0)
