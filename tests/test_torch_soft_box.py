"""PyTorch port, the soft-shadow slice on the spherical box (32 triangles):
the brute sampler's table twin (B9, ``ops/soft.py``) against JAX's
``soft_shadow_counts_pallas`` table kernel in interpret mode, and the slice
as a whole on the box (``test_torch_soft.check_slice``: one phase, two phase,
gradients).

Samples: 4.  JAX's brute table kernel unrolls every sample x triangle
Moller-Trumbore tile, and its interpret mode takes about 2.5 s of compile
per sample on this box; both tests share one compile (the same padded
shapes: one 1024-point tile).  Tolerances as ``test_torch_soft.py``.
"""
import jax.numpy as jnp
import numpy as np
import torch

from cg_raytracer_tpu.ops.pallas_kernels import soft_shadow_counts_pallas
from cg_raytracer_tpu_torch.ops import soft
from tests.test_torch_soft import (SIZE, assert_counts_agree, check_slice, gaussians, hit_points,
                                   spherical_pair)

S_BOX = 4


def test_brute_table_twin_matches_jax_kernel():
    j, t = spherical_pair("box")
    pos, valid = hit_points(j, SIZE)
    g = gaussians((S_BOX, pos.shape[0], 3))
    lpos, lrad = j.spherical_lights.position[0], j.spherical_lights.radius[0]
    want = soft_shadow_counts_pallas(j, jnp.asarray(pos), lpos, lrad, None, S_BOX,
                                     interpret=True, gauss=jnp.asarray(g))
    got = soft.soft_table_cuda(t, torch.from_numpy(pos), t.spherical_lights.position[0],
                               t.spherical_lights.radius[0], torch.from_numpy(g),
                               valid=torch.from_numpy(valid))
    assert got.dtype == torch.float32 and not got[~torch.from_numpy(valid)].any()
    assert_counts_agree(got, want, valid, "brute table")
    frac = np.asarray(want)[valid] / S_BOX
    assert ((frac > 0) & (frac < 1)).any() and (frac == 1).any() and valid.mean() > 0.2


def test_slice_renders_and_grads_match_jax_on_the_box():
    check_slice("box", S_BOX)
