"""Checks of the shade kernels against their plain twin on the card, shared by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``: a scene at the kernel's
caps, the twin's gradients, and the tolerance rule for the backward."""
from __future__ import annotations

import numpy as np
import torch

from ..ops import shade
from ..scene.types import PointLights, Scene, Spheres, make_scene

RAY_GRAD = dict(rtol=1e-4, atol=1e-6)  # d_o, d_d: one value per ray
TABLE_GRAD = dict(rtol=2e-4, atol=1e-5)  # d_tri, d_aux, d_lights, d_spheres: sums over rays
GRAD_NAMES = ("d_tri", "d_aux", "d_lights", "d_spheres", "d_o", "d_d")
MAX_WIDENED = 1e-3  # share of a ray gradient's elements that may need the float32 widening


def cap_scene(device) -> Scene:
    """The shade kernel's caps: 256 triangles, 8 spheres and 16 point lights
    (its backward then needs 2 x 29.4 KB of shared memory, past the 48 KB
    default), from a fixed seed."""
    rng = np.random.default_rng(256)
    centers = rng.uniform(-1.0, 1.0, (256, 1, 3))
    v = (centers + rng.uniform(-0.15, 0.15, (256, 3, 3))).reshape(-1, 3).astype(np.float32)
    nrm = rng.normal(size=v.shape).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    meshes = [{"vertices": v[96 * k:96 * (k + 1)], "normals": nrm[96 * k:96 * (k + 1)],
               "triangles": np.arange(96).reshape(32, 3),
               "material": {"kd": tuple(rng.uniform(0.1, 0.9, 3)),
                            "ks": tuple(rng.uniform(0.0, 0.5, 3)),
                            "shininess": float(rng.uniform(1.0, 50.0))}} for k in range(8)]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    spheres = Spheres(center=f32(rng.uniform(-1, 1, (8, 3))), radius=f32(rng.uniform(0.05, 0.2, 8)),
                      kd=f32(rng.uniform(0.1, 0.9, (8, 3))), ks=f32(rng.uniform(0, 0.5, (8, 3))),
                      shininess=f32(rng.uniform(1, 50, 8)))
    lights = PointLights.of(*((tuple(rng.uniform(-2, 2, 3)), tuple(rng.uniform(0.1, 0.3, 3)))
                              for _ in range(16)))
    return make_scene(meshes, spheres=spheres, point_lights=lights, device=device)


def twin_grads(tables, o, d, prim, bits, num_tris, cotangents):
    """Autograd of ``shade_plain`` for ``cotangents`` on its four outputs, in
    float32 and in float64: two lists in ``GRAD_NAMES`` order."""
    out = []
    for dtype in (torch.float32, torch.float64):
        leaves = [x.detach().to(dtype).requires_grad_(True) for x in (*tables, o, d)]
        outs = shade.shade_plain(*leaves, prim, bits, num_tris=num_tris)
        grads = torch.autograd.grad(outs, leaves, [c.to(dtype) for c in cotangents],
                                    allow_unused=True)
        out.append([torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)])
    return out


def shade_grads_close(got, twin, exact, n_rays: int) -> dict:
    """Hold the shade backward kernel's six cotangents ``got`` (``GRAD_NAMES``
    order, for a cotangent of unit variance per output element) to autograd
    of the twin in float32 (``twin``) and float64 (``exact``).  Raises on a
    mismatch or a non-finite value.

    - Table gradients are sums over the ``n_rays`` rays.  They are compared
      divided by sqrt(n_rays), the size of a cotangent of unit norm per image,
      which is the size ``TABLE_GRAD``'s atol is meant for.  Undivided, a
      table element whose terms cancel is resolved by float32 only to about
      eps * sum |terms| (~1e-5 here), above that atol for any float32
      evaluation, the twin's too.
    - Ray gradients are compared as they are, with ``RAY_GRAD``.  On rays that
      float32 does not resolve to that tolerance (sphere hits through the
      float32 quadratic, grazing hits; 0.01-1.5% of the rays checked) the twin
      itself misses its float64 value, and two float32 evaluations in another
      order differ by about as much.  So each element's tolerance widens by
      twice the twin's error on its ray, max over the ray's three components
      of |twin - exact|, which is ~0 where float32 resolves the ray, and at
      most ``MAX_WIDENED`` of the elements may need the widening.

    Returns {name: (max of |got - twin| over its widened tolerance, share of
    elements past the tolerance before the widening)}.
    """
    report = {}
    for name, k, t, x in zip(GRAD_NAMES, got, twin, exact):
        assert bool(torch.isfinite(k).all()), f"{name}: non-finite gradient"
        if not k.numel():
            report[name] = (0.0, 0.0)
            continue
        x = x.float()
        if name in ("d_o", "d_d"):
            tol = RAY_GRAD["atol"] + RAY_GRAD["rtol"] * t.abs()
            widened = tol + 2.0 * (t - x).abs().amax(dim=1, keepdim=True)
        else:
            k, t = k / n_rays ** 0.5, t / n_rays ** 0.5
            tol = widened = TABLE_GRAD["atol"] + TABLE_GRAD["rtol"] * t.abs()
        err = (k - t).abs()
        past = (err > tol).float().mean().item()
        bad = int((err > widened).sum())
        assert not bad, f"{name}: {bad} of {k.numel()} elements differ from the twin"
        assert past <= MAX_WIDENED, f"{name}: {past:.4%} of elements need the float32 widening"
        report[name] = ((err / widened).max().item(), past)
    return report
