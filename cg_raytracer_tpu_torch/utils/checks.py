"""Checks of the shade kernels against their plain twin on the card, shared by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``: a scene at the kernel's
caps, the twin's gradients, and the tolerance rule for the backward."""
from __future__ import annotations

import numpy as np
import torch

from ..ops import shade
from ..scene.types import PointLights, Scene, Spheres, make_scene

RAY_GRAD = dict(rtol=1e-4, atol=1e-6)  # d_o, d_d: one value per ray
# d_tri, d_aux, d_lights, d_spheres, d_sph: sums over rays
TABLE_GRAD = dict(rtol=2e-4, atol=1e-5)
GRAD_NAMES = ("d_tri", "d_aux", "d_lights", "d_spheres", "d_o", "d_d", "d_sph")
PRE_GRAD_NAMES = ("d_payload", "d_mats", "d_lights", "d_spheres", "d_o", "d_d", "d_sph")
MAX_WIDENED = 1e-3  # share of a ray gradient's elements that may need the float32 widening
MAX_OUTLIERS = 1e-5  # pregathered kernel: share of elements past even the widened tolerance
OUTLIER_RTOL = 1e-3  # ... whose error against float64 stays under this share of their row's scale


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


def twin_grads(tables, o, d, prim, bits, num_tris, cotangents, plain=shade.shade_plain,
               sph=None, fracs=None):
    """Autograd of the twin ``plain`` (``shade_plain``, or ``shade_plain_pre``
    on the pregathered tables) for ``cotangents`` on its four outputs, in
    float32 and in float64: two lists, the tables', the rays' and the
    spherical lights' gradients (``sph`` [Ls, 6] with ``fracs`` [Ls, N]; an
    empty [0, 6] gradient without them), in the order of ``GRAD_NAMES``."""
    if sph is None:
        sph = torch.zeros((0, 6), dtype=torch.float32, device=o.device)
        fracs = torch.zeros((0, o.shape[0]), dtype=torch.float32, device=o.device)
    out = []
    for dtype in (torch.float32, torch.float64):
        leaves = [x.detach().to(dtype).requires_grad_(True) for x in (*tables, o, d, sph)]
        outs = plain(*leaves[:-1], prim, bits, num_tris=num_tris, sph=leaves[-1],
                     fracs=fracs.to(dtype))
        grads = torch.autograd.grad(outs, leaves, [c.to(dtype) for c in cotangents],
                                    allow_unused=True)
        out.append([torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)])
    return out


def shade_grads_close(got, twin, exact, n_rays: int, names=GRAD_NAMES) -> dict:
    """Hold a shade backward kernel's six cotangents ``got`` (``names``:
    ``GRAD_NAMES``, or ``PRE_GRAD_NAMES`` for the pregathered kernel; for a
    cotangent of unit variance per output element) to autograd
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
    - The pregathered kernel (``PRE_GRAD_NAMES``) shades meshes of small
      triangles, whose Moller-Trumbore terms (1/det) are large and cancel:
      float32 then resolves a ray's gradient to about eps times its largest
      component, both in the kernel and in the twin (on the teacup at 1024^2
      the two miss the float64 value by the same median, 7.6e-6, and the
      kernel's error exceeds twice the twin's on 9-13% of the rays, the twin's
      being small by chance).  So there a ray's three components, and a
      ``d_payload`` row (a sum over the few rays that hit the triangle), are
      held at the scale of their largest element: the rtol term uses the
      row's max |twin|, and the widening the row's max |twin - exact|.
      Where the largest element is itself the sum of larger cancelling terms,
      the twin can still be accurate by chance where the kernel is not: so
      at most ``MAX_OUTLIERS`` of the elements may pass the widened
      tolerance, each within ``OUTLIER_RTOL`` of its row's scale from the
      float64 value (a wrong derivative is off by O(1) of it), and the
      kernel's median and 99.9th-percentile errors against float64 must be
      within twice the twin's: the two are equally accurate overall.

    Returns {name: (max of |got - twin| over its widened tolerance, share of
    elements past the tolerance before the widening)}.
    """
    report = {}
    for name, k, t, x in zip(names, got, twin, exact):
        assert bool(torch.isfinite(k).all()), f"{name}: non-finite gradient"
        if not k.numel():
            report[name] = (0.0, 0.0)
            continue
        x = x.float()
        by_row = tuple(names) == PRE_GRAD_NAMES and name in ("d_o", "d_d", "d_payload")
        scale = t.abs().amax(dim=1, keepdim=True) if by_row else t.abs()
        if name in ("d_o", "d_d"):
            tol = RAY_GRAD["atol"] + RAY_GRAD["rtol"] * scale
            widened = tol + 2.0 * (t - x).abs().amax(dim=1, keepdim=True)
        else:
            k, t, x = (y / n_rays ** 0.5 for y in (k, t, x))
            tol = widened = TABLE_GRAD["atol"] + TABLE_GRAD["rtol"] * scale / n_rays ** 0.5
            if by_row:
                widened = tol + 2.0 * (t - x).abs().amax(dim=1, keepdim=True)
        tol, widened = tol.expand_as(t), widened.expand_as(t)
        err = (k - t).abs()
        past = (err > tol).float().mean().item()
        over = err > widened
        bad = int(over.sum())
        if by_row:
            k_err, t_err = (k - x).abs(), (t - x).abs()
            q = torch.tensor([0.5, 0.999], dtype=torch.float64, device=k.device)
            k_q, t_q = (torch.quantile(e.flatten()[:1 << 24].double(), q)
                        for e in (k_err, t_err))
            assert bool((k_q <= 2.0 * t_q + 1e-12).all()), (
                f"{name}: kernel errors against float64 (median, 99.9%) {k_q.tolist()} past "
                f"twice the twin's {t_q.tolist()}")
            near = k_err[over] <= OUTLIER_RTOL * scale.expand_as(t)[over] + tol[over]
            if bad <= MAX_OUTLIERS * k.numel() and bool(near.all()):
                bad = 0
        if bad:
            i = int(torch.argmax(err / widened))
            raise AssertionError(
                f"{name}: {bad} of {k.numel()} elements differ from the twin; the worst, flat "
                f"index {i}: kernel {k.flatten()[i].item():.9g}, float32 twin "
                f"{t.flatten()[i].item():.9g}, float64 twin {x.flatten()[i].item():.9g}, "
                f"tolerance {widened.flatten()[i].item():.3g}")
        assert past <= MAX_WIDENED, f"{name}: {past:.4%} of elements need the float32 widening"
        report[name] = ((err / widened).max().item(), past)
    return report


def philox_matches_curand(device, n: int = 4096, seed: int = 0) -> float:
    """Share of ``n`` random (counter, key) pairs whose Philox4x32-10 words
    from ``ops/soft.py``'s twin equal the CUDA toolkit's
    ``curand_Philox4x32_10`` (``csrc/philox_check.cu``, a check library the
    port never calls)."""
    import ctypes

    from ..ops import _build, soft

    words = torch.randint(0, 1 << 32, (n, 6), dtype=torch.int64,
                          generator=torch.Generator().manual_seed(seed)).to(device)
    twin = torch.stack(soft.philox(*words[:, :4].unbind(1), words[:, 4], words[:, 5]), dim=1)
    signed = (words - (words >= (1 << 31)).to(torch.int64) * (1 << 32)).to(torch.int32)
    ctr, key = signed[:, :4].contiguous(), signed[:, 4:].contiguous()
    out = torch.empty((n, 4), dtype=torch.int32, device=device)
    lib = _build.load_check()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.cgrt_check_philox(ctypes.c_void_p(ctr.data_ptr()),
                                    ctypes.c_void_p(key.data_ptr()), n,
                                    ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"cgrt_check_philox: CUDA error {err}")
    curand = out.to(torch.int64) & 0xFFFFFFFF
    return (twin == curand).all(dim=1).float().mean().item()


def sincos_mismatches(device) -> int:
    """How many of the 2**24 angles 2 pi u01(b) that ``csrc/soft.cu``'s
    Box-Muller takes give a ``sincosf`` differing in any bit from ``sinf``
    and ``cosf`` on the card (``csrc/philox_check.cu``)."""
    import ctypes

    from ..ops import _build

    bad = torch.zeros((1,), dtype=torch.int32, device=device)
    lib = _build.load_check()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.cgrt_check_sincos(ctypes.c_void_p(bad.data_ptr()), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"cgrt_check_sincos: CUDA error {err}")
    return int(bad.item())
