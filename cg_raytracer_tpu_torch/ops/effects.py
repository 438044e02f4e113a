"""Post-process effects: anti-aliasing, bloom and motion blur, as in
``cg_raytracer_tpu/ops/effects.py`` (the reference's main.cpp:318-720).

- AA: the mean of four renders at the pixel corner + {0, 0.5} px in x and y
  (main.cpp:663-687); under ``reference_quirks`` the 4-sample sum is divided
  by 5 (main.cpp:685), else by 4.
- Bloom: the pixels with R+G+B > 1 blurred by a 21x21 box (the mean over the
  in-bounds window) and added back (main.cpp:586-628).  By default a clean
  separable box filter; under ``reference_quirks`` the reference's in-place
  raster-order blur (``_bloom_quirk_blur``), and on its AA path the
  reference's threshold and base (``bloom_quirk_aa``).
- Motion blur: 15 more renders with the camera's lookAt moved by +0.01 x
  per step, over 16 (main.cpp:318-584); under ``reference_quirks`` the
  lookAt is absolute and the base render is dropped, still over 16.

Every effect is plain PyTorch around the render function: autograd
differentiates it, and on the card the renders inside run the kernels.  The
quirk blur alone is a kernel of its own on the card (``csrc/bloom.cu``,
forward and adjoint, in ``_QuirkBlur``); a CPU tensor takes its plain twins
(``bloom_quirk_plain``, ``bloom_quirk_adjoint_plain``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..scene.types import Camera
from ..utils import counters
from ..utils.config import RenderConfig
from . import cuda_kernels as ck

BLOOM_RADIUS = 10  # 21x21 window (main.cpp:594-600)
MOTION_BLUR_STEPS = 15
MOTION_BLUR_DELTA = 0.01
# Subsample offsets (x, y) in pixels, in the reference's order (y outer, x inner).
AA_OFFSETS = ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (0.5, 0.5))


def supersample_render(render_offset_fn, cfg: RenderConfig):
    """2x2 supersampling: ``render_offset_fn((ox, oy) in pixels) -> [H, W, 3]``
    at the four offsets, summed in order and divided by 4 (5 under quirks)."""
    acc = None
    for off in AA_OFFSETS:
        img = render_offset_fn(off)
        acc = img if acc is None else acc + img
    return acc / (5.0 if cfg.reference_quirks else 4.0)


def _threshold(img):
    return torch.where(img.sum(dim=-1, keepdim=True) > 1.0, img, torch.zeros_like(img))


def _box_blur(img, radius: int = BLOOM_RADIUS):
    """The separable (2r+1)^2 mean of [H, W, 3] over each pixel's in-bounds
    window: a 1-D pass down the rows, then one along them.  Average pooling
    without the padded cells in the count is the JAX package's zero-padded
    sum over the in-bounds count (``_box_blur_1d``), and unlike a convolution
    it never takes cuDNN's TF32 route on the card."""
    size = 2 * radius + 1
    x = img.permute(2, 0, 1)[None]  # [1, 3, H, W]
    x = F.avg_pool2d(x, (size, 1), stride=1, padding=(radius, 0), count_include_pad=False)
    x = F.avg_pool2d(x, (1, size), stride=1, padding=(0, radius), count_include_pad=False)
    return x[0].permute(1, 2, 0)


def bloom(img, cfg: RenderConfig):
    """Threshold, 21x21 box blur, add back (bloomEffect, main.cpp:586-628);
    under ``reference_quirks`` the reference's in-place blur."""
    if cfg.reference_quirks:
        return img + _bloom_quirk_blur(_threshold(img))
    return img + _box_blur(_threshold(img))


def bloom_quirk_aa(render_offset_fn, cfg: RenderConfig):
    """The reference's bloom on its AA path (main.cpp:663-705): the bright
    buffer holds the last subsample (x+0.5, y+0.5) where the undivided
    4-subsample sum passes the threshold; the in-place blur of it is added to
    the un-antialiased render at the pixel corner, which replaces the AA
    average.  ``render_offset_fn`` as ``supersample_render``'s."""
    return bloom_quirk_aa_finish(bloom_quirk_aa_parts(render_offset_fn))


def bloom_quirk_aa_parts(render_offset_fn):
    """The per-pixel part of ``bloom_quirk_aa``: the un-antialiased render
    and the bright buffer, concatenated on channels ([..., 6]); a row tile of
    it is the frame's rows."""
    imgs = [render_offset_fn(off) for off in AA_OFFSETS]
    total = imgs[0] + imgs[1] + imgs[2] + imgs[3]
    bright = torch.where(total.sum(dim=-1, keepdim=True) > 1.0, imgs[3],
                         torch.zeros_like(imgs[3]))
    return torch.cat([imgs[0], bright], dim=-1)


def bloom_quirk_aa_finish(parts):
    """The in-place blur of the bright buffer added to the base: the
    whole-frame part of ``bloom_quirk_aa``."""
    return parts[..., :3] + _bloom_quirk_blur(parts[..., 3:])


def is_bloom_quirk_aa(cfg: RenderConfig) -> bool:
    """Whether a render takes the reference's AA + bloom path (no post-pass)."""
    return cfg.bloom and cfg.reference_quirks and cfg.anti_aliasing and not cfg.motion_blur


def _wavefronts(h: int, w: int, r: int):
    """Every pixel of an [h, w] image by wavefront ``t = (r + 1) y + x``,
    then by row: flat indices into the zero-padded [(h+2r) * (w+2r)] buffer
    of ``centers`` (the pixels) and ``corners`` (their windows' top-left
    cells), ``counters`` (in-bounds window sizes) and ``bounds`` [T + 1]
    (wavefront t is ``bounds[t]:bounds[t+1]``)."""
    wp = w + 2 * r
    ys, xs = np.divmod(np.arange(h * w), w)
    t = (r + 1) * ys + xs
    order = np.lexsort((ys, t))
    ys, xs, t = ys[order], xs[order], t[order]
    cnt_y = np.minimum(ys + r, h - 1) - np.maximum(ys - r, 0) + 1
    cnt_x = np.minimum(xs + r, w - 1) - np.maximum(xs - r, 0) + 1
    bounds = np.searchsorted(t, np.arange((r + 1) * (h - 1) + w + 1))
    return ((ys + r) * wp + xs + r, ys * wp + xs, (cnt_y * cnt_x).astype(np.float32),
            bounds.tolist())


def _bloom_quirk_blur(bright):
    """The reference's sequential in-place 21x21 window mean
    (main.cpp:586-614) of ``bright`` [H, W, 3], differentiable: the kernel
    and its adjoint on the card, the plain twins on the CPU."""
    return _QuirkBlur.apply(bright)


class _QuirkBlur(torch.autograd.Function):
    """The quirk blur with a hand-written adjoint (``bloom_quirk_adjoint_*``),
    where the JAX package differentiates through its ``lax.scan``."""

    @staticmethod
    def forward(ctx, bright):
        return bloom_quirk_cuda(bright)

    @staticmethod
    def backward(ctx, grad):
        return bloom_quirk_adjoint_cuda(grad)


def _blur_input(name, x):
    """[H, W, 3] float32, contiguous, detached, as a new buffer (the
    kernels work in place)."""
    if x.ndim != 3 or x.shape[2] != 3:
        raise ValueError(f"{name}: expected [H, W, 3], got {tuple(x.shape)}")
    if x.shape[0] * x.shape[1] >= 2 ** 31 // 3:
        raise ValueError(f"{name}: at most 2**31 / 3 pixels")
    return x.detach().to(torch.float32).clone(memory_format=torch.contiguous_format)


def bloom_quirk_cuda(bright):
    """The quirk blur of ``bright`` [H, W, 3] -> [H, W, 3] float32: the
    kernel of ``csrc/bloom.cu`` for a CUDA tensor (no gradient), the plain
    twin for a CPU one."""
    if not bright.is_cuda:
        return bloom_quirk_plain(bright)
    buf = _blur_input("cgrt_bloom_quirk", bright)
    ck._launch("cgrt_bloom_quirk", buf.device, ck._ptr(buf), buf.shape[0], buf.shape[1])
    counters.count("bloom_quirk_cuda")
    return buf


def bloom_quirk_adjoint_cuda(grad):
    """The blur's vector-Jacobian product: the cotangent [H, W, 3] of its
    output -> that of its input; the adjoint kernel for a CUDA tensor, the
    plain twin for a CPU one."""
    if not grad.is_cuda:
        return bloom_quirk_adjoint_plain(grad)
    v = _blur_input("cgrt_bloom_quirk_adjoint", grad)  # overwritten by the first pass
    out = torch.empty_like(v)
    ck._launch("cgrt_bloom_quirk_adjoint", v.device, ck._ptr(v), ck._ptr(out), v.shape[0],
               v.shape[1])
    counters.count("bloom_quirk_adjoint_cuda")
    return out


def _padded(x, r):
    """``x`` [h, w, 3] in a zero border of ``r`` cells, flattened to
    [(h + 2r) (w + 2r), 3], and the tables of ``_wavefronts`` on its device."""
    h, w = x.shape[0], x.shape[1]
    wp = w + 2 * r
    dev = x.device
    centers, corners, counters, bounds = _wavefronts(h, w, r)
    centers, corners = torch.from_numpy(centers).to(dev), torch.from_numpy(corners).to(dev)
    counters = torch.from_numpy(counters).to(dev)[:, None]
    span = torch.arange(2 * r + 1, device=dev)
    window = (span[:, None] * wp + span[None, :]).reshape(-1)  # [441] cell offsets
    buf = torch.zeros(((h + 2 * r) * wp, 3), dtype=x.dtype, device=dev)
    buf.view(h + 2 * r, wp, 3)[r:r + h, r:r + w] = x
    return buf, centers, corners, counters, bounds, window


def bloom_quirk_plain(bright):
    """The quirk blur in wavefronts, in PyTorch (differentiable by
    autograd).

    The reference visits pixels in raster order and overwrites each with the
    mean of the current buffer over its in-bounds window, so pixel (y, x)
    reads the blurred values of the window cells visited before it (rows
    y-10..y-1, and row y left of x) and the raw values of the rest.  On the
    wavefront ``t = 11 y + x`` every cell of (y, x)'s window visited before
    it has a smaller t (``11 (y - dy) + x + dx <= t - 1`` for dy >= 1,
    |dx| <= 10; ``t - dx`` to its left), every cell after it a larger one,
    and two pixels of one wavefront are 11 or more columns apart, outside
    each other's window.  So blurring wavefront after wavefront, every pixel
    of one wavefront at once, reads what the raster scan reads: 11 (H-1) + W
    steps (9,589 at 800^2) of about W/11 windows each, where the JAX package
    scans H*W pixels one at a time.  Window sums are taken in another order
    than XLA's (float tolerance)."""
    h, w, r = bright.shape[0], bright.shape[1], BLOOM_RADIUS
    buf, centers, corners, counters, bounds, window = _padded(bright, r)
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        mean = buf[corners[b0:b1, None] + window].sum(dim=1) / counters[b0:b1]
        buf.index_copy_(0, centers[b0:b1], mean)
    return buf.view(h + 2 * r, w + 2 * r, 3)[r:r + h, r:r + w]


@torch.no_grad()
def bloom_quirk_adjoint_plain(grad):
    """The blur's adjoint in PyTorch: the wavefronts in reverse; on each,
    the centres' cotangents divided by their counts (v), the centres set to
    0, then v added to every cell of each centre's window (``index_add_``,
    centre after centre, in row order).  Two centres of one wavefront lie
    outside each other's windows, so a centre's own update reads no other
    centre's."""
    h, w, r = grad.shape[0], grad.shape[1], BLOOM_RADIUS
    buf, centers, corners, counters, bounds, window = _padded(grad.detach(), r)
    cells = window.numel()
    for b0, b1 in reversed(list(zip(bounds[:-1], bounds[1:]))):
        v = buf[centers[b0:b1]] / counters[b0:b1]
        buf.index_fill_(0, centers[b0:b1], 0.0)
        buf.index_add_(0, (corners[b0:b1, None] + window).reshape(-1),
                       v[:, None, :].expand(-1, cells, -1).reshape(-1, 3))
    return buf.view(h + 2 * r, w + 2 * r, 3)[r:r + h, r:r + w].contiguous()


_COUNTS = counters.Group("bloom_quirk_cuda", "bloom_quirk_adjoint_cuda")
launch_counts, reset_launch_counts = _COUNTS.launch_counts, _COUNTS.reset


def motion_blur(base_render_fn, camera: Camera, cfg: RenderConfig):
    """Average over lookAt-jittered cameras (blurEffect, main.cpp:318-584).
    ``base_render_fn(camera) -> [H, W, 3]``; the 15 jittered renders are
    summed in place as they come, one held at a time."""
    deltas = torch.arange(1, MOTION_BLUR_STEPS + 1, dtype=torch.float32,
                          device=camera.device) * MOTION_BLUR_DELTA
    offsets = torch.stack([deltas, torch.zeros_like(deltas), torch.zeros_like(deltas)], dim=-1)
    # Under quirks the lookAt is the ABSOLUTE point (0.01 i, 0, 0) whatever
    # the camera (main.cpp:344-568); else relative to the camera's target.
    look_ats = offsets if cfg.reference_quirks else camera.look_at[None, :] + offsets
    acc = None
    for look_at in look_ats:
        img = base_render_fn(dataclasses.replace(camera, look_at=look_at))
        if acc is None:
            acc = torch.zeros_like(img)
        acc.add_(img)
    if cfg.reference_quirks:
        # The reference omits the base render but divides by 16 (main.cpp:581).
        return acc / 16.0
    return (base_render_fn(camera) + acc) / float(MOTION_BLUR_STEPS + 1)
