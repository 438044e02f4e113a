"""The reference's bloom blur (main.cpp:586-614), in plain PyTorch.

Upstream visits the pixels in raster order and overwrites each with the
mean of the buffer, as it stands then, over the pixel's in-bounds 21 x 21
window.  A pixel therefore reads the blurred values of the cells visited
before it and the raw values of the rest.  Every pixel (y, x) of the
anti-diagonal ``11 y + x = t`` reads only cells of smaller or larger
diagonals (those of its own diagonal lie 11 or more columns away), so the
diagonals blurred one after another, all pixels of one at once, give the
raster scan's result: 11 (H - 1) + W steps.
"""
from __future__ import annotations

import numpy as np
import torch

RADIUS = 10


def _diagonals(h: int, w: int, r: int):
    span = r + 1
    y, x = np.divmod(np.arange(h * w), w)
    t = span * y + x
    order = np.lexsort((y, t))
    y, x, t = y[order], x[order], t[order]
    count = ((np.minimum(y + r, h - 1) - np.maximum(y - r, 0) + 1)
             * (np.minimum(x + r, w - 1) - np.maximum(x - r, 0) + 1)).astype(np.float32)
    cuts = np.searchsorted(t, np.arange(span * (h - 1) + w + 1)).tolist()
    return y, x, count, cuts


@torch.no_grad()
def quirk_blur(img):
    """The in-place raster-order window mean of ``img`` [H, W, 3]."""
    h, w, r = img.shape[0], img.shape[1], RADIUS
    wp = w + 2 * r
    dev = img.device
    y, x, count, cuts = _diagonals(h, w, r)
    centre = torch.from_numpy((y + r) * wp + x + r).to(dev)
    corner = torch.from_numpy(y * wp + x).to(dev)
    count = torch.from_numpy(count).to(dev).to(img.dtype)[:, None]
    cells = torch.arange(2 * r + 1, device=dev)
    window = (cells[:, None] * wp + cells[None, :]).reshape(-1)
    buf = torch.zeros(((h + 2 * r) * wp, 3), dtype=img.dtype, device=dev)
    buf.view(h + 2 * r, wp, 3)[r:r + h, r:r + w] = img
    for a, b in zip(cuts[:-1], cuts[1:]):
        buf[centre[a:b]] = buf[corner[a:b, None] + window].sum(dim=1) / count[a:b]
    return buf.view(h + 2 * r, wp, 3)[r:r + h, r:r + w].clone()
