"""The soft-shadow sample stream, worked out again from the seed.

A frame draws one key, two 32-bit words, from a ``torch.Generator``
(``torch.randint(0, 2**32, (2,))``); it is folded on the host per bounce
level and then per light: ``fold_in(key, data)`` is the first two words of
Philox4x32-10 at counter (data, 0, 0, 0).  Sample s of the point whose
pixel has raster index g is Philox4x32-10 at counter (g, s, 0, 0) under the
light's key; its four words give three Gaussians by Box-Muller on 24-bit
uniforms (the fourth Gaussian is dropped).  A frozen copy of the
derivation in ``cg_raytracer_tpu_torch/ops/soft.py`` (commit 3c561914e6c9),
the published Philox4x32-10 of Salmon et al. (SC'11).
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
ROUNDS = 10
TWO_PI = 6.283185307179586


def draw_key(generator: torch.Generator) -> tuple:
    words = torch.randint(0, 1 << 32, (2,), dtype=torch.int64, generator=generator,
                          device=generator.device)
    k0, k1 = words.tolist()
    return int(k0), int(k1)


def philox_int(counter, key) -> tuple:
    c0, c1, c2, c3 = (int(x) & MASK for x in counter)
    k0, k1 = (int(x) & MASK for x in key)
    for _ in range(ROUNDS):
        p0, p1 = M0 * c0, M1 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & MASK, (p0 >> 32) ^ c3 ^ k1, p0 & MASK)
        k0, k1 = (k0 + W0) & MASK, (k1 + W1) & MASK
    return c0, c1, c2, c3


def fold_in(key: tuple, data: int) -> tuple:
    w = philox_int((data, 0, 0, 0), key)
    return w[0], w[1]


def _mulhilo(a, m: int):
    lo16, hi16 = a * (m & 0xFFFF), a * (m >> 16)
    s = lo16 + ((hi16 & 0xFFFF) << 16)
    return (hi16 >> 16) + (s >> 32), s & MASK


def philox_tensor(c0, c1, key: tuple):
    """Philox4x32-10 at counters (c0, c1, 0, 0) (int64 tensors of 32-bit
    words, broadcast together) -> four int64 tensors of words."""
    k0, k1 = key
    c2 = torch.zeros((), dtype=torch.int64, device=c0.device)
    c3 = c2
    for _ in range(ROUNDS):
        hi0, lo0 = _mulhilo(c0, M0)
        hi1, lo1 = _mulhilo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + W0) & MASK, (k1 + W1) & MASK
    return c0, c1, c2, c3


def _u01(bits, dtype):
    return (bits & 0xFFFFFF).to(dtype) * (1.0 / 16777216.0) + (0.5 / 16777216.0)


def gaussians(g, samples, key: tuple, dtype=torch.float32):
    """Gaussians [len(g), len(samples), 3] for points of raster indices
    ``g`` (int64 [P]) and sample indices ``samples`` (int64 [S])."""
    c0 = (g.to(torch.int64) & MASK)[:, None]
    c1 = samples.to(torch.int64).to(g.device)[None, :]
    b0, b1, b2, b3 = philox_tensor(c0, c1, key)
    u1, u2, u3, u4 = (_u01(b, dtype) for b in (b0, b1, b2, b3))
    r1 = torch.sqrt(-2.0 * torch.log(u1))
    r2 = torch.sqrt(-2.0 * torch.log(u3))
    return torch.stack([r1 * torch.cos(TWO_PI * u2), r1 * torch.sin(TWO_PI * u2),
                        r2 * torch.cos(TWO_PI * u4)], dim=-1)
