"""Spherical-light soft shadows on the card: the sample stream and the
samplers, each in a PRNG and a table variant, with their plain twins.
Counterpart of the in-kernel samplers of
``cg_raytracer_tpu/ops/pallas_kernels.py`` (brute force, <= 256 triangles),
``cg_raytracer_tpu/ops/pallas_bvh.py`` (the per-sample and cone samplers
over the binary tree) and ``cg_raytracer_tpu/ops/pallas_bvh4.py`` (the cone
sampler over the 4- or 8-wide tree).

====================  =============================================  =====================
wrapper               Pallas kernel replaced                         plain twin
====================  =============================================  =====================
``soft_prng_cuda``    ``_soft_shadow_prng_kernel`` (B9)              ``soft_prng_plain``
``soft_table_cuda``   ``_soft_shadow_table_kernel`` (B9)             ``soft_table_plain``
``soft4_prng_cuda``   ``_soft4_cone_prng_kernel`` (B10; W=8 B15),    ``soft4_prng_plain``
                      ``_soft_bvh_cone_prng_kernel`` (B11, W=2),
                      the per-sample PRNG kernel (B12, W=2)
``soft4_table_cuda``  ``_soft4_cone_table_kernel`` (B10; W=8 B15),   ``soft4_table_plain``
                      ``_soft_bvh_cone_table_kernel`` (B11, W=2),
                      the per-sample table kernel (B12, W=2)
====================  =============================================  =====================

One kernel body (``csrc/soft.cu``) serves all of them.  The tree samplers
walk the scene's one ``BVH4``, of any width (``ops/bvh4.py``), on both
routes of ``soft_shadow_tile``: 'cone' at the tree's width, 'sample' at
width 2 (it makes the tree binary, as in the JAX package).  The JAX
package's two tiles (points on lanes with a loop over samples; 128 pixels
x all their samples in one lockstep walk) are one layout on the card, a
thread per (point, sample), so the routes differ only in the tree's
width: a 'sample' launch counts as ``soft4_prng_cuda:w2``.  An any-hit
count does not depend on the tree: given one key or table, every width
counts the same.  Each returns, per
shading point, how many of ``num_samples`` shadow rays toward random points
on one spherical light reach it (main.cpp:166-218), as float32 counts [N].
The PRNG variants draw the samples in the kernel; the table variants take
them as Gaussians [S, N, 3] (the JAX package's layout), for tests and
parity.  ``valid`` ([N] bool) marks the points to sample: the rest do no work
and count 0 (the JAX kernels sampled a miss at position 0 and the shading
discarded it).

From ``csrc/soft.cu``'s ``kCullMinSamples`` samples on, the brute sampler
tests each sample ray only against the triangles that may lie between its
point and the light (per-point culling, exact: the counts are those of a
sweep of every triangle); its launches add the tests they kept and the
tests full sweeps would make to a tally on the card (``cull_counts``,
``reset_cull_counts``).

On the card the tree samplers read the tree's records (``BVH4.nodes``,
``BVH4.rows``, built once per tree by ``ops/bvh4.py``) through the any-hit
walk that ``bvh4.cu`` runs too, after a point pass: each marked point walks
the tree once against the hull of its sample rays and lists the triangles
that may block one of them; a point with at most ``list_max()`` has its
samples test that list alone, the rest walk, led by the path of a probe
toward the light's centre (exact: the counts are the walk's; the plain
model of both passes is ``list_counts_plain``).  Their launches add their
live samples, the nodes the point pass and the walks expanded and the
triangles the sample rays tested to a tally on the card
(``tree_sampler_counts``, ``reset_tree_sampler_counts``), and the point
pass's own counts to another (``tree_list_counts``,
``reset_tree_list_counts``).  Every kernel launch gets the marked points
compacted on the card (``_compact``), so a frame's misses cost it no
threads.

The sample stream (``SampleKey``): a render draws one key, two 32-bit
words, from its ``torch.Generator`` on the host, and folds it per bounce
level and per light on the host (``SampleKey.fold_in``: the first two words
of Philox4x32-10 at counter (data, 0, 0, 0) under the key).  The kernels
read a key's words on the card (``device_key``): each launch copies them
from the host, except under a ``KeyTable``, whose buffer a CUDA graph
(``utils/graphs.py``) reads instead, so that every replay samples its own
keys: each slot of the table records how its key derives from the captured
call's root keys (``SampleKey.path``), and before each replay ``fill``
writes the words of that call's keys into the buffer with one copy.  The
plain twin's Philox (``philox_gauss``) reads the same slots under a table.  Sample s of the
point with global index g (the batch's ``offset`` plus its row) is
Philox4x32-10 at counter (g, s, 0, 0) under the light's key; its four words
become three Gaussians by Box-Muller (``gauss3``, the JAX kernels'
``_gauss3_from_bits``: 24-bit uniforms, one Gaussian discarded).  The stream
depends on neither the launch geometry nor ``ray_chunk``, and the twins
compute the same words in PyTorch (the 32 x 32 -> 64-bit products in int64
halves), so a PRNG kernel is held to its twin on the card.  The scan over
the any-hit oracle (``shading.spherical_fracs``) draws the same samples.

Sample ray (``_soft_sample_ray`` of the JAX package, op for op): the
Gaussian normalised (times a reciprocal), the point on the sphere, the unit
direction toward it, the origin moved SHADOW_EPS along it, and t_max = the
distance from that origin to the sample point.  A ray is blocked by a
triangle at t in [0, t_max).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..scene.types import Scene
from ..utils import counters
from ..utils.profiling import span
from . import bvh4 as b4
from . import cuda_kernels as ck
from .intersect import moller_trumbore_edges

SHADOW_EPS = 1e-3
RAYS_PER_STEP = 1 << 21  # sample rays per step of the plain twins
_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Philox4x32 key bumps (Weyl sequence)
_ROUNDS = 10
_TWO_PI = 6.283185307179586


# --------------------------------------------------------------------------
# Philox4x32-10 and Box-Muller.
# --------------------------------------------------------------------------

def philox_host(counter, key):
    """Philox4x32-10 of four 32-bit words under a two-word key, on Python ints."""
    c0, c1, c2, c3 = (int(x) & _MASK for x in counter)
    k0, k1 = (int(x) & _MASK for x in key)
    for _ in range(_ROUNDS):
        p0, p1 = _M0 * c0, _M1 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & _MASK, (p0 >> 32) ^ c3 ^ k1, p0 & _MASK)
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def _mulhilo(a, m: int):
    """(hi, lo) words of the 64-bit product of ``a`` (int64 tensor of 32-bit
    words) and the constant ``m``, from two 48-bit partial products (a plain
    int64 product would overflow past 2**63)."""
    p_lo, p_hi = a * (m & 0xFFFF), a * (m >> 16)
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & _MASK


def philox(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors of 32-bit words (broadcast together)
    under the key (k0, k1), ints or such tensors -> four int64 tensors of
    32-bit words."""
    for _ in range(_ROUNDS):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def _u01(bits):
    """The low 24 bits as a float32 uniform in (0, 1) (``_u01``)."""
    return (bits & 0xFFFFFF).to(torch.float32) * (1.0 / 16777216.0) + (0.5 / 16777216.0)


def gauss3(b0, b1, b2, b3):
    """Box-Muller: four words -> three standard Gaussians (``_gauss3_from_bits``)."""
    u1, u2, u3, u4 = _u01(b0), _u01(b1), _u01(b2), _u01(b3)
    r1 = torch.sqrt(-2.0 * torch.log(u1))
    r2 = torch.sqrt(-2.0 * torch.log(u3))
    return r1 * torch.cos(_TWO_PI * u2), r1 * torch.sin(_TWO_PI * u2), r2 * torch.cos(_TWO_PI * u4)


class SampleKey(NamedTuple):
    """The soft-shadow samples' key: two 32-bit words, and the global index
    of the batch's first point (``offset``).  ``path``: under a capture, the
    index of the root key it derives from, then each ``fold_in``'s data
    (``KeyTable.root``); None elsewhere."""

    k0: int
    k1: int
    offset: int = 0
    path: Optional[tuple] = None

    def fold_in(self, data: int) -> "SampleKey":
        """A key for ``data`` (a level, a light), derived on the host."""
        w = philox_host((data, 0, 0, 0), (self.k0, self.k1))
        path = None if self.path is None else self.path + (int(data),)
        return SampleKey(w[0], w[1], self.offset, path)

    def at(self, offset: int) -> "SampleKey":
        return self._replace(offset=int(offset))


def draw_key(generator: Optional[torch.Generator] = None) -> SampleKey:
    """Draw a key from ``generator`` (None: a CPU generator seeded 0).  A CPU
    generator draws on the host; a CUDA generator's draw waits for the card
    once."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    words = torch.randint(0, 1 << 32, (2,), dtype=torch.int64, generator=generator,
                          device=generator.device)
    k0, k1 = words.tolist()
    return SampleKey(k0, k1)


def as_key(generator) -> SampleKey:
    """``generator`` as a key: a SampleKey as it is, else drawn from it."""
    return generator if isinstance(generator, SampleKey) else draw_key(generator)


def philox_gauss(key: SampleKey, points, samples):
    """Gaussians [len(points), len(samples), 3] of the stream: ``points``
    are the rows of the batch (int64 [m]; the key's offset is added),
    ``samples`` the sample indices (int64 [k]).  Under a ``KeyTable`` the
    key's words come from its slot (int64 tensors), else from the host."""
    c0 = (points.to(torch.int64) + key.offset)[:, None] & _MASK
    c1 = samples.to(torch.int64).to(c0.device)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=c0.device)
    k0, k1 = key.k0, key.k1
    if _TABLE[0] is not None:
        words = _TABLE[0].slot(key).to(torch.int64) & _MASK
        k0, k1 = words[0], words[1]
    b0, b1, b2, b3 = philox(c0, c1, zero, zero, k0, k1)
    return torch.stack(gauss3(b0, b1, b2, b3), dim=-1)


# --------------------------------------------------------------------------
# Keys on the card.
# --------------------------------------------------------------------------

KEY_SLOTS = 1024  # a KeyTable's slots: distinct (root, fold path) keys of one capture
_TABLE = [None]  # the KeyTable the kernels and philox_gauss read, while one records


def _word(x: int) -> int:
    """A 32-bit word as the int32 of the same bits."""
    x = int(x) & _MASK
    return x - (1 << 32) if x >= 1 << 31 else x


class KeyTable:
    """Sample keys on the card for a CUDA graph: ``words`` [KEY_SLOTS, 2]
    int32, one slot per distinct key the captured call uses, found by the
    key's ``path`` (its root's index and fold data), so a replay's keys are
    the captured call's derivations of the replay's roots.  On a CPU device
    a slot takes its key's words when it is made (the tests' stand-in for a
    capture); on the card ``fill`` writes every slot before a replay."""

    def __init__(self, device, slots: int = KEY_SLOTS):
        self.words = torch.zeros((slots, 2), dtype=torch.int32, device=device)
        self.paths = []
        self._slots = {}

    @staticmethod
    def root(index: int, key: Optional[SampleKey]) -> Optional[SampleKey]:
        """``key`` as root ``index`` of a capture (None stays None)."""
        return None if key is None else key._replace(path=(int(index),))

    def slot(self, key: SampleKey):
        """The key's two words: int32 [2], a view of ``words``."""
        if key.path is None:
            raise RuntimeError("a sample key that no root of the capture derives reached a "
                               "sampler: its words would be baked into the graph")
        s = self._slots.get(key.path)
        if s is None:
            s = self._slots[key.path] = len(self.paths)
            if s >= self.words.shape[0]:
                raise RuntimeError(f"more than {self.words.shape[0]} sample keys in one capture")
            self.paths.append(key.path)
            if not self.words.is_cuda:
                self.words[s] = torch.tensor([_word(key.k0), _word(key.k1)], dtype=torch.int32)
        return self.words[s]

    def fill(self, roots) -> None:
        """Write the words of every slot's key derived from ``roots`` (the
        replay's root keys, in the captured order), with one copy (span
        ``cgrt.graph.key_fill``, where the table has a slot)."""
        if not self.paths:
            return
        memo = {}

        def derive(path):
            if path not in memo:
                memo[path] = (roots[path[0]] if len(path) == 1
                              else derive(path[:-1]).fold_in(path[-1]))
            return memo[path]

        with span("graph.key_fill"):
            host = torch.tensor([[_word(derive(p).k0), _word(derive(p).k1)]
                                 for p in self.paths], dtype=torch.int32)
            if self.words.is_cuda:
                host = host.pin_memory()
            self.words[:len(self.paths)].copy_(host, non_blocking=True)
            del host  # the pinned block's release records an event: part of the fill

    def __enter__(self):
        if _TABLE[0] is not None:
            raise RuntimeError("a KeyTable is already recording")
        _TABLE[0] = self
        return self

    def __exit__(self, *exc):
        _TABLE[0] = None
        return False


def device_key(key: SampleKey, device):
    """The key's words as int32 [2] on ``device``, as the samplers read them:
    the slot of the recording ``KeyTable``, else a copy from the host (from
    pinned memory on the card).  Raises during a CUDA graph capture without
    a table: the copy would be replayed from freed host memory."""
    if _TABLE[0] is not None:
        return _TABLE[0].slot(key)
    device = torch.device(device)
    host = torch.tensor([_word(key.k0), _word(key.k1)], dtype=torch.int32)
    if device.type != "cuda":
        return host.to(device)
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a sample key reached a sampler during a CUDA graph capture "
                           "without a KeyTable (utils/graphs.py records one)")
    return host.pin_memory().to(device, non_blocking=True)


# --------------------------------------------------------------------------
# Sample rays and the plain twins.
# --------------------------------------------------------------------------

def light_row(light_pos, light_radius):
    """[4] float32: the light's center and radius (no gradient)."""
    return torch.cat([light_pos.detach().reshape(3).to(torch.float32),
                      torch.as_tensor(light_radius).detach().reshape(1).to(
                          device=light_pos.device, dtype=torch.float32)]).contiguous()


def sample_rays(p, g, light):
    """Shadow rays from points ``p`` [..., 3] toward the light's sample
    points for Gaussians ``g`` [..., 3] -> (origins, unit dirs, t_max)."""
    gx, gy, gz = g[..., 0], g[..., 1], g[..., 2]
    inv = 1.0 / torch.clamp_min(torch.sqrt(gx * gx + gy * gy + gz * gz), 1e-20)
    sx = light[0] + light[3] * (gx * inv)
    sy = light[1] + light[3] * (gy * inv)
    sz = light[2] + light[3] * (gz * inv)
    tx, ty, tz = sx - p[..., 0], sy - p[..., 1], sz - p[..., 2]
    invd = 1.0 / torch.clamp_min(torch.sqrt(tx * tx + ty * ty + tz * tz), 1e-20)
    dx, dy, dz = tx * invd, ty * invd, tz * invd
    ox = p[..., 0] + SHADOW_EPS * dx
    oy = p[..., 1] + SHADOW_EPS * dy
    oz = p[..., 2] + SHADOW_EPS * dz
    ex, ey, ez = sx - ox, sy - oy, sz - oz
    tm = torch.sqrt(ex * ex + ey * ey + ez * ez)
    return torch.stack([ox, oy, oz], -1), torch.stack([dx, dy, dz], -1), tm


@torch.no_grad()
def _counts_plain(anyhit, pos, light, num_samples, valid, key=None, gauss_nsc=None):
    """Visible-sample counts [N] int32 by stepping the sample rays through
    ``anyhit(o, d, t_max) -> bool``, at most ``RAYS_PER_STEP`` at a time.
    Samples come from ``key`` (the stream) or ``gauss_nsc`` ([N, S, 3])."""
    n = pos.shape[0]
    counts = torch.zeros((n,), dtype=torch.int32, device=pos.device)
    rows = (torch.arange(n, device=pos.device) if valid is None
            else torch.nonzero(valid.to(pos.device)).squeeze(1))
    m = rows.numel()
    if m == 0 or num_samples == 0:
        return counts
    p = pos[rows][:, None, :]
    step = max(1, RAYS_PER_STEP // m)
    visible = torch.zeros((m,), dtype=torch.int32, device=pos.device)
    for s0 in range(0, num_samples, step):
        s1 = min(num_samples, s0 + step)
        if gauss_nsc is None:
            g = philox_gauss(key, rows, torch.arange(s0, s1, device=pos.device))
        else:
            g = gauss_nsc[rows, s0:s1]
        o, d, tm = sample_rays(p, g, light)
        k = s1 - s0
        blocked = anyhit(o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous(),
                         tm.reshape(-1).contiguous())
        visible += (~blocked).reshape(m, k).sum(dim=1, dtype=torch.int32)
    counts[rows] = visible
    return counts


def _brute_anyhit(tri):
    return lambda o, d, tm: ck._anyhit_plain(tri, o, d, tm)


# --------------------------------------------------------------------------
# The tree samplers' point pass (csrc/soft.cu list_body), op for op in
# float32: its lists, and the tallies of a launch over them.
# --------------------------------------------------------------------------

_F = np.float32
_ULP64 = _F(64.0) * _F(5.9604645e-8)  # 64 u


def _hull(p, light):
    """make_hull's fields for points ``p`` [m, 3] (tensors [m] each)."""
    px, py, pz = p[:, 0], p[:, 1], p[:, 2]
    cx, cy, cz, r = (light[k].expand_as(px) for k in range(4))
    lam = _ULP64 * (px.abs() + py.abs() + pz.abs() + cx.abs() + cy.abs() + cz.abs() + r + 1.0)
    eo = _F(SHADOW_EPS) * _F(1.00001) + lam
    big_r = (r + _F(2.0) * _F(SHADOW_EPS)) * _F(1.00001) + lam
    wx, wy, wz = cx - px, cy - py, cz - pz
    h = torch.sqrt(wx * wx + wy * wy + wz * wz)
    b = (eo - big_r) / h
    return dict(px=px, py=py, pz=pz, cx=cx, cy=cy, cz=cz, r=r, lam=lam, eo=eo, big_r=big_r,
                wx=wx / h, wy=wy / h, wz=wz / h, h=h, b=b, a=torch.sqrt(1.0 - b * b))


def _hull_dist(hl, x, y, z):
    """hull_dist."""
    vx, vy, vz = x - hl["px"], y - hl["py"], z - hl["pz"]
    ax = vx * hl["wx"] + vy * hl["wy"] + vz * hl["wz"]
    qx, qy, qz = vx - ax * hl["wx"], vy - ax * hl["wy"], vz - ax * hl["wz"]
    rad = torch.sqrt(qx * qx + qy * qy + qz * qz)
    k = hl["a"] * ax - hl["b"] * rad
    z1 = ax - hl["h"]
    return torch.where(k < 0.0, torch.sqrt(rad * rad + ax * ax) - hl["eo"],
                       torch.where(k > hl["a"] * hl["h"],
                                   torch.sqrt(rad * rad + z1 * z1) - hl["big_r"],
                                   hl["a"] * rad + hl["b"] * ax - hl["eo"]))


def _box_near(hl, reach, lo, hi):
    """box_near for boxes ``lo``, ``hi`` [m, 3] against their points' hulls."""
    g = reach + hl["lam"]
    near = lo[:, 0] <= hi[:, 0]
    for k, (pk, ck_) in enumerate((("px", "cx"), ("py", "cy"), ("pz", "cz"))):
        near &= ~(hi[:, k] < torch.fmin(hl[pk] - hl["eo"], hl[ck_] - hl["big_r"]) - g)
        near &= ~(lo[:, k] > torch.fmax(hl[pk] + hl["eo"], hl[ck_] + hl["big_r"]) + g)
    e = hi - lo
    q = lo + _F(0.5) * e
    rho = _F(0.5) * torch.sqrt(e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1] + e[:, 2] * e[:, 2])
    slack = _ULP64 * (q[:, 0].abs() + q[:, 1].abs() + q[:, 2].abs() + rho + 1.0)
    far = _hull_dist(hl, q[:, 0], q[:, 1], q[:, 2]) > rho + reach + hl["lam"] + slack
    return near & ~far


def _may_block_tree(hl, v0, e1, e2):
    """may_block_tree for triangles (rows [m, 3] each) against their points'
    hulls."""
    nx = e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1]
    ny = e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2]
    nz = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    n = torch.sqrt(nx * nx + ny * ny + nz * nz)
    ea = torch.sqrt(e1[:, 0] * e1[:, 0] + e1[:, 1] * e1[:, 1] + e1[:, 2] * e1[:, 2])
    eb = torch.sqrt(e2[:, 0] * e2[:, 0] + e2[:, 1] * e2[:, 1] + e2[:, 2] * e2[:, 2])
    ab = ea * eb
    dx, dy, dz = hl["px"] - v0[:, 0], hl["py"] - v0[:, 1], hl["pz"] - v0[:, 2]
    cx, cy, cz = hl["cx"] - v0[:, 0], hl["cy"] - v0[:, 1], hl["cz"] - v0[:, 2]
    length = (torch.sqrt(dx * dx + dy * dy + dz * dz) + torch.sqrt(cx * cx + cy * cy + cz * cz)
              + hl["big_r"] + 1.0)
    h_mt = _ULP64 * length * ab
    hp = nx * dx + ny * dy + nz * dz
    hc = nx * cx + ny * cy + nz * cz
    mp = n * hl["eo"] + h_mt
    far_c = n * hl["r"] + (n * (hl["big_r"] - hl["r"]) + h_mt)
    culled = ((hp > mp) & (hc > far_c)) | ((hp < -mp) & (hc < -far_c))
    den = hl["h"] + hl["big_r"]
    off = n * (hl["eo"] - _F(SHADOW_EPS)) + h_mt
    gap_hi, gap_lo = hc - far_c - hp, hp - far_c - hc
    step = _F(0.99999) * _F(SHADOW_EPS)
    culled |= (hc > far_c) & (gap_hi > 0.0) & (hp + step * gap_hi / den > off)
    culled |= (hc < -far_c) & (gap_lo > 0.0) & (step * gap_lo / den - hp > off)
    sigma = torch.sqrt(_ULP64 * (ab / n))
    graze = n * length * sigma
    guarded = (hp.abs() > mp + graze) | (hc.abs() > far_c + graze)
    g = (e1 + e2) / _F(3.0)
    r0 = torch.sqrt(g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1] + g[:, 2] * g[:, 2])
    f1, f2 = g - e1, g - e2
    r1 = torch.sqrt(f1[:, 0] * f1[:, 0] + f1[:, 1] * f1[:, 1] + f1[:, 2] * f1[:, 2])
    r2 = torch.sqrt(f2[:, 0] * f2[:, 0] + f2[:, 1] * f2[:, 1] + f2[:, 2] * f2[:, 2])
    rho = torch.fmax(r0, torch.fmax(r1, r2))
    m = v0 + g
    grow = _F(4.04) * _F(1e-6) + _F(0.140625) * sigma + _F(4.0) * _F(5.9604645e-8)
    rho_plus = (rho + grow * (ea + eb)
                + _ULP64 * (m[:, 0].abs() + m[:, 1].abs() + m[:, 2].abs() + rho + 1.0))
    far = (_hull_dist(hl, m[:, 0], m[:, 1], m[:, 2])
           > rho_plus + hl["lam"] + length * (_F(0.5625) * sigma + _F(4.0) * _F(5.9604645e-8)))
    return ~culled & ~(guarded & far)


@torch.no_grad()
def point_lists_plain(tree, p, light, list_max: int):
    """The point pass on points ``p`` [m, 3] (the marked points in order)
    against the light row ``light`` [4]: (kept [m] int32, the triangles each
    hull kept, or past ``list_max`` -1 - L, L the length of its probe's
    path; lists [m, 2 list_max] int32, the first ``list_max`` kept in the
    order the pass met them, each as its row and its leaf's entry, or the
    probe's path, -1 past them;
    visits and tests, the nodes the pass expanded and the triangles it
    tested, its probes' included), stepped as the kernel walks: each node's
    entered children pushed in slot order, the last pushed walked first."""
    m, w, dev = p.shape[0], tree.width, p.device
    rec = tree.nodes.view(torch.int32).reshape(-1, 8 * w).long()
    boxes = tree.nodes.reshape(-1, 8 * w)[:, :6 * w]
    rows = tree.tris
    hl_all = _hull(p, light)
    reach_all = _F(3.0) * _F(1e-5) * (1.0 + hl_all["h"] + hl_all["big_r"] + hl_all["eo"])
    stack = torch.zeros((m, b4.MAX_STACK), dtype=torch.long, device=dev)
    sp = torch.zeros((m,), dtype=torch.long, device=dev)
    ref = torch.zeros((m,), dtype=torch.long, device=dev)
    live = torch.ones((m,), dtype=torch.bool, device=dev)
    kept = torch.zeros((m,), dtype=torch.long, device=dev)
    lists = torch.full((m, list_max + 1, 2), -1, dtype=torch.long, device=dev)
    visits = torch.zeros((m,), dtype=torch.long, device=dev)
    tests = torch.zeros((m,), dtype=torch.long, device=dev)
    while bool(live.any()):
        idx = torch.nonzero(live).squeeze(1)
        hl = {k: v[idx] for k, v in hl_all.items()}
        reach = reach_all[idx]
        r_i, sp_i, st = ref[idx], sp[idx], stack[idx]
        internal = r_i >= 0
        visits[idx] += internal.long()
        node = torch.where(internal, r_i, 0)
        bx = boxes[node].reshape(-1, 6, w)
        meta = rec[node]
        rows_i = torch.arange(idx.numel(), device=dev)
        for c in range(w):
            push = internal & _box_near(hl, reach, bx[:, 0:3, c], bx[:, 3:6, c])
            entry = torch.where(meta[:, 7 * w + c] > 0, ~(w * node + c), meta[:, 6 * w + c])
            at = sp_i.clamp(max=b4.MAX_STACK - 1)
            st[rows_i, at] = torch.where(push, entry, st[rows_i, at])
            sp_i = sp_i + push.long()
        # A leaf entry: test its triangles until the list overflows.
        s_ = torch.where(internal, 0, ~r_i)
        lnode, lc = s_ // w, s_ % w
        first = rec[lnode, 6 * w + lc]
        count = torch.where(internal, 0, rec[lnode, 7 * w + lc])
        k_i = kept[idx]
        for k in range(int(count.max().item()) if count.numel() else 0):
            go = (k < count) & (k_i <= list_max)
            tri = torch.where(go, first + k, 0)
            tests[idx] += go.long()
            keep = go & _may_block_tree(hl, rows[tri, 0:3], rows[tri, 3:6], rows[tri, 6:9])
            slot = k_i.clamp(max=list_max)
            lists[idx[keep], slot[keep], 0] = tri[keep]
            lists[idx[keep], slot[keep], 1] = r_i[keep]
            k_i = k_i + keep.long()
        kept[idx] = k_i
        done = (k_i > list_max) | (sp_i == 0)
        sp_i = torch.where(done, sp_i, sp_i - 1)
        ref[idx] = torch.where(done, r_i, st[rows_i, sp_i.clamp(min=0)])
        stack[idx], sp[idx] = st, sp_i
        live[idx[done]] = False
    listed = kept <= list_max
    lists = lists[:, :list_max].reshape(m, 2 * list_max)
    kept = torch.where(listed, kept, -1)
    # The probes of the rest: the ray toward the light's centre.
    probe = torch.nonzero(~listed).squeeze(1)
    stats = {"visits": int(visits.sum()), "tests": int(tests.sum())}
    if probe.numel():
        o, d, tm = sample_rays(p[probe], torch.zeros_like(p[probe]), light)
        _, trail, length = led_walk_plain(tree, o, d, tm, keep=list_max, stats=stats)
        lists[probe] = -1
        lists[probe, :list_max] = torch.where(
            torch.arange(list_max, device=dev) < length[:, None], trail, -1)
        kept[probe] = -1 - length
    return kept.to(torch.int32), lists.to(torch.int32), stats["visits"], stats["tests"]



def _up(tree):
    """up [Nw] long: W * parent + slot of each node but the root (-1)."""
    w = tree.width
    meta, nchild = tree.meta.long(), tree.nchild.long()
    slots = torch.arange(w, device=meta.device)
    inner = (slots[None, :] < nchild[:, None]) & (meta[:, w:2 * w] == 0)
    parent = torch.arange(meta.shape[0], device=meta.device)[:, None] * w + slots[None, :]
    up = torch.full((meta.shape[0],), -1, dtype=torch.long, device=meta.device)
    up[meta[:, 0:w][inner]] = parent[inner]
    return up


def reaches_plain(tree, up, entry, o, d, tm):
    """csrc/soft.cu reaches: whether each ray's any-hit walk enters its leaf
    entry ``entry`` [n] (every box from the leaf's up to the root's child)."""
    w = tree.width
    inv = 1.0 / d
    bound = b4._padded(tm)
    s_ = ~entry.long()
    ok = torch.ones(entry.shape, dtype=torch.bool, device=o.device)
    going = ok.clone()
    while bool(going.any()):
        node, c = s_ // w, s_ % w
        tin, hit = b4._slab(o[:, 0], o[:, 1], o[:, 2], inv[:, 0], inv[:, 1], inv[:, 2],
                            tree.boxes[node], w)
        rows_ = torch.arange(node.shape[0], device=o.device)
        passed = hit[rows_, c] & (tin[rows_, c] <= bound)
        ok &= ~going | passed
        going &= passed & (node != 0)
        s_ = torch.where(going, up[node], s_)
    return ok


@torch.no_grad()
def led_walk_plain(tree, o, d, tm, path=None, length=None, keep: int = 0, stats=None):
    """The tree samplers' any-hit walk (``csrc/bvh4.cuh`` occluded<W, true>)
    of rays ``o``, ``d``, ``tm`` [n], stepped as the kernel walks it: each
    ray's first descent led by its entries ``path`` [n, L] (``length`` [n]
    of them), nearest first from where its ray does not enter the next one.
    -> (blocked [n] bool, trail [n, keep] long, trail_len [n] long): with
    ``keep``, the first ``keep`` entries of the path from the root to the
    leaf of each blocked ray's blocker (the point pass's probe).  ``stats``
    as ``bvh4._traverse_plain``'s."""
    n, dev, w = o.shape[0], o.device, tree.width
    if path is None:
        path = torch.zeros((n, 1), dtype=torch.long, device=dev)
        length = torch.zeros((n,), dtype=torch.long, device=dev)
    path, length = path.long(), length.long()
    stack = torch.zeros((n, b4.MAX_STACK), dtype=torch.long, device=dev)
    depth_st = torch.zeros((n, b4.MAX_STACK if keep else 1), dtype=torch.long, device=dev)
    sp = (tm > 0.0).long()
    step = torch.zeros((n,), dtype=torch.long, device=dev)
    blocked = torch.zeros((n,), dtype=torch.bool, device=dev)
    trail = torch.full((n, max(keep, 1)), -1, dtype=torch.long, device=dev)
    trail_len = torch.zeros((n,), dtype=torch.long, device=dev)
    inv = 1.0 / d
    bound = b4._padded(tm)
    meta, nchild = tree.meta.long(), tree.nchild.long()
    lanes = torch.arange(w, device=dev)
    top = b4.MAX_STACK - 1
    visits = tests = 0
    while True:
        idx = torch.nonzero(sp > 0).squeeze(1)
        if idx.numel() == 0:
            break
        rows = torch.arange(idx.numel(), device=dev)
        st, dst = stack[idx], depth_st[idx]
        sp_i = sp[idx] - 1
        ref = st[rows, sp_i]
        dep = dst[rows, sp_i] if keep else None  # depths only where a trail is kept
        if keep:
            at = (dep >= 1) & (dep <= keep)
            trail[idx[at], dep[at] - 1] = ref[at]
        internal = ref >= 0
        node = torch.where(internal, ref, 0)
        oi, di = o[idx], d[idx]
        tin, hit = b4._slab(oi[:, 0], oi[:, 1], oi[:, 2], inv[idx, 0], inv[idx, 1], inv[idx, 2],
                            tree.boxes[node], w)
        hit = hit & (lanes < nchild[node][:, None]) & (tin <= bound[idx, None]) & internal[:, None]
        m = meta[node]
        tv = list(torch.where(hit, tin, b4._BIG).unbind(1))
        ev = list(torch.where(m[:, w:2 * w] > 0, ~(w * node[:, None] + lanes),
                              m[:, 0:w]).unbind(1))
        for a_, b_ in b4.SORT_NET[w]:
            sw = tv[a_] <= tv[b_] if w == 2 else tv[a_] < tv[b_]
            tv[a_], tv[b_] = torch.where(sw, tv[b_], tv[a_]), torch.where(sw, tv[a_], tv[b_])
            ev[a_], ev[b_] = torch.where(sw, ev[b_], ev[a_]), torch.where(sw, ev[a_], ev[b_])
        step_i, len_i = step[idx], length[idx]
        lead = internal & (step_i < len_i)
        nxt = path[idx, step_i.clamp(max=path.shape[1] - 1)]
        on = torch.zeros_like(lead)
        for tc, ec in zip(tv, ev):
            on |= lead & (tc < b4._BIG) & (ec == nxt)
        step[idx] = torch.where(on, step_i + 1, torch.where(lead, len_i, step_i))
        # The kernel takes the nearest (or the path's entry) without a push:
        # here it is pushed last and popped next.
        for tc, ec in zip(tv, ev):
            push = (tc < b4._BIG) & ~(on & (ec == nxt))
            at = sp_i.clamp(max=top)
            st[rows, at] = torch.where(push, ec, st[rows, at])
            if keep:
                dst[rows, at] = torch.where(push, dep + 1, dst[rows, at])
            sp_i = sp_i + push.long()
        at = sp_i.clamp(max=top)
        st[rows, at] = torch.where(on, nxt, st[rows, at])
        if keep:
            dst[rows, at] = torch.where(on, dep + 1, dst[rows, at])
        sp_i = sp_i + on.long()
        visits += int(internal.sum())
        # A leaf entry: its triangles up to the first that blocks.
        s_ = torch.where(internal, 0, ~ref)
        lnode, lc = s_ // w, s_ % w
        first = meta[lnode, lc]
        cnt = torch.where(internal, 0, meta[lnode, w + lc])
        found = torch.zeros_like(internal)
        for k in range(int(cnt.max().item()) if cnt.numel() else 0):
            go = (k < cnt) & ~found
            tri = tree.tris[torch.where(go, first + k, 0)]
            t, _, _, ok = moller_trumbore_edges(oi, di, tri[:, 0:3], tri[:, 3:6], tri[:, 6:9])
            tests += int(go.sum())
            found |= go & ok & (t < tm[idx])
        blocked[idx[found]] = True
        if keep:
            trail_len[idx[found]] = dep[found].clamp(max=keep)
        stack[idx], depth_st[idx] = st, dst
        sp[idx] = torch.where(found, 0, sp_i)
    if stats is not None:
        stats["visits"] = stats.get("visits", 0) + visits
        stats["tests"] = stats.get("tests", 0) + tests
    return blocked, trail[:, :keep], trail_len


@torch.no_grad()
def list_counts_plain(tree, pos, light, num_samples, valid, list_max: int, key=None,
                      gauss_nsc=None):
    """The plain model of a tree sampler's launch with its point pass: the
    counts [N] int32 (those of the walk alone), the tree tally (live
    samples; the pass's nodes and the walks' nodes expanded; the sample
    rays' list tests and walk tests) and the list tally (``LIST_KEYS``).  A
    listed point's sample tests its list in order up to its first blocker
    whose leaf its walk reaches (``reaches_plain``); the rest walk, led by
    their points' probe paths (``led_walk_plain``)."""
    n, dev = pos.shape[0], pos.device
    counts = torch.zeros((n,), dtype=torch.int32, device=dev)
    rows = (torch.arange(n, device=dev) if valid is None
            else torch.nonzero(valid.to(dev)).squeeze(1))
    m = rows.numel()
    kept, lists, p_visits, p_tests = point_lists_plain(tree, pos[rows], light, list_max)
    listed = kept >= 0
    length = kept.clamp_min(0).long()
    stats = {"visits": 0, "tests": 0}
    samples = torch.arange(num_samples, device=dev)
    g = (philox_gauss(key, rows, samples) if gauss_nsc is None else gauss_nsc[rows])
    o, d, tm = sample_rays(pos[rows][:, None, :], g, light)
    live = tm > 0.0
    # Each listed sample's first blocker in its point's list whose leaf its
    # walk reaches (length: none).
    up = _up(tree)
    first = length[:, None].expand(m, num_samples).clone()
    for q in range(int(length.max().item()) - 1 if m else -1, -1, -1):
        tri = tree.tris[lists[:, 2 * q].long().clamp_min(0)]
        t, _, _, ok = moller_trumbore_edges(o, d, tri[:, None, 0:3], tri[:, None, 3:6],
                                            tri[:, None, 6:9])
        ok = (q < length)[:, None] & ok & (t < tm)
        if bool(ok.any()):
            leaf = lists[:, 2 * q + 1].long()[:, None].expand(m, num_samples)
            ok[ok.clone()] = reaches_plain(tree, up, leaf[ok], o[ok], d[ok], tm[ok])
        first = torch.where(ok, q, first)
    on_list = live & listed[:, None]
    hit = on_list & (first < length[:, None])
    list_tests = int(torch.where(hit, first + 1, length[:, None])[on_list].sum())
    blocked = hit.clone()
    walk = live & ~listed[:, None]
    sel = walk.reshape(-1)
    if bool(sel.any()):
        led = torch.where(listed, 0, -1 - kept.long())[:, None].expand(m, num_samples)
        path = lists.long()[:, None, :list_max].expand(m, num_samples, list_max)
        blocked.reshape(-1)[sel] = led_walk_plain(
            tree, o.reshape(-1, 3)[sel], d.reshape(-1, 3)[sel], tm.reshape(-1)[sel],
            path.reshape(-1, list_max)[sel], led.reshape(-1)[sel], stats=stats)[0]
    counts[rows] = (~blocked).sum(dim=1, dtype=torch.int32)
    tree_tally = (m * num_samples, p_visits + stats["visits"], list_tests + stats["tests"])
    list_tally = (m, int(listed.sum()), int(kept[listed].sum()), p_visits, p_tests,
                  int((kept < -1).sum()))
    return counts, tree_tally, list_tally


def _tree_anyhit(tree, stats=None):
    """The twin walk; ``stats`` (a dict) gathers its node visits and tests."""
    return lambda o, d, tm: b4._anyhit_plain(tree, o, d, tm, stats=stats)


# --------------------------------------------------------------------------
# The kernels.
# --------------------------------------------------------------------------

def _compact(valid):
    """The marked points first, without waiting for the card: (order [N + 1]
    int32, the indices of the marked points in order, then the rest
    unspecified; count [1] int32, how many are marked).  The kernels read
    count on the card and spend no thread on the rest."""
    n = valid.shape[0]
    rank = torch.cumsum(valid, 0, dtype=torch.int32)
    order = torch.empty((n + 1,), dtype=torch.int32, device=valid.device)
    slot = torch.where(valid.bool(), rank - 1, n).to(torch.int64)
    order.scatter_(0, slot, torch.arange(n, dtype=torch.int32, device=valid.device))
    return order, rank[n - 1:]


def _head(name, pos, light, valid, gauss_nsc):
    """(pos, order, count, N, light) as the kernels take them, and the
    tensors to keep alive until the launch is queued."""
    ck._check(name, pos, light, gauss_nsc, device=pos.device)
    ck._check(name, valid, device=pos.device, dtype=torch.uint8)
    if pos.ndim != 2 or pos.shape[1] != 3 or pos.shape[0] >= 2 ** 31:
        raise ValueError(f"{name}: positions must be [N, 3] with N < 2**31")
    order, count = _compact(valid) if valid is not None and pos.shape[0] > 0 else (None, None)
    return (ck._ptr(pos), ck._ptr(order), ck._ptr(count), pos.shape[0], ck._ptr(light)), (
        order, count)


def _key_args(key, num_samples, device):
    """((S, key words' pointer, offset) as the kernels take them, the words
    on the card to keep alive until the launch is queued); a table launch
    has no key."""
    words = None if key is None else device_key(key, device)
    offset = 0 if key is None else key.offset
    return (int(num_samples), ck._ptr(words), ctypes.c_uint32(int(offset) & _MASK)), words


_TALLY = {}  # device -> int64 [2]: the brute sampler's (tests kept, tests of full sweeps)
_TREE_TALLY = {}  # device -> int64 [3]: the tree samplers' (live samples, nodes expanded, tests)
_LIST_TALLY = {}  # device -> int64 [6]: the tree samplers' point pass (LIST_KEYS)
LIST_KEYS = ("points", "listed", "kept", "visits", "tests", "led")


def _made(tallies: dict, size: int, device):
    """The tally of ``tallies`` on ``device``, made on its first launch there
    outside a CUDA graph capture (a capture's warm-up runs eagerly first);
    None inside a capture before that, and that launch counts nothing."""
    t = tallies.get(device)
    if t is None and not (device.type == "cuda" and torch.cuda.is_current_stream_capturing()):
        t = tallies[device] = torch.zeros((size,), dtype=torch.int64, device=device)
    return t


def _tally(device):
    """The brute sampler's tally on ``device`` (``_made``)."""
    return _made(_TALLY, 2, device)


def _tree_tally(device):
    """The tree samplers' tally on ``device`` (``_made``)."""
    return _made(_TREE_TALLY, 3, device)


def _list_tally(device):
    """The tree samplers' point-pass tally on ``device`` (``_made``)."""
    return _made(_LIST_TALLY, len(LIST_KEYS), device)


def _totals(tallies: dict, size: int) -> list:
    """Every device's tally summed (waits for the card)."""
    out = [0] * size
    for t in tallies.values():
        out = [a + b for a, b in zip(out, t.tolist())]
    return out


def cull_counts() -> tuple:
    """The brute sampler's cumulative (triangle tests its per-point masks
    kept, tests full sweeps would have made) over every live sample ray
    since the last ``reset_cull_counts``, its graphs' replays included;
    below ``csrc/soft.cu``'s ``kCullMinSamples`` a sample keeps all.  Waits
    for the card."""
    return tuple(_totals(_TALLY, 2))


def reset_cull_counts() -> None:
    for t in _TALLY.values():
        t.zero_()


def tree_sampler_counts() -> dict:
    """The tree samplers' cumulative work since the last
    ``reset_tree_sampler_counts``, their graphs' replays included:
    'samples', the live sample rays (every sample of a marked point);
    'visits', the internal nodes expanded by the point pass and by the sample
    rays' walks; 'tests', the triangles the sample rays tested, in their
    points' lists and in their walks (the plain model ``list_counts_plain``).
    Waits for the card."""
    return dict(zip(("samples", "visits", "tests"), _totals(_TREE_TALLY, 3)))


def reset_tree_sampler_counts() -> None:
    for t in _TREE_TALLY.values():
        t.zero_()


def tree_list_counts() -> dict:
    """The tree samplers' point pass since the last ``reset_tree_list_counts``,
    their graphs' replays included: 'points', the marked points; 'listed',
    those whose hull kept at most ``list_max()`` triangles (their samples test
    the list, the rest walk the tree); 'kept', the triangles kept on listed
    points; 'visits' and 'tests', the pass's internal nodes expanded and
    triangles tested.  Waits for the card."""
    return dict(zip(LIST_KEYS, _totals(_LIST_TALLY, len(LIST_KEYS))))


def reset_tree_list_counts() -> None:
    for t in _LIST_TALLY.values():
        t.zero_()


@functools.lru_cache(maxsize=None)
def list_max() -> int:
    """K: the longest list a point keeps (``csrc/soft.cu``'s ``kListMax``,
    read from the kernel library once)."""
    from . import _build

    return int(_build.load().cgrt_soft_list_max())


def _brute_kernel(tri, pos, light, num_samples, valid, key=None, gauss_nsc=None):
    """The brute sampler's launch."""
    counts = torch.zeros((pos.shape[0],), dtype=torch.int32, device=pos.device)
    ck._check("cgrt_soft_brute", tri, device=pos.device)
    head, _keep = _head("cgrt_soft_brute", pos, light, valid, gauss_nsc)
    key_args, _words = _key_args(key, num_samples, pos.device)
    ck._launch("cgrt_soft_brute", pos.device, *head, ck._ptr(tri), tri.shape[0], *key_args,
               ck._ptr(gauss_nsc), ck._ptr(counts), ck._ptr(_tally(pos.device)))
    counters.count("soft_prng_cuda" if gauss_nsc is None else "soft_table_cuda")
    return counts


def _tree_kernel(tree, pos, light, num_samples, valid, key=None, gauss_nsc=None):
    """A tree sampler's launch."""
    n = pos.shape[0]
    counts = torch.zeros((n,), dtype=torch.int32, device=pos.device)
    width, nodes, rows, _ = b4._tree_args("cgrt_soft_bvh4", tree, pos.device)
    head, _keep = _head("cgrt_soft_bvh4", pos, light, valid, gauss_nsc)
    key_args, _words = _key_args(key, num_samples, pos.device)
    # The point pass's lists: scratch the kernels write before they read it.
    lists = torch.empty((n, 2 * list_max()), dtype=torch.int32, device=pos.device)
    kept = torch.empty((n,), dtype=torch.int32, device=pos.device)
    up = torch.empty((tree.num_nodes,), dtype=torch.int32, device=pos.device)
    ck._launch("cgrt_soft_bvh4", pos.device, *head, width, nodes, rows, tree.num_nodes,
               *key_args, ck._ptr(gauss_nsc), ck._ptr(counts), ck._ptr(_tree_tally(pos.device)),
               ck._ptr(lists), ck._ptr(kept), ck._ptr(up), ck._ptr(_list_tally(pos.device)))
    # No rays: the registry's walk rays are the tree walks' (bvh4.py) alone.
    counters.count("soft4_prng_cuda" if gauss_nsc is None else "soft4_table_cuda", width)
    return counts


# --------------------------------------------------------------------------
# Public wrappers and their twins.
# --------------------------------------------------------------------------

def supports_soft_shadow_kernel(scene: Scene, max_tris: int = ck.UNROLL_MAX_TRIS) -> bool:
    """The brute sampler sweeps the triangle table from shared memory and
    has no sphere tail: all-triangle scenes of 1..256 triangles with
    spherical lights (``pallas_kernels.py:786-793``)."""
    return (0 < scene.num_triangles <= max_tris
            and scene.spheres.radius.shape[0] == 0
            and scene.spherical_lights.position.shape[0] > 0)


def supports_soft_shadow_kernel_bvh(scene: Scene) -> bool:
    """The tree samplers: all-triangle scenes of 1..``VMEM_MAX_TRIS``
    triangles with spherical lights (``pallas_bvh.py:1317-1324``; the JAX
    package's streaming tier past that cap has no sampler)."""
    return (0 < scene.num_triangles <= b4.VMEM_MAX_TRIS and scene.spheres.radius.shape[0] == 0
            and scene.spherical_lights.position.shape[0] > 0)


def _inputs(positions, light_pos, light_radius, valid):
    pos = positions.detach().to(torch.float32).contiguous()
    light = light_row(light_pos, light_radius).to(pos.device)
    v = None if valid is None else valid.detach().to(device=pos.device,
                                                     dtype=torch.uint8).contiguous()
    return pos, light, v


def _gauss_nsc(gauss, n, device):
    """[S, N, 3] Gaussians (the JAX package's layout) -> [N, S, 3] contiguous."""
    if gauss.ndim != 3 or gauss.shape[1] != n or gauss.shape[2] != 3:
        raise ValueError(f"gauss must be [S, {n}, 3], got {tuple(gauss.shape)}")
    return gauss.detach().to(device=device, dtype=torch.float32).permute(1, 0, 2).contiguous()


def _brute(scene, positions, light_pos, light_radius, num_samples, valid, key, gauss, on_card):
    if not supports_soft_shadow_kernel(scene):
        raise ValueError("soft-shadow kernel: the scene needs 1..256 triangles, no spheres and "
                         "a spherical light (supports_soft_shadow_kernel)")
    pos, light, v = _inputs(positions, light_pos, light_radius, valid)
    g = None if gauss is None else _gauss_nsc(gauss, pos.shape[0], pos.device)
    tri = ck._tri_table(scene).detach()
    if on_card:
        counts = _brute_kernel(tri, pos, light, num_samples, v, key, g)
    else:
        counts = _counts_plain(_brute_anyhit(tri), pos, light, num_samples, v, key, g)
    return counts.to(torch.float32)


def _tree(scene, tree, positions, light_pos, light_radius, num_samples, valid, key, gauss,
          on_card):
    if not supports_soft_shadow_kernel_bvh(scene):
        raise ValueError(f"tree soft-shadow kernel: the scene needs 1..{b4.VMEM_MAX_TRIS} "
                         f"triangles, no spheres and a spherical light "
                         f"(supports_soft_shadow_kernel_bvh)")
    if not isinstance(tree, b4.BVH4) or tree.num_tris != scene.num_triangles:
        raise ValueError("the tree samplers walk the scene's BVH4 (ops/bvh4.py)")
    pos, light, v = _inputs(positions, light_pos, light_radius, valid)
    g = None if gauss is None else _gauss_nsc(gauss, pos.shape[0], pos.device)
    if on_card:
        counts = _tree_kernel(tree, pos, light, num_samples, v, key, g)
    else:
        counts = _counts_plain(_tree_anyhit(tree), pos, light, num_samples, v, key, g)
    return counts.to(torch.float32)


def soft_prng_cuda(scene: Scene, positions, light_pos, light_radius, key: SampleKey,
                   num_samples: int, valid=None):
    """Visible-sample counts [N] float32 in [0, num_samples] for one
    spherical light, brute force over the scene's triangles, samples from
    the stream of ``key``."""
    return _brute(scene, positions, light_pos, light_radius, num_samples, valid, key, None,
                  on_card=positions.is_cuda)


def soft_prng_plain(scene: Scene, positions, light_pos, light_radius, key: SampleKey,
                    num_samples: int, valid=None):
    return _brute(scene, positions, light_pos, light_radius, num_samples, valid, key, None,
                  on_card=False)


def soft_table_cuda(scene: Scene, positions, light_pos, light_radius, gauss, valid=None):
    """``soft_prng_cuda`` on given Gaussians ``gauss`` [S, N, 3]."""
    return _brute(scene, positions, light_pos, light_radius, gauss.shape[0], valid, None, gauss,
                  on_card=positions.is_cuda)


def soft_table_plain(scene: Scene, positions, light_pos, light_radius, gauss, valid=None):
    return _brute(scene, positions, light_pos, light_radius, gauss.shape[0], valid, None, gauss,
                  on_card=False)


def soft4_prng_cuda(scene: Scene, tree, positions, light_pos, light_radius, key: SampleKey,
                    num_samples: int, valid=None):
    """The counts of ``soft_prng_cuda`` by any-hit walks of the scene's
    ``tree`` (any width): one thread per (point, sample)."""
    return _tree(scene, tree, positions, light_pos, light_radius, num_samples, valid, key, None,
                 on_card=positions.is_cuda)


def soft4_prng_plain(scene: Scene, tree, positions, light_pos, light_radius, key: SampleKey,
                     num_samples: int, valid=None):
    return _tree(scene, tree, positions, light_pos, light_radius, num_samples, valid, key, None,
                 on_card=False)


def soft4_table_cuda(scene: Scene, tree, positions, light_pos, light_radius, gauss,
                     valid=None):
    """``soft4_prng_cuda`` on given Gaussians ``gauss`` [S, N, 3]."""
    return _tree(scene, tree, positions, light_pos, light_radius, gauss.shape[0], valid, None,
                 gauss, on_card=positions.is_cuda)


def soft4_table_plain(scene: Scene, tree, positions, light_pos, light_radius, gauss,
                      valid=None):
    return _tree(scene, tree, positions, light_pos, light_radius, gauss.shape[0], valid, None,
                 gauss, on_card=False)


_BRUTE = counters.Group("soft_prng_cuda", "soft_table_cuda")
_TREES = counters.Group("soft4_prng_cuda", "soft4_table_cuda", widths=b4.WIDTHS)


def launch_counts() -> dict:
    """Each wrapper's launches; the tree samplers' also per node width."""
    return {**_BRUTE.launch_counts(), **_TREES.launch_counts()}


def reset_launch_counts() -> None:
    _BRUTE.reset()
    _TREES.reset()
