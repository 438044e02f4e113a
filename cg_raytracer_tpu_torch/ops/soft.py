"""Spherical-light soft shadows on the card: the sample stream and the
samplers, each in a PRNG and a table variant, with their plain twins.
Counterpart of the in-kernel samplers of
``cg_raytracer_tpu/ops/pallas_kernels.py`` (brute force, <= 256 triangles),
``cg_raytracer_tpu/ops/pallas_bvh.py`` (the per-sample and cone samplers
over the binary tree) and ``cg_raytracer_tpu/ops/pallas_bvh4.py`` (the cone
sampler over the 4- or 8-wide tree).

=======================  =============================================  ======================
wrapper                  Pallas kernel replaced                         plain twin
=======================  =============================================  ======================
``soft_prng_cuda``       ``_soft_shadow_prng_kernel`` (B9)              ``soft_prng_plain``
``soft_table_cuda``      ``_soft_shadow_table_kernel`` (B9)             ``soft_table_plain``
``soft_bvh_prng_cuda``   ``_soft_bvh_prng_kernel`` (B12)                ``soft_bvh_prng_plain``
``soft_bvh_table_cuda``  ``_soft_bvh_table_kernel`` (B12)               ``soft_bvh_table_plain``
``soft4_prng_cuda``      ``_soft4_cone_prng_kernel`` (B10; W=8 B15),    ``soft4_prng_plain``
                         ``_soft_bvh_cone_prng_kernel`` (B11, W=2)
``soft4_table_cuda``     ``_soft4_cone_table_kernel`` (B10; W=8 B15),   ``soft4_table_plain``
                         ``_soft_bvh_cone_table_kernel`` (B11, W=2)
=======================  =============================================  ======================

One kernel body (``csrc/soft.cu``) serves all of them.  The tree samplers
walk a ``BVH4`` of any width (``ops/bvh4.py``): ``soft_bvh_*`` are the
``soft_shadow_tile='sample'`` route, over the primary tree (binary: 'sample'
forces width 2, as in the JAX package), and ``soft4_*`` the 'cone' route,
over ``AccelBundle.soft`` at the primary tree's width.  The JAX package's
two tiles (points on lanes with a loop over samples; 128 pixels x all their
samples in one lockstep walk) are one layout on the card, a thread per
(point, sample), so the two routes differ only in the tree they walk.  An
any-hit count does not depend on the tree: given one key or table, every
width and both routes count the same.  Each returns, per
shading point, how many of ``num_samples`` shadow rays toward random points
on one spherical light reach it (main.cpp:166-218), as float32 counts [N].
The PRNG variants draw the samples in the kernel; the table variants take
them as Gaussians [S, N, 3] (the JAX package's layout), for tests and
parity.  ``valid`` ([N] bool) marks the points to sample: the rest do no work
and count 0 (the JAX kernels sampled a miss at position 0 and the shading
discarded it).

On the card the tree samplers read the tree's records (``BVH4.nodes``,
``BVH4.rows``, built once per tree by ``ops/bvh4.py``) through the any-hit
walk that ``bvh4.cu`` runs too.  Every kernel launch gets the marked points
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
from typing import NamedTuple, Optional

import torch

from ..scene.types import Scene
from . import bvh4 as b4
from . import cuda_kernels as ck

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
        replay's root keys, in the captured order), with one copy."""
        if not self.paths:
            return
        memo = {}

        def derive(path):
            if path not in memo:
                memo[path] = (roots[path[0]] if len(path) == 1
                              else derive(path[:-1]).fold_in(path[-1]))
            return memo[path]

        host = torch.tensor([[_word(derive(p).k0), _word(derive(p).k1)] for p in self.paths],
                            dtype=torch.int32)
        if self.words.is_cuda:
            host = host.pin_memory()
        self.words[:len(self.paths)].copy_(host, non_blocking=True)

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


def _brute_kernel(tri, pos, light, num_samples, valid, key=None, gauss_nsc=None):
    """The brute sampler's launch."""
    counts = torch.zeros((pos.shape[0],), dtype=torch.int32, device=pos.device)
    ck._check("cgrt_soft_brute", tri, device=pos.device)
    head, _keep = _head("cgrt_soft_brute", pos, light, valid, gauss_nsc)
    key_args, _words = _key_args(key, num_samples, pos.device)
    ck._launch("cgrt_soft_brute", pos.device, *head, ck._ptr(tri), tri.shape[0], *key_args,
               ck._ptr(gauss_nsc), ck._ptr(counts))
    (soft_prng_cuda if gauss_nsc is None else soft_table_cuda).launches += 1
    return counts


def _tree_kernel(tree, pos, light, num_samples, valid, key=None, gauss_nsc=None,
                 route: str = "cone"):
    """A tree sampler's launch; ``route`` ('sample' or 'cone') names the
    wrapper whose count it adds to."""
    counts = torch.zeros((pos.shape[0],), dtype=torch.int32, device=pos.device)
    width, nodes, rows, _ = b4._tree_args("cgrt_soft_bvh4", tree, pos.device)
    head, _keep = _head("cgrt_soft_bvh4", pos, light, valid, gauss_nsc)
    key_args, _words = _key_args(key, num_samples, pos.device)
    ck._launch("cgrt_soft_bvh4", pos.device, *head, width, nodes, rows, *key_args,
               ck._ptr(gauss_nsc), ck._ptr(counts))
    prng, table = (soft_bvh_prng_cuda, soft_bvh_table_cuda) if route == "sample" else (
        soft4_prng_cuda, soft4_table_cuda)
    b4.count_launch(prng if gauss_nsc is None else table, width)
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


supports_soft_shadow_kernel_bvh4 = supports_soft_shadow_kernel_bvh


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
          on_card, route="cone"):
    if not supports_soft_shadow_kernel_bvh(scene):
        raise ValueError(f"tree soft-shadow kernel: the scene needs 1..{b4.VMEM_MAX_TRIS} "
                         f"triangles, no spheres and a spherical light "
                         f"(supports_soft_shadow_kernel_bvh)")
    if not isinstance(tree, b4.BVH4) or tree.num_tris != scene.num_triangles:
        raise ValueError("the tree samplers walk the scene's BVH4 (ops/bvh4.py)")
    pos, light, v = _inputs(positions, light_pos, light_radius, valid)
    g = None if gauss is None else _gauss_nsc(gauss, pos.shape[0], pos.device)
    if on_card:
        counts = _tree_kernel(tree, pos, light, num_samples, v, key, g, route)
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


def soft_bvh_prng_cuda(scene: Scene, tree, positions, light_pos, light_radius,
                       key: SampleKey, num_samples: int, valid=None):
    """The 'sample' route: the counts of ``soft_prng_cuda`` by any-hit walks
    of the primary ``tree`` (the per-sample sampler; the JAX package's
    ``soft_shadow_counts_pallas_bvh``)."""
    return _tree(scene, tree, positions, light_pos, light_radius, num_samples, valid, key, None,
                 on_card=positions.is_cuda, route="sample")


def soft_bvh_prng_plain(scene: Scene, tree, positions, light_pos, light_radius,
                        key: SampleKey, num_samples: int, valid=None):
    return _tree(scene, tree, positions, light_pos, light_radius, num_samples, valid, key, None,
                 on_card=False, route="sample")


def soft_bvh_table_cuda(scene: Scene, tree, positions, light_pos, light_radius, gauss,
                        valid=None):
    """``soft_bvh_prng_cuda`` on given Gaussians ``gauss`` [S, N, 3]."""
    return _tree(scene, tree, positions, light_pos, light_radius, gauss.shape[0], valid, None,
                 gauss, on_card=positions.is_cuda, route="sample")


def soft_bvh_table_plain(scene: Scene, tree, positions, light_pos, light_radius, gauss,
                         valid=None):
    return _tree(scene, tree, positions, light_pos, light_radius, gauss.shape[0], valid, None,
                 gauss, on_card=False, route="sample")


def soft4_prng_cuda(scene: Scene, tree, positions, light_pos, light_radius, key: SampleKey,
                    num_samples: int, valid=None):
    """The 'cone' route: the counts of ``soft_prng_cuda`` by any-hit walks
    of the soft ``tree`` (any width): one thread per (point, sample)."""
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


BRUTE_WRAPPERS = (soft_prng_cuda, soft_table_cuda)
TREE_WRAPPERS = (soft_bvh_prng_cuda, soft_bvh_table_cuda, soft4_prng_cuda, soft4_table_cuda)
KERNEL_WRAPPERS = BRUTE_WRAPPERS + TREE_WRAPPERS


def launch_counts() -> dict:
    """Each wrapper's launches; the tree samplers' also per node width."""
    return {**{w.__name__: w.launches for w in BRUTE_WRAPPERS}, **b4.width_counts(TREE_WRAPPERS)}


def reset_launch_counts() -> None:
    for w in BRUTE_WRAPPERS:
        w.launches = 0
    b4.reset_counts(TREE_WRAPPERS)


reset_launch_counts()
