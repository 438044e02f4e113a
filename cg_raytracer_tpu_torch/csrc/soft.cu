// Spherical-light soft-shadow samplers: visible-sample counts per shading
// point for one spherical light (main.cpp:166-218).
//
// Replaces eight Pallas kernels:
//   cgrt_soft_brute, PRNG  <- pallas_kernels.py _soft_shadow_prng_kernel (B9),
//   cgrt_soft_brute, table <- pallas_kernels.py _soft_shadow_table_kernel (B9),
//   cgrt_soft_bvh4, PRNG   <- pallas_bvh4.py _soft4_cone_prng_kernel (B10; at
//                             W = 8 B15), pallas_bvh.py's per-sample PRNG
//                             kernel (B12, W = 2, pallas_bvh.py:1008) and
//                             _soft_bvh_cone_prng_kernel (B11, W = 2),
//   cgrt_soft_bvh4, table  <- their table twins _soft4_cone_table_kernel,
//                             the per-sample table kernel (pallas_bvh.py:
//                             1036), _soft_bvh_cone_table_kernel.
// Wrappers, the sample stream and the plain twins: ops/soft.py.
//
// One body (sample_visible), templated on the sample source (Philox in the
// kernel, or a table of Gaussians [N, S, 3]) and on the scene (the triangle
// table in shared memory, or a W-wide tree, W = 2, 4 or 8).  The JAX
// package's 'sample' tile (points on lanes, a loop over samples, the binary
// tree) and 'cone' tile (128 pixels x all their samples in one lockstep walk
// of the tree) are both this layout: on the card they differ only in the
// width of the scene's one tree, which the caller passes.  Layout: one thread per (point,
// sample), point-major, so a point's 200 samples fill ~6 consecutive warps
// and a block's four warps sample one or two points.  The cone sampler's
// coherence (one point's rays toward a sphere of radius ~0.1 stop at the
// same blocker or walk nearly the same nodes) then holds across the warps of
// a block as well as inside each.  A warp adds its count per point with one
// atomicAdd (__popc of the ballot over the lanes of that point).  Only the
// points the wrapper marks (the hits) are sampled, compacted on the card
// (order, count): the rest get no thread and count 0, and the grid strides
// over the marked points' samples.  One warp per point with one lane per
// sample was written first and measured 2.53x slower at 1024^2: an SM's ~36
// resident warps then walk ~36 points at once, against ~9 here.
//
// Sample s of the point with global index g = offset + i: Philox4x32-10 at
// counter (g, s, 0, 0) under the key (k0, k1), read on the card from the
// two words the wrapper points at (ops/soft.py device_key: a fresh copy per
// launch, or a slot of the key table a CUDA graph replays with, so no key is
// baked into a captured launch), its four words turned into
// three Gaussians by Box-Muller on 24-bit uniforms (_gauss3_from_bits; logf,
// sqrtf, and sincosf / cosf, not the fast intrinsics).  The sample ray is
// _soft_sample_ray op for op (the build's -fmad=false keeps each multiply
// and add rounded as the twin's), so the table variant agrees with its twin
// exactly and the PRNG variant up to the transcendental functions.
//
// The tree walk is bvh4.cuh's any-hit walk (occluded<W>), the one that
// bvh4.cu's any-hit and bounce kernels run, over the tree's records built
// once per tree (ops/bvh4.py BVH4.nodes, BVH4.rows): one 32W-byte record
// per node read with 16-byte loads, NaN boxes in the absent slots, PTX
// min.NaN/max.NaN, a stack of node ids in local memory (held in shared
// memory, [entry][thread], it measured 4-6% slower: PERF.md, the
// samplers), the nearest child walked at once, and the any-hit
// Moller-Trumbore of sweep.cuh (mt_blocks), which stops at the first failed
// condition: a point's lanes nearly always reject a triangle at the same
// step.
// The brute sweep is sweep.cuh's any_hit_sweep over the triangles staged in
// shared memory in the same three-row layout (stage_rows3: three 16-byte
// broadcast loads per test), the same mt_blocks.
//
// Per-point culling (the brute sweep from kCullMinSamples samples on: its
// own instantiation, soft_kernel<kTable, 0, true>, cull_body).  A point's
// sample rays all run from near p to near the light's sphere (c, r), so
// whether a triangle can block any of them is decided once per point, by
// two conservative tests (may_block), and the sweep tests only the
// triangles that pass.  Each grid-stride iteration of a block covers the
// samples of at most span = ceil(127 / S) + 1 points: the block's threads
// share out the (point, triangle) pairs, set each kept triangle's bit in the
// point's mask in shared memory (atomicOr; one 32-bit word per 32
// triangles), and after one __syncthreads each warp sweeps, lowest index
// first, the set bits of the OR of the masks of the points its lanes sample
// (warp-uniform, so the rows stay broadcast loads).  Three mask buffers in
// turn need one barrier per iteration: iteration n sets buffer n % 3 and
// zeroes buffer (n + 1) % 3, which the sweep of iteration n - 2 read before
// every thread passed iteration n - 1's barrier.  The masks cost ~T x span /
// 128 cull tests per thread per iteration, ~1 / S of a sweep, and the
// culled kernel needs 48 registers against the sweep's 32-36: culling every
// S measured 2.56x, 1.13x and 1.04x slower than none at S = 1, 4 and 5, and
// 4% faster at 6 (the spherical box at 1024^2, chip_smoke.py cull_part;
// PERF.md), so below 6 samples the kernel sweeps every triangle, as before
// culling.  The kernel's tally counts, per live sample, the triangles its
// sweep may test (the OR's set bits; all T without culling) and T; a block
// adds its two sums once to the wrapper's int64 pair (ops/soft.py
// cull_counts).
//
// The tree samplers' per-point lists (W > 0: two launches).  All of a
// point's sample rays run from near p to near the light's sphere, so the
// tree is walked once per point first, by the point pass
// (soft_kernel<false, W, true>, list_body: one thread per marked point).
// It walks the tree against the point's hull, the convex hull of B(p, eo)
// and B(c, R) (below), entering the boxes that box_near keeps and keeping
// the leaf triangles that may_block_tree keeps, in the order it meets them,
// each as its row and its leaf's entry.  A point that keeps at most
// kListMax (K) gets its list; the (K + 1)-th kept ends its walk, and the
// point probes instead: the nearest-first any-hit walk of the ray from p
// toward c, whose path from the root to the blocker's leaf (its first K
// entries) the point keeps.  The same launch writes up, each node's parent
// entry.  Then the sample pass, as before: one thread per (point, sample).
// A listed point's sample tests its list in order with mt_blocks, and takes
// the first triangle that blocks whose leaf its own walk would reach
// (reaches: the box test of expand for the leaf's box and each ancestor's,
// climbing up); none, and it reaches the light.  The rest walk the tree
// (occluded<W, true>), their first descent led by the point's path: a
// shadowed point's rays go straight to its probe's blocker, which in a
// nearest-first walk they meet only after the boxes around p and across
// the cup's hollow.  Why the counts are the walk's:
//  (i) A triangle that MT accepts for a sample ray, in a leaf that ray's
//      walk enters, is kept: box_near keeps every box a sample ray's walk
//      may enter, and may_block_tree every triangle MT may accept for one.
//  (ii) The walk's answer is whether some leaf it enters holds a triangle
//      that MT accepts: it expands every node it enters until it meets one,
//      and whether it enters a node depends on the ray and the node's and
//      its ancestors' boxes alone, not on the order.  So a list decides as
//      the walk does by (i) and reaches, and a led walk is the walk.
// The hull's tests, with (a)'s terms below and eo, R, lam as there:
//  (a') Origins.  Every sample ray starts at o = p + kShadowEps d, d the
//      unit vector toward its sample point s, s within r of c.  Where B(c,
//      R) lies beyond H on one side of the plane (h(c) > n R + H), h(o) -
//      h(p) = kShadowEps (h(s) - h(p)) / |s - p| >= kShadowEps gap / (h +
//      R), gap = h(c) - n R - H - h(p) > 0 (h = |c - p|), so h(o) > H where
//      h(p) + kShadowEps gap / (h + R) > n (eo - kShadowEps) + H (the
//      computed o lies within eo - kShadowEps of the exact one), and (a)
//      rules the ray out; a factor 0.99999 takes up the test's rounding.
//      This keeps out p's own triangle and those p lies on, whose planes
//      pass within eo of p, where (a) alone keeps them.
//  (b') Hull.  Each ray's segment [o, e] lies in the hull, a round cone
//      (hull_dist: the exact distance, within lam in float), so (b)'s
//      argument holds with dist(m, [p, c]) - R replaced by hull_dist(m):
//      the narrow end near p keeps the triangles about p that (b)'s
//      capsule of radius R would keep.
//  Boxes.  A walk enters a box only where the ray's padded slab test
//      passes: the ray's line comes within sqrt(3) pad of the box at a t in
//      [-pad, t_max + pad], pad = kSlabEps (1 + |t_out|) <= kSlabEps (1 + h
//      + R + eo) with the slab t's rounding (a few u of t <= t_max + pad),
//      so within M = 3 kSlabEps (1 + h + R + eo) of the hull.  box_near
//      rules a box out where its bounding sphere, or the hull's axis-
//      aligned box, lies beyond M + lam (+ 64 u terms) of the hull.
// The pass costs ~20-40 node visits a point (one sample ray's ~15 walk
// visits, at ~200 samples a point), and lists and up live in scratch the
// wrapper allocates per launch: 8 K bytes a point, 4 a node.
// tests/test_torch_soft_lists.py holds the counts to the walk on cases built
// to need each margin, and builds with the margins negated or reaches
// always true must miscount.
//
// The tree samplers' tally (soft_kernel<kTable, W> for W > 0; the walk's
// counting compiled into these instantiations alone, bvh4.cuh occluded<W,
// true>): each thread of the sample pass counts its live samples (every
// sample of a marked point), its walks' internal nodes expanded and
// triangles tested (as ops/bvh4.py _traverse_plain's stats count them), and
// its list tests; the point pass adds the nodes it expanded, and tallies
// apart (marked points, listed points, triangles kept on them, its nodes
// expanded and triangles tested, points whose walks a path leads).  After a
// grid-stride loop a warp sums each count (__reduce_add_sync), its four
// warps' sums meet in the block's shared memory, and one thread adds the
// block's to the wrapper's int64 tallies (ops/soft.py tree_sampler_counts,
// tree_list_counts): one global add per count and block.
//
// Why the cull changes no count.  u = 2^-24 (kUlp); a triangle is the rows
// MT reads, v0, e1, e2 (floats), N = e1 x e2, n = |N|, a = |e1|, b = |e2|,
// g = ab / n.  Every sample ray the kernel forms from p (sample_ray) has
// its origin o within eo = kShadowEps (1 + 1e-5) + lam of p and its end e =
// o + t_max d within R = (r + 2 kShadowEps)(1 + 1e-5) + lam of c, lam =
// 64 u (|c|_1 + |p|_1 + r + 1): the computed sample point lies within r (1
// + 7u) + 2u (|c| + r) of c while |g| is 0 or a normal float's root
// (Philox's |g| >= 2.4e-4 always is), e within 2 max(0, kShadowEps - |s -
// p|) + 30u (|s - p| + |p| + 1) of it (the second term sums the roundings
// of d, o and t_max; the first is a point within kShadowEps of the sphere,
// whose ray overshoots).  So every ray's segment [o, e] lies in [p, c] (+)
// B(0, R).  Let h(x) = N . (x - v0), L = |p - v0| + |c - v0| + R + 1 (>=
// |o - v0|, t_max).  In exact arithmetic on MT's float inputs, det = -d . N
// and num = h(o), and the floats det_f, num_f, U_f, V_f (the numerators of
// u, v) each lie within 9 u |T| |e1| |e2|-type bounds of the exact ones
// (6 roundings, sqrt(2) from Cauchy-Schwarz; |T| <= L).
//  (a) Plane: h(o) and h(e) of one sign, each beyond H = 64 u L ab.  If
//      det <= 0 (for h > 0), det_f > 0 needs det_f <= 9u ab, so t_f =
//      num_f / det_f >= t_max; if det > 0, h(e) = num - t_max det > H gives
//      num_f (1 - 2u) >= t_max (det + 9u ab) and t_f >= t_max again; a det_f
//      of the other sign gives t_f < 0.  Either way mt_blocks is false (it
//      needs 0 <= t_f < t_max).  H covers 2u L ab + 9u L ab + t_max 9u ab
//      and the test's own rounding of h and n (<= 19 u L ab).  The test:
//      h(p), h(c) of one sign with |h(p)| > n eo + H and |h(c)| > n R + H.
//      A point on the triangle's plane (its own wall) is never culled.
//  (b) Sphere: with sigma = sqrt(64 u g), a ray with |det| >= n sigma that
//      MT accepts (u_f, v_f >= -kBaryEps, u_f + v_f <= 1 + kBaryEps, 0 <=
//      t_f < t_max) crosses the plane at X = o + t d with |u - u_f| a, |v -
//      v_f| b, |t - t_f| summing to at most E = (9/64) sigma (4L + a + b) +
//      4u (a + b + L) (each error over |det| >= n sigma), and X_f = v0 + u_f
//      e1 + v_f e2 lies within 4.04 kBaryEps (a + b) of the triangle, inside
//      the bounding sphere (m, rho).  So dist(m, [p, c]) > rho + 4.04
//      kBaryEps (a + b) + R + E (+ the test's rounding, 64u terms) rules
//      out every such ray.  A ray with |det| < n sigma moves h by less than
//      L n sigma along it, so where |h(p)| > n (eo + L sigma) + H or |h(c)|
//      > n (R + L sigma) + H (the guard), its two ends stay beyond H on one
//      side and (a) rules it out.  (b) culls only under the guard.
// Both tests compare x > y, so a NaN or an infinite margin (a degenerate
// triangle: n = 0) keeps the triangle.  Every bound above carries slack
// (9 over 8.49, 64 over 39, 1e-5 over 7u), which absorbs the rounding of
// the margins themselves.  tests/test_torch_soft_cull.py holds the kernel
// to its twin on cases built to need each margin, and a build with the
// margins negated fails them.
//
// What bounds it on an H100 (counts of utils/roofline.py): per sample ray,
// 104 integer operations of Philox (at 16.7 Tops/s) and 65 FLOPs of
// Box-Muller and sample ray, then the any-hit: up to T Moller-Trumbore tests
// of 68 FLOPs (brute; the lane stops at its first blocker; culled, those of
// its warp's masks: 17.5% of T on the spherical box) or a walk of 159
// FLOPs per 4-wide node visit (75 at W = 2, 345 at W = 8) and 68 per leaf
// triangle (tree).  Bytes are 13 per point in and 4 out, so it is bound by
// operations.  The walk's working set (the teacup's tree, ~0.9 MB at W = 4)
// sits in L1 and L2, and its work is scalar float compares and selects per
// lane: tensor cores, TMA and thread-block clusters have nothing to carry.
// What is left is the issue rate of those instructions (under -fmad=false
// no multiply pairs with an add) and the latency of each dependent node
// load; lanes of a warp that finish early idle until its last lane is done.
// With the point pass (PERF.md, the tree samplers' findings), a listed
// point's sample tests ~2 triangles and an unlisted one walks ~12-20 nodes,
// so the unlisted points' walks take most of the time, and a warp's lanes
// walk ~65% of the time the warp takes; the pass costs about a tenth of
// the sample pass.
#include <cstdint>

#include "bvh4.cuh"

namespace cgrt {

constexpr int kWarp = 32;
constexpr int kSoftThreads = 128;  // threads per block (four warps)
constexpr long long kMaxBlocks = 65536;  // the grid-stride loop takes the rest
constexpr float kTwoPi = 6.283185307179586f;
constexpr int kCullMinSamples = 6;  // the brute sweep culls per point from this many samples on
constexpr float kUlp = 5.9604645e-8f;  // 2^-24, float's unit roundoff
constexpr int kListMax = 16;  // K: a point whose hull keeps more triangles walks the tree

struct SoftArgs {
  const float* pos;  // [N, 3] shading points
  const int* order;  // [N + 1] the points to sample first (ops/soft.py _compact), or null (all N)
  const int* count;  // [1] how many of order to sample (read on the card)
  int n;
  const float* light;  // [4] center, radius
  int num_samples;
  const unsigned* key;  // [2] the light's key words (k0, k1) on the card; null for a table
  unsigned offset;      // the batch's first global point index
  const float* gauss;       // table variant: [N, S, 3]
  int* counts;              // [N]
};

// What the sampler sweeps or walks.
struct SoftScene {
  const float* __restrict__ tris;  // brute: [T, 9] v0, v1, v2
  int num_tris;                    // brute
  Tree tree;                       // tree: its records (bvh4.cuh)
  // brute: [2] += (tests kept, tests of full sweeps); tree: [3] += (live
  // samples, internal nodes expanded, triangle tests); or null
  unsigned long long* tally;
  // tree: the point pass's output, per marked point j (order's j-th): the
  // triangles its hull keeps, in the order the pass met them, each as its
  // row and its leaf's entry ([N, 2 kListMax]), and how many; or, where it
  // keeps more than kListMax and its samples walk, -1 - L, with the first L
  // entries of its probe's path in the list (L = 0: none)
  int* lists;
  int* kept;
  // tree: [num_nodes], written by the point pass: up[n] = W * parent + slot
  // of node n > 0 (reaches)
  int* up;
  int num_nodes;
  // tree: [6] += (marked points, listed points, triangles kept on listed
  // points, the point pass's nodes expanded and triangles tested, points
  // whose walks a path leads); or null
  unsigned long long* list_tally;
};

// Philox4x32-10 (Salmon et al., SC'11), as curand_Philox4x32_10; each
// round's two 32 x 32 -> 64-bit products as one wide multiply each.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0, unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned long long p0 = static_cast<unsigned long long>(c.x) * 0xD2511F53u;
    const unsigned long long p1 = static_cast<unsigned long long>(c.z) * 0xCD9E8D57u;
    c = make_uint4(static_cast<unsigned>(p1 >> 32) ^ c.y ^ k0, static_cast<unsigned>(p1),
                   static_cast<unsigned>(p0 >> 32) ^ c.w ^ k1, static_cast<unsigned>(p0));
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ float u01(unsigned bits) {
  return static_cast<float>(bits & 0xFFFFFFu) * (1.0f / 16777216.0f) + (0.5f / 16777216.0f);
}

// Box-Muller.  sincosf gives the bits of sinf and cosf of the same argument
// (chip_smoke.py checks every value u01 can take).
__device__ __forceinline__ void gauss3(uint4 b, float& gx, float& gy, float& gz) {
  const float u1 = u01(b.x), u2 = u01(b.y), u3 = u01(b.z), u4 = u01(b.w);
  const float r1 = sqrtf(-2.0f * logf(u1));
  const float r2 = sqrtf(-2.0f * logf(u3));
  float s2, c2;
  sincosf(kTwoPi * u2, &s2, &c2);
  gx = r1 * c2;
  gy = r1 * s2;
  gz = r2 * cosf(kTwoPi * u4);
}

// Shadow ray from p toward the light's sample point for the Gaussian g.
__device__ __forceinline__ Ray sample_ray(float px, float py, float pz, float gx, float gy,
                                          float gz, const float* l, float& t_max) {
  const float inv = 1.0f / fmaxf(sqrtf(gx * gx + gy * gy + gz * gz), kNormEps);
  const float sx = l[0] + l[3] * (gx * inv);
  const float sy = l[1] + l[3] * (gy * inv);
  const float sz = l[2] + l[3] * (gz * inv);
  const float tx = sx - px, ty = sy - py, tz = sz - pz;
  const float invd = 1.0f / fmaxf(sqrtf(tx * tx + ty * ty + tz * tz), kNormEps);
  const float dx = tx * invd, dy = ty * invd, dz = tz * invd;
  const float ox = px + kShadowEps * dx, oy = py + kShadowEps * dy, oz = pz + kShadowEps * dz;
  const float ex = sx - ox, ey = sy - oy, ez = sz - oz;
  t_max = sqrtf(ex * ex + ey * ey + ez * ez);
  return Ray{ox, oy, oz, dx, dy, dz};
}

// Sample s of point i (at p): its Gaussian from the table or the stream,
// then the sample ray.
template <bool kTable>
__device__ __forceinline__ Ray sample_of(const SoftArgs& a, int i, int s, float px, float py,
                                         float pz, unsigned k0, unsigned k1, float& tm) {
  float gx, gy, gz;
  if (kTable) {
    const float* g = a.gauss + 3 * (static_cast<size_t>(i) * a.num_samples + s);
    gx = g[0], gy = g[1], gz = g[2];
  } else {
    const uint4 ctr = make_uint4(a.offset + static_cast<unsigned>(i), static_cast<unsigned>(s),
                                 0u, 0u);
    gauss3(philox4x32_10(ctr, k0, k1), gx, gy, gz);
  }
  return sample_ray(px, py, pz, gx, gy, gz, a.light, tm);
}

// Whether the any-hit walk of the ray r over [0, t_max) enters the leaf
// entry e = ~(W * node + slot): expand's test of e's box in its node's
// record, then of each node's own box in its parent's (up), up to the
// root, which every walk expands.  The walk enters a node exactly where it
// enters its parent and the node's box passes this test (the test reads
// nothing else), and it expands every node it enters until it meets a
// blocker; so a triangle of e's leaf that blocks the ray makes the walk's
// answer true.
template <int W>
__device__ __forceinline__ bool reaches(const Tree& tr, const int* up, int e, const Ray& r,
                                        float t_max) {
  const float ix = 1.0f / r.dx, iy = 1.0f / r.dy, iz = 1.0f / r.dz;
  const float bound = padded(t_max);
  unsigned s = static_cast<unsigned>(~e);
  for (;;) {
    const unsigned n = s / W, c = s % W;
    const float* b = reinterpret_cast<const float*>(tr.nodes + 2 * W * n) + c;
    const float t0x = (__ldg(b) - r.ox) * ix, t0y = (__ldg(b + W) - r.oy) * iy;
    const float t0z = (__ldg(b + 2 * W) - r.oz) * iz;
    const float t1x = (__ldg(b + 3 * W) - r.ox) * ix;
    const float t1y = (__ldg(b + 4 * W) - r.oy) * iy;
    const float t1z = (__ldg(b + 5 * W) - r.oz) * iz;
    const float tin = max_nan(max_nan(min_nan(t0x, t1x), min_nan(t0y, t1y)), min_nan(t0z, t1z));
    const float tout = min_nan(min_nan(max_nan(t0x, t1x), max_nan(t0y, t1y)), max_nan(t0z, t1z));
    const float pad = kSlabEps * (1.0f + fabsf(tout));
    if (!(tin <= tout + pad && tout >= -pad && tin <= bound)) return false;
    if (n == 0u) return true;
    s = static_cast<unsigned>(__ldg(up + n));
  }
}

// Whether sample s of point i (at p) reaches the light l: an any-hit sweep
// of the staged triangles or an any-hit walk of the tree, its first descent
// led by path[0..len), whose work is added to *walks.
template <bool kTable, int W>
__device__ __forceinline__ bool sample_visible(const SoftArgs& a, const SoftScene& sc,
                                               const float4* s_tri, int i, int s, float px,
                                               float py, float pz, unsigned k0, unsigned k1,
                                               WalkCount* walks, const int* path = nullptr,
                                               int len = 0) {
  float tm;
  const Ray r = sample_of<kTable>(a, i, s, px, py, pz, k0, k1, tm);
  if (!(tm > 0.0f)) return true;
  if constexpr (W > 0) {
    return !occluded<W, true>(sc.tree, r, tm, walks, path, len);
  } else {
    return !any_hit_sweep(s_tri, sc.num_tris, r, tm);
  }
}

// The cull's per-triangle terms, three float4 rows beside the triangle's
// three (from the rows this thread staged: stage_rows3's stride): (N, n),
// (m, rho+: the bounding sphere about the centroid grown by the margins
// that depend on the triangle alone), (h(c), |c - v0|, ab, sigma).
__device__ __forceinline__ void stage_cull(const float4* s_tri, int num_tris, const float* l,
                                           float4* s_cull) {
  for (int k = threadIdx.x; k < num_tris; k += blockDim.x) {
    float4 v0, e1, e2;
    tri_rows(s_tri, k, v0, e1, e2);
    const float nx = e1.y * e2.z - e1.z * e2.y;
    const float ny = e1.z * e2.x - e1.x * e2.z;
    const float nz = e1.x * e2.y - e1.y * e2.x;
    const float n = sqrtf(nx * nx + ny * ny + nz * nz);
    const float ea = sqrtf(e1.x * e1.x + e1.y * e1.y + e1.z * e1.z);
    const float eb = sqrtf(e2.x * e2.x + e2.y * e2.y + e2.z * e2.z);
    const float ab = ea * eb;
    const float sigma = sqrtf(64.0f * kUlp * (ab / n));
    const float gx = (e1.x + e2.x) / 3.0f, gy = (e1.y + e2.y) / 3.0f, gz = (e1.z + e2.z) / 3.0f;
    const float r0 = sqrtf(gx * gx + gy * gy + gz * gz);
    const float r1 = sqrtf((gx - e1.x) * (gx - e1.x) + (gy - e1.y) * (gy - e1.y) +
                           (gz - e1.z) * (gz - e1.z));
    const float r2 = sqrtf((gx - e2.x) * (gx - e2.x) + (gy - e2.y) * (gy - e2.y) +
                           (gz - e2.z) * (gz - e2.z));
    const float rho = fmaxf(r0, fmaxf(r1, r2));
    const float mx = v0.x + gx, my = v0.y + gy, mz = v0.z + gz;
    const float rho_plus = rho + (4.04f * kBaryEps + 0.140625f * sigma + 4.0f * kUlp) * (ea + eb) +
                           32.0f * kUlp * (fabsf(mx) + fabsf(my) + fabsf(mz) + rho + 1.0f);
    const float cx = l[0] - v0.x, cy = l[1] - v0.y, cz = l[2] - v0.z;
    s_cull[3 * k] = make_float4(nx, ny, nz, n);
    s_cull[3 * k + 1] = make_float4(mx, my, mz, rho_plus);
    s_cull[3 * k + 2] = make_float4(nx * cx + ny * cy + nz * cz,
                                    sqrtf(cx * cx + cy * cy + cz * cz), ab, sigma);
  }
}

// Whether triangle k may block a sample ray of the point p toward the light
// l: false only where test (a) or (b) of the header proves mt_blocks false
// for every sample ray the kernel forms from p.
__device__ __forceinline__ bool may_block(const float4* s_tri, const float4* s_cull, int k,
                                          float px, float py, float pz, const float* l) {
  const float4 v0 = s_tri[3 * k];
  const float4 nn = s_cull[3 * k];
  const float4 sp = s_cull[3 * k + 1];
  const float4 cc = s_cull[3 * k + 2];
  const float cx = l[0], cy = l[1], cz = l[2], r = l[3];
  const float lam = 64.0f * kUlp *
                    (fabsf(px) + fabsf(py) + fabsf(pz) + fabsf(cx) + fabsf(cy) + fabsf(cz) + r +
                     1.0f);
  const float eo = kShadowEps * 1.00001f + lam;
  const float big_r = (r + 2.0f * kShadowEps) * 1.00001f + lam;
  const float dx = px - v0.x, dy = py - v0.y, dz = pz - v0.z;
  const float len = sqrtf(dx * dx + dy * dy + dz * dz) + cc.y + big_r + 1.0f;
  const float h_mt = 64.0f * kUlp * len * cc.z;
  const float hp = nn.x * dx + nn.y * dy + nn.z * dz;
  const float hc = cc.x;
  const float mp = nn.w * eo + h_mt;
  const float mc = nn.w * (big_r - r) + h_mt;
  const float far_c = nn.w * r + mc;
  if ((hp > mp && hc > far_c) || (hp < -mp && hc < -far_c)) return false;
  const float graze = nn.w * len * cc.w;
  if (!(fabsf(hp) > mp + graze || fabsf(hc) > far_c + graze)) return true;
  const float wx = cx - px, wy = cy - py, wz = cz - pz;
  const float vx = sp.x - px, vy = sp.y - py, vz = sp.z - pz;
  const float ww = wx * wx + wy * wy + wz * wz;
  const float tt = ww > 0.0f ? fminf(fmaxf((vx * wx + vy * wy + vz * wz) / ww, 0.0f), 1.0f) : 0.0f;
  const float qx = vx - tt * wx, qy = vy - tt * wy, qz = vz - tt * wz;
  const float ms = (big_r - r) + lam + len * (0.5625f * cc.w + 4.0f * kUlp);
  return !(sqrtf(qx * qx + qy * qy + qz * qz) > sp.w + r + ms);
}

// any_hit_sweep over the triangles set in the OR of the masks of the
// block's points lo..hi (words 32-bit words each), lowest index first.
__device__ __forceinline__ bool any_hit_masked(const float4* s_tri, const unsigned* mask, int lo,
                                               int hi, int words, const Ray& r, float t_max) {
  for (int w = 0; w < words; ++w) {
    unsigned bits = 0u;
    for (int q = lo; q <= hi; ++q) bits |= mask[q * words + w];
    while (bits != 0u) {
      float4 v0, e1, e2;
      tri_rows(s_tri, 32 * w + __ffs(bits) - 1, v0, e1, e2);
      bits &= bits - 1u;
      if (mt_blocks(v0, e1, e2, r, t_max)) return true;
    }
  }
  return false;
}

// The points of one grid-stride iteration that a block's masks cover.
__host__ __device__ __forceinline__ int cull_span(int num_samples) {
  return (kSoftThreads - 1 + num_samples - 1) / num_samples + 1;
}

// The brute sampler culled per point (kCullMinSamples samples or more).
// Dynamic shared memory: the rows [3T] float4, the cull rows [3T] float4,
// the block's tally [2] uint64, three mask buffers of cull_span(S) x words.
template <bool kTable>
__device__ __forceinline__ void cull_body(const SoftArgs& a, const SoftScene& sc,
                                          float4* s_mem) {
  const int nt = sc.num_tris, ns = a.num_samples;
  const long long points = a.order != nullptr ? *a.count : a.n;
  const long long total = points * ns;
  // The grid follows n, not the count read here: a block past the marked
  // points' samples has nothing to stage (a bounce level marks few points).
  if (static_cast<long long>(blockIdx.x) * blockDim.x >= total) return;
  const int words = (nt + 31) / 32, buffer = cull_span(ns) * words;
  float4* s_cull = s_mem + 3 * nt;
  unsigned long long* s_tally = reinterpret_cast<unsigned long long*>(s_mem + 6 * nt);
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_tally + 2);
  stage_rows3(sc.tris, nt, s_mem);
  stage_cull(s_mem, nt, a.light, s_cull);
  for (int q = threadIdx.x; q < buffer; q += blockDim.x) s_mask[q] = 0u;
  if (threadIdx.x < 2) s_tally[threadIdx.x] = 0ull;
  __syncthreads();
  unsigned k0 = 0u, k1 = 0u;
  if (!kTable) {
    k0 = a.key[0];
    k1 = a.key[1];
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // The block's first sample t0 = point j0, sample rem0, carried from one
  // iteration to the next by the stride's quotient and remainder.
  long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x;
  long long j0 = t0 / ns;
  int rem0 = static_cast<int>(t0 - j0 * ns);
  const long long step_j = stride / ns;
  const int step_rem = static_cast<int>(stride - step_j * ns);
  unsigned kept = 0u, live = 0u;
  // t0 is the same for the whole block, so every thread reaches the
  // barrier and every lane the warp votes.
  for (int n = 0; t0 < total; ++n) {
    const int last = static_cast<int>(total - 1 - t0 < blockDim.x - 1 ? total - 1 - t0
                                                                      : blockDim.x - 1);
    unsigned* mask = s_mask + (n % 3) * buffer;
    unsigned* next = s_mask + ((n + 1) % 3) * buffer;
    for (int q = threadIdx.x; q < buffer; q += blockDim.x) next[q] = 0u;
    const int pairs = ((rem0 + last) / ns + 1) * nt;
    for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
      const int pl = q / nt, k = q - pl * nt;
      const long long j = j0 + pl;
      const int i = a.order != nullptr ? a.order[j] : static_cast<int>(j);
      if (may_block(s_mem, s_cull, k, a.pos[3 * i], a.pos[3 * i + 1], a.pos[3 * i + 2],
                    a.light)) {
        atomicOr(&mask[pl * words + k / 32], 1u << (k % 32));
      }
    }
    __syncthreads();
    int i = -1;
    bool visible = false;
    if (static_cast<int>(threadIdx.x) <= last) {
      const int pl = (rem0 + static_cast<int>(threadIdx.x)) / ns;
      const int s = rem0 + static_cast<int>(threadIdx.x) - pl * ns;
      i = a.order != nullptr ? a.order[j0 + pl] : static_cast<int>(j0 + pl);
      float tm;
      const Ray r = sample_of<kTable>(a, i, s, a.pos[3 * i], a.pos[3 * i + 1], a.pos[3 * i + 2],
                                      k0, k1, tm);
      ++live;
      // The points of this warp's live lanes.
      const int lane0 = static_cast<int>(threadIdx.x) & ~(kWarp - 1);
      const int lo = (rem0 + lane0) / ns;
      const int hi = (rem0 + (lane0 + kWarp - 1 < last ? lane0 + kWarp - 1 : last)) / ns;
      for (int w = 0; w < words; ++w) {
        unsigned bits = 0u;
        for (int q = lo; q <= hi; ++q) bits |= mask[q * words + w];
        kept += __popc(bits);
      }
      visible = !(tm > 0.0f) || !any_hit_masked(s_mem, mask, lo, hi, words, r, tm);
    }
    const unsigned same = __match_any_sync(0xFFFFFFFFu, i);
    const int count = __popc(__ballot_sync(0xFFFFFFFFu, visible) & same);
    if (i >= 0 && count > 0 && threadIdx.x % kWarp == __ffs(same) - 1) {
      atomicAdd(&a.counts[i], count);
    }
    t0 += stride;
    j0 += step_j;
    rem0 += step_rem;
    if (rem0 >= ns) {
      rem0 -= ns;
      ++j0;
    }
  }
  if (sc.tally != nullptr) {
    // A warp's sums first, so that a block adds four times into its shared
    // pair: 128 conflicting adds a block cost the box's frame ~1 ms (PERF.md).
    const unsigned warp_kept = __reduce_add_sync(0xFFFFFFFFu, kept);
    const unsigned warp_live = __reduce_add_sync(0xFFFFFFFFu, live);
    if (threadIdx.x % kWarp == 0 && warp_live != 0u) {
      atomicAdd(&s_tally[0], static_cast<unsigned long long>(warp_kept));
      atomicAdd(&s_tally[1], static_cast<unsigned long long>(warp_live) * nt);
    }
    __syncthreads();
    if (threadIdx.x == 0 && s_tally[1] != 0ull) {
      atomicAdd(&sc.tally[0], s_tally[0]);
      atomicAdd(&sc.tally[1], s_tally[1]);
    }
  }
}

// The tally of sweeps over every triangle: T tests kept and swept per
// sample of the block's grid-stride iterations (thread 0, after them).
__device__ __forceinline__ void tally_full_sweeps(const SoftScene& sc, long long total) {
  if (sc.tally == nullptr || threadIdx.x != 0) return;
  unsigned long long samples = 0ull;
  for (long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x; t0 < total;
       t0 += static_cast<long long>(gridDim.x) * blockDim.x) {
    samples += total - t0 < blockDim.x ? total - t0 : blockDim.x;
  }
  if (samples != 0ull) {
    atomicAdd(&sc.tally[0], samples * sc.num_tris);
    atomicAdd(&sc.tally[1], samples * sc.num_tris);
  }
}

// The warp's sum of x, exact for any 32-bit x: its two 16-bit halves
// summed apart (every lane takes part).
__device__ __forceinline__ unsigned long long warp_sum(unsigned x) {
  const unsigned lo = __reduce_add_sync(0xFFFFFFFFu, x & 0xFFFFu);
  const unsigned hi = __reduce_add_sync(0xFFFFFFFFu, x >> 16);
  return static_cast<unsigned long long>(lo) + (static_cast<unsigned long long>(hi) << 16);
}

// The block's sums of each thread's x[c], called by every thread of the
// block after its loop: each warp's sums staged in s_warps ([warps][N]: the
// launch's dynamic shared memory), then one global add into *dst[c] by
// thread 0 for each sum that is not 0 and each dst[c] that is not null.
template <int N>
__device__ __forceinline__ void add_block_sums(const unsigned (&x)[N],
                                               unsigned long long* const* dst,
                                               unsigned long long* s_warps) {
  unsigned long long sums[N];
  for (int c = 0; c < N; ++c) sums[c] = warp_sum(x[c]);
  if (threadIdx.x % kWarp == 0) {
    for (int c = 0; c < N; ++c) s_warps[N * (threadIdx.x / kWarp) + c] = sums[c];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int c = 0; c < N; ++c) {
    unsigned long long block = 0ull;
    for (int w = 0; w < kSoftThreads / kWarp; ++w) block += s_warps[N * w + c];
    if (block != 0ull && dst[c] != nullptr) atomicAdd(dst[c], block);
  }
}

// ---------------------------------------------------------------------------
// The tree samplers' per-point lists (the header's point pass and sample pass).
// ---------------------------------------------------------------------------

// A point's hull: the convex hull of B(p, eo) and B(c, R) (the header's eo,
// R, lam), and the frame of its axis.
struct Hull {
  float px, py, pz, cx, cy, cz, r;
  float lam, eo, big_r;
  float wx, wy, wz, h;  // the unit axis from p toward c, and |c - p|
  float b, a;           // the taper: b = (eo - R) / h, a = sqrt(1 - b^2)
};

__device__ __forceinline__ Hull make_hull(float px, float py, float pz, const float* l) {
  Hull hl;
  hl.px = px, hl.py = py, hl.pz = pz;
  hl.cx = l[0], hl.cy = l[1], hl.cz = l[2], hl.r = l[3];
  hl.lam = 64.0f * kUlp *
           (fabsf(px) + fabsf(py) + fabsf(pz) + fabsf(hl.cx) + fabsf(hl.cy) + fabsf(hl.cz) +
            hl.r + 1.0f);
  hl.eo = kShadowEps * 1.00001f + hl.lam;
  hl.big_r = (hl.r + 2.0f * kShadowEps) * 1.00001f + hl.lam;
  const float wx = hl.cx - px, wy = hl.cy - py, wz = hl.cz - pz;
  hl.h = sqrtf(wx * wx + wy * wy + wz * wz);
  hl.wx = wx / hl.h, hl.wy = wy / hl.h, hl.wz = wz / hl.h;
  hl.b = (hl.eo - hl.big_r) / hl.h;
  hl.a = sqrtf(1.0f - hl.b * hl.b);
  return hl;
}

// The distance from x to the hull (a round cone: disks of radius eo + (R -
// eo) s / h along the axis), in the axis frame; NaN where the hull has no
// frame (h = 0, or h <= R - eo), which every test below reads as near.
__device__ __forceinline__ float hull_dist(const Hull& hl, float x, float y, float z) {
  const float vx = x - hl.px, vy = y - hl.py, vz = z - hl.pz;
  const float ax = vx * hl.wx + vy * hl.wy + vz * hl.wz;
  const float qx = vx - ax * hl.wx, qy = vy - ax * hl.wy, qz = vz - ax * hl.wz;
  const float rad = sqrtf(qx * qx + qy * qy + qz * qz);
  const float k = hl.a * ax - hl.b * rad;
  if (k < 0.0f) return sqrtf(rad * rad + ax * ax) - hl.eo;
  if (k > hl.a * hl.h) {
    const float z1 = ax - hl.h;
    return sqrtf(rad * rad + z1 * z1) - hl.big_r;
  }
  return hl.a * rad + hl.b * ax - hl.eo;
}

// How far past the hull a box may lie and still be entered by the walk of a
// sample ray (the header's M).
__device__ __forceinline__ float box_reach(const Hull& hl) {
  return 3.0f * kSlabEps * (1.0f + hl.h + hl.big_r + hl.eo);
}

// Whether the walk of a sample ray of the point may enter the box [lo, hi]
// (false for an absent slot's NaN box): false only where the box's bounding
// sphere lies beyond reach of the hull, or the box beyond reach of the
// hull's axis-aligned box.
__device__ __forceinline__ bool box_near(const Hull& hl, float reach, float lox, float loy,
                                         float loz, float hix, float hiy, float hiz) {
  if (!(lox <= hix)) return false;
  const float g = reach + hl.lam;
  if (hix < fminf(hl.px - hl.eo, hl.cx - hl.big_r) - g ||
      lox > fmaxf(hl.px + hl.eo, hl.cx + hl.big_r) + g ||
      hiy < fminf(hl.py - hl.eo, hl.cy - hl.big_r) - g ||
      loy > fmaxf(hl.py + hl.eo, hl.cy + hl.big_r) + g ||
      hiz < fminf(hl.pz - hl.eo, hl.cz - hl.big_r) - g ||
      loz > fmaxf(hl.pz + hl.eo, hl.cz + hl.big_r) + g)
    return false;
  const float ex = hix - lox, ey = hiy - loy, ez = hiz - loz;
  const float qx = lox + 0.5f * ex, qy = loy + 0.5f * ey, qz = loz + 0.5f * ez;
  const float rho = 0.5f * sqrtf(ex * ex + ey * ey + ez * ez);
  const float slack = 64.0f * kUlp * (fabsf(qx) + fabsf(qy) + fabsf(qz) + rho + 1.0f);
  return !(hull_dist(hl, qx, qy, qz) > rho + reach + hl.lam + slack);
}

// Whether the triangle (v0, e1, e2) may block a sample ray of the point:
// false only where test (a), (a') or (b') of the header proves mt_blocks
// false for every sample ray the kernel forms from p.
__device__ __forceinline__ bool may_block_tree(const Hull& hl, const float4 v0, const float4 e1,
                                               const float4 e2) {
  const float nx = e1.y * e2.z - e1.z * e2.y;
  const float ny = e1.z * e2.x - e1.x * e2.z;
  const float nz = e1.x * e2.y - e1.y * e2.x;
  const float n = sqrtf(nx * nx + ny * ny + nz * nz);
  const float ea = sqrtf(e1.x * e1.x + e1.y * e1.y + e1.z * e1.z);
  const float eb = sqrtf(e2.x * e2.x + e2.y * e2.y + e2.z * e2.z);
  const float ab = ea * eb;
  const float dx = hl.px - v0.x, dy = hl.py - v0.y, dz = hl.pz - v0.z;
  const float cx = hl.cx - v0.x, cy = hl.cy - v0.y, cz = hl.cz - v0.z;
  const float len = sqrtf(dx * dx + dy * dy + dz * dz) + sqrtf(cx * cx + cy * cy + cz * cz) +
                    hl.big_r + 1.0f;
  const float h_mt = 64.0f * kUlp * len * ab;
  const float hp = nx * dx + ny * dy + nz * dz;
  const float hc = nx * cx + ny * cy + nz * cz;
  const float near_p = n * hl.eo + h_mt;
  const float far_c = n * hl.r + (n * (hl.big_r - hl.r) + h_mt);
  // (a)
  if ((hp > near_p && hc > far_c) || (hp < -near_p && hc < -far_c)) return false;
  // (a'): the origins move kShadowEps toward a sphere on one side.
  const float den = hl.h + hl.big_r;
  const float off = n * (hl.eo - kShadowEps) + h_mt;
  const float gap_hi = hc - far_c - hp, gap_lo = hp - far_c - hc;
  if (hc > far_c && gap_hi > 0.0f && hp + 0.99999f * kShadowEps * gap_hi / den > off) return false;
  if (hc < -far_c && gap_lo > 0.0f && 0.99999f * kShadowEps * gap_lo / den - hp > off)
    return false;
  // (b') under the guard.
  const float sigma = sqrtf(64.0f * kUlp * (ab / n));
  const float graze = n * len * sigma;
  if (!(fabsf(hp) > near_p + graze || fabsf(hc) > far_c + graze)) return true;
  const float gx = (e1.x + e2.x) / 3.0f, gy = (e1.y + e2.y) / 3.0f, gz = (e1.z + e2.z) / 3.0f;
  const float r0 = sqrtf(gx * gx + gy * gy + gz * gz);
  const float r1 = sqrtf((gx - e1.x) * (gx - e1.x) + (gy - e1.y) * (gy - e1.y) +
                         (gz - e1.z) * (gz - e1.z));
  const float r2 = sqrtf((gx - e2.x) * (gx - e2.x) + (gy - e2.y) * (gy - e2.y) +
                         (gz - e2.z) * (gz - e2.z));
  const float rho = fmaxf(r0, fmaxf(r1, r2));
  const float mx = v0.x + gx, my = v0.y + gy, mz = v0.z + gz;
  const float rho_plus = rho + (4.04f * kBaryEps + 0.140625f * sigma + 4.0f * kUlp) * (ea + eb) +
                         64.0f * kUlp * (fabsf(mx) + fabsf(my) + fabsf(mz) + rho + 1.0f);
  return !(hull_dist(hl, mx, my, mz) >
           rho_plus + hl.lam + len * (0.5625f * sigma + 4.0f * kUlp));
}

// The point pass's probe of an unlisted point: the nearest-first any-hit
// walk of the ray from p toward the light's centre (sample_ray of the
// Gaussian 0), counted into *count, that keeps the entries of its path
// from the root (each stack entry carries its depth).  Where it meets a
// blocker, the first kListMax entries of the path to the blocker's leaf go
// to path, and their number is returned; 0 where nothing blocks the ray.
template <int W>
__device__ __forceinline__ int probe_path(const Tree& tr, float px, float py, float pz,
                                          const float* light, int* path, WalkCount* count) {
  float t_max;
  const Ray r = sample_ray(px, py, pz, 0.0f, 0.0f, 0.0f, light, t_max);
  if (!(t_max > 0.0f)) return 0;
  const float ix = 1.0f / r.dx, iy = 1.0f / r.dy, iz = 1.0f / r.dz;
  const float bound = padded(t_max);
  int trail[kListMax];
  int stack[kStack], depths[kStack];
  int sp = 0, ref = 0, depth = 0;  // the entry ref lies depth steps below the root
  for (;;) {
    if (ref >= 0) {
      ++count->visits;
      float ts[W];
      int es[W];
      expand<W>(tr, ref, r, ix, iy, iz, bound, ts, es);
      ++depth;
#pragma unroll
      for (int c = 0; c < W - 1; ++c) {
        if (ts[c] < kBig) {
          stack[sp] = es[c];
          depths[sp] = depth;
          ++sp;
        }
      }
      if (ts[W - 1] < kBig) {
        ref = es[W - 1];
        if (depth <= kListMax) trail[depth - 1] = ref;
        continue;
      }
    } else {
      int first, end;
      leaf_rows<W>(tr, ref, first, end);
      for (int k = first; k < end; ++k) {
        ++count->tests;
        const float4* row = tr.rows + 3 * k;
        if (mt_blocks(__ldg(row), __ldg(row + 1), __ldg(row + 2), r, t_max)) {
          const int len = depth < kListMax ? depth : kListMax;
          for (int q = 0; q < len; ++q) path[q] = trail[q];
          return len;
        }
      }
    }
    if (sp == 0) return 0;
    --sp;
    ref = stack[sp];
    depth = depths[sp];
    if (depth <= kListMax) trail[depth - 1] = ref;
  }
}

// The point pass (soft_kernel<false, W, true>): one thread per marked point
// walks the tree once against its hull (a node's entered children pushed in
// slot order, the last pushed walked first) and lists the triangles
// may_block_tree keeps in the leaves whose boxes box_near lets it enter, in
// the order it meets them (kept: how many).  The (kListMax + 1)-th kept
// ends the walk, and the point's samples walk the tree, led by the path of
// the point's probe (kept -1 - the path's length; -1: no path).
template <int W>
__device__ __forceinline__ void list_body(const SoftArgs& a, const SoftScene& sc,
                                          float4* s_mem) {
  const long long points = a.order != nullptr ? *a.count : a.n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first_j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // up, for the sample pass's reaches: each node's internal children.
  for (long long q = first_j; q < sc.num_nodes; q += stride) {
    const float* rec = reinterpret_cast<const float*>(sc.tree.nodes + 2 * W * q);
    for (int c = 0; c < W; ++c) {
      if (rec[c] == rec[c] && __float_as_int(rec[7 * W + c]) == 0) {
        sc.up[__float_as_int(rec[6 * W + c])] = static_cast<int>(W * q + c);
      }
    }
  }
  unsigned marked = 0u, listed = 0u, kept_sum = 0u, led = 0u;
  WalkCount pass;
  for (long long j = first_j; j < points; j += stride) {
    const int i = a.order != nullptr ? a.order[j] : static_cast<int>(j);
    const float px = a.pos[3 * i], py = a.pos[3 * i + 1], pz = a.pos[3 * i + 2];
    const Hull hl = make_hull(px, py, pz, a.light);
    const float reach = box_reach(hl);
    int* list = sc.lists + 2 * kListMax * j;
    int kept = 0;
    int stack[kStack];
    int sp = 0, ref = 0;
    for (;;) {
      if (ref >= 0) {
        ++pass.visits;
        float rec[8 * W];
        const float4* node = sc.tree.nodes + 2 * W * ref;
#pragma unroll
        for (int k = 0; k < 2 * W; ++k) {
          const float4 q = __ldg(node + k);
          rec[4 * k] = q.x;
          rec[4 * k + 1] = q.y;
          rec[4 * k + 2] = q.z;
          rec[4 * k + 3] = q.w;
        }
#pragma unroll
        for (int c = 0; c < W; ++c) {
          if (box_near(hl, reach, rec[c], rec[W + c], rec[2 * W + c], rec[3 * W + c],
                       rec[4 * W + c], rec[5 * W + c])) {
            stack[sp] = __float_as_int(rec[7 * W + c]) > 0 ? ~(W * ref + c)
                                                           : __float_as_int(rec[6 * W + c]);
            ++sp;
          }
        }
      } else {
        int first, end;
        leaf_rows<W>(sc.tree, ref, first, end);
        for (int k = first; k < end && kept <= kListMax; ++k) {
          ++pass.tests;
          const float4* row = sc.tree.rows + 3 * k;
          if (!may_block_tree(hl, __ldg(row), __ldg(row + 1), __ldg(row + 2))) continue;
          if (kept < kListMax) {
            list[2 * kept] = k;
            list[2 * kept + 1] = ref;
          }
          ++kept;
        }
        if (kept > kListMax) break;
      }
      if (sp == 0) break;
      --sp;
      ref = stack[sp];
    }
    ++marked;
    if (kept <= kListMax) {
      ++listed;
      kept_sum += static_cast<unsigned>(kept);
      sc.kept[j] = kept;
    } else {
      const int len = probe_path<W>(sc.tree, px, py, pz, a.light, list, &pass);
      led += len > 0 ? 1u : 0u;
      sc.kept[j] = -1 - len;
    }
  }
  // The list tally, and the pass's nodes into the tree tally's visits.
  const unsigned x[7] = {marked, listed, kept_sum, pass.visits, pass.tests, led, pass.visits};
  unsigned long long* dst[7];
  for (int c = 0; c < 6; ++c) dst[c] = sc.list_tally != nullptr ? sc.list_tally + c : nullptr;
  dst[6] = sc.tally != nullptr ? sc.tally + 1 : nullptr;
  add_block_sums<7>(x, dst, reinterpret_cast<unsigned long long*>(s_mem));
}

// Whether sample s of the listed point i reaches the light: the any-hit
// test of its listed triangles, in order, each that blocks the ray taken
// where the walk reaches its leaf (the header).
template <bool kTable, int W>
__device__ __forceinline__ bool list_visible(const SoftArgs& a, const SoftScene& sc,
                                             const int* list, int kept, int i, int s, float px,
                                             float py, float pz, unsigned k0, unsigned k1,
                                             WalkCount* walks) {
  float tm;
  const Ray r = sample_of<kTable>(a, i, s, px, py, pz, k0, k1, tm);
  if (!(tm > 0.0f)) return true;
  for (int q = 0; q < kept; ++q) {
    ++walks->tests;
    const float4* row = sc.tree.rows + 3 * __ldg(list + 2 * q);
    if (mt_blocks(__ldg(row), __ldg(row + 1), __ldg(row + 2), r, tm) &&
        reaches<W>(sc.tree, sc.up, __ldg(list + 2 * q + 1), r, tm)) {
      return false;
    }
  }
  return true;
}

// The port's layout: one thread per (point, sample), point-major.  A warp
// adds its visible count per point (__match_any_sync groups its lanes by
// point, at most two points for S >= 32) into counts, which start at 0.
// W: the tree's node width (dynamic shared memory: the tally's warp sums),
// 0 for the brute sweep of the staged table (dynamic shared memory: its
// triangles, three float4 rows each).  With
// order, the grid strides over the count points it lists first (the count
// is read here, so the wrapper never waits for the card), and no thread is
// spent on a point that missed.
template <bool kTable, int W>
__device__ __forceinline__ void sample_body(const SoftArgs& a, const SoftScene& sc,
                                            float4* s_mem) {
  if (W == 0) {
    stage_rows3(sc.tris, sc.num_tris, s_mem);
    __syncthreads();
  }
  unsigned k0 = 0u, k1 = 0u;
  if (!kTable) {
    k0 = a.key[0];
    k1 = a.key[1];
  }
  const long long points = a.order != nullptr ? *a.count : a.n;
  const long long total = points * a.num_samples;
  unsigned live = 0u;  // the tree samplers' tally: live samples and their walks' work
  WalkCount walks;
  // t0 is the same for the whole block, so every lane reaches the warp votes.
  for (long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x; t0 < total;
       t0 += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long t = t0 + threadIdx.x;
    int i = -1, j = 0;
    if (t < total) {
      j = static_cast<int>(t / a.num_samples);
      i = a.order != nullptr ? a.order[j] : j;
    }
    bool visible = false;
    if (i >= 0) {
      const int s = static_cast<int>(t % a.num_samples);
      if constexpr (W > 0) {
        ++live;
        const int kept = sc.kept[j];
        const int* list = sc.lists + static_cast<size_t>(2 * kListMax) * j;
        visible = kept >= 0 ? list_visible<kTable, W>(a, sc, list, kept, i, s, a.pos[3 * i],
                                                      a.pos[3 * i + 1], a.pos[3 * i + 2], k0,
                                                      k1, &walks)
                            : sample_visible<kTable, W>(a, sc, s_mem, i, s, a.pos[3 * i],
                                                        a.pos[3 * i + 1], a.pos[3 * i + 2], k0,
                                                        k1, &walks, list, -1 - kept);
      } else {
        visible = sample_visible<kTable, W>(a, sc, s_mem, i, s, a.pos[3 * i], a.pos[3 * i + 1],
                                            a.pos[3 * i + 2], k0, k1, &walks);
      }
    }
    const unsigned same = __match_any_sync(0xFFFFFFFFu, i);
    const int count = __popc(__ballot_sync(0xFFFFFFFFu, visible) & same);
    if (i >= 0 && count > 0 && threadIdx.x % kWarp == __ffs(same) - 1) {
      atomicAdd(&a.counts[i], count);
    }
  }
  if constexpr (W == 0) {
    tally_full_sweeps(sc, total);
  } else if (sc.tally != nullptr) {
    const unsigned x[3] = {live, walks.visits, walks.tests};
    unsigned long long* const dst[3] = {sc.tally, sc.tally + 1, sc.tally + 2};
    add_block_sums<3>(x, dst, reinterpret_cast<unsigned long long*>(s_mem));
  }
}

// kCull: the per-point cull, its own instantiation: the brute sweep culled
// per point (cull_body, W = 0), so that the registers it needs cost the
// sweep of every triangle (below kCullMinSamples) and the tree walks
// nothing; and the tree samplers' point pass (list_body, W > 0, kTable
// false: it draws no sample).
template <bool kTable, int W, bool kCull = false>
__global__ void __launch_bounds__(kSoftThreads) soft_kernel(SoftArgs a, SoftScene sc) {
  extern __shared__ float4 s_mem[];
  if constexpr (kCull) {
    if constexpr (W == 0) {
      cull_body<kTable>(a, sc, s_mem);
    } else {
      list_body<W>(a, sc, s_mem);
    }
  } else {
    sample_body<kTable, W>(a, sc, s_mem);
  }
}

// One launch of kSoftThreads-thread blocks, one thread per item, the grid
// capped at kMaxBlocks (the kernels stride over the rest).
inline int go(void (*kernel)(SoftArgs, SoftScene), long long items, size_t smem,
              const SoftArgs& a, const SoftScene& sc, cudaStream_t stream) {
  const long long blocks = (items + kSoftThreads - 1) / kSoftThreads;
  const unsigned grid = static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  kernel<<<grid, kSoftThreads, smem, stream>>>(a, sc);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTable, int W>
int launch(const SoftArgs& a, const SoftScene& sc, cudaStream_t stream) {
  if (a.n <= 0 || a.num_samples <= 0) return static_cast<int>(cudaGetLastError());
  void (*kernel)(SoftArgs, SoftScene) = soft_kernel<kTable, W>;
  size_t smem = W > 0 ? sizeof(unsigned long long) * 3 * (kSoftThreads / kWarp)
                      : sizeof(float4) * 3 * sc.num_tris;
  if constexpr (W == 0) {
    if (a.num_samples >= kCullMinSamples) {
      kernel = soft_kernel<kTable, 0, true>;
      smem = sizeof(float4) * 6 * sc.num_tris + 2 * sizeof(unsigned long long) +
             3 * sizeof(unsigned) * cull_span(a.num_samples) * ((sc.num_tris + 31) / 32);
    }
  } else {
    const int err = go(soft_kernel<false, W, true>, a.n,
                       sizeof(unsigned long long) * 7 * (kSoftThreads / kWarp), a, sc, stream);
    if (err != 0) return err;
  }
  return go(kernel, static_cast<long long>(a.n) * a.num_samples, smem, a, sc, stream);
}

}  // namespace cgrt

extern "C" {

// counts[i] += visible samples of point i out of num_samples (the caller
// zeroes counts); gauss null = the Philox stream of the key words key[0],
// key[1] (device memory) at points offset + i, else the table [N,
// num_samples, 3] (key unread, may be null).  Only the count points
// listed first in order are sampled (ops/soft.py _compact); order and count
// null: every point.  tally (device, may be null) += (the triangle tests
// the per-point masks keep, the tests full sweeps would make), summed over
// the live samples.
int cgrt_soft_brute(const float* pos, const int* order, const int* count, int n,
                    const float* light, const float* tris, int num_tris, int num_samples,
                    const unsigned* key, unsigned offset, const float* gauss, int* counts,
                    unsigned long long* tally, cudaStream_t stream) {
  const cgrt::SoftArgs a{pos, order, count, n, light, num_samples, key, offset, gauss, counts};
  const cgrt::SoftScene sc{tris,    num_tris, cgrt::Tree{nullptr, nullptr}, tally, nullptr,
                           nullptr, nullptr,  0,                            nullptr};
  return gauss != nullptr ? cgrt::launch<true, 0>(a, sc, stream)
                          : cgrt::launch<false, 0>(a, sc, stream);
}

// The same over a width-wide tree (2, 4 or 8) of at most 64 stack entries
// ((width - 1) x levels + 1, ops/bvh4.py collapse_bvhw): nodes [Nw, 8 width]
// and rows [T, 12], the tree's records (ops/bvh4.py pack_nodes, pack_tris),
// both 16-byte aligned.  lists [n, 2 cgrt_soft_list_max()], kept [n] and
// up [num_nodes] (device scratch, overwritten) hold the point pass's lists.
// tally (device, may be null)
// += (live samples, internal nodes expanded, triangle tests) of the launch:
// the point pass's nodes, and the sample rays' list tests and walks.
// list_tally (device, may be null) += (marked points, listed points,
// triangles kept on listed points, the point pass's nodes expanded and
// triangles tested, unlisted points whose walks a probe's path leads).
int cgrt_soft_bvh4(const float* pos, const int* order, const int* count, int n,
                   const float* light, int width, const float* nodes, const float* rows,
                   int num_nodes, int num_samples, const unsigned* key, unsigned offset,
                   const float* gauss, int* counts, unsigned long long* tally, int* lists,
                   int* kept, int* up, unsigned long long* list_tally, cudaStream_t stream) {
  const cgrt::SoftArgs a{pos, order, count, n, light, num_samples, key, offset, gauss, counts};
  if (lists == nullptr || kept == nullptr || up == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cgrt::SoftScene sc{nullptr,
                           0,
                           cgrt::Tree{reinterpret_cast<const float4*>(nodes),
                                      reinterpret_cast<const float4*>(rows)},
                           tally,
                           lists,
                           kept,
                           up,
                           num_nodes,
                           list_tally};
  const bool table = gauss != nullptr;
  switch (width) {
    case 2: return table ? cgrt::launch<true, 2>(a, sc, stream)
                         : cgrt::launch<false, 2>(a, sc, stream);
    case 4: return table ? cgrt::launch<true, 4>(a, sc, stream)
                         : cgrt::launch<false, 4>(a, sc, stream);
    case 8: return table ? cgrt::launch<true, 8>(a, sc, stream)
                         : cgrt::launch<false, 8>(a, sc, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K, the list's length per point in cgrt_soft_bvh4's lists.
int cgrt_soft_list_max() { return cgrt::kListMax; }

}  // extern "C"
