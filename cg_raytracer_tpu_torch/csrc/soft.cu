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
// The tree samplers' tally (soft_kernel<kTable, W> for W > 0; the walk's
// counting compiled into these instantiations alone, bvh4.cuh occluded<W,
// true>): each thread counts its live samples (every sample of a marked
// point) and its walks' internal nodes expanded and triangles tested, as
// ops/bvh4.py _traverse_plain's stats count them; after the grid-stride loop
// a warp sums each count (__reduce_add_sync), its four warps' sums meet in
// the block's shared memory, and one thread adds the block's to the
// wrapper's int64 triple (ops/soft.py tree_sampler_counts): one global add
// per count and block.
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
#include <cstdint>

#include "bvh4.cuh"

namespace cgrt {

constexpr int kWarp = 32;
constexpr int kSoftThreads = 128;  // threads per block (four warps)
constexpr long long kMaxBlocks = 65536;  // the grid-stride loop takes the rest
constexpr float kTwoPi = 6.283185307179586f;
constexpr int kCullMinSamples = 6;  // the brute sweep culls per point from this many samples on
constexpr float kUlp = 5.9604645e-8f;  // 2^-24, float's unit roundoff

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

// Whether sample s of point i (at p) reaches the light l: an any-hit sweep
// of the staged triangles or an any-hit walk of the tree, whose work is
// added to *walks.
template <bool kTable, int W>
__device__ __forceinline__ bool sample_visible(const SoftArgs& a, const SoftScene& sc,
                                               const float4* s_tri, int i, int s, float px,
                                               float py, float pz, unsigned k0, unsigned k1,
                                               WalkCount* walks) {
  float tm;
  const Ray r = sample_of<kTable>(a, i, s, px, py, pz, k0, k1, tm);
  if (!(tm > 0.0f)) return true;
  if constexpr (W > 0) {
    return !occluded<W, true>(sc.tree, r, tm, walks);
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

// The tree samplers' tally, by every thread of the block after its loop:
// the block's (live samples, nodes expanded, triangles tested), each warp's
// sums staged in s_warps ([warps][3]: the launch's dynamic shared memory),
// one global add each by thread 0.
__device__ __forceinline__ void tally_walks(const SoftScene& sc, unsigned live,
                                            const WalkCount& walks,
                                            unsigned long long* s_warps) {
  if (sc.tally == nullptr) return;
  const unsigned long long sums[3] = {warp_sum(live), warp_sum(walks.visits),
                                      warp_sum(walks.tests)};
  if (threadIdx.x % kWarp == 0) {
    for (int c = 0; c < 3; ++c) s_warps[3 * (threadIdx.x / kWarp) + c] = sums[c];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned long long block[3] = {0ull, 0ull, 0ull};
  for (int w = 0; w < kSoftThreads / kWarp; ++w) {
    for (int c = 0; c < 3; ++c) block[c] += s_warps[3 * w + c];
  }
  if (block[0] != 0ull) {
    for (int c = 0; c < 3; ++c) atomicAdd(&sc.tally[c], block[c]);
  }
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
    int i = -1;
    if (t < total) {
      const int j = static_cast<int>(t / a.num_samples);
      i = a.order != nullptr ? a.order[j] : j;
    }
    bool visible = false;
    if (i >= 0) {
      if constexpr (W > 0) ++live;
      visible = sample_visible<kTable, W>(a, sc, s_mem, i, static_cast<int>(t % a.num_samples),
                                          a.pos[3 * i], a.pos[3 * i + 1], a.pos[3 * i + 2], k0,
                                          k1, &walks);
    }
    const unsigned same = __match_any_sync(0xFFFFFFFFu, i);
    const int count = __popc(__ballot_sync(0xFFFFFFFFu, visible) & same);
    if (i >= 0 && count > 0 && threadIdx.x % kWarp == __ffs(same) - 1) {
      atomicAdd(&a.counts[i], count);
    }
  }
  if constexpr (W == 0) {
    tally_full_sweeps(sc, total);
  } else {
    tally_walks(sc, live, walks, reinterpret_cast<unsigned long long*>(s_mem));
  }
}

// kCull: the brute sweep culled per point (cull_body), its own
// instantiation, so that the registers it needs cost the sweep of every
// triangle (below kCullMinSamples) and the tree walks nothing.
template <bool kTable, int W, bool kCull = false>
__global__ void __launch_bounds__(kSoftThreads) soft_kernel(SoftArgs a, SoftScene sc) {
  extern __shared__ float4 s_mem[];
  if constexpr (kCull) {
    cull_body<kTable>(a, sc, s_mem);
  } else {
    sample_body<kTable, W>(a, sc, s_mem);
  }
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
  }
  const long long blocks =
      (static_cast<long long>(a.n) * a.num_samples + kSoftThreads - 1) / kSoftThreads;
  const unsigned grid = static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  kernel<<<grid, kSoftThreads, smem, stream>>>(a, sc);
  return static_cast<int>(cudaGetLastError());
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
  const cgrt::SoftScene sc{tris, num_tris, cgrt::Tree{nullptr, nullptr}, tally};
  return gauss != nullptr ? cgrt::launch<true, 0>(a, sc, stream)
                          : cgrt::launch<false, 0>(a, sc, stream);
}

// The same over a width-wide tree (2, 4 or 8) of at most 64 stack entries
// ((width - 1) x levels + 1, ops/bvh4.py collapse_bvhw): nodes [Nw, 8 width]
// and rows [T, 12], the tree's records (ops/bvh4.py pack_nodes, pack_tris),
// both 16-byte aligned.  tally (device, may be null) += (live samples,
// internal nodes expanded, triangle tests) of the launch's walks.
int cgrt_soft_bvh4(const float* pos, const int* order, const int* count, int n,
                   const float* light, int width, const float* nodes, const float* rows,
                   int num_samples, const unsigned* key, unsigned offset, const float* gauss,
                   int* counts, unsigned long long* tally, cudaStream_t stream) {
  const cgrt::SoftArgs a{pos, order, count, n, light, num_samples, key, offset, gauss, counts};
  const cgrt::SoftScene sc{nullptr, 0,
                           cgrt::Tree{reinterpret_cast<const float4*>(nodes),
                                      reinterpret_cast<const float4*>(rows)},
                           tally};
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

}  // extern "C"
