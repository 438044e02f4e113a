// Spherical-light soft-shadow samplers: visible-sample counts per shading
// point for one spherical light (main.cpp:166-218).
//
// Replaces eight Pallas kernels:
//   cgrt_soft_brute, PRNG  <- pallas_kernels.py _soft_shadow_prng_kernel (B9),
//   cgrt_soft_brute, table <- pallas_kernels.py _soft_shadow_table_kernel (B9),
//   cgrt_soft_bvh4, PRNG   <- pallas_bvh4.py _soft4_cone_prng_kernel (B10; at
//                             W = 8 B15), pallas_bvh.py _soft_bvh_prng_kernel
//                             (B12, W = 2) and _soft_bvh_cone_prng_kernel
//                             (B11, W = 2),
//   cgrt_soft_bvh4, table  <- their table twins _soft4_cone_table_kernel,
//                             _soft_bvh_table_kernel, _soft_bvh_cone_table_
//                             kernel.
// Wrappers, the sample stream and the plain twins: ops/soft.py.
//
// One body (sample_visible), templated on the sample source (Philox in the
// kernel, or a table of Gaussians [N, S, 3]) and on the scene (the triangle
// table in shared memory, or a W-wide tree, W = 2, 4 or 8).  The JAX
// package's 'sample' tile (points on lanes, a loop over samples, the binary
// primary tree) and 'cone' tile (128 pixels x all their samples in one
// lockstep walk of the soft tree) are both this layout: on the card they
// differ only in the tree the caller passes.  Layout: one thread per (point,
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
// counter (g, s, 0, 0) under the key (k0, k1), its four words turned into
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
// The brute sweep stages its triangles in shared memory in the same
// three-row layout (three 16-byte broadcast loads per test) and runs the
// same mt_blocks.
//
// What bounds it on an H100 (counts of utils/roofline.py): per sample ray,
// 104 integer operations of Philox (at 16.7 Tops/s) and 65 FLOPs of
// Box-Muller and sample ray, then the any-hit: up to T Moller-Trumbore tests
// of 68 FLOPs (brute; the lane stops at its first blocker) or a walk of 159
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

struct SoftArgs {
  const float* pos;  // [N, 3] shading points
  const int* order;  // [N + 1] the points to sample first (ops/soft.py _compact), or null (all N)
  const int* count;  // [1] how many of order to sample (read on the card)
  int n;
  const float* light;  // [4] center, radius
  int num_samples;
  unsigned k0, k1, offset;  // the light's key and the batch's first global point index
  const float* gauss;       // table variant: [N, S, 3]
  int* counts;              // [N]
};

// What the sampler sweeps or walks.
struct SoftScene {
  const float* __restrict__ tris;  // brute: [T, 9] v0, v1, v2
  int num_tris;                    // brute
  Tree tree;                       // tree: its records (bvh4.cuh)
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

// Stage [T, 9] rows (v0, v1, v2) as three 16-byte rows each, (v0, 0), (e1,
// 0), (e2, 0): stage_triangles's edges in pack_tris's layout.
__device__ __forceinline__ void stage_rows3(const float* __restrict__ tris, int num_tris,
                                            float4* s_rows) {
  for (int k = threadIdx.x; k < num_tris; k += blockDim.x) {
    const float* r = tris + 9 * k;
    s_rows[3 * k] = make_float4(r[0], r[1], r[2], 0.0f);
    s_rows[3 * k + 1] = make_float4(r[3] - r[0], r[4] - r[1], r[5] - r[2], 0.0f);
    s_rows[3 * k + 2] = make_float4(r[6] - r[0], r[7] - r[1], r[8] - r[2], 0.0f);
  }
}

// Whether sample s of point i (at p) reaches the light l: its Gaussian from
// the table or the stream, the sample ray, then an any-hit sweep of the
// staged triangles or an any-hit walk of the tree.
template <bool kTable, int W>
__device__ __forceinline__ bool sample_visible(const SoftArgs& a, const SoftScene& sc,
                                               const float4* s_tri, int i, int s, float px,
                                               float py, float pz) {
  float gx, gy, gz;
  if (kTable) {
    const float* g = a.gauss + 3 * (static_cast<size_t>(i) * a.num_samples + s);
    gx = g[0], gy = g[1], gz = g[2];
  } else {
    const uint4 ctr = make_uint4(a.offset + static_cast<unsigned>(i), static_cast<unsigned>(s),
                                 0u, 0u);
    gauss3(philox4x32_10(ctr, a.k0, a.k1), gx, gy, gz);
  }
  float tm;
  const Ray r = sample_ray(px, py, pz, gx, gy, gz, a.light, tm);
  if (!(tm > 0.0f)) return true;
  if constexpr (W > 0) {
    return !occluded<W>(sc.tree, r, tm);
  } else {
    for (int k = 0; k < sc.num_tris; ++k) {
      if (mt_blocks(s_tri[3 * k], s_tri[3 * k + 1], s_tri[3 * k + 2], r, tm)) return false;
    }
    return true;
  }
}

// The port's layout: one thread per (point, sample), point-major.  A warp
// adds its visible count per point (__match_any_sync groups its lanes by
// point, at most two points for S >= 32) into counts, which start at 0.
// W: the tree's node width, 0 for the brute sweep of the staged table.
// Dynamic shared memory: the brute sweep's triangles (three float4 rows
// each).  With order, the grid strides over the count points it lists first
// (the count is read here, so the wrapper never waits for the card), and no
// thread is spent on a point that missed.
template <bool kTable, int W>
__global__ void __launch_bounds__(kSoftThreads) soft_kernel(SoftArgs a, SoftScene sc) {
  extern __shared__ float4 s_mem[];
  if (W == 0) {
    stage_rows3(sc.tris, sc.num_tris, s_mem);
    __syncthreads();
  }
  const long long points = a.order != nullptr ? *a.count : a.n;
  const long long total = points * a.num_samples;
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
      visible = sample_visible<kTable, W>(a, sc, s_mem, i, static_cast<int>(t % a.num_samples),
                                          a.pos[3 * i], a.pos[3 * i + 1], a.pos[3 * i + 2]);
    }
    const unsigned same = __match_any_sync(0xFFFFFFFFu, i);
    const int count = __popc(__ballot_sync(0xFFFFFFFFu, visible) & same);
    if (i >= 0 && count > 0 && threadIdx.x % kWarp == __ffs(same) - 1) {
      atomicAdd(&a.counts[i], count);
    }
  }
}

template <bool kTable, int W>
int launch(const SoftArgs& a, const SoftScene& sc, cudaStream_t stream) {
  if (a.n <= 0 || a.num_samples <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = W > 0 ? 0 : sizeof(float4) * 3 * sc.num_tris;
  const long long blocks =
      (static_cast<long long>(a.n) * a.num_samples + kSoftThreads - 1) / kSoftThreads;
  const unsigned grid = static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  soft_kernel<kTable, W><<<grid, kSoftThreads, smem, stream>>>(a, sc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cgrt

extern "C" {

// counts[i] += visible samples of point i out of num_samples (the caller
// zeroes counts); gauss null = the Philox stream of (k0, k1) at points
// offset + i, else the table [N, num_samples, 3].  Only the count points
// listed first in order are sampled (ops/soft.py _compact); order and count
// null: every point.
int cgrt_soft_brute(const float* pos, const int* order, const int* count, int n,
                    const float* light, const float* tris, int num_tris, int num_samples,
                    unsigned k0, unsigned k1, unsigned offset, const float* gauss, int* counts,
                    cudaStream_t stream) {
  const cgrt::SoftArgs a{pos, order, count, n, light, num_samples, k0, k1, offset, gauss, counts};
  const cgrt::SoftScene sc{tris, num_tris, cgrt::Tree{nullptr, nullptr}};
  return gauss != nullptr ? cgrt::launch<true, 0>(a, sc, stream)
                          : cgrt::launch<false, 0>(a, sc, stream);
}

// The same over a width-wide tree (2, 4 or 8) of at most 64 stack entries
// ((width - 1) x levels + 1, ops/bvh4.py collapse_bvhw): nodes [Nw, 8 width]
// and rows [T, 12], the tree's records (ops/bvh4.py pack_nodes, pack_tris),
// both 16-byte aligned.
int cgrt_soft_bvh4(const float* pos, const int* order, const int* count, int n,
                   const float* light, int width, const float* nodes, const float* rows,
                   int num_samples, unsigned k0, unsigned k1, unsigned offset, const float* gauss,
                   int* counts, cudaStream_t stream) {
  const cgrt::SoftArgs a{pos, order, count, n, light, num_samples, k0, k1, offset, gauss, counts};
  const cgrt::SoftScene sc{nullptr, 0,
                           cgrt::Tree{reinterpret_cast<const float4*>(nodes),
                                      reinterpret_cast<const float4*>(rows)}};
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
