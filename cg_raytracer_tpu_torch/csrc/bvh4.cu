// Wide BVH traversal: closest hit, any hit, and the fused bounce, at node
// width W = 2, 4 or 8 (one template; the entry points take the width and
// launch its instantiation).
//
// Replaces the Pallas kernels of cg_raytracer_tpu/ops/pallas_bvh4.py and
// pallas_bvh.py:
//   cgrt_bvh4_closest / cgrt_bvh4_anyhit <- _bvh4_kernel / _bvh4_kernel_xn (B5;
//                                           W = 8: B15), _bvh4_hbm_kernel_xn
//                                           (B8), _bvh_kernel (B13, W = 2),
//                                           _bvh_hbm_kernel (B14, W = 2),
//   cgrt_bvh4_bounce                     <- _bvh4_bounce_kernel / _xn (B6;
//                                           W = 8: B15), _bvh4_hbm_bounce_
//                                           kernel_xn (B8), _bvh_bounce_kernel
//                                           (B13), _bvh_hbm_bounce_kernel (B14).
// Wrappers and plain twins: ops/bvh4.py (which also documents the layout).
//
// One body for both of the JAX package's tiers: B5/B6/B13 held the tree in
// VMEM (to 200,000 triangles), B8/B14 streamed each leaf's triangle rows from
// HBM (to HBM_MAX_TRIS = 2,752,512).  Here every table is read from global
// memory either way; a tree past the 50 MB L2 simply streams from HBM.
// Past that cap the same walks run, up to ops/bvh4.py MAX_TRIS: the int32
// index arithmetic (2 W * ref records of 16 bytes with ref < Nw <= T, 3 * k
// rows and slot_to_prim[k] with k < T, ~(W * ref + c)) stays below 16 * T <
// 2^31 there (the derivation sits beside the constant).  The stack: build_bvh's binary
// depth cap of 20 leaves internal nodes at depth <= 19, so a collapsed tree
// has at most 20 levels at W = 2, 10 at W = 4 and 7 at W = 8, and a walk at
// most (W - 1) * levels + 1 live entries: 21, 31 and 50 of kStack = 64,
// whatever T (collapse_bvhw checks the bound per tree).
//
// One thread per ray, where the Pallas kernels walked a tile of 8192 rays
// through the tree in lockstep with one scalar stack (a node was visited if
// any ray of the tile wanted it).  Both walks (bvh4.cuh) read one record
// per node, built once per tree (ops/bvh4.py pack_nodes): the 6W child box
// floats with NaN in the slots past the node's child count, then the 2W
// meta ints bit-cast, 32W bytes read with 2W 16-byte loads; and triangle
// rows padded to 16 bytes (pack_tris).  A node's child boxes get the padded
// slab test of _slab with NaN-propagating min/max in one instruction each
// (PTX min.NaN / max.NaN: jnp.minimum's NaN, which CUDA's fminf would drop),
// are pruned past the padded best (a NaN slot fails the test as the absent
// child it stands for) and sorted by entry t with the JAX package's
// compare-exchange network for W (at W = 2 the left child first on a tie,
// as the binary kernel).
// - closest (closest): the children are pushed far to near with their
//   entry t, so the nearest pops first; a popped entry whose entry t
//   exceeds the padded current best is stale and skipped.  A leaf child
//   runs sweep.cuh's mt over its rows (closer = ok && t < t_best).  The
//   nearest child walked at once and mt's early exits, which the any-hit
//   walk takes, measured slower here (PERF.md, the walks).
// - any hit (occluded, also the samplers' walk in soft.cu): its best stays
//   t_max until it returns, and every entry was pushed with tin <=
//   padded(t_max), so no entry is ever stale: the stack holds node ids only
//   (256 bytes), the nearest child is walked at once instead of pushed and
//   popped, the leaf test is sweep.cuh's mt_blocks (the first failed
//   condition ends it), and it returns at the first hit.
// Both visit the nodes and triangles of the twin, in its order.  The bounce
// runs the closest walk, then one any-hit walk per point light from p +
// SHADOW_EPS * ldir with t_max = dist - SHADOW_EPS (sweep.cuh light_ray, as
// oracle.cu's bounce).  A ray with t_max < 0 is dead and does no work.
//
// Inputs: rays o, d [N, 3], t_max [N] (may be null); the tree: nodes [Nw,
// 8W] f32 (the records), rows [T, 12] f32 (v0, e1 = v1 - v0, e2 = v2 - v0 in
// leaf order, each padded to 16 bytes), slot_to_prim [T] i32; bounce: light
// positions [L, 3] (shared memory).  Outputs: t (inf on a miss), prim
// (triangle id, -1), u, v; any-hit a byte per ray; bounce also the shadow
// bits.
//
// What bounds it on an H100: a pop reads 32 W bytes of node and a leaf 48
// bytes per triangle, from L2 (a 48K-triangle tree is ~2.5 MB) or L1; per
// pop 36 W FLOPs of slab tests and prunes and 3 per comparator of the sort.
// A wider node means fewer pops per walk and more work per pop.  Rays of a
// warp diverge in their walks, so the bound is the issue rate of scalar
// compares and selects per lane and the latency of dependent node loads,
// not a roof; tensor cores, TMA and clusters have nothing to carry.  The
// levers above cut instructions and loads per pop (PERF.md, the walks).
#include <cstdint>

#include "bvh4.cuh"

namespace cgrt {

constexpr int kWalkThreads = 128;  // threads per block

template <int W, bool kAnyHit>
__global__ void __launch_bounds__(kWalkThreads)
    bvh_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ t_max, int n, Tree tr,
               const int* __restrict__ slot_to_prim, float* __restrict__ t_out,
               int* __restrict__ prim_out, float* __restrict__ u_out, float* __restrict__ v_out,
               uint8_t* __restrict__ hit_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(o, d, i);
  float t_best = t_max != nullptr ? t_max[i] : CUDART_INF_F, u = 0.0f, v = 0.0f;
  if (kAnyHit) {
    hit_out[i] = t_best > 0.0f && occluded<W>(tr, r, t_best);
    return;
  }
  const int slot = t_best >= 0.0f ? closest<W>(tr, r, t_best, u, v) : -1;
  t_out[i] = slot >= 0 ? t_best : CUDART_INF_F;
  prim_out[i] = slot >= 0 ? slot_to_prim[slot] : -1;
  u_out[i] = u;
  v_out[i] = v;
}

template <int W>
__global__ void __launch_bounds__(kWalkThreads)
    bvh_bounce_kernel(const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ t_max, int n, Tree tr,
                      const int* __restrict__ slot_to_prim, const float* __restrict__ lights,
                      int num_lights, float* __restrict__ t_out, int* __restrict__ prim_out,
                      float* __restrict__ u_out, float* __restrict__ v_out,
                      int* __restrict__ bits_out) {
  extern __shared__ float s_light[];
  stage_rows(lights, 3 * num_lights, s_light);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(o, d, i);
  float t_best = t_max != nullptr ? t_max[i] : CUDART_INF_F, u = 0.0f, v = 0.0f;
  const int slot = t_best >= 0.0f ? closest<W>(tr, r, t_best, u, v) : -1;
  int bits = 0;
  if (slot >= 0) {
    const float px = r.ox + r.dx * t_best, py = r.oy + r.dy * t_best, pz = r.oz + r.dz * t_best;
    for (int l = 0; l < num_lights; ++l) {
      float tm;
      const Ray s = light_ray(s_light + 3 * l, px, py, pz, tm);
      if (tm > 0.0f && occluded<W>(tr, s, tm)) bits |= 1 << l;
    }
  }
  t_out[i] = slot >= 0 ? t_best : CUDART_INF_F;
  prim_out[i] = slot >= 0 ? slot_to_prim[slot] : -1;
  u_out[i] = u;
  v_out[i] = v;
  bits_out[i] = bits;
}

struct Rays {
  const float *o, *d, *t_max;
  int n;
};

__host__ __forceinline__ int walk_blocks(int n) { return (n + kWalkThreads - 1) / kWalkThreads; }

template <int W, bool kAnyHit>
void launch_walk(const Rays& r, const Tree& tr, const int* slot_to_prim, float* t, int* prim,
                 float* u, float* v, uint8_t* hit, cudaStream_t stream) {
  bvh_kernel<W, kAnyHit><<<walk_blocks(r.n), kWalkThreads, 0, stream>>>(
      r.o, r.d, r.t_max, r.n, tr, slot_to_prim, t, prim, u, v, hit);
}

template <int W>
void launch_bounce(const Rays& r, const Tree& tr, const int* slot_to_prim, const float* lights,
                   int num_lights, float* t, int* prim, float* u, float* v, int* bits,
                   cudaStream_t stream) {
  bvh_bounce_kernel<W><<<walk_blocks(r.n), kWalkThreads, sizeof(float) * 3 * num_lights,
                         stream>>>(r.o, r.d, r.t_max, r.n, tr, slot_to_prim, lights, num_lights,
                                   t, prim, u, v, bits);
}

inline Tree tree_of(const float* nodes, const float* rows) {
  return Tree{reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(rows)};
}

// The instantiation for the run-time width; false for a width with none.
template <class F2, class F4, class F8>
bool by_width(int width, F2 f2, F4 f4, F8 f8) {
  switch (width) {
    case 2: f2(); return true;
    case 4: f4(); return true;
    case 8: f8(); return true;
    default: return false;
  }
}

}  // namespace cgrt

extern "C" {

// t_max may be null (no bound); t_max < 0 marks a dead ray.  width: the
// tree's node width, 2, 4 or 8; nodes [Nw, 8 width] and rows [T, 12] the
// tree's records (ops/bvh4.py pack_nodes, pack_tris), 16-byte aligned.
int cgrt_bvh4_closest(const float* o, const float* d, const float* t_max, int n, int width,
                      const float* nodes, const float* rows, const int* slot_to_prim, float* t,
                      int* prim, float* u, float* v, cudaStream_t stream) {
  const cgrt::Rays r{o, d, t_max, n};
  const cgrt::Tree tr = cgrt::tree_of(nodes, rows);
  if (n > 0 && !cgrt::by_width(
                   width,
                   [&] { cgrt::launch_walk<2, false>(r, tr, slot_to_prim, t, prim, u, v, nullptr,
                                                     stream); },
                   [&] { cgrt::launch_walk<4, false>(r, tr, slot_to_prim, t, prim, u, v, nullptr,
                                                     stream); },
                   [&] { cgrt::launch_walk<8, false>(r, tr, slot_to_prim, t, prim, u, v, nullptr,
                                                     stream); })) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// hit[i] = 1 where some triangle lies at t in [0, t_max[i]).
int cgrt_bvh4_anyhit(const float* o, const float* d, const float* t_max, int n, int width,
                     const float* nodes, const float* rows, const int* slot_to_prim, uint8_t* hit,
                     cudaStream_t stream) {
  const cgrt::Rays r{o, d, t_max, n};
  const cgrt::Tree tr = cgrt::tree_of(nodes, rows);
  if (n > 0 && !cgrt::by_width(
                   width,
                   [&] { cgrt::launch_walk<2, true>(r, tr, slot_to_prim, nullptr, nullptr,
                                                    nullptr, nullptr, hit, stream); },
                   [&] { cgrt::launch_walk<4, true>(r, tr, slot_to_prim, nullptr, nullptr,
                                                    nullptr, nullptr, hit, stream); },
                   [&] { cgrt::launch_walk<8, true>(r, tr, slot_to_prim, nullptr, nullptr,
                                                    nullptr, nullptr, hit, stream); })) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Closest hit plus bit l of bits[i] set where light l (lights [L, 3]) is
// occluded from the hit point.
int cgrt_bvh4_bounce(const float* o, const float* d, const float* t_max, int n, int width,
                     const float* nodes, const float* rows, const int* slot_to_prim,
                     const float* lights, int num_lights, float* t, int* prim, float* u, float* v,
                     int* bits, cudaStream_t stream) {
  const cgrt::Rays r{o, d, t_max, n};
  const cgrt::Tree tr = cgrt::tree_of(nodes, rows);
  if (n > 0 && !cgrt::by_width(
                   width,
                   [&] { cgrt::launch_bounce<2>(r, tr, slot_to_prim, lights, num_lights, t, prim,
                                                u, v, bits, stream); },
                   [&] { cgrt::launch_bounce<4>(r, tr, slot_to_prim, lights, num_lights, t, prim,
                                                u, v, bits, stream); },
                   [&] { cgrt::launch_bounce<8>(r, tr, slot_to_prim, lights, num_lights, t, prim,
                                                u, v, bits, stream); })) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
