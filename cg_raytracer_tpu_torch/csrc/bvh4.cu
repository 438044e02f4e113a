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
// Checked at that cap: the int32 index arithmetic (6 W * ref and 2 W * ref
// with ref < Nw <= T, 9 * k and slot_to_prim[k] with k < T, ~(W * ref + c))
// stays below 48 * T = 1.3e8, far from 2^31.  The stack: build_bvh's binary
// depth cap of 20 leaves internal nodes at depth <= 19, so a collapsed tree
// has at most 20 levels at W = 2, 10 at W = 4 and 7 at W = 8, and a walk at
// most (W - 1) * levels + 1 live entries: 21, 31 and 50 of kStack = 64,
// whatever T (collapse_bvhw checks the bound per tree).
//
// One thread per ray with a per-thread stack in local memory, where the Pallas
// kernels walked a tile of 8192 rays through the tree in lockstep with one
// scalar stack (a node was visited if any ray of the tile wanted it).  Per
// pop: a stale entry (entry t past the padded best) is skipped; a node's
// child boxes (valid slots 0..nchild-1) get the padded slab test of _slab
// with NaN-propagating min/max (as jnp.minimum: CUDA's fminf would drop a
// NaN), are pruned past the padded best, sorted by entry t with the JAX
// package's compare-exchange network for W (at W = 2 the left child first
// on a tie, as the binary kernel) and pushed far to near; a leaf child runs the
// shared Moller-Trumbore (sweep.cuh) over its rows, closer = ok && t < t_best,
// and an any-hit ray returns at its first hit.  The bounce runs the closest
// pass, then one any-hit pass per point light from p + SHADOW_EPS * ldir with
// t_max = dist - SHADOW_EPS (sweep.cuh light_ray, as oracle.cu's bounce).  A
// ray with t_max < 0 is dead and does no work.
//
// Inputs: rays o, d [N, 3], t_max [N] (may be null); the tree: boxes [Nw, 6W]
// f32, meta [Nw, 2W] i32, nchild [Nw] i32, tris [T, 9] f32 (v0, e1, e2 in leaf
// order), slot_to_prim [T] i32; bounce: light positions [L, 3] (shared
// memory).  Outputs: t (inf on a miss), prim (triangle id, -1), u, v; any-hit
// a byte per ray; bounce also the shadow bits.
//
// What bounds it on an H100: a pop reads 32 W bytes of node and a leaf 36
// bytes per triangle, all from L2 (a 48K-triangle tree is ~2.5 MB) or L1; per
// pop 36 W FLOPs of slab tests and prunes and 3 per comparator of the sort.
// A wider node means fewer pops per walk and more work per pop.  Rays of a
// warp diverge in their walks, so the bound is latency of dependent loads and
// divergence, not a roof.  Levers: wide (float4) loads, compressed nodes, ray
// reordering.
#include <cstdint>

#include "bvh4.cuh"

namespace cgrt {

template <int W, bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
    bvh_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ t_max, int n, Tree tr,
               const int* __restrict__ slot_to_prim, float* __restrict__ t_out,
               int* __restrict__ prim_out, float* __restrict__ u_out, float* __restrict__ v_out,
               uint8_t* __restrict__ hit_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Walk w = make_walk(load_ray(o, d, i));
  float t_best = t_max != nullptr ? t_max[i] : CUDART_INF_F, u = 0.0f, v = 0.0f;
  if (kAnyHit) {
    hit_out[i] = t_best > 0.0f && traverse<W, true>(tr, w, t_best, u, v) >= 0;
    return;
  }
  const int slot = t_best >= 0.0f ? traverse<W, false>(tr, w, t_best, u, v) : -1;
  t_out[i] = slot >= 0 ? t_best : CUDART_INF_F;
  prim_out[i] = slot >= 0 ? slot_to_prim[slot] : -1;
  u_out[i] = u;
  v_out[i] = v;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
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
  const int slot = t_best >= 0.0f ? traverse<W, false>(tr, make_walk(r), t_best, u, v) : -1;
  int bits = 0;
  if (slot >= 0) {
    const float px = r.ox + r.dx * t_best, py = r.oy + r.dy * t_best, pz = r.oz + r.dz * t_best;
    for (int l = 0; l < num_lights; ++l) {
      float tm;
      const Ray s = light_ray(s_light + 3 * l, px, py, pz, tm);
      float su = 0.0f, sv = 0.0f;
      if (tm > 0.0f && traverse<W, true>(tr, make_walk(s), tm, su, sv) >= 0) bits |= 1 << l;
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

template <int W, bool kAnyHit>
void launch_walk(const Rays& r, const Tree& tr, const int* slot_to_prim, float* t, int* prim,
                 float* u, float* v, uint8_t* hit, cudaStream_t stream) {
  bvh_kernel<W, kAnyHit><<<num_blocks(r.n), kThreads, 0, stream>>>(
      r.o, r.d, r.t_max, r.n, tr, slot_to_prim, t, prim, u, v, hit);
}

template <int W>
void launch_bounce(const Rays& r, const Tree& tr, const int* slot_to_prim, const float* lights,
                   int num_lights, float* t, int* prim, float* u, float* v, int* bits,
                   cudaStream_t stream) {
  bvh_bounce_kernel<W><<<num_blocks(r.n), kThreads, sizeof(float) * 3 * num_lights, stream>>>(
      r.o, r.d, r.t_max, r.n, tr, slot_to_prim, lights, num_lights, t, prim, u, v, bits);
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
// tree's node width, 2, 4 or 8.
int cgrt_bvh4_closest(const float* o, const float* d, const float* t_max, int n, int width,
                      const float* boxes, const int* meta, const int* nchild, const float* tris,
                      const int* slot_to_prim, float* t, int* prim, float* u, float* v,
                      cudaStream_t stream) {
  const cgrt::Rays r{o, d, t_max, n};
  const cgrt::Tree tr{boxes, meta, nchild, tris};
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
                     const float* boxes, const int* meta, const int* nchild, const float* tris,
                     const int* slot_to_prim, uint8_t* hit, cudaStream_t stream) {
  const cgrt::Rays r{o, d, t_max, n};
  const cgrt::Tree tr{boxes, meta, nchild, tris};
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
                     const float* boxes, const int* meta, const int* nchild, const float* tris,
                     const int* slot_to_prim, const float* lights, int num_lights, float* t,
                     int* prim, float* u, float* v, int* bits, cudaStream_t stream) {
  const cgrt::Rays r{o, d, t_max, n};
  const cgrt::Tree tr{boxes, meta, nchild, tris};
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
