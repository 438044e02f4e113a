// 4-wide BVH traversal: closest hit, any hit, and the fused bounce.
//
// Replaces the Pallas kernels of cg_raytracer_tpu/ops/pallas_bvh4.py:
//   cgrt_bvh4_closest / cgrt_bvh4_anyhit <- _bvh4_kernel / _bvh4_kernel_xn (B5),
//                                           _bvh4_hbm_kernel_xn (B8),
//   cgrt_bvh4_bounce                     <- _bvh4_bounce_kernel / _xn      (B6),
//                                           _bvh4_hbm_bounce_kernel_xn (B8).
// Wrappers and plain twins: ops/bvh4.py (which also documents the layout).
//
// One body for both of the JAX package's tiers: B5/B6 held the tree in VMEM
// (to 200,000 triangles), B8 streamed each leaf's triangle rows from HBM (to
// HBM_MAX_TRIS = 2,752,512).  Here every table is read from global memory
// either way; a tree past the 50 MB L2 simply streams from HBM.  Checked at
// that cap: the int32 index arithmetic (24 * ref and 8 * ref with ref < Nw
// <= T, 9 * k and slot_to_prim[k] with k < T, ~(4 * ref + c)) stays below
// 24 * T = 6.6e7, far from 2^31; and build_bvh's binary depth cap of 20
// leaves internal nodes at depth <= 19, so a collapsed tree has at most 10
// levels and a walk at most 3 * 10 + 1 = 31 live stack entries of kStack =
// 64, whatever T (collapse_bvh4 checks the bound per tree).
//
// One thread per ray with a per-thread stack in local memory, where the Pallas
// kernels walked a tile of 8192 rays through the tree in lockstep with one
// scalar stack (a node was visited if any ray of the tile wanted it).  Per
// pop: a stale entry (entry t past the padded best) is skipped; a node's
// child boxes (valid slots 0..nchild-1) get the padded slab test of _slab4
// with NaN-propagating min/max (as jnp.minimum: CUDA's fminf would drop a
// NaN), are pruned past the padded best, sorted by entry t with _slab4's
// compare-exchange network and pushed far to near; a leaf child runs the
// shared Moller-Trumbore (sweep.cuh) over its rows, closer = ok && t < t_best,
// and an any-hit ray returns at its first hit.  The bounce runs the closest
// pass, then one any-hit pass per point light from p + SHADOW_EPS * ldir with
// t_max = dist - SHADOW_EPS (sweep.cuh light_ray, as oracle.cu's bounce).  A
// ray with t_max < 0 is dead and does no work.
//
// Inputs: rays o, d [N, 3], t_max [N] (may be null); the tree: boxes [Nw, 24]
// f32, meta [Nw, 8] i32, nchild [Nw] i32, tris [T, 9] f32 (v0, e1, e2 in leaf
// order), slot_to_prim [T] i32; bounce: light positions [L, 3] (shared
// memory).  Outputs: t (inf on a miss), prim (triangle id, -1), u, v; any-hit
// a byte per ray; bounce also the shadow bits.
//
// What bounds it on an H100: a pop reads 96 + 32 bytes of node and a leaf
// 36 bytes per triangle, all from L2 (a 48K-triangle tree is ~2.5 MB) or L1;
// per pop ~70 FLOPs of slab tests.  Rays of a warp diverge in their walks, so
// the bound is latency of dependent loads and divergence, not a roof.  A later
// PR's levers: wide (float4) loads, compressed nodes, ray reordering.
#include <cstdint>

#include "bvh4.cuh"

namespace cgrt {

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
    bvh4_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ t_max, int n, Tree tr,
                const int* __restrict__ slot_to_prim, float* __restrict__ t_out,
                int* __restrict__ prim_out, float* __restrict__ u_out,
                float* __restrict__ v_out, uint8_t* __restrict__ hit_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Walk w = make_walk(load_ray(o, d, i));
  float t_best = t_max != nullptr ? t_max[i] : CUDART_INF_F, u = 0.0f, v = 0.0f;
  if (kAnyHit) {
    hit_out[i] = t_best > 0.0f && traverse<true>(tr, w, t_best, u, v) >= 0;
    return;
  }
  const int slot = t_best >= 0.0f ? traverse<false>(tr, w, t_best, u, v) : -1;
  t_out[i] = slot >= 0 ? t_best : CUDART_INF_F;
  prim_out[i] = slot >= 0 ? slot_to_prim[slot] : -1;
  u_out[i] = u;
  v_out[i] = v;
}

__global__ void __launch_bounds__(kThreads)
    bvh4_bounce_kernel(const float* __restrict__ o, const float* __restrict__ d,
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
  const int slot = t_best >= 0.0f ? traverse<false>(tr, make_walk(r), t_best, u, v) : -1;
  int bits = 0;
  if (slot >= 0) {
    const float px = r.ox + r.dx * t_best, py = r.oy + r.dy * t_best, pz = r.oz + r.dz * t_best;
    for (int l = 0; l < num_lights; ++l) {
      float tm;
      const Ray s = light_ray(s_light + 3 * l, px, py, pz, tm);
      float su = 0.0f, sv = 0.0f;
      if (tm > 0.0f && traverse<true>(tr, make_walk(s), tm, su, sv) >= 0) bits |= 1 << l;
    }
  }
  t_out[i] = slot >= 0 ? t_best : CUDART_INF_F;
  prim_out[i] = slot >= 0 ? slot_to_prim[slot] : -1;
  u_out[i] = u;
  v_out[i] = v;
  bits_out[i] = bits;
}

}  // namespace cgrt

extern "C" {

// t_max may be null (no bound); t_max < 0 marks a dead ray.
int cgrt_bvh4_closest(const float* o, const float* d, const float* t_max, int n,
                      const float* boxes, const int* meta, const int* nchild, const float* tris,
                      const int* slot_to_prim, float* t, int* prim, float* u, float* v,
                      cudaStream_t stream) {
  if (n > 0) {
    cgrt::bvh4_kernel<false><<<cgrt::num_blocks(n), cgrt::kThreads, 0, stream>>>(
        o, d, t_max, n, cgrt::Tree{boxes, meta, nchild, tris}, slot_to_prim, t, prim, u, v,
        nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// hit[i] = 1 where some triangle lies at t in [0, t_max[i]).
int cgrt_bvh4_anyhit(const float* o, const float* d, const float* t_max, int n,
                     const float* boxes, const int* meta, const int* nchild, const float* tris,
                     const int* slot_to_prim, uint8_t* hit, cudaStream_t stream) {
  if (n > 0) {
    cgrt::bvh4_kernel<true><<<cgrt::num_blocks(n), cgrt::kThreads, 0, stream>>>(
        o, d, t_max, n, cgrt::Tree{boxes, meta, nchild, tris}, slot_to_prim, nullptr, nullptr,
        nullptr, nullptr, hit);
  }
  return static_cast<int>(cudaGetLastError());
}

// Closest hit plus bit l of bits[i] set where light l (lights [L, 3]) is
// occluded from the hit point.
int cgrt_bvh4_bounce(const float* o, const float* d, const float* t_max, int n,
                     const float* boxes, const int* meta, const int* nchild, const float* tris,
                     const int* slot_to_prim, const float* lights, int num_lights, float* t,
                     int* prim, float* u, float* v, int* bits, cudaStream_t stream) {
  if (n > 0) {
    cgrt::bvh4_bounce_kernel<<<cgrt::num_blocks(n), cgrt::kThreads,
                               sizeof(float) * 3 * num_lights, stream>>>(
        o, d, t_max, n, cgrt::Tree{boxes, meta, nchild, tris}, slot_to_prim, lights,
        num_lights, t, prim, u, v, bits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
