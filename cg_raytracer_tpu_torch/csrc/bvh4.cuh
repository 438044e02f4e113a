// 4-wide BVH traversal shared by the kernels that walk the tree: bvh4.cu
// (closest hit, any hit, the fused bounce) and soft.cu (the cone soft-shadow
// sampler).  The layout is ops/bvh4.py's; the walk is documented in bvh4.cu.
#pragma once

#include <cstdint>

#include "sweep.cuh"

namespace cgrt {

constexpr int kStack = 64;  // ops/bvh4.py MAX_STACK (collapse_bvh4 checks the bound)
constexpr float kSlabEps = 1e-5f;
constexpr float kBig = 3.4e38f;

struct Tree {
  const float* __restrict__ boxes;  // [Nw, 24]
  const int* __restrict__ meta;     // [Nw, 8]
  const int* __restrict__ nchild;   // [Nw]
  const float* __restrict__ tris;   // [T, 9]
};

// min/max that return NaN when either side is NaN (jnp.minimum, torch.minimum).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fmaxf(a, b);
}

__device__ __forceinline__ float padded(float t) { return t + kSlabEps * (1.0f + fabsf(t)); }

// Ray, its reciprocal direction and its running best.
struct Walk {
  Ray r;
  float ix, iy, iz;
};

// Traverse from the root.  Closest: returns the slot (leaf-order row) of the
// nearest triangle at t < t_best and updates t_best, u, v; -1 if none.
// Any-hit: returns the first slot found at t < t_best, -1 if none.
template <bool kAnyHit>
__device__ int traverse(const Tree& tr, const Walk& w, float& t_best, float& u, float& v) {
  int stack[kStack];
  float tstack[kStack];
  stack[0] = 0;
  tstack[0] = -kBig;
  int sp = 1, slot = -1;
  while (sp > 0) {
    --sp;
    const int ref = stack[sp];
    const float bound = padded(t_best);
    if (tstack[sp] > bound) continue;  // stale: pushed before t_best improved
    if (ref >= 0) {
      const float* b = tr.boxes + 24 * ref;
      const int* m = tr.meta + 8 * ref;
      const int nc = tr.nchild[ref];
      float ts[4];
      int es[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ts[c] = kBig;
        es[c] = m[4 + c] > 0 ? ~(4 * ref + c) : m[c];
        if (c < nc) {
          const float t0x = (b[c] - w.r.ox) * w.ix, t0y = (b[4 + c] - w.r.oy) * w.iy;
          const float t0z = (b[8 + c] - w.r.oz) * w.iz, t1x = (b[12 + c] - w.r.ox) * w.ix;
          const float t1y = (b[16 + c] - w.r.oy) * w.iy, t1z = (b[20 + c] - w.r.oz) * w.iz;
          const float tin = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                                    nan_min(t0z, t1z));
          const float tout = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                                     nan_max(t0z, t1z));
          const float pad = kSlabEps * (1.0f + fabsf(tout));
          if (tin <= tout + pad && tout >= -pad && tin <= bound) ts[c] = tin;
        }
      }
      // Descending sort: the nearest child is pushed last and popped first.
      constexpr int kNet[5][2] = {{0, 1}, {2, 3}, {0, 2}, {1, 3}, {1, 2}};
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const int a = kNet[k][0], bb = kNet[k][1];
        if (ts[a] < ts[bb]) {
          const float tt = ts[a];
          ts[a] = ts[bb];
          ts[bb] = tt;
          const int ee = es[a];
          es[a] = es[bb];
          es[bb] = ee;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (ts[c] < kBig) {
          stack[sp] = es[c];
          tstack[sp] = ts[c];
          ++sp;
        }
      }
    } else {
      const int s = ~ref;
      const int* m = tr.meta + 8 * (s >> 2);
      const int first = m[s & 3], end = first + m[4 + (s & 3)];
      for (int k = first; k < end; ++k) {
        float t, uu, vv;
        if (mt(tr.tris + 9 * k, w.r, t, uu, vv) && t < t_best) {
          t_best = t;
          slot = k;
          u = uu;
          v = vv;
          if (kAnyHit) return slot;
        }
      }
    }
  }
  return slot;
}

__device__ __forceinline__ Walk make_walk(const Ray& r) {
  return Walk{r, 1.0f / r.dx, 1.0f / r.dy, 1.0f / r.dz};
}

}  // namespace cgrt
