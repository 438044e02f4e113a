// Wide BVH traversal shared by the kernels that walk the tree: bvh4.cu
// (closest hit, any hit, the fused bounce) and soft.cu (the soft-shadow
// samplers over a tree).  A template on the node width W (2, 4 or 8); the
// layout is ops/bvh4.py's; the walk is documented in bvh4.cu.
#pragma once

#include <cstdint>

#include "sweep.cuh"

namespace cgrt {

constexpr int kStack = 64;  // ops/bvh4.py MAX_STACK (collapse_bvhw checks the bound)
constexpr float kSlabEps = 1e-5f;
constexpr float kBig = 3.4e38f;

struct Tree {
  const float* __restrict__ boxes;  // [Nw, 6W]
  const int* __restrict__ meta;     // [Nw, 2W]
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

// Compare-exchange of children a and b: the larger entry t moves to slot a
// (strictly larger; at W = 2 also on a tie, so the left child, pushed last,
// pops first, as the binary Pallas kernel's left_near = min_tl <= min_tr).
template <int W>
__device__ __forceinline__ void cswap(float (&ts)[W], int (&es)[W], int a, int b) {
  if (W == 2 ? ts[a] <= ts[b] : ts[a] < ts[b]) {
    const float tt = ts[a];
    ts[a] = ts[b];
    ts[b] = tt;
    const int ee = es[a];
    es[a] = es[b];
    es[b] = ee;
  }
}

// Descending sort of a node's children by entry t: the networks of
// pallas_bvh4.py _SORT_NET (ops/bvh4.py SORT_NET), one comparator at W = 2,
// five at W = 4, Batcher's nineteen at W = 8.
template <int W>
__device__ __forceinline__ void sort_children(float (&ts)[W], int (&es)[W]);

template <>
__device__ __forceinline__ void sort_children<2>(float (&ts)[2], int (&es)[2]) {
  cswap<2>(ts, es, 0, 1);
}

template <>
__device__ __forceinline__ void sort_children<4>(float (&ts)[4], int (&es)[4]) {
  constexpr int kNet[5][2] = {{0, 1}, {2, 3}, {0, 2}, {1, 3}, {1, 2}};
#pragma unroll
  for (int k = 0; k < 5; ++k) cswap<4>(ts, es, kNet[k][0], kNet[k][1]);
}

template <>
__device__ __forceinline__ void sort_children<8>(float (&ts)[8], int (&es)[8]) {
  constexpr int kNet[19][2] = {{0, 1}, {2, 3}, {4, 5}, {6, 7}, {0, 2}, {1, 3}, {4, 6},
                               {5, 7}, {1, 2}, {5, 6}, {0, 4}, {1, 5}, {2, 6}, {3, 7},
                               {2, 4}, {3, 5}, {1, 2}, {3, 4}, {5, 6}};
#pragma unroll
  for (int k = 0; k < 19; ++k) cswap<8>(ts, es, kNet[k][0], kNet[k][1]);
}

// Ray, its reciprocal direction and its running best.
struct Walk {
  Ray r;
  float ix, iy, iz;
};

// Traverse the W-wide tree from the root.  Closest: returns the slot
// (leaf-order row) of the nearest triangle at t < t_best and updates t_best,
// u, v; -1 if none.  Any-hit: returns the first slot found at t < t_best, -1
// if none.
template <int W, bool kAnyHit>
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
      const float* b = tr.boxes + 6 * W * ref;
      const int* m = tr.meta + 2 * W * ref;
      const int nc = tr.nchild[ref];
      float ts[W];
      int es[W];
#pragma unroll
      for (int c = 0; c < W; ++c) {
        ts[c] = kBig;
        es[c] = m[W + c] > 0 ? ~(W * ref + c) : m[c];
        if (c < nc) {
          const float t0x = (b[c] - w.r.ox) * w.ix, t0y = (b[W + c] - w.r.oy) * w.iy;
          const float t0z = (b[2 * W + c] - w.r.oz) * w.iz;
          const float t1x = (b[3 * W + c] - w.r.ox) * w.ix;
          const float t1y = (b[4 * W + c] - w.r.oy) * w.iy;
          const float t1z = (b[5 * W + c] - w.r.oz) * w.iz;
          const float tin = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                                    nan_min(t0z, t1z));
          const float tout = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                                     nan_max(t0z, t1z));
          const float pad = kSlabEps * (1.0f + fabsf(tout));
          if (tin <= tout + pad && tout >= -pad && tin <= bound) ts[c] = tin;
        }
      }
      // Descending sort: the nearest child is pushed last and popped first.
      sort_children<W>(ts, es);
#pragma unroll
      for (int c = 0; c < W; ++c) {
        if (ts[c] < kBig) {
          stack[sp] = es[c];
          tstack[sp] = ts[c];
          ++sp;
        }
      }
    } else {
      const unsigned s = static_cast<unsigned>(~ref);  // W * node + child slot
      const int* m = tr.meta + 2 * W * (s / W);
      const int first = m[s % W], end = first + m[W + s % W];
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
