// Wide BVH traversal shared by the kernels that walk the tree: bvh4.cu
// (closest hit, any hit, the fused bounce) and soft.cu (the soft-shadow
// samplers over a tree).  Templates on the node width W (2, 4 or 8); the
// record is ops/bvh4.py's (pack_nodes, pack_tris); the two walks, closest
// and any hit, are documented in bvh4.cu.
#pragma once

#include <cstdint>

#include "sweep.cuh"

namespace cgrt {

constexpr int kStack = 64;  // ops/bvh4.py MAX_STACK (collapse_bvhw checks the bound)
constexpr float kSlabEps = 1e-5f;
constexpr float kBig = 3.4e38f;

// The tree as the walks read it, both built once per tree (BVH4.nodes,
// BVH4.rows): per node one record of 2W 16-byte words, the 6W child box
// floats (lo.x of children 0..W-1, then lo.y, lo.z, hi.x, hi.y, hi.z; NaN in
// the slots past the node's child count) then the 2W meta ints bit-cast
// (meta[c]: child c's node id, or its first triangle row where meta[W + c],
// its triangle count, is > 0); per triangle three 16-byte rows (v0, 0), (e1,
// 0), (e2, 0) in leaf order.
struct Tree {
  const float4* __restrict__ nodes;  // [Nw, 2W]
  const float4* __restrict__ rows;   // [T, 3]
};

// min/max that return NaN when either side is NaN (jnp.minimum,
// torch.minimum), by compares: the host's version of min_nan / max_nan.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fmaxf(a, b);
}

// The same in one instruction each (PTX min.NaN / max.NaN, sm_80+).
__device__ __forceinline__ float min_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return nan_min(a, b);
#endif
}

__device__ __forceinline__ float max_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return nan_max(a, b);
#endif
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

// Node ref's children against the ray (reciprocal direction ix, iy, iz):
// the padded slab test of _slab, pruned past bound; ts the entry t of each
// child (kBig where it is not entered; a NaN box fails the test as the slot
// it stands for), es its stack entry (node id, or ~(W * ref + c) for leaf
// child c), sorted descending, so the nearest child comes last.
template <int W>
__device__ __forceinline__ void expand(const Tree& tr, int ref, const Ray& r, float ix, float iy,
                                       float iz, float bound, float (&ts)[W], int (&es)[W]) {
  float rec[8 * W];
  const float4* node = tr.nodes + 2 * W * ref;
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
    es[c] = __float_as_int(rec[7 * W + c]) > 0 ? ~(W * ref + c) : __float_as_int(rec[6 * W + c]);
    const float t0x = (rec[c] - r.ox) * ix, t0y = (rec[W + c] - r.oy) * iy;
    const float t0z = (rec[2 * W + c] - r.oz) * iz;
    const float t1x = (rec[3 * W + c] - r.ox) * ix;
    const float t1y = (rec[4 * W + c] - r.oy) * iy;
    const float t1z = (rec[5 * W + c] - r.oz) * iz;
    const float tin = max_nan(max_nan(min_nan(t0x, t1x), min_nan(t0y, t1y)), min_nan(t0z, t1z));
    const float tout = min_nan(min_nan(max_nan(t0x, t1x), max_nan(t0y, t1y)), max_nan(t0z, t1z));
    const float pad = kSlabEps * (1.0f + fabsf(tout));
    ts[c] = (tin <= tout + pad && tout >= -pad && tin <= bound) ? tin : kBig;
  }
  sort_children<W>(ts, es);
}

// The triangle rows [first, end) of leaf entry ref = ~(W * node + c).
template <int W>
__device__ __forceinline__ void leaf_rows(const Tree& tr, int ref, int& first, int& end) {
  const unsigned s = static_cast<unsigned>(~ref);
  const float* m = reinterpret_cast<const float*>(tr.nodes + 2 * W * (s / W)) + 6 * W + s % W;
  first = __float_as_int(__ldg(m));
  end = first + __float_as_int(__ldg(m + W));
}

// Whether a triangle lies at t in [0, t_max) on the ray: the any-hit walk.
template <int W>
__device__ __forceinline__ bool occluded(const Tree& tr, const Ray& r, float t_max) {
  const float ix = 1.0f / r.dx, iy = 1.0f / r.dy, iz = 1.0f / r.dz;
  const float bound = padded(t_max);
  int stack[kStack];
  int sp = 0, ref = 0;
  for (;;) {
    if (ref >= 0) {
      float ts[W];
      int es[W];
      expand<W>(tr, ref, r, ix, iy, iz, bound, ts, es);
      // Push the others and walk the nearest now.
#pragma unroll
      for (int c = 0; c < W - 1; ++c) {
        if (ts[c] < kBig) {
          stack[sp] = es[c];
          ++sp;
        }
      }
      if (ts[W - 1] < kBig) {
        ref = es[W - 1];
        continue;
      }
    } else {
      int first, end;
      leaf_rows<W>(tr, ref, first, end);
      for (int k = first; k < end; ++k) {
        const float4* row = tr.rows + 3 * k;
        if (mt_blocks(__ldg(row), __ldg(row + 1), __ldg(row + 2), r, t_max)) return true;
      }
    }
    if (sp == 0) return false;
    --sp;
    ref = stack[sp];
  }
}

// The closest triangle at t in [0, t_best): its row (leaf order), with
// t_best, u and v updated; -1 if none.  The closest walk.
template <int W>
__device__ __forceinline__ int closest(const Tree& tr, const Ray& r, float& t_best, float& u,
                                       float& v) {
  const float ix = 1.0f / r.dx, iy = 1.0f / r.dy, iz = 1.0f / r.dz;
  int stack[kStack];
  float tstack[kStack];
  int sp = 0, ref = 0, slot = -1;
  for (;;) {
    if (ref >= 0) {
      float ts[W];
      int es[W];
      expand<W>(tr, ref, r, ix, iy, iz, padded(t_best), ts, es);
#pragma unroll
      for (int c = 0; c < W; ++c) {
        if (ts[c] < kBig) {
          stack[sp] = es[c];
          tstack[sp] = ts[c];
          ++sp;
        }
      }
    } else {
      int first, end;
      leaf_rows<W>(tr, ref, first, end);
      for (int k = first; k < end; ++k) {
        const float4* row = tr.rows + 3 * k;
        const float4 v0 = __ldg(row), e1 = __ldg(row + 1), e2 = __ldg(row + 2);
        float t, uu, vv;
        if (mt(v0, e1, e2, r, t, uu, vv) && t < t_best) {
          t_best = t;
          slot = k;
          u = uu;
          v = vv;
        }
      }
    }
    // The next entry that is not stale (pushed before t_best improved).
    do {
      if (sp == 0) return slot;
      --sp;
    } while (tstack[sp] > padded(t_best));
    ref = stack[sp];
  }
}

}  // namespace cgrt
