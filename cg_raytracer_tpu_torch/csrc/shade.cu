// Fused differentiable shade: reconstruct + Phong from point lights and
// spherical lights at recorded hits, forward and backward.  Phase 2 of the
// two-phase gradient structure (models/whitted.py::trace_rays), behind
// ops/shade.py::_ShadeFn.
//
// Replaces four Pallas kernels of cg_raytracer_tpu/ops/pallas_shade.py:
//   cgrt_shade_fwd     <- _shade_fwd_kernel     (#23, the select-gather forward),
//   cgrt_shade_bwd     <- _shade_bwd_kernel     (#25, its VJP),
//   cgrt_shade_pre_fwd <- _shade_fwd_kernel_pre (#24, the pregathered forward),
//   cgrt_shade_pre_bwd <- _shade_bwd_kernel_pre (#26, its VJP).
// The math is _shade_math (pallas_shade.py:128-261) and _shade_math19
// (:289) op for op; the plain PyTorch twins are ops/shade.py::shade_plain and
// shade_plain_pre.  One templated body serves both table layouts:
// - select (kPre = false, T <= 256): where the Pallas kernel selected the
//   hit's row with one masked select per triangle (so T <= 64 there), a
//   thread indexes the row of tri [T, 9] and aux [T, 19] in shared memory;
// - pregathered (kPre = true, any T): where XLA gathered a [N, 19] payload
//   before the Pallas kernel and scatter-added its cotangents after, a
//   thread reads the hit's row of payload [T, 19] (v0 v1 v2, n0 n1 n2,
//   material id) from device memory and the backward adds the row's
//   cotangents into d_payload with global atomics (the id column gets none).
//   The face normal is recomputed from the vertices (it only picks the
//   facing flip) and kd, ks, shininess come from mats [M, 7] in shared memory.
//
// Inputs: rays o, d [N, 3]; the recorded prim id and shadow bits [N] (int32,
// discrete); tables tri [T, 9] (v0 v1 v2) and aux [T, 19] (n0 n1 n2, face
// normal, kd, ks, shininess), or payload [T, 19] and mats [M, 7]; lights
// [L, 6] (position, color), spheres [S, 11] (center, radius, kd, ks,
// shininess); spherical lights sph [Ls, 6] (center, color) with the recorded
// visibility fractions fracs [Ls, N] (discrete, like the bits: the shading
// uses the light's center and scales its Phong terms by the fraction,
// main.cpp:168-218).  A ray is live where
// 0 <= prim < T + S: prim < T is a triangle, T + s sphere s; any other prim
// is a miss, whose outputs and cotangents are exactly 0 (the Pallas kernel
// let misses fall through to row 0 and gated them; here they do no work).
//
// Forward (one thread per ray; tables staged in shared memory, <= 29.4 KB at
// T = 256, L = 16, S = 8): Moller-Trumbore recompute on the hit triangle
// (det_safe), the interpolated normal flipped toward the viewer, or the
// sphere quadratic recompute and geometric normal; the unit reflection of
// d; then per point light not blocked by its bit, diffuse max(ld.n, 0) and
// specular pow(max(r.ld, 1e-30), shininess) where r.ld > 0; then per
// spherical light the same terms times its fraction (a light whose fraction
// is 0 is skipped: it adds exactly 0 either way).  Outputs
// direct, ks, normal, position, each [N, 3].  The pregathered forward stages
// only mats, lights and spheres (<= 1.0 KB at M = L = 16, S = 8).
//
// Backward: the same forward recomputed in registers, then the reverse pass
// written out by hand (the Pallas kernel traced jax.vjp inside its body); a
// spherical light's terms reverse as a point light's with the direct
// cotangent scaled by its fraction.  The derivation is csrc/SHADE_BWD.md.
// Per-ray cotangents d_o, d_d [N, 3] are stored, each lane's own arithmetic,
// without atomics.  The table cotangents are summed within the warp before
// any atomic (SHADE_BWD.md, "Summation"): the lanes that add into one row
// form a group by a warp vote (__ballot_sync on "the light is not blocked"
// for a light row, which every such lane of the warp shares;
// __match_any_sync on the hit's slot for its triangle or sphere row, and on
// the material row in the pregathered kernel), each group's values are
// summed by a tree of shuffles within its mask, and its lowest lane adds
// the sums once.  Those adds go into a shared-memory copy of the
// tables, added once per block to d_tri, d_aux (or d_mats), d_lights,
// d_spheres, d_sph in device memory with atomicAdd (the wrapper zeroes
// them); the pregathered backward adds the payload row's sums straight into
// d_payload [T, 19] in device memory.  The grid is one wave of blocks that
// stride over the rays a block at a time, so every lane of a warp reaches
// the votes and each block flushes once.  fp32 atomics sum in an order that
// changes from run to run: the table gradients are not bitwise reproducible
// (they vary in the last bits), and the on-card checks compare them to
// their twin with a tolerance that covers float32 summation
// (utils/checks.py).
//
// What bounds it on an H100: the forward is ~100 FLOPs per ray and light
// against 56 bytes of ray I/O in and 48 out, so neither roof at these sizes:
// latency of the branchy per-thread program.  The backward adds ~3x the
// FLOPs and, per live ray, 25 + 6 L table cotangents.  Added lane by lane,
// coherent rays that hit one wall all add into the same rows, so those
// shared-memory atomics serialise up to 32-fold (the parent design, PERF.md
// rows 25-26); summed in the warp first, a row takes one atomic per group
// and ~5 shuffles per value.
#include <cstdint>

#include "sweep.cuh"

namespace cgrt {

constexpr float kSpecEps = 1e-30f;

// d max(a, b) / da, with a tie split in half (jnp.maximum, torch.maximum).
__device__ __forceinline__ float max_weight(float a, float b) {
  return a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

// The launch's inputs; the select path reads tris/aux, the pregathered path
// payload/mats.
struct ShadeArgs {
  const float* o;
  const float* d;
  const int* prim;
  const int* bits;
  int n;
  const float* tris;     // select: [rows, 9]
  const float* aux;      // select: [rows, 19]
  int rows;              // select: table rows (num_tris, or 1 in an all-sphere scene)
  const float* payload;  // pregathered: [num_tris, 19]
  const float* mats;     // pregathered: [num_mats, 7]
  int num_mats;
  int num_tris;
  const float* lights;  // [L, 6]
  int num_lights;
  const float* spheres;  // [S, 11]
  int num_spheres;
  const float* sph;  // [Ls, 6] spherical lights: center, color
  int num_sph;
  const float* fracs;  // [Ls, N] their visibility fractions
};

// Cotangents in and out of the backward.
struct ShadeGrads {
  const float* g_direct;
  const float* g_ks;
  const float* g_normal;
  const float* g_position;
  float* d_o;
  float* d_d;
  float* d_tri;      // select
  float* d_aux;      // select
  float* d_payload;  // pregathered
  float* d_mats;     // pregathered
  float* d_lights;
  float* d_spheres;
  float* d_sph;
};

// Shared-memory floats before the lights: tri + aux, or mats.
template <bool kPre>
__host__ __device__ __forceinline__ int head_floats(const ShadeArgs& a) {
  return kPre ? 7 * a.num_mats : 28 * a.rows;
}

// Then lights [L, 6], spheres [S, 11] and spherical lights [Ls, 6].
template <bool kPre>
__host__ __device__ __forceinline__ int sph_offset(const ShadeArgs& a) {
  return head_floats<kPre>(a) + 6 * a.num_lights + 11 * a.num_spheres;
}

template <bool kPre>
__host__ __device__ __forceinline__ int table_floats(const ShadeArgs& a) {
  return sph_offset<kPre>(a) + 6 * a.num_sph;
}

struct Tables {
  const float* tri;      // select: shared [rows, 9]
  const float* aux;      // select: shared [rows, 19]
  const float* payload;  // pregathered: device [num_tris, 19]
  const float* mats;     // pregathered: shared [num_mats, 7]
  const float* light;    // shared [L, 6]
  const float* sph;      // shared [S, 11]
  const float* sphl;     // shared [Ls, 6]
  int num_tris, num_mats, num_lights, num_spheres, num_sphl;
};

template <bool kPre>
__device__ __forceinline__ Tables stage_shade_tables(const ShadeArgs& a, float* smem) {
  const int head = head_floats<kPre>(a);
  Tables tb{smem, smem + 9 * a.rows, a.payload, smem, smem + head,
            smem + head + 6 * a.num_lights, smem + sph_offset<kPre>(a), a.num_tris,
            a.num_mats, a.num_lights, a.num_spheres, a.num_sph};
  if (kPre) {
    stage_rows(a.mats, 7 * a.num_mats, smem);
  } else {
    stage_rows(a.tris, 9 * a.rows, smem);
    stage_rows(a.aux, 19 * a.rows, smem + 9 * a.rows);
  }
  stage_rows(a.lights, 6 * a.num_lights, smem + head);
  stage_rows(a.spheres, 11 * a.num_spheres, smem + head + 6 * a.num_lights);
  stage_rows(a.sph, 6 * a.num_sph, smem + sph_offset<kPre>(a));
  return tb;
}

// The hit triangle's attributes: vertices, vertex normals, the face normal
// (which only picks the facing flip) and kd (3), ks (3), shininess.
struct TriAttr {
  const float* v;  // v0 v1 v2
  const float* n;  // n0 n1 n2
  float fx, fy, fz;
  const float* mat;
  int mat_row;  // pregathered: the row of mats
};

template <bool kPre>
__device__ __forceinline__ TriAttr tri_attr(const Tables& tb, int slot) {
  if (!kPre) {
    const float* a = tb.aux + 19 * slot;
    return TriAttr{tb.tri + 9 * slot, a, a[9], a[10], a[11], a + 12, 0};
  }
  // _shade_math19: the face normal from the vertices, normalised as the
  // other unit vectors are; the material selected by its id (rows other
  // than 1..M-1 take material 0, as the Pallas select does).
  const float* p = tb.payload + 19 * slot;
  const float e1x = p[3] - p[0], e1y = p[4] - p[1], e1z = p[5] - p[2];
  const float e2x = p[6] - p[0], e2y = p[7] - p[1], e2z = p[8] - p[2];
  float fx = e1y * e2z - e1z * e2y;
  float fy = e1z * e2x - e1x * e2z;
  float fz = e1x * e2y - e1y * e2x;
  const float finv = 1.0f / fmaxf(sqrtf(fx * fx + fy * fy + fz * fz), kNormEps);
  fx = fx * finv, fy = fy * finv, fz = fz * finv;
  int m = static_cast<int>(p[18]);
  if (m < 0 || m >= tb.num_mats || static_cast<float>(m) != p[18]) m = 0;
  return TriAttr{p, p + 9, fx, fy, fz, tb.mats + 7 * m, m};
}

// Forward of one live ray, with what the reverse pass reads.
struct Fwd {
  bool sphere;
  int row;
  TriAttr ta;  // triangle hits
  // Moller-Trumbore on the hit triangle.
  float e1x, e1y, e1z, e2x, e2y, e2z, pvx, pvy, pvz, tvx, tvy, tvz, qvx, qvy, qvz;
  float inv_det, U, V, Tn, t, u, v, w0;
  bool ok_det;
  // Interpolated normal before normalisation, its norm and reciprocal; flip.
  float ntx, nty, ntz, ns, ninv, flip;
  // Sphere quadratic.
  float ocx, ocy, ocz, qa, qb, sq, inv2a, t_sp, sntx, snty, sntz, ss, sinv;
  bool disc_ok, small, t_ok;
  // Surface.
  float px, py, pz, nx, ny, nz, kdx, kdy, kdz, ksx, ksy, ksz, shin;
  // Reflection before normalisation, its norm and reciprocal; unit reflection.
  float ddn, rtx, rty, rtz, rs, rinv, rx, ry, rz;
};

template <bool kPre>
__device__ __forceinline__ void shade_surface(const Tables& tb, const Ray& r, int slot,
                                              Fwd& f) {
  f.sphere = slot >= tb.num_tris;
  if (!f.sphere) {
    f.row = slot;
    f.ta = tri_attr<kPre>(tb, slot);
    const float* tri = f.ta.v;
    const float* a = f.ta.n;
    const float v0x = tri[0], v0y = tri[1], v0z = tri[2];
    f.e1x = tri[3] - v0x, f.e1y = tri[4] - v0y, f.e1z = tri[5] - v0z;
    f.e2x = tri[6] - v0x, f.e2y = tri[7] - v0y, f.e2z = tri[8] - v0z;
    f.pvx = r.dy * f.e2z - r.dz * f.e2y;
    f.pvy = r.dz * f.e2x - r.dx * f.e2z;
    f.pvz = r.dx * f.e2y - r.dy * f.e2x;
    const float det = f.e1x * f.pvx + f.e1y * f.pvy + f.e1z * f.pvz;
    f.ok_det = fabsf(det) > kMtEps;
    f.inv_det = f.ok_det ? 1.0f / det : 0.0f;
    f.tvx = r.ox - v0x, f.tvy = r.oy - v0y, f.tvz = r.oz - v0z;
    f.U = f.tvx * f.pvx + f.tvy * f.pvy + f.tvz * f.pvz;
    f.u = f.U * f.inv_det;
    f.qvx = f.tvy * f.e1z - f.tvz * f.e1y;
    f.qvy = f.tvz * f.e1x - f.tvx * f.e1z;
    f.qvz = f.tvx * f.e1y - f.tvy * f.e1x;
    f.V = r.dx * f.qvx + r.dy * f.qvy + r.dz * f.qvz;
    f.v = f.V * f.inv_det;
    f.Tn = f.e2x * f.qvx + f.e2y * f.qvy + f.e2z * f.qvz;
    f.t = f.Tn * f.inv_det;
    f.px = r.ox + r.dx * f.t;
    f.py = r.oy + r.dy * f.t;
    f.pz = r.oz + r.dz * f.t;
    f.w0 = 1.0f - f.u - f.v;
    f.ntx = f.w0 * a[0] + f.u * a[3] + f.v * a[6];
    f.nty = f.w0 * a[1] + f.u * a[4] + f.v * a[7];
    f.ntz = f.w0 * a[2] + f.u * a[5] + f.v * a[8];
    f.ns = sqrtf(f.ntx * f.ntx + f.nty * f.nty + f.ntz * f.ntz);
    f.ninv = 1.0f / fmaxf(f.ns, kNormEps);
    f.flip = (f.ta.fx * r.dx + f.ta.fy * r.dy + f.ta.fz * r.dz) < 0.0f ? 1.0f : -1.0f;
    f.nx = f.ntx * f.ninv * f.flip;
    f.ny = f.nty * f.ninv * f.flip;
    f.nz = f.ntz * f.ninv * f.flip;
    const float* mat = f.ta.mat;
    f.kdx = mat[0], f.kdy = mat[1], f.kdz = mat[2];
    f.ksx = mat[3], f.ksy = mat[4], f.ksz = mat[5];
    f.shin = mat[6];
  } else {
    f.row = slot - tb.num_tris;
    const float* s = tb.sph + 11 * f.row;
    f.ocx = r.ox - s[0], f.ocy = r.oy - s[1], f.ocz = r.oz - s[2];
    f.qa = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
    f.qb = 2.0f * (r.dx * f.ocx + r.dy * f.ocy + r.dz * f.ocz);
    const float qc = f.ocx * f.ocx + f.ocy * f.ocy + f.ocz * f.ocz - s[3] * s[3];
    const float disc = f.qb * f.qb - 4.0f * f.qa * qc;
    f.disc_ok = disc > 0.0f;
    f.sq = f.disc_ok ? sqrtf(disc) : 0.0f;
    f.inv2a = 1.0f / (2.0f * f.qa);
    const float t_small = (-f.qb - f.sq) * f.inv2a;
    const float t_big = (-f.qb + f.sq) * f.inv2a;
    f.small = t_small >= 0.0f;
    const float t_sel = f.small ? t_small : t_big;
    f.t_ok = f.disc_ok && t_sel >= 0.0f;
    f.t_sp = f.t_ok ? t_sel : 0.0f;
    f.px = r.ox + r.dx * f.t_sp;
    f.py = r.oy + r.dy * f.t_sp;
    f.pz = r.oz + r.dz * f.t_sp;
    f.sntx = f.px - s[0], f.snty = f.py - s[1], f.sntz = f.pz - s[2];
    f.ss = sqrtf(f.sntx * f.sntx + f.snty * f.snty + f.sntz * f.sntz);
    f.sinv = 1.0f / fmaxf(f.ss, kNormEps);
    f.nx = f.sntx * f.sinv, f.ny = f.snty * f.sinv, f.nz = f.sntz * f.sinv;
    f.kdx = s[4], f.kdy = s[5], f.kdz = s[6];
    f.ksx = s[7], f.ksy = s[8], f.ksz = s[9];
    f.shin = s[10];
  }
  f.ddn = r.dx * f.nx + r.dy * f.ny + r.dz * f.nz;
  f.rtx = r.dx - 2.0f * f.ddn * f.nx;
  f.rty = r.dy - 2.0f * f.ddn * f.ny;
  f.rtz = r.dz - 2.0f * f.ddn * f.nz;
  f.rs = sqrtf(f.rtx * f.rtx + f.rty * f.rty + f.rtz * f.rtz);
  f.rinv = 1.0f / fmaxf(f.rs, kNormEps);
  f.rx = f.rtx * f.rinv, f.ry = f.rty * f.rinv, f.rz = f.rtz * f.rinv;
}

// One light's geometry and Phong terms at the surface.
struct LightTerms {
  float tox, toy, toz, ls, linv, ldx, ldy, ldz, x, dcos, scos, b, spec;
};

__device__ __forceinline__ LightTerms light_terms(const Fwd& f, const float* lrow) {
  LightTerms L;
  L.tox = lrow[0] - f.px, L.toy = lrow[1] - f.py, L.toz = lrow[2] - f.pz;
  L.ls = sqrtf(L.tox * L.tox + L.toy * L.toy + L.toz * L.toz);
  L.linv = 1.0f / fmaxf(L.ls, kNormEps);
  L.ldx = L.tox * L.linv, L.ldy = L.toy * L.linv, L.ldz = L.toz * L.linv;
  L.x = L.ldx * f.nx + L.ldy * f.ny + L.ldz * f.nz;
  L.dcos = fmaxf(L.x, 0.0f);
  L.scos = f.rx * L.ldx + f.ry * L.ldy + f.rz * L.ldz;
  L.b = fmaxf(L.scos, kSpecEps);
  L.spec = L.scos > 0.0f ? powf(L.b, f.shin) : 0.0f;
  return L;
}

__device__ __forceinline__ bool live_slot(int slot, const Tables& tb) {
  return slot >= 0 && slot < tb.num_tris + tb.num_spheres;
}

template <bool kPre>
__global__ void __launch_bounds__(kThreads)
    shade_fwd_kernel(ShadeArgs a, float* __restrict__ direct, float* __restrict__ ks_out,
                     float* __restrict__ normal, float* __restrict__ position) {
  extern __shared__ float smem[];
  const Tables tb = stage_shade_tables<kPre>(a, smem);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int slot = a.prim[i];
  float out[12] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (live_slot(slot, tb)) {
    const Ray r = load_ray(a.o, a.d, i);
    Fwd f;
    shade_surface<kPre>(tb, r, slot, f);
    const int bits = a.bits[i];
    for (int l = 0; l < tb.num_lights; ++l) {
      if ((bits >> l) & 1) continue;
      const float* lrow = tb.light + 6 * l;
      const LightTerms L = light_terms(f, lrow);
      out[0] = out[0] + lrow[3] * (f.kdx * L.dcos + f.ksx * L.spec);
      out[1] = out[1] + lrow[4] * (f.kdy * L.dcos + f.ksy * L.spec);
      out[2] = out[2] + lrow[5] * (f.kdz * L.dcos + f.ksz * L.spec);
    }
    for (int l = 0; l < tb.num_sphl; ++l) {
      const float w = a.fracs[static_cast<size_t>(l) * a.n + i];
      if (w == 0.0f) continue;
      const float* lrow = tb.sphl + 6 * l;
      const LightTerms L = light_terms(f, lrow);
      out[0] = out[0] + lrow[3] * (f.kdx * L.dcos + f.ksx * L.spec) * w;
      out[1] = out[1] + lrow[4] * (f.kdy * L.dcos + f.ksy * L.spec) * w;
      out[2] = out[2] + lrow[5] * (f.kdz * L.dcos + f.ksz * L.spec) * w;
    }
    out[3] = f.ksx, out[4] = f.ksy, out[5] = f.ksz;
    out[6] = f.nx, out[7] = f.ny, out[8] = f.nz;
    out[9] = f.px, out[10] = f.py, out[11] = f.pz;
  }
  for (int c = 0; c < 3; ++c) {
    direct[3 * i + c] = out[c];
    ks_out[3 * i + c] = out[3 + c];
    normal[3 * i + c] = out[6 + c];
    position[3 * i + c] = out[9 + c];
  }
}

// Reverse of y = x * inv, inv = 1 / max(s, eps), s = |x|: adds dy's pull-back to gx.
__device__ __forceinline__ void normalize_bwd(float x0, float x1, float x2, float s, float inv,
                                              float gy0, float gy1, float gy2, float& gx0,
                                              float& gx1, float& gx2) {
  gx0 += gy0 * inv;
  gx1 += gy1 * inv;
  gx2 += gy2 * inv;
  const float g_inv = gy0 * x0 + gy1 * x1 + gy2 * x2;
  const float g_s = -g_inv * inv * inv * max_weight(s, kNormEps);
  if (g_s != 0.0f) {
    const float k = g_s / s;  // d s / d x = x / s
    gx0 += k * x0;
    gx1 += k * x1;
    gx2 += k * x2;
  }
}

// Warp aggregation of the table cotangents (SHADE_BWD.md, "Summation").
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

// A lane's group: the lanes of its warp that add into the same table row
// (mask, from a warp vote), the lane's rank among them, their count, and per
// step of the reduction the lane whose partial sum it reads.
struct Group {
  unsigned mask;
  int rank, size;
  int src[5];
};

__device__ __forceinline__ unsigned lane_bit() { return 1u << (threadIdx.x % 32); }

__device__ __forceinline__ Group group_of(unsigned mask) {
  Group g;
  g.mask = mask;
  g.rank = __popc(mask & (lane_bit() - 1u));
  g.size = __popc(mask);
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    // The lane of rank + 2^s (its rank + 2^s + 1-th set bit), where there is one.
    g.src[s] = g.rank + (1 << s) < g.size ? static_cast<int>(__fns(mask, 0, g.rank + (1 << s) + 1))
                                          : static_cast<int>(threadIdx.x % 32);
  }
  return g;
}

// v[0..N) summed over the group into its rank-0 lane: a tree over ranks,
// step s adding the partial sum of rank + 2^s, each shuffle within the
// group's mask.  A group of one lane does no step.
template <int N>
__device__ __forceinline__ void group_sum(const Group& g, float* v) {
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    if ((1 << s) >= g.size) break;
    const bool take = g.rank + (1 << s) < g.size;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float other = __shfl_sync(g.mask, v[k], g.src[s]);
      if (take) v[k] += other;
    }
  }
}

// The group of the lanes whose key matches this lane's (key -1: no row).
// Every lane of the warp calls it.  A warp whose lanes hit many distinct
// rows forms many small groups, each adding its own sums: lane by lane
// past a threshold of distinct rows measured slower for every threshold
// (PERF.md, the shade backward).
__device__ __forceinline__ Group row_group(bool live, int key) {
  return group_of(__match_any_sync(kFullWarp, live ? key : -1));
}

template <int N>
__device__ __forceinline__ void add_row(float* dst, const float* v) {
#pragma unroll
  for (int k = 0; k < N; ++k) atomicAdd(&dst[k], v[k]);
}

// One light row's six cotangents (position, color) from the lanes where act
// holds, all of which add into that row: summed over them and added once.
// Every lane of the warp calls it.
__device__ __forceinline__ void add_light_row(bool act, float* row, float* acc_row) {
  const unsigned mask = __ballot_sync(kFullWarp, act);
  if (!act) return;
  const Group g = group_of(mask);
  group_sum<6>(g, row);
  if (g.rank == 0) add_row<6>(acc_row, row);
}

template <bool kPre>
__global__ void __launch_bounds__(kThreads) shade_bwd_kernel(ShadeArgs a, ShadeGrads g) {
  extern __shared__ float smem[];
  const int floats = table_floats<kPre>(a), head = head_floats<kPre>(a);
  const Tables tb = stage_shade_tables<kPre>(a, smem);
  // Gradient accumulators: the same layout, right after the tables.
  float* acc = smem + floats;
  float* a_tri = acc;                // select
  float* a_aux = acc + 9 * a.rows;   // select
  float* a_mat = acc;                // pregathered
  float* a_light = acc + head;
  float* a_sph = acc + head + 6 * a.num_lights;
  float* a_sphl = acc + sph_offset<kPre>(a);
  for (int k = threadIdx.x; k < floats; k += blockDim.x) acc[k] = 0.0f;
  __syncthreads();

  // base is the same for the whole block, so every lane of a warp reaches
  // the warp votes, live or not.
  for (int base = blockIdx.x * blockDim.x; base < a.n; base += gridDim.x * blockDim.x) {
    const int i = base + threadIdx.x;
    const int slot = i < a.n ? a.prim[i] : -1;
    const bool live = live_slot(slot, tb);
    float go[3] = {0.0f, 0.0f, 0.0f}, gd[3] = {0.0f, 0.0f, 0.0f};
    // The surface row's cotangents: a triangle's vertices (9), normals (9)
    // and material (kd, ks, shininess: 7), or a sphere's row (11).
    float gs[25];
#pragma unroll
    for (int k = 0; k < 25; ++k) gs[k] = 0.0f;
    Ray r;
    Fwd f;
    int bits = 0;
    float gD[3] = {0.0f, 0.0f, 0.0f};
    // Cotangents of the surface: position and normal, kd, ks, shininess,
    // and of the unit reflection.
    float gpx = 0.0f, gpy = 0.0f, gpz = 0.0f, gnx = 0.0f, gny = 0.0f, gnz = 0.0f;
    float gkd[3] = {0.0f, 0.0f, 0.0f}, gks[3] = {0.0f, 0.0f, 0.0f};
    float gshin = 0.0f, grx = 0.0f, gry = 0.0f, grz = 0.0f;
    if (live) {
      r = load_ray(a.o, a.d, i);
      shade_surface<kPre>(tb, r, slot, f);
      bits = a.bits[i];
      gD[0] = g.g_direct[3 * i], gD[1] = g.g_direct[3 * i + 1], gD[2] = g.g_direct[3 * i + 2];
      gpx = g.g_position[3 * i], gpy = g.g_position[3 * i + 1], gpz = g.g_position[3 * i + 2];
      gnx = g.g_normal[3 * i], gny = g.g_normal[3 * i + 1], gnz = g.g_normal[3 * i + 2];
      gks[0] = g.g_ks[3 * i], gks[1] = g.g_ks[3 * i + 1], gks[2] = g.g_ks[3 * i + 2];
    }

    // Lights (SHADE_BWD.md, "Lights"): one light row's reverse, for the
    // direct cotangent gL (gD, or gD times a spherical light's fraction),
    // writing the row's cotangents (position, then color) to row.
    auto light_bwd = [&](const float* lrow, const float* gL, float* row) {
      const LightTerms L = light_terms(f, lrow);
      const float kd[3] = {f.kdx, f.kdy, f.kdz}, ks[3] = {f.ksx, f.ksy, f.ksz};
      float g_dcos = 0.0f, g_spec = 0.0f;
      for (int c = 0; c < 3; ++c) {
        const float gA = gL[c] * lrow[3 + c];
        row[3 + c] = gL[c] * (kd[c] * L.dcos + ks[c] * L.spec);
        gkd[c] += gA * L.dcos;
        gks[c] += gA * L.spec;
        g_dcos += gA * kd[c];
        g_spec += gA * ks[c];
      }
      float g_scos = 0.0f;
      if (L.scos > 0.0f) {
        gshin += g_spec * L.spec * logf(L.b);
        g_scos = g_spec * f.shin * powf(L.b, f.shin - 1.0f) * max_weight(L.scos, kSpecEps);
      }
      const float g_x = g_dcos * max_weight(L.x, 0.0f);
      // scos = r . ld, x = ld . n
      grx += g_scos * L.ldx, gry += g_scos * L.ldy, grz += g_scos * L.ldz;
      const float gldx = g_scos * f.rx + g_x * f.nx;
      const float gldy = g_scos * f.ry + g_x * f.ny;
      const float gldz = g_scos * f.rz + g_x * f.nz;
      gnx += g_x * L.ldx, gny += g_x * L.ldy, gnz += g_x * L.ldz;
      // ld = normalize(to), to = light - p
      float gtx = 0.0f, gty = 0.0f, gtz = 0.0f;
      normalize_bwd(L.tox, L.toy, L.toz, L.ls, L.linv, gldx, gldy, gldz, gtx, gty, gtz);
      row[0] = gtx, row[1] = gty, row[2] = gtz;
      gpx -= gtx, gpy -= gty, gpz -= gtz;
    };
    for (int l = 0; l < tb.num_lights; ++l) {
      const bool act = live && !((bits >> l) & 1);
      float row[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (act) light_bwd(tb.light + 6 * l, gD, row);
      add_light_row(act, row, a_light + 6 * l);
    }
    // Spherical lights (SHADE_BWD.md, "Spherical lights").
    for (int l = 0; l < tb.num_sphl; ++l) {
      const float w = live ? a.fracs[static_cast<size_t>(l) * a.n + i] : 0.0f;
      const bool act = w != 0.0f;
      float row[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (act) {
        const float gW[3] = {gD[0] * w, gD[1] * w, gD[2] * w};
        light_bwd(tb.sphl + 6 * l, gW, row);
      }
      add_light_row(act, row, a_sphl + 6 * l);
    }

    if (live) {
      // Reflection: r = normalize(rt), rt = d - 2 (d . n) n (SHADE_BWD.md, "Reflection").
      float grtx = 0.0f, grty = 0.0f, grtz = 0.0f;
      normalize_bwd(f.rtx, f.rty, f.rtz, f.rs, f.rinv, grx, gry, grz, grtx, grty, grtz);
      gd[0] += grtx, gd[1] += grty, gd[2] += grtz;
      const float g_ddn = -2.0f * (grtx * f.nx + grty * f.ny + grtz * f.nz);
      const float m = -2.0f * f.ddn;
      gnx += m * grtx + g_ddn * r.dx;
      gny += m * grty + g_ddn * r.dy;
      gnz += m * grtz + g_ddn * r.dz;
      gd[0] += g_ddn * f.nx, gd[1] += g_ddn * f.ny, gd[2] += g_ddn * f.nz;

      if (f.sphere) {
        // Sphere (SHADE_BWD.md, "Sphere").
        const float* s = tb.sph + 11 * f.row;
        float gsx = gpx, gsy = gpy, gsz = gpz;  // cotangent of the point sp
        float gcx = 0.0f, gcy = 0.0f, gcz = 0.0f;
        float gsnx = 0.0f, gsny = 0.0f, gsnz = 0.0f;
        normalize_bwd(f.sntx, f.snty, f.sntz, f.ss, f.sinv, gnx, gny, gnz, gsnx, gsny, gsnz);
        gsx += gsnx, gsy += gsny, gsz += gsnz;
        gcx -= gsnx, gcy -= gsny, gcz -= gsnz;
        go[0] += gsx, go[1] += gsy, go[2] += gsz;
        gd[0] += gsx * f.t_sp, gd[1] += gsy * f.t_sp, gd[2] += gsz * f.t_sp;
        float grad = 0.0f;
        if (f.t_ok) {
          const float g_t = gsx * r.dx + gsy * r.dy + gsz * r.dz;
          const float sgn = f.small ? -1.0f : 1.0f;  // t = (-qb -/+ sq) * inv2a
          float g_qb = -g_t * f.inv2a;
          const float g_sq = sgn * g_t * f.inv2a;
          const float g_inv2a = g_t * (-f.qb + sgn * f.sq);
          float g_qa = -2.0f * g_inv2a * f.inv2a * f.inv2a;
          const float rad = s[3];
          const float g_disc = g_sq * 0.5f / f.sq;
          g_qb += 2.0f * f.qb * g_disc;
          const float qc = f.ocx * f.ocx + f.ocy * f.ocy + f.ocz * f.ocz - rad * rad;
          g_qa += -4.0f * qc * g_disc;
          const float g_qc = -4.0f * f.qa * g_disc;
          // qa = d.d, qb = 2 d.oc, qc = oc.oc - rad^2, oc = o - c
          gd[0] += 2.0f * g_qa * r.dx + 2.0f * g_qb * f.ocx;
          gd[1] += 2.0f * g_qa * r.dy + 2.0f * g_qb * f.ocy;
          gd[2] += 2.0f * g_qa * r.dz + 2.0f * g_qb * f.ocz;
          const float gocx = 2.0f * g_qb * r.dx + 2.0f * g_qc * f.ocx;
          const float gocy = 2.0f * g_qb * r.dy + 2.0f * g_qc * f.ocy;
          const float gocz = 2.0f * g_qb * r.dz + 2.0f * g_qc * f.ocz;
          go[0] += gocx, go[1] += gocy, go[2] += gocz;
          gcx -= gocx, gcy -= gocy, gcz -= gocz;
          grad = -2.0f * rad * g_qc;
        }
        gs[0] = gcx, gs[1] = gcy, gs[2] = gcz, gs[3] = grad;
        for (int c = 0; c < 3; ++c) gs[4 + c] = gkd[c], gs[7 + c] = gks[c];
        gs[10] = gshin;
      } else {
        // Triangle (SHADE_BWD.md, "Normal" and "Moller-Trumbore").
        const float* nv = f.ta.n;
        float gntx = 0.0f, gnty = 0.0f, gntz = 0.0f;
        normalize_bwd(f.ntx, f.nty, f.ntz, f.ns, f.ninv, gnx * f.flip, gny * f.flip,
                      gnz * f.flip, gntx, gnty, gntz);
        const float g_w0 = gntx * nv[0] + gnty * nv[1] + gntz * nv[2];
        const float g_u = gntx * nv[3] + gnty * nv[4] + gntz * nv[5] - g_w0;
        const float g_v = gntx * nv[6] + gnty * nv[7] + gntz * nv[8] - g_w0;
        gs[9] = f.w0 * gntx, gs[10] = f.w0 * gnty, gs[11] = f.w0 * gntz;
        gs[12] = f.u * gntx, gs[13] = f.u * gnty, gs[14] = f.u * gntz;
        gs[15] = f.v * gntx, gs[16] = f.v * gnty, gs[17] = f.v * gntz;
        for (int c = 0; c < 3; ++c) gs[18 + c] = gkd[c], gs[21 + c] = gks[c];
        gs[24] = gshin;
        // p = o + d t
        go[0] += gpx, go[1] += gpy, go[2] += gpz;
        gd[0] += gpx * f.t, gd[1] += gpy * f.t, gd[2] += gpz * f.t;
        const float g_t = gpx * r.dx + gpy * r.dy + gpz * r.dz;
        // u = U inv_det, v = V inv_det, t = Tn inv_det
        const float g_inv = g_u * f.U + g_v * f.V + g_t * f.Tn;
        const float gU = g_u * f.inv_det, gV = g_v * f.inv_det, gT = g_t * f.inv_det;
        // U = tv . pv, V = d . qv, Tn = e2 . qv
        float gtvx = gU * f.pvx, gtvy = gU * f.pvy, gtvz = gU * f.pvz;
        float gpvx = gU * f.tvx, gpvy = gU * f.tvy, gpvz = gU * f.tvz;
        gd[0] += gV * f.qvx, gd[1] += gV * f.qvy, gd[2] += gV * f.qvz;
        const float gqx = gV * r.dx + gT * f.e2x;
        const float gqy = gV * r.dy + gT * f.e2y;
        const float gqz = gV * r.dz + gT * f.e2z;
        float ge2x = gT * f.qvx, ge2y = gT * f.qvy, ge2z = gT * f.qvz;
        // qv = tv x e1: g_tv += e1 x g_qv, g_e1 = g_qv x tv
        gtvx += f.e1y * gqz - f.e1z * gqy;
        gtvy += f.e1z * gqx - f.e1x * gqz;
        gtvz += f.e1x * gqy - f.e1y * gqx;
        float ge1x = gqy * f.tvz - gqz * f.tvy;
        float ge1y = gqz * f.tvx - gqx * f.tvz;
        float ge1z = gqx * f.tvy - gqy * f.tvx;
        // tv = o - v0
        go[0] += gtvx, go[1] += gtvy, go[2] += gtvz;
        // inv_det = 1 / det where |det| > eps (det_safe), det = e1 . pv
        const float g_det = f.ok_det ? -g_inv * f.inv_det * f.inv_det : 0.0f;
        ge1x += g_det * f.pvx, ge1y += g_det * f.pvy, ge1z += g_det * f.pvz;
        gpvx += g_det * f.e1x, gpvy += g_det * f.e1y, gpvz += g_det * f.e1z;
        // pv = d x e2: g_d += e2 x g_pv, g_e2 += g_pv x d
        gd[0] += f.e2y * gpvz - f.e2z * gpvy;
        gd[1] += f.e2z * gpvx - f.e2x * gpvz;
        gd[2] += f.e2x * gpvy - f.e2y * gpvx;
        ge2x += gpvy * r.dz - gpvz * r.dy;
        ge2y += gpvz * r.dx - gpvx * r.dz;
        ge2z += gpvx * r.dy - gpvy * r.dx;
        // e1 = v1 - v0, e2 = v2 - v0, tv = o - v0
        gs[0] = -gtvx - ge1x - ge2x, gs[1] = -gtvy - ge1y - ge2y, gs[2] = -gtvz - ge1z - ge2z;
        gs[3] = ge1x, gs[4] = ge1y, gs[5] = ge1z;
        gs[6] = ge2x, gs[7] = ge2y, gs[8] = ge2z;
      }
    }

    // The surface rows, grouped by the hit's slot (a triangle or a sphere,
    // never both in one group).  Vertex and normal cotangents go to the
    // shared tri/aux copies, or straight to the device payload; material
    // ones to aux columns 12-18, or to mats grouped by material row.
    const Group gr = row_group(live, slot);
    if (live) {
      group_sum<kPre ? 18 : 25>(gr, gs);
      if (gr.rank == 0) {
        if (f.sphere) {
          add_row<11>(a_sph + 11 * f.row, gs);
        } else if (kPre) {
          add_row<18>(g.d_payload + 19 * f.row, gs);
        } else {
          add_row<9>(a_tri + 9 * f.row, gs);
          add_row<9>(a_aux + 19 * f.row, gs + 9);
          add_row<7>(a_aux + 19 * f.row + 12, gs + 18);
        }
      }
    }
    if (kPre) {
      const bool tri_hit = live && !f.sphere;
      const Group gm = row_group(tri_hit, tri_hit ? f.ta.mat_row : -1);
      if (tri_hit) {
        group_sum<7>(gm, gs + 18);
        if (gm.rank == 0) add_row<7>(a_mat + 7 * f.ta.mat_row, gs + 18);
      }
    }
    if (i < a.n) {
      for (int c = 0; c < 3; ++c) {
        g.d_o[3 * i + c] = go[c];
        g.d_d[3 * i + c] = gd[c];
      }
    }
  }

  __syncthreads();
  for (int k = threadIdx.x; k < floats; k += blockDim.x) {
    const float v = acc[k];
    if (v == 0.0f) continue;
    if (k < head) {
      if (kPre) {
        atomicAdd(&g.d_mats[k], v);
      } else if (k < 9 * a.rows) {
        atomicAdd(&g.d_tri[k], v);
      } else {
        atomicAdd(&g.d_aux[k - 9 * a.rows], v);
      }
    } else if (k < head + 6 * a.num_lights) {
      atomicAdd(&g.d_lights[k - head], v);
    } else if (k < sph_offset<kPre>(a)) {
      atomicAdd(&g.d_spheres[k - head - 6 * a.num_lights], v);
    } else {
      atomicAdd(&g.d_sph[k - sph_offset<kPre>(a)], v);
    }
  }
}

template <bool kPre>
int launch_fwd(const ShadeArgs& a, float* direct, float* ks, float* normal, float* position,
               cudaStream_t stream) {
  if (a.n > 0) {
    shade_fwd_kernel<kPre><<<num_blocks(a.n), kThreads, sizeof(float) * table_floats<kPre>(a),
                             stream>>>(a, direct, ks, normal, position);
  }
  return static_cast<int>(cudaGetLastError());
}

// One wave of blocks striding over the rays, so each block flushes its
// accumulators once.
template <bool kPre>
int launch_bwd(const ShadeArgs& a, const ShadeGrads& g, cudaStream_t stream) {
  if (a.n <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = 2 * sizeof(float) * table_floats<kPre>(a);
  cudaError_t err = cudaFuncSetAttribute(shade_bwd_kernel<kPre>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, shade_bwd_kernel<kPre>,
                                                           kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  const int wave = sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = num_blocks(a.n) < wave ? num_blocks(a.n) : wave;
  shade_bwd_kernel<kPre><<<blocks, kThreads, smem, stream>>>(a, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cgrt

extern "C" {

// sph [Ls, 6] and fracs [Ls, N]: the spherical lights and their fractions.
int cgrt_shade_fwd(const float* o, const float* d, const int* prim, const int* bits, int n,
                   const float* tris, const float* aux, int rows, int num_tris,
                   const float* lights, int num_lights, const float* spheres, int num_spheres,
                   const float* sph, int num_sph, const float* fracs, float* direct, float* ks,
                   float* normal, float* position, cudaStream_t stream) {
  const cgrt::ShadeArgs a{o, d, prim, bits, n, tris, aux, rows, nullptr, nullptr, 0,
                          num_tris, lights, num_lights, spheres, num_spheres, sph, num_sph,
                          fracs};
  return cgrt::launch_fwd<false>(a, direct, ks, normal, position, stream);
}

// The table cotangents d_tri, d_aux, d_lights, d_spheres, d_sph are added to
// (the caller zeroes them); d_o and d_d are written.
int cgrt_shade_bwd(const float* o, const float* d, const int* prim, const int* bits, int n,
                   const float* tris, const float* aux, int rows, int num_tris,
                   const float* lights, int num_lights, const float* spheres, int num_spheres,
                   const float* sph, int num_sph, const float* fracs, const float* g_direct,
                   const float* g_ks, const float* g_normal, const float* g_position,
                   float* d_o, float* d_d, float* d_tri, float* d_aux, float* d_lights,
                   float* d_spheres, float* d_sph, cudaStream_t stream) {
  const cgrt::ShadeArgs a{o, d, prim, bits, n, tris, aux, rows, nullptr, nullptr, 0,
                          num_tris, lights, num_lights, spheres, num_spheres, sph, num_sph,
                          fracs};
  const cgrt::ShadeGrads g{g_direct, g_ks, g_normal, g_position, d_o, d_d, d_tri, d_aux,
                           nullptr, nullptr, d_lights, d_spheres, d_sph};
  return cgrt::launch_bwd<false>(a, g, stream);
}

int cgrt_shade_pre_fwd(const float* o, const float* d, const int* prim, const int* bits, int n,
                       const float* payload, int num_tris, const float* mats, int num_mats,
                       const float* lights, int num_lights, const float* spheres,
                       int num_spheres, const float* sph, int num_sph, const float* fracs,
                       float* direct, float* ks, float* normal, float* position,
                       cudaStream_t stream) {
  const cgrt::ShadeArgs a{o, d, prim, bits, n, nullptr, nullptr, 0, payload, mats, num_mats,
                          num_tris, lights, num_lights, spheres, num_spheres, sph, num_sph,
                          fracs};
  return cgrt::launch_fwd<true>(a, direct, ks, normal, position, stream);
}

// d_payload, d_mats, d_lights, d_spheres, d_sph are added to (the caller
// zeroes them); d_o and d_d are written.
int cgrt_shade_pre_bwd(const float* o, const float* d, const int* prim, const int* bits, int n,
                       const float* payload, int num_tris, const float* mats, int num_mats,
                       const float* lights, int num_lights, const float* spheres,
                       int num_spheres, const float* sph, int num_sph, const float* fracs,
                       const float* g_direct, const float* g_ks, const float* g_normal,
                       const float* g_position, float* d_o, float* d_d, float* d_payload,
                       float* d_mats, float* d_lights, float* d_spheres, float* d_sph,
                       cudaStream_t stream) {
  const cgrt::ShadeArgs a{o, d, prim, bits, n, nullptr, nullptr, 0, payload, mats, num_mats,
                          num_tris, lights, num_lights, spheres, num_spheres, sph, num_sph,
                          fracs};
  const cgrt::ShadeGrads g{g_direct, g_ks, g_normal, g_position, d_o, d_d, nullptr, nullptr,
                           d_payload, d_mats, d_lights, d_spheres, d_sph};
  return cgrt::launch_bwd<true>(a, g, stream);
}

}  // extern "C"
