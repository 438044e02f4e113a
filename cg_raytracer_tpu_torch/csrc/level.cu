// One bounce level of the default forward route: the hit's surface
// (reconstruct_hit), Phong over the point and spherical lights
// (direct_light) and the level's update (color, throughput, the active mask
// and the next rays), one thread per ray.  Behind ops/level.py::level_cuda,
// called by models/whitted.py::trace_rays once per level.
//
// Replaces the JAX package's compiled one-phase level
// (cg_raytracer_tpu/models/whitted.py:697-727, shade_level :600-613), which
// is not a Pallas kernel: under jax.jit XLA fuses each level into a few
// fusions.  Run as plain PyTorch, the same level is ~230 small elementwise
// launches (ops/intersect.py::reconstruct_hit, ops/shading.py, the update;
// chip_smoke.py phase 37 counts a graphed frame's kernels both ways).
// The plain twin is ops/level.py::level_plain, which is that chain.
//
// Three entry points of one body:
// - cgrt_level: surface, shade and update in one launch, where the shadow
//   bits come from a fused bounce kernel and the scene has no spherical
//   lights (the box, the teacup, the donut, every tree walk);
// - cgrt_level_surface: the surface alone (position, normal, kd, ks,
//   shininess, valid), for the routes whose next step reads it: the
//   spherical lights' sampler, or the shadow rays of a backend without a
//   fused bounce;
// - cgrt_level_shade: the shade and update from that surface, with the
//   shadow bits or the per-light blocked masks [L, N] and the spherical
//   lights' fractions [Ls, N].
//
// Numerics: the output equals the chain's bit for bit on the card.  The
// library is built with -fmad=false and no fast math (ops/_build.py), so
// each multiply and add rounds alone as a PyTorch elementwise op does, and
// every expression follows the chain's order: dots are ((x + y) + z);
// safe_normalize divides each component by max(sqrt(dot), 1e-20); the
// clamps propagate NaN as torch.clamp_min does; the diffuse term is
// (light_color * kd) * max(cos, 0); direct light adds light by light in
// index order from 0, the point lights and the spherical lights each in a
// sum of their own, added at the end; pow is powf, which torch.pow runs.
// Lanes that are not triangle hits skip the chain's gated triangle math:
// the chain discards it with torch.where, so it reaches no output.  A miss
// has a zero surface (shininess 1), so its next origin is
// REFLECT_EPS * safe_normalize(d) and its next direction d, as the chain
// gives.
//
// What bounds it on an H100: bytes.  A ray streams its o, d, prim id, bits,
// state in and out (~100 bytes with two levels of state) and gathers its
// triangle's indices, three vertices, three normals and material (~90 bytes,
// mostly from the L2); its arithmetic is ~150 operations for the surface and
// ~60 per light, far under the float rate.  The design is the simplest one
// that is right: one thread per ray over a grid-stride loop, no shared
// memory; the scene rows come through the read-only cache.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace cgrt_levels {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // a grid of up to eight blocks per SM, striding
constexpr float kNormEps = 1e-20f;   // linalg.safe_normalize
constexpr float kMtEps = 1e-9f;      // intersect.moller_trumbore
constexpr float kSpecEps = 1e-30f;   // shading.phong_one_light
constexpr float kReflectEps = 1e-3f;  // models/whitted.py::REFLECT_EPS
constexpr float kReflective = 0.01f;  // the continue test, main.cpp:246

// One launch's inputs and outputs (ops/level.py::_Args mirrors it field by
// field).  Null inputs: active, throughput, color at level 0 (all active,
// throughput 1, color 0); bits or masks where the other is given; fracs
// without spherical lights.  Null outputs: throughput_out, active_out,
// o_next, d_next at the last level.
struct LevelArgs {
  const float* o;  // [N, 3]
  const float* d;  // [N, 3]
  const int32_t* prim;  // [N]: -1 a miss, [0, T) a triangle, T + s sphere s
  int32_t n;
  const uint8_t* active;  // [N]
  const float* throughput;  // [N, 3]
  const float* color;  // [N, 3]
  const int32_t* bits;  // [N]: bit l set where point light l is blocked
  const uint8_t* masks;  // [L, N]: nonzero where point light l is blocked
  const float* fracs;  // [Ls, N]: the spherical lights' visibility fractions
  const float* vertices;  // [V, 3]
  const float* normals;  // [V, 3]
  const int32_t* triangles;  // [T, 3]
  const int32_t* tri_material;  // [T]
  const float* mat_kd;  // [M, 3]
  const float* mat_ks;  // [M, 3]
  const float* mat_shininess;  // [M]
  int32_t num_tris;
  const float* sph_center;  // [S, 3]
  const float* sph_radius;  // [S]
  const float* sph_kd;  // [S, 3]
  const float* sph_ks;  // [S, 3]
  const float* sph_shininess;  // [S]
  int32_t num_spheres;
  const float* pl_position;  // [L, 3]
  const float* pl_color;  // [L, 3]
  int32_t num_pl;
  const float* sl_position;  // [Ls, 3]
  const float* sl_color;  // [Ls, 3]
  int32_t num_sl;
  int32_t quirk_ks_z;  // reference_quirks: only ks.z is tested (main.cpp:246)
  int32_t last;  // the last level: color only
  // The surface: written by cgrt_level_surface, read by cgrt_level_shade.
  float* position;  // [N, 3]
  float* normal;  // [N, 3]
  float* kd;  // [N, 3]
  float* ks;  // [N, 3]
  float* shininess;  // [N]
  uint8_t* valid;  // [N]
  // The level's outputs.
  float* color_out;  // [N, 3]
  float* throughput_out;  // [N, 3]
  uint8_t* active_out;  // [N]
  float* o_next;  // [N, 3]
  float* d_next;  // [N, 3]
};

enum Mode : int { kFused = 0, kSurface = 1, kShade = 2 };

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) { return V3{a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return V3{a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return V3{a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return V3{a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 neg(V3 a) { return V3{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// torch.clamp_min on the card: NaN passes through, else fmaxf.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// linalg.safe_normalize: a / max(|a|, 1e-20), a division per component.
__device__ __forceinline__ V3 safe_normalize(V3 a) {
  const float n = clamp_min(sqrtf(dot(a, a)), kNormEps);
  return V3{a.x / n, a.y / n, a.z / n};
}

// linalg.reflect: I - (2 dot(N, I)) N.
__device__ __forceinline__ V3 reflect(V3 i, V3 n) { return sub(i, scale(n, 2.0f * dot(n, i))); }

__device__ __forceinline__ V3 load3(const float* p, long long row) {
  return V3{__ldg(p + 3 * row), __ldg(p + 3 * row + 1), __ldg(p + 3 * row + 2)};
}

__device__ __forceinline__ void store3(float* p, long long row, V3 v) {
  p[3 * row] = v.x;
  p[3 * row + 1] = v.y;
  p[3 * row + 2] = v.z;
}

struct Surface {
  V3 p, n, kd, ks;
  float shin;
  bool valid;
};

// ops/intersect.py::reconstruct_hit on one lane.
__device__ __forceinline__ Surface surface(const LevelArgs& a, V3 o, V3 d, int prim) {
  const V3 zero{0.0f, 0.0f, 0.0f};
  Surface s{zero, zero, zero, zero, 1.0f, prim >= 0};
  if (!s.valid) return s;
  float t;
  if (prim < a.num_tris) {
    // Moller-Trumbore on the hit triangle; the interpolated normal flipped
    // toward the viewer.
    const int i0 = __ldg(a.triangles + 3 * static_cast<long long>(prim));
    const int i1 = __ldg(a.triangles + 3 * static_cast<long long>(prim) + 1);
    const int i2 = __ldg(a.triangles + 3 * static_cast<long long>(prim) + 2);
    const V3 v0 = load3(a.vertices, i0), v1 = load3(a.vertices, i1),
             v2 = load3(a.vertices, i2);
    const V3 e1 = sub(v1, v0), e2 = sub(v2, v0);
    const V3 face_n = safe_normalize(cross(e1, e2));
    const V3 pvec = cross(d, e2);
    const float det = dot(e1, pvec);
    const bool ok_det = fabsf(det) > kMtEps;
    const float inv_det = ok_det ? 1.0f / det : 0.0f;
    const V3 tvec = sub(o, v0);
    const float u = dot(tvec, pvec) * inv_det;
    const V3 qvec = cross(tvec, e1);
    const float v = dot(d, qvec) * inv_det;
    t = dot(e2, qvec) * inv_det;
    const float w0 = (1.0f - u) - v;
    const V3 n_raw = add(add(scale(load3(a.normals, i0), w0), scale(load3(a.normals, i1), u)),
                         scale(load3(a.normals, i2), v));
    const V3 n_interp = safe_normalize(n_raw);
    s.n = dot(face_n, neg(d)) > 0.0f ? n_interp : neg(n_interp);
    const int m = __ldg(a.tri_material + prim);
    s.kd = load3(a.mat_kd, m);
    s.ks = load3(a.mat_ks, m);
    s.shin = __ldg(a.mat_shininess + m);
  } else if (a.num_spheres > 0) {
    // The quadratic in the chain's form: (-qb -+ sq) / (2 qa).
    const int sp = prim - a.num_tris < a.num_spheres ? prim - a.num_tris : a.num_spheres - 1;
    const V3 c = load3(a.sph_center, sp);
    const float r = __ldg(a.sph_radius + sp);
    const V3 oc = sub(o, c);
    const float qa = dot(d, d);
    const float qb = 2.0f * dot(d, oc);
    const float qc = dot(oc, oc) - r * r;
    const float disc = qb * qb - (4.0f * qa) * qc;
    const bool disc_ok = disc > 0.0f;
    const float sq = disc_ok ? sqrtf(disc) : 0.0f;
    const float t_small = (-qb - sq) / (2.0f * qa);
    const float t_big = (-qb + sq) / (2.0f * qa);
    const float t_sel = t_small >= 0.0f ? t_small : t_big;
    t = disc_ok && t_sel >= 0.0f ? t_sel : 0.0f;
    s.n = safe_normalize(sub(add(o, scale(d, t)), c));
    s.kd = load3(a.sph_kd, sp);
    s.ks = load3(a.sph_ks, sp);
    s.shin = __ldg(a.sph_shininess + sp);
  } else {
    // A sphere id in a scene without spheres: the chain's zero fields.
    t = 0.0f;
    s.shin = 0.0f;
  }
  s.p = add(o, scale(d, t));
  return s;
}

// shading.phong_one_light: diffuse + specular toward one light.
__device__ __forceinline__ V3 phong(const Surface& s, V3 refl, V3 ldir, V3 lc) {
  const float c = clamp_min(dot(ldir, s.n), 0.0f);
  const V3 diffuse = scale(mul(lc, s.kd), c);
  const float spec_cos = dot(refl, ldir);
  const float spec = powf(clamp_min(spec_cos, kSpecEps), s.shin);
  const V3 specular = scale(mul(lc, s.ks), spec_cos > 0.0f ? spec : 0.0f);
  return add(diffuse, specular);
}

// shading.direct_light with the shadow bits or masks, then the level's
// update (models/whitted.py::trace_rays).
__device__ __forceinline__ void shade(const LevelArgs& a, long long i, V3 d, const Surface& s) {
  const V3 zero{0.0f, 0.0f, 0.0f};
  const V3 refl = safe_normalize(reflect(d, s.n));
  V3 direct = zero;
  const int bits = a.bits != nullptr ? __ldg(a.bits + i) : 0;
  for (int l = 0; l < a.num_pl; ++l) {
    const bool blocked = a.bits != nullptr ? ((bits >> l) & 1) != 0
                                           : __ldg(a.masks + l * static_cast<long long>(a.n) + i)
                                                 != 0;
    const V3 ldir = safe_normalize(sub(load3(a.pl_position, l), s.p));
    const V3 term = phong(s, refl, ldir, load3(a.pl_color, l));
    direct = add(direct, scale(term, !blocked && s.valid ? 1.0f : 0.0f));
  }
  if (a.num_sl > 0) {
    V3 soft = zero;
    for (int l = 0; l < a.num_sl; ++l) {
      const V3 ldir = safe_normalize(sub(load3(a.sl_position, l), s.p));
      const V3 term = phong(s, refl, ldir, load3(a.sl_color, l));
      const float w = __ldg(a.fracs + l * static_cast<long long>(a.n) + i) * (s.valid ? 1.0f : 0.0f);
      soft = add(soft, scale(term, w));
    }
    direct = add(direct, soft);
  }
  const bool active = a.active == nullptr || __ldg(a.active + i) != 0;
  const V3 through = a.throughput != nullptr ? load3(a.throughput, i) : V3{1.0f, 1.0f, 1.0f};
  const V3 color = a.color != nullptr ? load3(a.color, i) : zero;
  const bool lit = active && s.valid;
  store3(a.color_out, i, add(color, scale(mul(through, direct), lit ? 1.0f : 0.0f)));
  if (a.last) return;
  const bool reflective = a.quirk_ks_z ? s.ks.z > kReflective
                                       : (s.ks.x > kReflective) | (s.ks.y > kReflective) |
                                             (s.ks.z > kReflective);
  const bool next = lit && reflective;
  a.active_out[i] = next ? 1 : 0;
  store3(a.throughput_out, i, mul(through, s.ks));
  store3(a.o_next, i, add(s.p, scale(refl, kReflectEps)));
  store3(a.d_next, i, next ? refl : d);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) level_kernel(const LevelArgs a) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < a.n;
       i += stride) {
    const V3 d = load3(a.d, i);
    Surface s;
    if (kMode == kShade) {
      s = Surface{load3(a.position, i), load3(a.normal, i), load3(a.kd, i), load3(a.ks, i),
                  __ldg(a.shininess + i), __ldg(a.valid + i) != 0};
    } else {
      s = surface(a, load3(a.o, i), d, __ldg(a.prim + i));
    }
    if (kMode == kSurface) {
      store3(a.position, i, s.p);
      store3(a.normal, i, s.n);
      store3(a.kd, i, s.kd);
      store3(a.ks, i, s.ks);
      a.shininess[i] = s.shin;
      a.valid[i] = s.valid ? 1 : 0;
    } else {
      shade(a, i, d, s);
    }
  }
}

template <int kMode>
int launch(const LevelArgs* a, cudaStream_t stream) {
  if (a->n > 0) {
    const long long want = (static_cast<long long>(a->n) + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
    level_kernel<kMode><<<blocks, kThreads, 0, stream>>>(*a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cgrt_levels

extern "C" {

// Surface, shade and update in one launch (bits given, no spherical lights).
int cgrt_level(const cgrt_levels::LevelArgs* a, cudaStream_t stream) {
  return cgrt_levels::launch<cgrt_levels::kFused>(a, stream);
}

// The surface alone: writes position, normal, kd, ks, shininess, valid.
int cgrt_level_surface(const cgrt_levels::LevelArgs* a, cudaStream_t stream) {
  return cgrt_levels::launch<cgrt_levels::kSurface>(a, stream);
}

// Shade and update from the surface, with bits or masks and the fractions.
int cgrt_level_shade(const cgrt_levels::LevelArgs* a, cudaStream_t stream) {
  return cgrt_levels::launch<cgrt_levels::kShade>(a, stream);
}

}  // extern "C"
