// Shared device code of the brute-force sweep kernels (oracle.cu, trace.cu,
// record.cu, shade.cu), of the 4-wide BVH kernels (bvh4.cu: the
// Moller-Trumbore test and the shadow ray) and of the soft-shadow samplers
// (soft.cu and bvh4.cuh's any-hit walk: the any-hit test mt_blocks).
//
// Counterpart of the helpers in cg_raytracer_tpu/ops/pallas_kernels.py:
// _mt_tile (Moller-Trumbore with the same epsilons and the det_safe form),
// _sphere_tile (the ray-sphere quadratic), the per-light shadow sweeps, and
// the attribute fetch, facing normal, reflection and continue-test that
// _trace_kernel and _bounce_refl_tile share.  One thread owns one ray and walks
// the triangle table, which every block stages in shared memory: all threads
// of a warp read the same triangle at the same step, so each read is a
// shared-memory broadcast.  The loop over triangles runs at run time, so one
// build serves every scene (the Pallas kernels unrolled it per triangle count).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace cgrt {

constexpr int kThreads = 128;
constexpr float kMtEps = 1e-9f;
constexpr float kBaryEps = 1e-6f;
constexpr float kShadowEps = 1e-3f;
constexpr float kReflectEps = 1e-3f;
constexpr float kNormEps = 1e-20f;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int i) {
  return Ray{o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1], d[3 * i + 2]};
}

// Stage [T, 9] rows (v0, v1, v2) as (v0, e1 = v1 - v0, e2 = v2 - v0).  The
// edge subtraction is the one Moller-Trumbore does per ray, done once per
// block: the same float either way.
__device__ __forceinline__ void stage_triangles(const float* __restrict__ tris,
                                                int num_tris, float* s_tri) {
  for (int k = threadIdx.x; k < num_tris; k += blockDim.x) {
    const float* r = tris + 9 * k;
    float* s = s_tri + 9 * k;
    s[0] = r[0];
    s[1] = r[1];
    s[2] = r[2];
    s[3] = r[3] - r[0];
    s[4] = r[4] - r[1];
    s[5] = r[5] - r[2];
    s[6] = r[6] - r[0];
    s[7] = r[7] - r[1];
    s[8] = r[8] - r[2];
  }
}

__device__ __forceinline__ void stage_rows(const float* __restrict__ src, int count,
                                           float* dst) {
  for (int k = threadIdx.x; k < count; k += blockDim.x) dst[k] = src[k];
}

// Moller-Trumbore against one staged triangle; true when the hit is valid.
__device__ __forceinline__ bool mt(const float* tri, const Ray& r, float& t, float& u,
                                   float& v) {
  const float v0x = tri[0], v0y = tri[1], v0z = tri[2];
  const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
  const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool ok_det = fabsf(det) > kMtEps;
  const float det_safe = ok_det ? det : 1.0f;
  const float inv_det = ok_det ? 1.0f / det_safe : 0.0f;
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return ok_det && u >= -kBaryEps && v >= -kBaryEps && u + v <= 1.0f + kBaryEps &&
         t >= 0.0f;
}

// The any-hit decision mt(...) && t < t_max for the triangle (v0, e1, e2)
// (the .w of each row unused): ok_det, then u >= -kBaryEps, v, u + v and 0
// <= t < t_max, each quantity by mt's own operations and only as far as the
// decision needs it.  Under -fmad=false nothing is contracted, so each value
// is the float mt computes.
__device__ __forceinline__ bool mt_blocks(const float4 v0, const float4 e1, const float4 e2,
                                          const Ray& r, float t_max) {
  const float px = r.dy * e2.z - r.dz * e2.y;
  const float py = r.dz * e2.x - r.dx * e2.z;
  const float pz = r.dx * e2.y - r.dy * e2.x;
  const float det = e1.x * px + e1.y * py + e1.z * pz;
  if (!(fabsf(det) > kMtEps)) return false;
  const float inv_det = 1.0f / det;
  const float tx = r.ox - v0.x, ty = r.oy - v0.y, tz = r.oz - v0.z;
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  if (!(u >= -kBaryEps)) return false;
  const float qx = ty * e1.z - tz * e1.y;
  const float qy = tz * e1.x - tx * e1.z;
  const float qz = tx * e1.y - ty * e1.x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  if (!(v >= -kBaryEps) || !(u + v <= 1.0f + kBaryEps)) return false;
  const float t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
  return t >= 0.0f && t < t_max;
}

// Closest triangle strictly nearer than t_best; the lowest index wins a tie.
__device__ __forceinline__ void closest_sweep(const float* s_tri, int num_tris,
                                              const Ray& r, float& t_best, int& slot,
                                              float& u_best, float& v_best) {
  for (int k = 0; k < num_tris; ++k) {
    float t, u, v;
    if (mt(s_tri + 9 * k, r, t, u, v) && t < t_best) {
      t_best = t;
      slot = k;
      u_best = u;
      v_best = v;
    }
  }
}

// Any triangle at t in [0, t_max); stops at the first one.
__device__ __forceinline__ bool any_hit_sweep(const float* s_tri, int num_tris,
                                              const Ray& r, float t_max) {
  for (int k = 0; k < num_tris; ++k) {
    float t, u, v;
    if (mt(s_tri + 9 * k, r, t, u, v) && t < t_max) return true;
  }
  return false;
}

// Shadow ray from a hit point toward a light at lpos (pointInShadow,
// main.cpp:104-135): origin p + SHADOW_EPS * ldir, the unit direction ldir
// (scaled by a reciprocal), and t_max = dist - SHADOW_EPS.
__device__ __forceinline__ Ray light_ray(const float* lpos, float px, float py, float pz,
                                         float& t_max) {
  const float tx = lpos[0] - px;
  const float ty = lpos[1] - py;
  const float tz = lpos[2] - pz;
  const float dist = sqrtf(tx * tx + ty * ty + tz * tz);
  const float inv = 1.0f / fmaxf(dist, kNormEps);
  const float sdx = tx * inv, sdy = ty * inv, sdz = tz * inv;
  t_max = dist - kShadowEps;
  return Ray{px + kShadowEps * sdx, py + kShadowEps * sdy, pz + kShadowEps * sdz,
             sdx, sdy, sdz};
}

// Shadow bits from a hit point: bit l set where light l (s_light [L, 3]
// positions) is occluded.
__device__ __forceinline__ int shadow_bits(const float* s_tri, int num_tris,
                                           const float* s_light, int num_lights, float px,
                                           float py, float pz) {
  int bits = 0;
  for (int l = 0; l < num_lights; ++l) {
    float t_max;
    const Ray s = light_ray(s_light + 3 * l, px, py, pz, t_max);
    if (any_hit_sweep(s_tri, num_tris, s, t_max)) bits |= 1 << l;
  }
  return bits;
}

// What the shading and the next bounce read at a hit.
struct SurfaceAt {
  float px, py, pz, nx, ny, nz, kdx, kdy, kdz, ksx, ksy, ksz, shin;
};

// Surface at a hit (slot >= 0) at distance t: a triangle's interpolated
// normal flipped toward the viewer and its attributes (row of s_aux [T, 19]:
// n0 n1 n2, face normal, kd, ks, shininess), or a sphere's geometric normal
// and inline material (row slot - T of s_sph [S, 11]; no facing flip,
// ray_tracing.cpp:156).
__device__ __forceinline__ SurfaceAt hit_surface(const Ray& r, float t, int slot, float u,
                                                 float v, const float* s_aux, int num_tris,
                                                 const float* s_sph) {
  SurfaceAt s;
  s.px = r.ox + r.dx * t;
  s.py = r.oy + r.dy * t;
  s.pz = r.oz + r.dz * t;
  if (slot < num_tris) {
    const float* a = s_aux + 19 * slot;
    const float w0 = 1.0f - u - v;
    float nx = w0 * a[0] + u * a[3] + v * a[6];
    float ny = w0 * a[1] + u * a[4] + v * a[7];
    float nz = w0 * a[2] + u * a[5] + v * a[8];
    const float ninv = 1.0f / fmaxf(sqrtf(nx * nx + ny * ny + nz * nz), kNormEps);
    nx = nx * ninv;
    ny = ny * ninv;
    nz = nz * ninv;
    const float flip = (a[9] * r.dx + a[10] * r.dy + a[11] * r.dz) < 0.0f ? 1.0f : -1.0f;
    s.nx = nx * flip;
    s.ny = ny * flip;
    s.nz = nz * flip;
    s.kdx = a[12], s.kdy = a[13], s.kdz = a[14];
    s.ksx = a[15], s.ksy = a[16], s.ksz = a[17];
    s.shin = a[18];
  } else {
    const float* row = s_sph + 11 * (slot - num_tris);
    const float snx = s.px - row[0], sny = s.py - row[1], snz = s.pz - row[2];
    const float sinv = 1.0f / fmaxf(sqrtf(snx * snx + sny * sny + snz * snz), kNormEps);
    s.nx = snx * sinv;
    s.ny = sny * sinv;
    s.nz = snz * sinv;
    s.kdx = row[4], s.kdy = row[5], s.kdz = row[6];
    s.ksx = row[7], s.ksy = row[8], s.ksz = row[9];
    s.shin = row[10];
  }
  return s;
}

// Unit reflection of the ray's direction about the normal n (glm::reflect,
// then normalised): the specular lobe and the next bounce's direction.
__device__ __forceinline__ void reflect_unit(const Ray& r, float nx, float ny, float nz,
                                             float& rx, float& ry, float& rz) {
  const float ddn = r.dx * nx + r.dy * ny + r.dz * nz;
  rx = r.dx - 2.0f * ddn * nx;
  ry = r.dy - 2.0f * ddn * ny;
  rz = r.dz - 2.0f * ddn * nz;
  const float rinv = 1.0f / fmaxf(sqrtf(rx * rx + ry * ry + rz * rz), kNormEps);
  rx = rx * rinv;
  ry = ry * rinv;
  rz = rz * rinv;
}

// The reflection continue-test: any ks > 0.01, or ks.z alone under the
// reference's comma-operator quirk (main.cpp:246).
__device__ __forceinline__ bool continues(const SurfaceAt& s, int quirk_ks_z) {
  return quirk_ks_z ? s.ksz > 0.01f : (s.ksx > 0.01f || s.ksy > 0.01f || s.ksz > 0.01f);
}

// Ray-sphere quadratic (intersect_spheres_one parity); a2 = dot(d, d).
__device__ __forceinline__ bool sphere_hit(const Ray& r, float a2, float cx, float cy,
                                           float cz, float rad, float& t) {
  const float ocx = r.ox - cx, ocy = r.oy - cy, ocz = r.oz - cz;
  const float b = 2.0f * (r.dx * ocx + r.dy * ocy + r.dz * ocz);
  const float c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  const float disc = b * b - 4.0f * a2 * c;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float t_small = (-b - sq) / (2.0f * a2);
  const float t_big = (-b + sq) / (2.0f * a2);
  t = t_small >= 0.0f ? t_small : t_big;
  return disc >= 0.0f && t >= 0.0f;
}

__host__ __forceinline__ int num_blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace cgrt
